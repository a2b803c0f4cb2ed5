"""calib.eval_ms: milliseconds an evaluation, by the benchmark's clock: the
solves' walls summed over their evaluations summed, over the window's
solves that ran outside the profiler."""


def read(r):
    rest = [x for x in r.records if x["i"] not in r.profiled]
    evals = sum(x["evaluations"] for x in rest)
    if not evals:
        return None
    return 1e3 * sum(x["wall"] for x in rest) / evals
