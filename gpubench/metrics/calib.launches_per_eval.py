"""calib.launches_per_eval: device kernel launches (memsets and copies not
counted) over the traced solves, a value-and-gradient evaluation: the
arithmetic of the port's ``profiling.eval_split``."""


def read(r):
    evals = sum(x["evaluations"] for x in r.traced)
    if r.trace is None or not evals or not r.trace.launches:
        return None
    return r.trace.launches / evals
