"""calib.host_ms_per_eval.refine: host milliseconds an evaluation in
``opt/refine`` itself: the self time of the port's ``refine.*`` spans but
``refine.backward`` (the solve, its phases and outer iterations, the
trust-region guard, the evaluation's pose), over the device pass's solves.
With ``.bfgs``, ``.nid`` and ``.backward`` it covers a solve's wall."""

from gpubench import port_spans


def read(r):
    return port_spans.self_ms_per_eval(
        r, lambda name: name.startswith("refine.") and name != "refine.backward")
