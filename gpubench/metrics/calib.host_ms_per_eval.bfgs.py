"""calib.host_ms_per_eval.bfgs: host milliseconds an evaluation in
``opt/bfgs``: the self time of the port's ``bfgs.line_search`` (the
probes' step arithmetic and Armijo tests, and the evaluation's glue outside
the ``nid.*`` spans) and ``bfgs.update`` (direction, curvature, the
inverse-Hessian update, the convergence tests), over the device pass's
solves."""

from gpubench import port_spans


def read(r):
    return port_spans.self_ms_per_eval(r, lambda name: name.startswith("bfgs."))
