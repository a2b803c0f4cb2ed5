"""calib.host_ms_per_eval.backward: host milliseconds an evaluation in the
objective's backward: the self time of the port's ``refine.backward`` span
(``torch.autograd.grad``: autograd's queueing of the adjoint ops and K2),
over the device pass's solves."""

from gpubench import port_spans


def read(r):
    return port_spans.self_ms_per_eval(r, lambda name: name == "refine.backward")
