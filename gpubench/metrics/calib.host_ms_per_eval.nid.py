"""calib.host_ms_per_eval.nid: host milliseconds an evaluation in
``opt/nid``'s forward: the self time of the port's ``nid.*`` spans
(prepare, cache, project, gather, guard, histograms, entropies), over the
device pass's solves."""

from gpubench import port_spans


def read(r):
    return port_spans.self_ms_per_eval(r, lambda name: name.startswith("nid."))
