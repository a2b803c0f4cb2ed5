"""calib.syncs_per_eval: the port's host syncs (its ``host_sync`` counter:
reads of the card by the BFGS tests, the trust-region guard, the outer
convergence test, the frozen-tap guard and partial-refresh decisions, and
copies of host constants to it) an evaluation, over every traced solve
(both passes)."""

from gpubench import port_spans


def read(r):
    syncs = port_spans.host_syncs(r)
    evals = sum(x["evaluations"] for x in r.records if x["i"] in r.profiled)
    if syncs is None or not evals:
        return None
    return syncs / evals
