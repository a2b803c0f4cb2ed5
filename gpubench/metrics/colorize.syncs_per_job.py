"""colorize.syncs_per_job (read for ``colorize.syncs_per_job.<cull>``): the
port's host syncs (its ``host_sync`` counter: reads of the card and
copies of host values to it) a fuse, over every traced fuse (both
passes)."""

from gpubench import port_spans


def read(r):
    syncs = port_spans.host_syncs(r)
    jobs = sum(1 for x in r.records if x["i"] in r.profiled)
    if syncs is None or not jobs:
        return None
    return syncs / jobs
