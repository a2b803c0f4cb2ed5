"""idle_share (read for every ``idle_share.<cell kind>``): the share of the
device-traced jobs' work in which the device would idle at the untraced
pace, in percent: 1 less the device pass's busy time (the union of its
kernels, memsets and copies) over the untraced wall of the same work, each
traced job's wall taken as the mean of the window's untraced jobs of its
``work`` (a solve: its start). Tracing slows the host (CUPTI: a traced solve
takes 1.1-1.4x its untraced wall) but not the device's work, so the share
holds none of the profiler's cost, and a change that cuts host work shows in
it whole."""

from collections import defaultdict


def read(r):
    t = r.trace
    if t is None or not t.busy_s or not r.traced:
        return None
    walls = defaultdict(list)
    for x in r.records:
        if x["i"] not in r.profiled:
            walls[x["work"]].append(x["wall"])
    if any(x["work"] not in walls for x in r.traced):
        return None
    untraced = sum(sum(walls[x["work"]]) / len(walls[x["work"]]) for x in r.traced)
    return 100.0 * (1.0 - t.busy_s / untraced)
