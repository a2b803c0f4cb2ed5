"""hpr.h2_roofline: H2 (``hpr_bounds``, ``hpr_scatter``, ``hpr_erode``,
``hpr_test`` of ``csrc/hpr.cu``) over the traced jobs, its least time in the
views form (``rooflines/h2.py``, one call for each batch of up to 32 views)
over its device time, in percent."""

from gpubench.rooflines import h2


def read(r):
    c = r.counts
    if r.trace is None or not c or c["method"] != "hpr":
        return None
    t, n = r.trace.matching("hpr_bounds", "hpr_scatter", "hpr_erode", "hpr_test")
    if not t or not n:
        return None
    views = c["views"]
    bound = sum(h2.bound_s(c["n"], min(c["batch"], views - a)) for a in range(0, views, c["batch"]))
    return 100.0 * bound * c["jobs"] / t
