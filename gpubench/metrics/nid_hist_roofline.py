"""nid_hist_roofline: K1 and K2 (``ops/nid_hist``) over the traced solves,
their least time (``rooflines/k1.py``, ``k2.py`` at each launch's shape, as
the port counts launches by points a keyframe) over their device time, in
percent."""

from gpubench.rooflines import k1, k2


def read(r):
    c = r.counts
    if r.trace is None or not c:
        return None
    t, n = r.trace.matching("nid_hist_fwd", "nid_hist_bwd")
    if not t or not n:
        return None
    bound = 0.0
    for key, launches in c["shapes"].items():
        kernel, points = key.rsplit(":", 1)
        mod = {"nid_hist_fwd": k1, "nid_hist_bwd": k2}.get(kernel)
        if mod is not None:
            bound += launches * mod.bound_s(c["k"], int(points))
    return 100.0 * bound / t
