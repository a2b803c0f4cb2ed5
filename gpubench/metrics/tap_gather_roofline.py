"""tap_gather_roofline: G1 (``tap_take``) and B1 (``bin_pack``) of
``ops/tap_gather`` over the traced solves, their least time
(``rooflines/g1.py`` at each launch's shape, its window pixels counted at
that shape's pose; ``rooflines/b1.py``, one pack of the K bin images a
solve) over their device time, in percent."""

from gpubench.rooflines import b1, g1


def read(r):
    c = r.counts
    if r.trace is None or not c:
        return None
    t_g1, n_g1 = r.trace.matching("tap_take_kernel")
    t_b1, n_b1 = r.trace.matching("bin_pack")
    if not (t_g1 + t_b1) or not n_g1:
        return None
    bound = n_b1 * b1.bound_s(c["k"], c["height"], c["width"])
    for key, launches in c["shapes"].items():
        kernel, points = key.rsplit(":", 1)
        if kernel == "tap_take":
            pixels = c["window_pixels"].get(int(points))
            if pixels is None:
                return None
            bound += launches * g1.bound_s(c["k"], int(points), pixels)
    return 100.0 * bound / (t_g1 + t_b1)
