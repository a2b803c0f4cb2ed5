"""colorize.c1_roofline (read for ``colorize.c1_roofline.<cull>``): C1a (``colorize_scatter``, under the z-buffer) and
C1b (``colorize_update``) of ``csrc/colorize.cu`` over the traced jobs,
their least time over their device time, in percent. The counts are those
of the reference's fuse of the first traced job's input
(``rooflines/c1a.py``, ``c1b.py``); every traced job fuses the same views
of the same map within a centimetre, so each is charged those counts."""

from gpubench.rooflines import c1a, c1b


def read(r):
    c = r.counts
    if r.trace is None or not c:
        return None
    t, n = r.trace.matching("colorize_scatter", "colorize_update")
    if not t or not n:
        return None
    stats, views = c["stats"], c["views"]
    bound = 0.0
    if c["method"] == "zbuffer":
        for a in range(0, views, c["batch"]):
            part = stats[a:a + c["batch"]]
            bound += c1a.bound_s(c["n"], len(part), c["cells"], c["valid"] * len(part),
                                 sum(s["front"] for s in part), sum(s["gated"] for s in part))
        cull_bytes = 4 * c["cells"]
    else:
        cull_bytes = c["n"]
    for s in stats:
        bound += c1b.bound_s(c["n"], cull_bytes, s["visible"], c["top_k"], s["pixels"],
                             s["replaced"])
    return 100.0 * bound * c["jobs"] / t
