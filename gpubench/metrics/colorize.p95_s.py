"""colorize.p95_s: the 95th percentile of the fuse latencies (seconds, host
clock, each job ending in a device synchronize), over the window's jobs that
ran outside the profiler, linear between ranks. Read where the host paces
the fuse (the traced card idles over half of it), so that its tail swings
with the host; where the card paces it the tail is the end-to-end
``colorize_p95_s``."""

from gpubench.harness import p95


def read(r):
    rest = [x for x in r.records if x["i"] not in r.profiled]
    return p95([x["wall"] for x in rest]) if len(rest) >= 20 else None
