"""colorize.launches_per_job (read for ``colorize.launches_per_job.<cull>``): device kernel launches (memsets and copies
not counted) a fuse, over the traced jobs."""


def read(r):
    if r.trace is None or not r.traced or not r.trace.launches:
        return None
    return r.trace.launches / len(r.traced)
