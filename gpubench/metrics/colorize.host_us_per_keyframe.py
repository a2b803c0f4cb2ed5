"""colorize.host_us_per_keyframe (read for
``colorize.host_us_per_keyframe.<cull>``): host microseconds of a
keyframe's update in a fuse: the mean self time of the port's
``colorize.keyframe`` spans (its arguments packed and C1b queued), over the
device pass's fuses."""

from gpubench import port_spans


def read(r):
    jobs = port_spans.device_pass(r)
    if not jobs:
        return None
    ns = [s for job in jobs for rec, s in job if rec.name == "colorize.keyframe"]
    return sum(ns) / len(ns) / 1e3 if ns else None
