"""calib.gathers_per_solve: gathers of the frozen-tap cache a solve, the
mean over the window's solves (``RefineResult.gathers``)."""


def read(r):
    if not r.records:
        return None
    return sum(x["gathers"] for x in r.records) / len(r.records)
