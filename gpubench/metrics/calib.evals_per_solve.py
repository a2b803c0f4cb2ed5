"""calib.evals_per_solve: objective evaluations (value and gradient) a
solve, the mean over the window's solves (``RefineResult.evaluations``)."""


def read(r):
    if not r.records:
        return None
    return sum(x["evaluations"] for x in r.records) / len(r.records)
