"""What the per-layer metrics read of the port's own spans and counters
(``pointcloudprocessor_tpu_torch.utils.profiling``: ``span_records()``,
each span's name, parent, host clock and the counts ticked while it was the
innermost open span).

The port records spans while any torch.profiler capture runs, so a traced
run leaves one root span a traced job (``refine.solve`` of a solve,
``colorize.fuse`` of a fuse) with the spans of its layers under it: the
device pass's ``params["trace_jobs"]`` jobs first, then the spans pass's
``params["span_jobs"]``. Self times are read from the device pass alone
(CUDA activity only: the host near its untraced pace); counts from both.
A port without spans (an older checkout) gives None, and so does each
reader built on it."""

from __future__ import annotations

ROOTS = ("refine.solve", "colorize.fuse")


def traced_jobs(r):
    """The traced run's jobs, in run order, each a list of ``(record,
    self_ns)`` of the spans under its root, the root first; self_ns is a
    span's duration less its children's. The last ``trace_jobs +
    span_jobs`` root spans of the process are the run's. None where the
    port recorded none, or fewer than that."""
    try:
        from pointcloudprocessor_tpu_torch.utils import profiling

        records = profiling.span_records()
    except (ImportError, AttributeError):
        return None
    return jobs_of(records, r.params["trace_jobs"] + r.params["span_jobs"])


def jobs_of(records, n: int):
    """:func:`traced_jobs` on a list of span records."""
    if n <= 0:
        return None
    self_ns, root_of = [], []
    for j, rec in enumerate(records):
        self_ns.append(rec.end_ns - rec.start_ns)
        root_of.append(j if rec.parent < 0 else root_of[rec.parent])
        if rec.parent >= 0:
            self_ns[rec.parent] -= rec.end_ns - rec.start_ns
    roots = [j for j, rec in enumerate(records) if rec.parent < 0 and rec.name in ROOTS]
    if len(roots) < n:
        return None
    trees = {j: [] for j in roots[-n:]}
    for j, rec in enumerate(records):
        if root_of[j] in trees:
            trees[root_of[j]].append((rec, self_ns[j]))
    return [trees[j] for j in roots[-n:]]


def device_pass(r):
    """The device pass's jobs of :func:`traced_jobs`, or None."""
    jobs = traced_jobs(r)
    return None if jobs is None else jobs[: r.params["trace_jobs"]]


def self_ms_per_eval(r, keep) -> float | None:
    """Milliseconds a solve's evaluation spends in the spans whose name
    ``keep`` accepts, by their self time, over the device pass's solves."""
    jobs = device_pass(r)
    evals = sum(x["evaluations"] for x in r.traced)
    if not jobs or not evals or len(jobs) != len(r.traced):
        return None
    ns = sum(s for job in jobs for rec, s in job if keep(rec.name))
    return ns / 1e6 / evals


def host_syncs(r) -> int | None:
    """``host_sync`` ticks over every traced job, or None."""
    jobs = traced_jobs(r)
    if jobs is None:
        return None
    return sum(rec.counts.get("host_sync", 0) for job in jobs for rec, _ in job)
