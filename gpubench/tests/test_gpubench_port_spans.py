"""The readers of the port's spans and counters (``port_spans.py`` and the
metrics built on it) on synthetic span records: the device pass's jobs
give the self times, every traced job the counts, the four
``calib.host_ms_per_eval.*`` cover a solve's whole root span, and a port
without spans, or with too few roots, reads None."""

import os
from types import SimpleNamespace

import pytest

from gpubench import harness, port_spans
from pointcloudprocessor_tpu_torch.utils import profiling
from tiny import ROOT


def _rec(name, parent, start, end, **counts):
    return SimpleNamespace(name=name, parent=parent, start_ns=start, end_ns=end, counts=counts)


def _solve(records, t0, syncs):
    """A solve's spans from ``t0`` (ns), appended to ``records``: 100 us of
    root, under it a fine phase with one outer iteration holding a line
    search (guard, nid.project, nid.histograms, refine.backward) and an
    update."""
    r = len(records)
    records += [_rec("refine.solve", -1, t0, t0 + 100_000),
                _rec("nid.prepare", r, t0 + 1_000, t0 + 6_000),
                _rec("refine.fine", r, t0 + 10_000, t0 + 90_000)]
    o = len(records)
    records.append(_rec("refine.outer", r + 2, t0 + 12_000, t0 + 88_000, host_sync=1))
    ls = len(records)
    records += [_rec("bfgs.line_search", o, t0 + 20_000, t0 + 70_000, host_sync=syncs),
                _rec("refine.guard", ls, t0 + 21_000, t0 + 23_000, host_sync=1),
                _rec("nid.project", ls, t0 + 25_000, t0 + 35_000),
                _rec("nid.histograms", ls, t0 + 35_000, t0 + 45_000),
                _rec("refine.backward", ls, t0 + 50_000, t0 + 68_000),
                _rec("bfgs.update", o, t0 + 72_000, t0 + 80_000, host_sync=2)]


def _reading(records, traced, profiled, trace_jobs, span_jobs):
    return harness.Reading("calib.s1_k64", records, traced, profiled, None, {}, {},
                           {"trace_jobs": trace_jobs, "span_jobs": span_jobs}, 0)


def _read(metric):
    return harness.load_file_module(
        harness.reader_path(os.path.join(ROOT, "gpubench"), metric), "gpubench_metric").read


@pytest.fixture
def calib(monkeypatch):
    """An earlier run's solve, then a traced run's 2 device-pass and 1
    spans-pass solves (its jobs 5-7, 4 evaluations each)."""
    records = []
    for i, syncs in enumerate((9, 3, 3, 3)):
        _solve(records, 1_000_000 * (i + 1), syncs)
    monkeypatch.setattr(profiling, "span_records", lambda: list(records), raising=False)
    jobs = [{"i": i, "evaluations": 4, "work": 0, "wall": 1.0} for i in range(8)]
    return _reading(jobs, jobs[5:7], {5, 6, 7}, 2, 1)


def test_jobs_are_the_last_roots(calib):
    jobs = port_spans.traced_jobs(calib)
    assert len(jobs) == 3 and all(job[0][0].name == "refine.solve" for job in jobs)
    assert [job[0][0].start_ns for job in jobs] == [2_000_000, 3_000_000, 4_000_000]
    assert all(len(job) == 10 and sum(s for _, s in job) == 100_000 for job in jobs)


def test_calib_readers(calib):
    ms = {k: _read(f"calib.host_ms_per_eval.{k}")(calib)
          for k in ("refine", "bfgs", "nid", "backward")}
    # Self times (us) a solve: refine 15 (solve) + 4 (fine) + 18 (outer) + 2
    # (guard), bfgs 10 + 8, nid 5 + 10 + 10, backward 18; over 4 evaluations.
    assert ms == pytest.approx({"refine": 0.00975, "bfgs": 0.0045, "nid": 0.00625,
                                "backward": 0.0045})
    assert sum(ms.values()) == pytest.approx(0.1 / 4)  # the root's 100 us a solve
    assert _read("calib.syncs_per_eval")(calib) == pytest.approx(3 * (1 + 3 + 1 + 2) / 12)


def test_colorize_readers(monkeypatch):
    records = []
    for j in range(3):
        t0 = 1_000_000 * j
        records.append(_rec("colorize.fuse", -1, t0, t0 + 50_000))
        root = len(records) - 1
        records.append(_rec("colorize.keys", root, t0 + 1_000, t0 + 3_000))
        for k in range(4):
            records.append(_rec("colorize.keyframe", root, t0 + 5_000 + 10_000 * k,
                                t0 + 5_000 + 10_000 * k + 2_000 * (j + 1)))
        records.append(_rec("colorize.blend", root, t0 + 46_000, t0 + 49_000))
    monkeypatch.setattr(profiling, "span_records", lambda: list(records), raising=False)
    jobs = [{"i": i, "work": 0, "wall": 1.0} for i in range(3)]
    r = _reading(jobs, jobs[:2], {0, 1, 2}, 2, 1)
    # The device pass's keyframes: 2 us and 4 us.
    assert _read("colorize.host_us_per_keyframe.zbuffer")(r) == pytest.approx(3.0)
    assert _read("colorize.syncs_per_job.hpr")(r) == 0.0


def test_no_spans_read_none(calib, monkeypatch):
    """A port without span records (an older checkout), or fewer roots than
    the traced jobs, reads None and raises nothing."""
    few = port_spans.jobs_of(profiling.span_records()[:20], 3)
    assert few is None
    monkeypatch.delattr(profiling, "span_records")
    for metric in ("calib.syncs_per_eval", "calib.host_ms_per_eval.refine",
                   "colorize.host_us_per_keyframe.hpr", "colorize.syncs_per_job.zbuffer"):
        assert _read(metric)(calib) is None
