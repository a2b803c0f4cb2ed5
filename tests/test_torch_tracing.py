"""The port's spans and counters (`utils/profiling.span`, `count`,
`host_read`, `to_device`) on the CPU: a tiny solve with the coarse phase and frozen taps
on, and tiny fuses under the z-buffer and under HPR (its grid views form),
recorded under a torch.profiler capture.

Every span the two reach is recorded with the parent the solve's and the
fuse's layering gives it; the spans nest (each inside its parent, siblings
apart), so a root's self times sum to its duration; with no capture a
whole solve and fuse record nothing and tick nothing, with
``record_function`` made to raise; ``host_sync`` ticks at least once an
evaluation, the same on two identical solves; a capture the port did not
open gets no event of the port's, and one it did (``profiling.trace``)
gets each span as a region."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pointcloudprocessor_tpu_torch.core import se3
from pointcloudprocessor_tpu_torch.models import camera as cam
from pointcloudprocessor_tpu_torch.opt import refine
from pointcloudprocessor_tpu_torch.pipeline import colorize
from pointcloudprocessor_tpu_torch.tools import nid_locality
from pointcloudprocessor_tpu_torch.utils import profiling

CPU = "cpu"
W, H, N, K = 128, 96, 2048, 2  # the NID scene: width, height, points a keyframe, keyframes
SOLVE = dict(max_outer_iterations=2, max_inner_iterations=6, coarse_outer_iterations=1,
             coarse_stride=4, frozen_taps=True, frozen_guard_frac=0.25, ftol=3e-4)
# A span an evaluation opens sits in the line search or, for an inner
# solve's first evaluation, in the outer iteration.
EVAL = {"bfgs.line_search", "refine.outer"}
# Each span the tiny solve or fuse reaches, with the parents its layer
# gives it (None: a root).
PARENTS = {
    "refine.solve": {None},
    "nid.prepare": {"refine.solve"},
    "refine.coarse": {"refine.solve"},
    "refine.fine": {"refine.solve"},
    "refine.final_nid": {"refine.solve"},
    "nid.cache": {"refine.fine"},
    "refine.outer": {"refine.coarse", "refine.fine"},
    "bfgs.line_search": {"refine.outer"},
    "bfgs.update": {"refine.outer"},
    "refine.guard": EVAL,
    "refine.pose": EVAL,
    "refine.backward": EVAL,
    "nid.project": EVAL,
    "nid.gather": EVAL,
    "nid.guard": EVAL,
    "nid.histograms": EVAL,
    "nid.entropies": EVAL,
    "colorize.fuse": {None},
    "colorize.keys": {"colorize.fuse"},
    "colorize.cull": {"colorize.fuse"},
    "colorize.keyframe": {"colorize.fuse"},
    "colorize.blend": {"colorize.fuse"},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch ops (the suite runs several
    workers; a thread pool over many small ops slows them all)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nid_scene():
    camera, kfs = nid_locality.build_scene(W, H, N, K, CPU)
    q = torch.tensor([1.0, 0.002, -0.001, 0.0])
    T0 = se3.from_qt(q / torch.linalg.norm(q), torch.tensor([0.01, -0.005, 0.0]))
    return camera, kfs, T0


@pytest.fixture(scope="module")
def fuse_scene():
    """A wall of 3,000 points at z = 5 m seen by 3 keyframes 0.2 m apart."""
    g = torch.Generator().manual_seed(5)
    w, h, f = 96, 72, 90.0
    camera = cam.create_camera("pinhole", (f, f, w / 2, h / 2), (0.0,) * 5, w, h, CPU)
    n = 3000
    xy = (torch.rand((n, 2), generator=g) - 0.5) * torch.tensor([6.0, 4.0])
    points = torch.cat([xy, torch.full((n, 1), 5.0)], dim=1)
    valid = torch.ones(n, dtype=torch.bool)
    images = torch.randint(0, 256, (3, h, w, 3), generator=g, dtype=torch.uint8)
    q = torch.tensor([[1.0, 0.0, 0.0, 0.0]] * 3)
    t = torch.tensor([[-0.2, 0.0, 0.0], [0.0, 0.0, 0.0], [0.2, 0.0, 0.0]])
    return camera, points, valid, images, se3.SE3(q, t)


def _solve(nid_scene):
    camera, kfs, T0 = nid_scene
    return refine.refine_pose(camera, kfs, T0, **SOLVE)


def _fuse(fuse_scene, method):
    camera, points, valid, images, poses = fuse_scene
    return colorize.fuse(camera, points, valid, images, poses, se3.identity(CPU), top_k=3,
                         culling_method=method, downsample_factor=4, hpr_impl="grid")


def _captured(fn):
    """(fn's result, its span records, its counters) under a CPU capture."""
    profiling.reset_trace()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, profiling.span_records(), profiling.counter_values()


@pytest.fixture(scope="module")
def traced(nid_scene, fuse_scene):
    """Each traced run: the solve, the z-buffer fuse, the HPR fuse."""
    runs = {"solve": _captured(lambda: _solve(nid_scene))}
    for method in ("zbuffer", "hpr"):
        runs[method] = _captured(lambda m=method: _fuse(fuse_scene, m))
    profiling.reset_trace()
    return runs


@pytest.mark.parametrize("name", sorted(PARENTS))
def test_span_is_recorded_under_its_parent(traced, name):
    records = [r for _, recs, _ in traced.values() for r in recs]
    found = [(recs, r) for _, recs, _ in traced.values() for r in recs if r.name == name]
    assert found, f"no {name} span recorded"
    parents = {recs[r.parent].name if r.parent >= 0 else None for recs, r in found}
    if name.startswith("nid."):
        # The nid spans also sit under the cache's build, the keyframes'
        # preparation, the final exact evaluation and, the exact objective
        # preparing its keyframes, under an evaluation.
        assert parents & PARENTS[name], parents
        assert parents <= PARENTS[name] | EVAL | {"refine.solve", "refine.fine",
                                                  "refine.final_nid", "nid.cache",
                                                  "nid.prepare"}, parents
    else:
        assert parents <= PARENTS[name], parents
    assert all(r.end_ns >= r.start_ns > 0 for r in records)


@pytest.mark.parametrize("run", ["solve", "hpr"])
def test_root_self_times_add_up(traced, run):
    """Each span lies inside its parent and after its earlier siblings, so
    a root's self time plus its children's durations is its duration, and
    the self times of its tree sum to it."""
    _, records, _ = traced[run]
    roots = [j for j, r in enumerate(records) if r.parent < 0]
    assert [records[j].name for j in roots] == ["refine.solve" if run == "solve"
                                                 else "colorize.fuse"]
    self_ns = [r.end_ns - r.start_ns for r in records]
    last_end = {}
    for j, r in enumerate(records):
        if r.parent >= 0:
            p = records[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
            assert r.start_ns >= last_end.get(r.parent, p.start_ns)
            last_end[r.parent] = r.end_ns
            self_ns[r.parent] -= r.end_ns - r.start_ns
    assert min(self_ns) >= 0
    root = records[roots[0]]
    children = sum(r.end_ns - r.start_ns for r in records if r.parent == roots[0])
    assert self_ns[roots[0]] + children == root.end_ns - root.start_ns
    assert sum(self_ns) == root.end_ns - root.start_ns


@pytest.mark.parametrize("run", ["solve", "fuse"])
def test_no_capture_records_nothing(nid_scene, fuse_scene, monkeypatch, run):
    """Without a capture a whole solve or fuse opens no region (one would
    raise here) and records and counts nothing."""

    def refuse(*args, **kwargs):
        raise AssertionError("a span opened a record_function with no capture running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    profiling.reset_trace()
    if run == "solve":
        res = _solve(nid_scene)
        assert res.evaluations > 0
    else:
        for method in ("zbuffer", "hpr"):
            assert int(_fuse(fuse_scene, method).colored.sum()) > 0
    assert profiling.span_records() == [] and profiling.counter_values() == {}


def test_host_syncs_count_each_evaluation_and_repeat(traced, nid_scene):
    """``host_sync`` ticks at least once an evaluation (the trust-region
    guard) and reads the same on an identical second solve; every tick is
    on a span of the solve. The fuse reads nothing back: its one tick is the
    quaternion constant its views' inverse uploads."""
    res, records, counters = traced["solve"]
    again, records2, counters2 = _captured(lambda: _solve(nid_scene))
    profiling.reset_trace()
    assert again.evaluations == res.evaluations
    assert counters["host_sync"] >= res.evaluations
    assert counters2 == counters
    assert sum(r.counts.get("host_sync", 0) for r in records) == counters["host_sync"]
    assert [r.counts for r in records2] == [r.counts for r in records]
    for method in ("zbuffer", "hpr"):
        assert traced[method][2] == {"host_sync": 1}


def test_a_foreign_capture_holds_no_port_event(fuse_scene):
    """A capture the port did not open (the benchmark's) gets none of the
    port's spans among its events: they stay in the port's records."""
    profiling.reset_trace()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _fuse(fuse_scene, "zbuffer")
    names = {e.name for e in prof.events()}
    recorded = {r.name for r in profiling.span_records()}
    profiling.reset_trace()
    assert {"colorize.fuse", "colorize.keys", "colorize.keyframe"} <= recorded
    assert not names & recorded


def test_own_trace_holds_each_span_as_a_region(tmp_path, fuse_scene):
    """Inside ``profiling.trace`` every span is also a ``record_function``
    of its name, on the capture's clock, written to trace.json."""
    profiling.reset_trace()
    with profiling.trace(str(tmp_path)) as prof:
        _fuse(fuse_scene, "hpr")
    events = [e for e in prof.events() if e.name.startswith("colorize.")]
    recorded = profiling.span_records()
    profiling.reset_trace()
    assert sorted(e.name for e in events) == sorted(r.name for r in recorded)
    with open(tmp_path / "trace.json") as f:
        text = f.read()
    assert '"colorize.cull"' in text and '"colorize.blend"' in text
