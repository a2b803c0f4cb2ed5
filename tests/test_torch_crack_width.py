"""PyTorch port vs the JAX package: the crack analytics — `ops/morphology`
(numpy + scipy copies, bit-equal) and `tools/crack_width` (normals on the
device through `knn.radius_search`, S1's plain twin
`chunked_radius_neighbors` on the CPU; everything after them numpy).

Tolerance classes: bit-equal morphology and neighbor indices / flags (the
JAX package's `chunked_radius_neighbors` divides a query by the cell size
as a product with its reciprocal under `lax.map`, ROADMAP.md §3: no query
of these clouds sits within an ulp of a cell face, and the test asserts
the indices equal); normals within 1 - |cos| <= 1e-5 with the same sign on
rows of 3 or more neighbors (f32 summation order of the covariance), and on
degenerate rows (1-2 neighbors, a rank 0-1 covariance whose inverse
iteration ends near 1e19, ROADMAP.md §3) the zero-normal flips counted as
`tests/test_torch_mls.py`'s `_assert_fit_close` counts them; the results
JSON's widths within 1e-4 mm and its pixels equal."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pointcloudprocessor_tpu.ops import knn as jknn
from pointcloudprocessor_tpu.ops import morphology as jmorph
from pointcloudprocessor_tpu.tools import crack_width as jcw
from pointcloudprocessor_tpu_torch.ops import morphology as tmorph
from pointcloudprocessor_tpu_torch.tools import crack_width as tcw

import test_crack_width

CPU = "cpu"
cv2 = pytest.importorskip("cv2")
NRM_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _masks(seed):
    rng = np.random.default_rng(seed)
    m = np.zeros((70, 90), np.uint8)
    m[20:32, 5:80] = 255
    m[10:60, 40:47] = 255
    m[rng.uniform(size=m.shape) < 0.03] = 255
    return m


@pytest.mark.parametrize("seed", [0, 1])
def test_morphology_bit_equal(seed):
    """EDT, Zhang-Suen skeleton, Gaussian blur, structure-tensor directions
    and edge tracing bit-equal to the JAX package's on a cross with
    speckle."""
    m = _masks(seed)
    np.testing.assert_array_equal(tmorph.distance_transform(m), jmorph.distance_transform(m))
    sk = tmorph.skeletonize(m)
    np.testing.assert_array_equal(sk, jmorph.skeletonize(m))
    np.testing.assert_array_equal(tmorph.gaussian_blur(m, 1.5), jmorph.gaussian_blur(m, 1.5))
    pts = np.argwhere(sk > 0)[::3][:, ::-1]
    d = tmorph.structure_tensor_directions(sk, pts)
    np.testing.assert_array_equal(d, jmorph.structure_tensor_directions(sk, pts))
    normals = np.stack([-d[:, 1], d[:, 0]], -1)
    np.testing.assert_array_equal(tmorph.trace_edges(m, pts, normals),
                                  jmorph.trace_edges(m, pts, normals))


def _clouds():
    """Camera-frame clouds: test_crack_width's wall at z = 2, a tilted noisy
    wall with sparse outliers (rows of 1-2 neighbors), and a corner."""
    rng = np.random.default_rng(7)
    t = test_crack_width.TestCrackWidth
    n = 6000
    u, v = rng.uniform(0, t.W, n), rng.uniform(0, t.H, n)
    wall = np.stack([(u - t.W / 2) / t.F * t.Z, (v - t.H / 2) / t.F * t.Z,
                     np.full(n, t.Z)], -1)
    x, y = rng.uniform(-1.5, 1.5, 8000), rng.uniform(-1, 1, 8000)
    tilt = np.stack([x, y, 3.0 + 0.4 * x - 0.2 * y + rng.normal(0, 0.004, 8000)], -1)
    tilt = np.concatenate([tilt, rng.uniform([-3, -3, 1], [3, 3, 6], (60, 3))])
    a, b = rng.uniform(0, 1, (2, 3000))
    corner = np.concatenate([np.stack([a, b, np.full(3000, 2.5)], -1),
                             np.stack([np.zeros(3000), a, 2.5 - b], -1)]) + [-0.5, -0.5, 0]
    return {"wall": wall.astype(np.float32), "tilted": tilt.astype(np.float32),
            "corner": corner.astype(np.float32)}


@pytest.mark.parametrize("name", ["wall", "tilted", "corner"])
def test_estimate_normals_matches_jax(name):
    """Neighbor indices and flags bit-equal to JAX's grid search with JAX's
    parameters (cell = radius, table max(2n, 1024), capacity max(64,
    max_nn), chunks of 16,384); normals within NRM_TOL with JAX's sign
    towards the camera."""
    pts = _clouds()[name]
    n = len(pts)
    jp = jnp.asarray(pts)
    grid = jknn.build(jp, jnp.ones((n,), bool), cell_size=0.1, table_size=max(2 * n, 1024),
                      bucket_capacity=64)
    idx_j, _, ok_j = jknn.chunked_radius_neighbors(grid, jp, jp, 0.1, 60, chunk_size=16384)
    idx_t, ok_t = tcw.neighbors(torch.from_numpy(pts), 0.1, 60)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))

    nj = jcw.estimate_normals(pts)
    nt = tcw.estimate_normals(pts, device=CPU)
    cnt = np.asarray(ok_j).sum(1)
    zero_j, zero_t = ~np.any(nj != 0, 1), ~np.any(nt != 0, 1)
    flip = zero_j != zero_t
    assert (cnt[flip] <= 3).all(), cnt[flip]
    live = ~zero_j & ~flip & (cnt >= 3)
    cos = np.sum(nt * nj, axis=1)
    assert live.sum() > 0.9 * n
    assert (1.0 - cos[live]).max() <= NRM_TOL, (1.0 - cos[live]).max()
    # Oriented towards the camera at the origin, as JAX orients them.
    assert (np.sum(nt[live] * pts[live], 1) <= 0).all()
    if name == "tilted":
        assert (cnt <= 2).sum() > 0  # the outliers' degenerate rows ran


def _process(root, module, **kw):
    t = test_crack_width.TestCrackWidth
    return module.process(str(root), intrinsic=(t.F, t.F, t.W / 2, t.H / 2),
                          distortion=(0, 0, 0, 0, 0), width=t.W, height=t.H, **kw)


@pytest.mark.parametrize("picks", [False, True])
def test_crack_width_process_matches_jax(tmp_path, picks):
    """`process` on tests/test_crack_width.py's data (auto-sampled skeleton,
    and picked points): the results JSON's pixels, directions and planes
    equal JAX's up to the normals' and bearings' f32 rounding (1e-6), its
    widths within 1e-4 mm, and the same masks and overlays written."""
    t = test_crack_width.TestCrackWidth()
    for sub in ("j", "t"):
        t._write_dataset(tmp_path / sub)
    kw = dict(skeleton_stride=20)
    if picks:
        for sub in ("j", "t"):
            (tmp_path / sub / "picks.json").write_text(
                json.dumps({"100.000000": [[128, 100], [128, 150], [120, 60]]}))
        kw = dict(picks_path=None)
    res = {}
    for sub, mod in (("j", jcw), ("t", tcw)):
        args = dict(kw)
        if picks:
            args["picks_path"] = str(tmp_path / sub / "picks.json")
        if mod is tcw:
            args["device"] = CPU
        res[sub] = json.loads(open(_process(tmp_path / sub, mod, **args)).read())
    rj, rt = res["j"], res["t"]
    assert len(rt) == len(rj) >= (3 if picks else 5)
    for a, b in zip(rt, rj):
        assert set(a) == set(b)
        for key in ("skeleton_pt", "left_edge_pt2d", "right_edge_pt2d"):
            assert a[key] == b[key]
        for key in ("direction_2d", "local_plane_3d", "left_edge_3d_pt", "right_edge_3d_pt"):
            np.testing.assert_allclose(a[key], b[key], atol=1e-6)
        np.testing.assert_allclose(a["crack_width_mm"], b["crack_width_mm"], atol=1e-4)
    widths = [m["crack_width_mm"] for m in rt if m["crack_width_mm"]]
    assert 55.0 < np.median(widths) < 110.0, widths
    for rel in ("edt_skeleton/100.000000_skeleton.png", "edt_skeleton/100.000000_edt.png",
                "distance_mask/100.000000_distance.png"):
        assert (tmp_path / "t" / rel).read_bytes() == (tmp_path / "j" / rel).read_bytes(), rel
    for rel in ("norm_masks/100.000000_norm.png",
                "edt_skeleton/100.000000_skeleton_edge_pts.png"):
        assert os.path.exists(tmp_path / "t" / rel)


def test_crack_width_cli(tmp_path, capsys):
    t = test_crack_width.TestCrackWidth()
    t._write_dataset(tmp_path)
    rc = tcw.main(["--data_root", str(tmp_path), "--intrinsic", str(t.F), str(t.F),
                   str(t.W / 2), str(t.H / 2), "--width", str(t.W), "--height", str(t.H),
                   "--skeleton-stride", "40", "--device", CPU])
    assert rc == 0
    path = capsys.readouterr().out.strip()
    assert path.endswith("crack_width_3d_results.json") and json.loads(open(path).read())
