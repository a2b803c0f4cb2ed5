"""PyTorch port: the query schedules of the grid-hash searches and the
order independence that S1 and M1 rest on, held against the JAX package.

S1 (``knn.knn_select_cuda``) and M1 (``mls.mls_moments_cuda``) take their
queries in a schedule that groups equal cells (the grid's own sort order
``HashGrid.order`` for the grid's points, or ``knn.cell_order``) and stage one
candidate window a cell; their results must not depend on the schedule.
The kernels run only on the card (``chip_smoke.py`` holds them to their
twins under three schedules); here the schedules themselves and the twins'
order independence are checked, on a 20,000-point hardened corner, a
cell-face lattice, a cloud with NaN / inf rows and 1% invalid points, and a
2-bucket table where every cell collides.

Tolerance classes as tests/test_torch_mls.py: neighbor indices, flags,
in-radius counts and bucket tables bit-exact; distances against JAX op by
op within rtol 1e-6 (XLA's vectorized sqrt on the CPU is not always
correctly rounded); SOR masks equal (a point on the other side would have
to lie within 4 ulp of the threshold); against the port's own twins on a
reordered query set, every output bit for bit.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from pointcloudprocessor_tpu.ops import knn as jknn
from pointcloudprocessor_tpu.ops import sor as jsor
from pointcloudprocessor_tpu_torch.ops import knn as tknn
from pointcloudprocessor_tpu_torch.ops import mls as tmls
from pointcloudprocessor_tpu_torch.ops import sor as tsor
from pointcloudprocessor_tpu_torch.ops.voxel import voxel_coords
from pointcloudprocessor_tpu_torch.tools import bench_scene

SOR_CELL, SOR_K, SOR_B = 0.25, 60, 60  # the reference's SOR (cloudSmooth.cpp:110-115)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch ops (see test_torch_mls.py:
    under the suite's workers a thread pool over small ops runs far slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corner(n=20_000, seed=2):
    return bench_scene.mls_scene(n, seed), np.ones(n, bool)


def _face_lattice(seed=10):
    """x on the 0.015 m lattice (f32 products; every other value on a face
    of the 0.03 m cells), y random, z on a plane with 1 mm noise
    (tests/test_torch_mls.py's lattice)."""
    rs = np.random.default_rng(seed)
    ix = rs.integers(150, 200, 4000)
    p = np.stack([ix * np.float32(0.015), rs.uniform(0, 0.6, 4000),
                  2.0 + 0.001 * rs.standard_normal(4000)], -1)
    return p.astype(np.float32), np.ones(4000, bool)


def _nan_rows(n=6000, seed=3):
    """A corner with NaN and +-inf coordinates and 1% of the points invalid."""
    p = bench_scene.mls_scene(n, seed)
    p[:3] = np.nan
    p[3, 0], p[4, 2], p[5, 1] = np.inf, -np.inf, np.nan
    return p, np.arange(n) % 100 != 7


CLOUDS = {"corner": _corner, "face lattice": _face_lattice, "NaN rows": _nan_rows}
# The 2-bucket table: every occupied cell shares one of two buckets.
TABLES = {"2N buckets": None, "2 buckets": 2}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (NaN rows included)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _runs(cells: torch.Tensor) -> int:
    """Runs of equal consecutive rows."""
    if cells.shape[0] == 0:
        return 0
    return 1 + int((cells[1:] != cells[:-1]).any(1).sum())


@pytest.mark.parametrize("cloud", list(CLOUDS))
@pytest.mark.parametrize("table", list(TABLES))
def test_cell_order_groups_equal_cells(cloud, table):
    """``knn.cell_order`` is an int32 permutation of the queries that puts
    equal cells next to each other: as many runs as distinct cells, hash
    collisions (the 2-bucket table), NaN and infinite rows included."""
    p, _ = CLOUDS[cloud]()
    pts = _t(p)
    t = TABLES[table] or 2 * len(p)
    order = tknn.cell_order(pts, SOR_CELL, t)
    assert order.dtype == torch.int32 and order.shape == (len(p),)
    assert torch.equal(torch.sort(order).values, torch.arange(len(p), dtype=torch.int32))
    cells = voxel_coords(pts, SOR_CELL)[order.long()]
    assert _runs(cells) == torch.unique(cells, dim=0).shape[0]
    cells3 = voxel_coords(pts, 0.03)[tknn.cell_order(pts, 0.03, t).long()]
    assert _runs(cells3) == torch.unique(cells3, dim=0).shape[0]


@pytest.mark.parametrize("cloud", list(CLOUDS))
@pytest.mark.parametrize("table", list(TABLES))
def test_build_keeps_its_order_and_jax_tables(cloud, table):
    """``knn.build`` keeps the permutation it sorts by (``order``: by bucket,
    in a bucket the valid points before the invalid, each in index order),
    and its tables stay bit-equal to the JAX package's."""
    p, valid = CLOUDS[cloud]()
    t = TABLES[table] or 2 * len(p)
    grid = tknn.build(_t(p), _t(valid), SOR_CELL, t, SOR_B)
    gj = jknn.build(jnp.asarray(p), jnp.asarray(valid), SOR_CELL, t, SOR_B)
    np.testing.assert_array_equal(grid.buckets.numpy(), np.asarray(gj.buckets))
    np.testing.assert_array_equal(grid.counts.numpy(), np.asarray(gj.counts))
    order = grid.order
    assert order.dtype == torch.int32
    assert torch.equal(torch.sort(order).values, torch.arange(len(p), dtype=torch.int32))
    from pointcloudprocessor_tpu_torch.ops.voxel import voxel_hash

    key = (voxel_hash(voxel_coords(_t(p), SOR_CELL), t).long() * 2 + (~_t(valid)).long())
    key = key[order.long()]
    assert bool((key[1:] >= key[:-1]).all())
    same = key[1:] == key[:-1]
    assert bool((order[1:][same] > order[:-1][same]).all())  # stable


def _permutations(p, t):
    pts = _t(p)
    rs = np.random.default_rng(7)
    return {"cell order": tknn.cell_order(pts, SOR_CELL, t).long(),
            "random": torch.from_numpy(rs.permutation(len(p)))}


@pytest.mark.parametrize("cloud", list(CLOUDS))
@pytest.mark.parametrize("table", list(TABLES))
def test_radius_neighbors_do_not_depend_on_the_query_order(cloud, table):
    """``radius_neighbors`` on the queries reordered (cell order, a seeded
    random permutation), with ``exclude_self_index`` the permutation, equals
    ``chunked_radius_neighbors(..., exclude_self=True)`` on the original
    order bit for bit once un-permuted (the SOR's K = 60); so does the
    nearest-source search (K = 1) on queries that are not the points."""
    p, valid = CLOUDS[cloud]()
    n = len(p)
    t = TABLES[table] or 2 * n
    pts = _t(p)
    grid = tknn.build(pts, _t(valid), SOR_CELL, t, SOR_B)
    want = tknn.chunked_radius_neighbors(grid, pts, pts, SOR_CELL, SOR_K, chunk_size=4096,
                                         exclude_self=True)
    q1 = (pts[: n // 4] + 0.01).contiguous()
    want1 = tknn.chunked_radius_neighbors(grid, pts, q1, SOR_CELL, 1, chunk_size=4096)
    for name, perm in _permutations(p, t).items():
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(n)
        got = [torch.cat(parts) for parts in zip(*(
            tknn.radius_neighbors(grid, pts, pts[perm[s: s + 4096]], SOR_CELL, SOR_K,
                                  perm[s: s + 4096].to(torch.int32))
            for s in range(0, n, 4096)))]
        for w, g in zip(want, got):
            assert torch.equal(g[inv], w), name
        perm1 = perm[perm < n // 4]
        inv1 = torch.empty_like(perm1)
        inv1[perm1] = torch.arange(len(perm1))
        got1 = tknn.radius_neighbors(grid, pts, q1[perm1], SOR_CELL, 1)
        for w, g in zip(want1, got1):
            assert torch.equal(g[inv1], w), name
    assert int(want[2].sum()) > 0


def _fit_in_order(grid, q, radius, sqr_gauss, width, chunk=3000):
    """The moments fit of ``mls_pass_plain`` over the queries ``q`` taken in
    their given order, in chunks of ``chunk`` (not the pass's), the rows
    padded to ``width``: (positions, normals, surface fields, counts)."""
    parts = []
    for s in range(0, q.shape[0], chunk):
        qq = q[s: s + chunk]
        *packed, cnt = tmls._in_radius(qq, *tknn.candidate_points(grid, qq), radius)
        surf, cnt = tmls._fit_moments(qq, *(F.pad(x, (0, width - x.shape[1])) for x in packed),
                                      cnt, sqr_gauss, 2)
        parts.append((*tmls.project_onto(surf, qq), *surf, cnt))
    return [torch.cat(f) for f in zip(*parts)]


@pytest.mark.parametrize("cloud", list(CLOUDS))
def test_mls_pass_plain_does_not_depend_on_the_query_order(cloud):
    """M1's twin, ``mls_pass_plain`` (the default MLSConfig, n // 2 buckets,
    dedup on and off), equals the same fit taken over the queries in cell
    order and in a seeded random order, in other chunks, bit for bit once
    un-permuted: a point's fit depends on its candidates alone."""
    p, valid = CLOUDS[cloud]()
    n = len(p)
    r, sg, cap, t = 0.03, 0.0009, 32, max(n // 2, 1024)
    pts, v = _t(p), _t(valid)
    kw = dict(search_radius=r, sqr_gauss_param=sg, polynomial_order=2, bucket_capacity=cap,
              table_size=t, chunk_size=4096)
    want = tmls.mls_pass_plain(pts, v, **kw)
    want_nodedup = tmls.mls_pass_plain(pts, v, dedup_candidates=False, **kw)
    pos, nrm, surf, cnt = want
    fields = [pos, nrm, *surf, cnt]
    for a, b in zip(fields, [want_nodedup[0], want_nodedup[1], *want_nodedup[2],
                             want_nodedup[3]]):
        assert _bits_equal(a, b)
    grid = tknn.build(pts, v, r, t, cap, store_points=True)
    width = int(cnt.max())
    rs = np.random.default_rng(11)
    for name, perm in (("cell order", tknn.cell_order(pts, r, t).long()),
                       ("random", torch.from_numpy(rs.permutation(n)))):
        got = _fit_in_order(grid, pts[perm], r, sg, width)
        for f, g in zip(fields, got):
            out = torch.empty_like(g)
            out[perm] = g
            assert _bits_equal(out, f), name
    assert int(surf.ok.sum()) > 0


@pytest.mark.parametrize("cloud", list(CLOUDS))
@pytest.mark.parametrize("table", list(TABLES))
def test_twins_match_jax_op_by_op(cloud, table):
    """The twins against the JAX package run op by op (``jax.disable_jit``:
    its jitted search contracts d2 into FMAs and divides by the cell through
    the reciprocal, ROADMAP.md §3): ``chunked_radius_neighbors`` indices and
    flags bit-equal, distances within rtol 1e-6; the SOR inlier mask equal
    (none within 4 ulp of the threshold differ here)."""
    p, valid = CLOUDS[cloud]()
    n = len(p)
    t = TABLES[table] or 2 * n
    pts = _t(p)
    grid = tknn.build(pts, _t(valid), SOR_CELL, t, SOR_B)
    got = tknn.chunked_radius_neighbors(grid, pts, pts, SOR_CELL, SOR_K, chunk_size=4096,
                                        exclude_self=True)
    with jax.disable_jit():
        gj = jknn.build(jnp.asarray(p), jnp.asarray(valid), SOR_CELL, t, SOR_B)
        want = jknn.chunked_radius_neighbors(gj, jnp.asarray(p), jnp.asarray(p), SOR_CELL,
                                             SOR_K, chunk_size=4096, exclude_self=True)
        mask_j = np.asarray(jsor.sor_mask(jnp.asarray(p), jnp.asarray(valid), mean_k=SOR_K,
                                          std_mult=0.7, cell_size=SOR_CELL, table_size=t,
                                          bucket_capacity=SOR_B, chunk_size=4096))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)
    mean_d = tsor.sor_stats(pts, _t(valid), SOR_K, SOR_CELL, t, SOR_B, 4096)
    mask, thresh = tsor.sor_threshold(mean_d, _t(valid), 0.7)
    differ = mask.numpy() != mask_j
    ulp = float(np.spacing(np.float32(thresh)))
    near = np.abs(mean_d.numpy() - float(thresh)) <= 4 * ulp
    assert not (differ & ~near).any()
    assert int(differ.sum()) == 0
    np.testing.assert_array_equal(mask.numpy(), tsor.sor_mask(
        pts, _t(valid), SOR_K, 0.7, SOR_CELL, t, SOR_B, 4096).numpy())


WITNESS_CASES = {"lattice cloud": ("the lattice cloud", None),
                 "snapped cloud": ("the snapped cloud", None),
                 "5 buckets": ("the NaN / inf cloud", 5)}


@pytest.mark.parametrize("case", list(WITNESS_CASES))
def test_witness_flags_every_row_f32_cannot_hold(case, monkeypatch):
    """``chip_smoke._conditioning``, the f64 witness under which the smoke
    lets M1 leave its bounds on the snapped edge clouds: every row whose
    f32 twin lies outside those bounds from the twin's own fit run in f64
    on the same candidates (ok fits, normal not 0) is a row it flags as
    ill-conditioned; and each case has such rows."""
    import chip_smoke as cs
    from pointcloudprocessor_tpu_torch.utils import config as cfg_mod

    monkeypatch.setattr(cs, "EDGE_SIZES", ())
    label, table = WITNESS_CASES[case]
    p, v = cs._edge_clouds()[label]
    pts, valid = _t(p), _t(v)
    kw = cs._mls_kw(cfg_mod.MLSConfig(), len(p))
    if table:
        kw["table_size"] = table
    pos_w, nrm_w, _, cnt_w = tmls.mls_pass_plain(pts, valid, chunk_size=16384, **kw)
    rows = (valid & torch.isfinite(pts).all(1)).nonzero()[:, 0]
    r = kw["search_radius"]
    grid = tknn.build(pts, valid, r, kw["table_size"], kw["bucket_capacity"], store_points=True)
    q = pts[rows]
    dx, dy, dz, _, cnt = tmls._in_radius(q, *tknn.candidate_points(grid, q), r)
    d = [c.double() for c in (dx, dy, dz)]
    surf64, _ = tmls._fit_moments(q.double(), *d, d[0] ** 2 + d[1] ** 2 + d[2] ** 2, cnt,
                                  kw["sqr_gauss_param"], kw["polynomial_order"])
    pos64, nrm64 = tmls.project_onto(surf64, q.double())
    held = (cnt >= 3) & (nrm_w[rows] != 0).any(1)
    off = held & (((pos_w[rows].double() - pos64).abs().amax(1) > cs.MLS_POS_TOL)
                  | (1.0 - (nrm_w[rows].double() * nrm64).sum(1).abs() > cs.MLS_NRM_TOL))
    assert int(off.sum()) > 0
    ill, _, _ = cs._conditioning(pts, valid, kw, rows[off], cnt_w)
    assert bool(ill.all()), f"{int((~ill).sum())} of {int(off.sum())} rows not flagged"
