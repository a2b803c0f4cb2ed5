"""PyTorch port vs the JAX package: the slab table, the raster sort and the
grouped tap gathers (ops/tap_gather: the twins of kernels K3/K4, which plan
and select over the interleaved row table, and the control flow around
them).

Tolerance class: bit-exact throughout (integer data movement and integer
index arithmetic). The grouped takes specify only their ``ok`` rows, so
those are compared (as tests/test_tap_gather.py does); the JAX package's
Pallas kernels run in interpret mode."""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pointcloudprocessor_tpu.core import se3 as jse3
from pointcloudprocessor_tpu.ops import tap_gather as jtg
from pointcloudprocessor_tpu.opt import nid as jnid
from pointcloudprocessor_tpu_torch.core import se3 as tse3
from pointcloudprocessor_tpu_torch.kernels import build as kbuild
from pointcloudprocessor_tpu_torch.ops import tap_gather as ttg
from pointcloudprocessor_tpu_torch.opt import nid as tnid
from pointcloudprocessor_tpu_torch.utils import interop

from test_torch_nid import _cameras, _keyframes

CPU = "cpu"


def _table(r, seed):
    # Full 32-bit patterns: nibble-packed words use every bit, the sign too.
    rng = np.random.default_rng(seed)
    return rng.integers(-(2**31), 2**31, size=(r, 2), dtype=np.int64).astype(np.int32)


def _padded_rows(table, slab):
    """The row table padded with zero rows to a whole number (>= 2) of slabs."""
    r = table.shape[0]
    n = max(-(-r // slab), 2)
    return np.pad(table, ((0, n * slab - r), (0, 0)))


def _plane_slabs(table, slab):
    rows = _padded_rows(table, slab)
    n = rows.shape[0] // slab
    return np.concatenate([rows[:, 0].reshape(n, slab), rows[:, 1].reshape(n, slab)], axis=1)


def _case(name):
    """(R, idx, ok) of each regime of tests/test_tap_gather.py."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "dense":
        r, n = 65536, 4096
        idx = np.sort(rng.integers(0, r // 8, n))
        ok = np.ones(n, bool)
    elif name == "sparse_tail":  # a few groups span huge gaps: the repair
        r, n = 1 << 19, 4096
        idx = np.sort(rng.integers(0, 4096, n))
        idx[1024:1088] = np.sort(rng.integers(0, r, 64))
        idx = np.sort(idx)
        ok = np.ones(n, bool)
    elif name == "unsorted":  # nearly every group overflows: the fallback
        r, n = 65536, 16384
        idx = rng.integers(0, r, n)
        ok = np.ones(n, bool)
    elif name == "masked":  # ~ok rows carry arbitrary indices
        r, n = 32768, 1024
        idx = np.sort(rng.integers(0, r, n))
        ok = rng.random(n) > 0.3
        idx[~ok] = rng.integers(0, r, (~ok).sum())
    elif name == "all_masked_group":  # whole groups masked, far from row 0
        r, n = 1 << 19, 4096
        idx = np.sort(rng.integers(r - 8192, r, n))
        ok = np.ones(n, bool)
        ok[:64] = False
        ok[512:640] = False
        ok[2048:2080] = False
    elif name == "all_masked_step":  # a whole streamed step and a whole K3 grid step masked
        r, n = 1 << 19, 5000
        idx = np.sort(rng.integers(200_000, 300_000, n))
        ok = rng.random(n) > 0.05
        ok[1024:2048] = False
        ok[3072:3328] = False
        idx[~ok] = rng.integers(0, r, (~ok).sum())
    elif name == "boundaries":  # duplicates, slab edges, the last row
        r = 16384
        idx = np.sort(np.asarray(
            [0, 0, 0, 1, 1, 2, 1023, 1024, 1025, 2047, 2048, 4095] + [r - 1] * 4
            + list(range(8000, 8016)), np.int64))
        ok = np.ones(len(idx), bool)
    elif name == "tiny_table":  # fewer rows than two slabs, size not a multiple
        r, n = 1000, 777
        idx = np.sort(rng.integers(0, r, n))
        ok = np.ones(n, bool)
    elif name.startswith("k_flattened"):  # K tables flattened, kf*R + anchor
        stride = int(name[-1])
        k, rk, n = 3, 50_000, 4096 // stride
        r = k * rk
        idx = np.concatenate([np.sort(rng.integers(0, rk, n)) + kf * rk for kf in range(k)])
        ok = rng.random(k * n) > 0.1
    else:
        raise ValueError(name)
    return r, idx.astype(np.int32), ok


CASES = ["dense", "sparse_tail", "unsorted", "masked", "all_masked_group", "all_masked_step",
         "boundaries", "tiny_table", "k_flattened_1", "k_flattened_4"]
VARIANTS = {
    "slabbed": (ttg.plan_slabbed, ttg.select_slabbed_plain, ttg.grouped_select_slabbed,
                ttg.grouped_take_slabbed, lambda p: (p.slab_id, p.offs)),
    "streamed": (ttg.plan_streamed, ttg.select_streamed_plain, ttg.grouped_select_streamed,
                 ttg.grouped_take_streamed, lambda p: (p.blk0, p.rel, p.offs)),
}


def _jax_take(variant, table, idx, ok, slab):
    """The JAX package's grouped take over the plane-concat slab table, in
    interpret mode."""
    slabs = jnp.asarray(_plane_slabs(table, slab))
    fn = jtg.grouped_take_streamed if variant == "streamed" else jtg.grouped_take_slabbed
    return np.asarray(fn(slabs, jnp.asarray(idx), jnp.asarray(ok), slab=slab, interpret=True))


@pytest.mark.parametrize("variant", ["slabbed", "streamed"])
@pytest.mark.parametrize("case", CASES)
def test_grouped_takes_match_jax_on_ok_rows(case, variant):
    """The port's grouped takes (plan, twin selection, repair, fallback)
    against the JAX package's and against the plain take, on ok rows."""
    r, idx, ok = _case(case)
    table = _table(r, seed=len(case))
    want = table[np.minimum(idx, r - 1)]
    if variant == "slabbed":
        jgot = np.asarray(jtg.grouped_take(
            jnp.asarray(table), jnp.asarray(idx), jnp.asarray(ok), interpret=True))
        tgot = ttg.grouped_take(torch.from_numpy(table), torch.from_numpy(idx),
                                torch.from_numpy(ok)).numpy()
    else:
        slab = 512
        jgot = _jax_take("streamed", table, idx, ok, slab)
        tgot = ttg.grouped_take_streamed(
            torch.from_numpy(_padded_rows(table, slab)), torch.from_numpy(idx),
            torch.from_numpy(ok), slab=slab).numpy()
    assert tgot.dtype == np.int32 and tgot.shape == (len(idx), 2)
    np.testing.assert_array_equal(tgot[ok], want[ok])
    np.testing.assert_array_equal(tgot[ok], jgot[ok])


@pytest.mark.parametrize("case", ["dense", "unsorted"])
def test_plans_branch_as_jax_does(case):
    """The overflow flags, windows and repair budgets the branch is decided
    on equal the JAX package's arithmetic, recomputed here in numpy."""
    r, idx, ok = _case(case)
    slab, group = 512, 16
    rows = torch.from_numpy(_padded_rows(_table(r, 0), slab))
    p = ttg.plan_slabbed(rows, torch.from_numpy(idx), torch.from_numpy(ok),
                         slab=slab, group=group)
    n_slabs = rows.shape[0] // slab
    pad = -len(idx) % (group * 16)
    i2 = np.pad(np.minimum(idx, n_slabs * slab - 1), (0, pad)).reshape(-1, group)
    o2 = np.pad(ok, (0, pad)).reshape(-1, group)
    base = np.where(o2.any(1), np.where(o2, i2, 2**31 - 1).min(1), 0)
    sid = np.clip(base // slab, 0, n_slabs - 2)
    offs = np.where(o2, i2, base[:, None]) - sid[:, None] * slab
    np.testing.assert_array_equal(p.slab_id.numpy(), sid)
    np.testing.assert_array_equal(p.offs.numpy(), np.clip(offs, 0, 2 * slab - 1))
    np.testing.assert_array_equal(p.ovf_grp.numpy(), (o2 & (offs >= 2 * slab)).any(1))
    f_rep = ttg._budget(len(base), None, 64)
    assert f_rep == min(max(256, len(base) // 64), len(base))
    expect_fallback = case == "unsorted"
    assert (int(p.ovf_grp.sum()) > f_rep) == expect_fallback


def test_select_slabbed_twin_matches_jax_local_select():
    """K3's twin selection from the row table against the JAX package's
    `_local_select` over windows taken from the slab table (interpret
    mode), every row: offsets cover both slabs."""
    rng = np.random.default_rng(3)
    slab, group, ng, n_slabs = 512, 16, 64, 9
    table = _table(n_slabs * slab, 4)
    slabs = _plane_slabs(table, slab)
    sid = rng.integers(0, n_slabs - 1, ng).astype(np.int32)
    offs = rng.integers(0, 2 * slab, (ng, group)).astype(np.int32)
    offs[0, :4] = [0, slab - 1, slab, 2 * slab - 1]
    s = jnp.asarray(slabs)
    want = np.asarray(jtg._local_select(
        jnp.take(s, jnp.asarray(sid), axis=0), jnp.take(s, jnp.asarray(sid) + 1, axis=0),
        jnp.asarray(offs), slab=slab, group=group, interpret=True))
    got = ttg.select_slabbed_plain(torch.from_numpy(table), torch.from_numpy(sid),
                                   torch.from_numpy(offs), slab)
    np.testing.assert_array_equal(got.numpy(), want)


def test_select_streamed_twin_formula():
    """K4's twin selection from the row table: out[i*32 + g, p, c] =
    slabs[blk0[i]*64 + rel[i*32+g] + o//S][c*S + o%S] of the slab table,
    slab rows past the table's end clamped to its last."""
    rng = np.random.default_rng(5)
    slab, group, n_steps, n_rows = 128, 32, 3, 150
    table = _table(n_rows * slab, 6)
    slabs = _plane_slabs(table, slab)
    blk0 = rng.integers(0, 2, n_steps).astype(np.int32)
    rel = rng.integers(0, 2 * 64 - 4 + 1, n_steps * 32).astype(np.int32)
    offs = rng.integers(0, 4 * slab, (n_steps, 32, group)).astype(np.int32)
    got = ttg.select_streamed_plain(
        *(torch.from_numpy(a) for a in (table, blk0, rel, offs)), slab).numpy()
    assert got.shape == (n_steps * 32, group, 2)
    for i in range(n_steps):
        for g in range(32):
            row = np.minimum(blk0[i] * 64 + rel[i * 32 + g] + offs[i, g] // slab, n_rows - 1)
            for c in range(2):
                np.testing.assert_array_equal(got[i * 32 + g, :, c],
                                              slabs[row, c * slab + offs[i, g] % slab])


def test_counts_and_device_dispatch():
    """CPU tensors take the twins: grouped takes count as calls, never as
    kernel launches, and a sorted input does not fall back. The kernel
    wrappers refuse CPU tensors."""
    ttg.reset_launch_counts()
    r, idx, ok = _case("dense")
    rows = torch.from_numpy(_padded_rows(_table(r, 1), 512))
    args = (rows, torch.from_numpy(idx), torch.from_numpy(ok))
    ttg.grouped_take_slabbed(*args, slab=512)
    ttg.grouped_take_streamed(*args, slab=512)
    assert ttg.call_counts == {"grouped_take_slabbed": 1, "grouped_take_streamed": 1}
    assert ttg.launch_counts == dict.fromkeys(
        ("tap_take", "bin_pack", "tap_select", "tap_streamed", "tap_take_blocks", "wide_take",
         "wide_take_blocks", "wide_select"), 0)
    assert ttg.fallback_counts == {"grouped_take_slabbed": 0, "grouped_take_streamed": 0}
    with pytest.raises(ValueError, match="CUDA"):
        ttg.grouped_select_slabbed_cuda(*args, slab=512)
    with pytest.raises(ValueError, match="CUDA"):
        ttg.grouped_select_streamed_cuda(*args, slab=512)
    with pytest.raises(ValueError, match="whole number"):
        ttg.grouped_select_slabbed(rows[:-1], *args[1:], slab=512)


def test_tap_gather_build_without_nvcc_raises(monkeypatch, tmp_path):
    """The K3/K4 library build raises without nvcc; nothing falls back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(kbuild, "BUILD_DIR", str(tmp_path / "_build"))
    real_isfile = kbuild.os.path.isfile
    monkeypatch.setattr(kbuild.os.path, "isfile",
                        lambda p: False if p.endswith("nvcc") else real_isfile(p))
    with pytest.raises(RuntimeError, match="nvcc"):
        kbuild._compile("tap_gather")


@pytest.mark.parametrize("n_rows, n_idx", [(12_288_000, 262_144), (76_800, 3600), (1000, 777),
                                           (1 << 19, 4096), (50, 10**6)])
def test_default_slab_matches_jax(n_rows, n_idx):
    for group in (16, 32):
        assert ttg.default_slab(n_rows, n_idx, group) == jtg.default_slab(n_rows, n_idx, group)


def test_build_tap_slabs_bit_exact():
    b = np.random.default_rng(7).integers(0, 16, (48, 64)).astype(np.int32)
    for slab in (512, 1024):
        want = np.asarray(jnid.build_tap_slabs(jnp.asarray(b), slab))
        got = tnid.build_tap_slabs(torch.from_numpy(b), slab).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_prepare_keyframes_slabs_and_warning():
    """Slabs are built only when asked, bit-exact with the JAX package's;
    a table that is no multiple of the slab warns instead."""
    cj, _ = _cameras()
    pts, inten, valid, bins = _keyframes(cj)
    kt = tnid.prepare_keyframes(interop.nid_keyframes(pts, inten, valid, bins, CPU))
    assert kt.tap_slabs is None and kt.slab_width == 512
    kt = tnid.prepare_keyframes(kt, build_slabs=True)
    kj = jnid.prepare_keyframes(
        jnid.NIDKeyframe(jnp.asarray(pts), jnp.asarray(inten), jnp.asarray(valid),
                         jnp.asarray(bins)), build_slabs=True)
    np.testing.assert_array_equal(kt.tap_slabs.numpy(), np.asarray(kj.tap_slabs))
    np.testing.assert_array_equal(kt.tap_rows.numpy(), np.asarray(kj.tap_rows))
    odd = interop.nid_keyframes(pts, inten, valid, bins[:, :95, :127], CPU)
    with pytest.warns(UserWarning, match="cannot build tap slabs"):
        assert tnid.prepare_keyframes(odd, build_slabs=True).tap_slabs is None
    with pytest.warns(UserWarning, match="cannot build tap slabs"):
        assert tnid.prepare_keyframes(odd, grouped=True).slab_width is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tnid.prepare_keyframes(odd).slab_width is None  # not asked: no warning


@pytest.mark.parametrize("xi", [(0.0,) * 6, (0.05, -0.03, 0.02, 0.01, -0.01, 0.02)])
def test_sort_by_raster_permutation_bit_exact(xi):
    """The stable sort on the int32 raster key reproduces lax.sort's
    permutation, ties (shared anchors, the 2^31-1 of out-of-view and
    padded points) included."""
    cj, ct = _cameras()
    pts, inten, valid, bins = _keyframes(cj)
    # Duplicate points share anchors: ties inside the in-view prefix too.
    pts[:, 100:200] = pts[:, 0:100]
    xi = np.asarray(xi, np.float32)
    Tj = jse3.exp(jnp.asarray(xi))
    kj = jnid.sort_by_raster(cj, Tj, jnid.NIDKeyframe(
        jnp.asarray(pts), jnp.asarray(inten), jnp.asarray(valid), jnp.asarray(bins)))
    kt = tnid.sort_by_raster(
        ct, interop.pose(np.asarray(Tj.q), np.asarray(Tj.t), CPU),
        interop.nid_keyframes(pts, inten, valid, bins, CPU))
    np.testing.assert_array_equal(kt.points.numpy(), np.asarray(kj.points))
    np.testing.assert_array_equal(kt.intensity.numpy(), np.asarray(kj.intensity))
    np.testing.assert_array_equal(kt.valid.numpy(), np.asarray(kj.valid))


@pytest.mark.parametrize("use_grouped", [True, "streamed"])
def test_nid_gather_grouped_equals_direct(use_grouped):
    """_gather_taps over K flattened keyframes: the grouped paths return
    the direct take's rows for every inlier, at the sort pose and after a
    pose step (fallback or repair)."""
    cj, ct = _cameras()
    pts, inten, valid, bins = _keyframes(cj)
    kt = tnid.prepare_keyframes(interop.nid_keyframes(pts, inten, valid, bins, CPU),
                                build_slabs=True)
    kt = tnid.sort_by_raster(ct, tse3.identity(CPU), kt)
    for xi in ((0.0,) * 6, (0.04, -0.02, 0.0, 0.01, 0.0, 0.01)):
        _, knot, inl = tnid._project_all(ct, tse3.exp(torch.tensor(xi)), kt)
        direct = tnid._gather_taps(ct, kt, knot, inl, use_grouped=False)
        grouped = tnid._gather_taps(ct, kt, knot, inl, use_grouped=use_grouped)
        np.testing.assert_array_equal(grouped[inl].numpy(), direct[inl].numpy())


def test_slab_table_is_the_row_table_relaid():
    """The addressing the kernels rest on: slabs[j, c*S + m] == rows[j*S + m, c]
    on the tables that build_tap_slabs and build_tap_table make (both
    packages' slab tables)."""
    b = np.random.default_rng(8).integers(0, 16, (48, 64)).astype(np.int32)
    rows = tnid.build_tap_table(torch.from_numpy(b)).numpy()
    for slab in (512, 1024):
        n = rows.shape[0] // slab
        for slabs in (tnid.build_tap_slabs(torch.from_numpy(b), slab).numpy(),
                      np.asarray(jnid.build_tap_slabs(jnp.asarray(b), slab))):
            relaid = slabs.reshape(n, 2, slab).transpose(0, 2, 1).reshape(-1, 2)
            np.testing.assert_array_equal(relaid, rows)


@pytest.mark.parametrize("variant", ["slabbed", "streamed"])
@pytest.mark.parametrize("case", CASES)
def test_fused_twin_matches_plan_select_and_jax(case, variant):
    """What K3 / K4 return (the fused twin): taps, flags and count equal the
    plan and the selection run apart, the count is the flags' sum, and on
    the ok rows of clean groups the taps equal the direct take and the JAX
    package's grouped take (interpret mode)."""
    plan, select, fused, _, sel_args = VARIANTS[variant]
    r, idx, ok = _case(case)
    slab = 512
    table = _table(r, seed=len(case))
    rows = torch.from_numpy(_padded_rows(table, slab))
    args = (rows, torch.from_numpy(idx), torch.from_numpy(ok))
    got = fused(*args, slab=slab)
    p = plan(*args, slab=slab)
    np.testing.assert_array_equal(got.taps.numpy(), select(rows, *sel_args(p), slab).numpy())
    np.testing.assert_array_equal(got.ovf_grp.numpy(), p.ovf_grp.numpy())
    assert got.n_ovf.dtype == torch.int32 and got.n_ovf.shape == ()
    assert int(got.n_ovf) == int(p.ovf_grp.sum())
    ng, group, _ = got.taps.shape
    assert ng == p.ovf_grp.shape[0] and ng * group >= len(idx)
    clean = ok & ~np.repeat(got.ovf_grp.numpy(), group)[: len(idx)]
    flat = got.taps.numpy().reshape(-1, 2)[: len(idx)]
    np.testing.assert_array_equal(flat[clean], table[np.minimum(idx, r - 1)][clean])
    np.testing.assert_array_equal(flat[clean], _jax_take(variant, table, idx, ok, slab)[clean])


@pytest.mark.parametrize("use_grouped, take", [(True, "grouped_take_slabbed"),
                                               ("streamed", "grouped_take_streamed")])
def test_gather_taps_grouped_on_slab_width_alone(use_grouped, take):
    """Keyframes that carry only the slab width (no slab table) take the
    grouped path, and it equals the direct take on every inlier."""
    cj, ct = _cameras()
    pts, inten, valid, bins = _keyframes(cj)
    kt = tnid.prepare_keyframes(interop.nid_keyframes(pts, inten, valid, bins, CPU),
                                grouped=True)
    assert kt.tap_slabs is None and kt.slab_width is not None
    kt = tnid.sort_by_raster(ct, tse3.identity(CPU), kt)
    _, knot, inl = tnid._project_all(ct, tse3.identity(CPU), kt)
    ttg.reset_launch_counts()
    grouped = tnid._gather_taps(ct, kt, knot, inl, use_grouped=use_grouped)
    assert ttg.call_counts[take] == 1 and sum(ttg.call_counts.values()) == 1
    direct = tnid._gather_taps(ct, kt, knot, inl, use_grouped=False)
    np.testing.assert_array_equal(grouped[inl].numpy(), direct[inl].numpy())


@pytest.mark.parametrize("variant", ["slabbed", "streamed"])
def test_fallback_counts(variant):
    """An unsorted input overflows past the repair budget: the take falls
    back to the per-row lookup, counts one fallback, and stays exact."""
    take = VARIANTS[variant][3]
    r, idx, ok = _case("unsorted")
    table = _table(r, 2)
    ttg.reset_launch_counts()
    got = take(torch.from_numpy(_padded_rows(table, 512)), torch.from_numpy(idx),
               torch.from_numpy(ok), slab=512)
    name = f"grouped_take_{variant}"
    assert ttg.fallback_counts[name] == ttg.call_counts[name] == 1
    assert sum(ttg.fallback_counts.values()) == 1
    np.testing.assert_array_equal(got.numpy(), table[idx])
