"""Grouped tap-row gathers: CUDA kernels K3/K4 and their plain torch twins.

Port of `pointcloudprocessor_tpu/ops/tap_gather.py`: an exact
``take(tap_rows, idx)`` for every ``ok`` row (rows with ``~ok`` hold
unspecified data, which the NID inlier gate zeroes downstream), for
raster-sorted indices that hit near-monotone table rows. Points form groups
of consecutive entries; each group reads from a small window of the
plane-concat slab table (``opt/nid.build_tap_slabs``: row j = [word0 of
pixels jS..jS+S-1 | word1 of the same pixels]). A point outside its
group's window (a sparse region) is repaired by a bounded per-row re-take
of the worst groups (``topk`` over per-group overflow flags), and when more
groups overflow than that budget (unsorted input, or a pose far from the
sort pose) the whole call falls back to the per-row lookup.

Two variants, each with its selection step as a kernel:

* :func:`grouped_take_slabbed` (group 16): each group's window is 2 slabs
  starting at its minimum row's slab. Selection = K3, :func:`select_slabbed`
  (the TPU's `_select_kernel` over XLA-taken windows, `tap_gather.py:95`).
* :func:`grouped_take_streamed` (group 32): 32 groups form a step sharing a
  2-mega-block window of 2 x 64 slabs; each group selects from a 4-slab
  sub-window at ``rel``. Selection = K4, :func:`select_streamed` (the TPU's
  `_streamed_kernel`, `tap_gather.py:343`).

The index arithmetic (group bases, windows, overflow flags, repair budgets)
is the JAX package's, in torch. ``lax.cond(n_ovf > f_rep, slow, fast)``
becomes a Python branch on ``int(n_ovf)``: one device sync per call.

Dispatch of the selections goes by device: CPU tensors take the plain twin
(:func:`select_slabbed_plain` / :func:`select_streamed_plain`), CUDA tensors
take the kernels in `csrc/tap_gather.cu` or raise. ``launch_counts`` counts
kernel launches; ``call_counts`` counts grouped takes, so on the card
``call_counts - launch_counts`` is the number of takes that fell back.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..kernels import build as kbuild

_GBLK = 16  # groups per grid step of the TPU's K3 (sets the index padding)
_SPG = 32  # groups per step of the streamed variant
_WBLK = 64  # slab rows per mega-block
_SUBROWS = 4  # slab rows per group sub-window
_BIG = 2**31 - 1

# Launches of each CUDA kernel, and grouped takes (any device), in this
# process (see reset_launch_counts).
launch_counts = {"tap_select": 0, "tap_streamed": 0}
call_counts = {"grouped_take_slabbed": 0, "grouped_take_streamed": 0}


def reset_launch_counts() -> None:
    for counts in (launch_counts, call_counts):
        for name in counts:
            counts[name] = 0


_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # slabs, slab_id, offs, out, n_slabs, slab, ng, group, stream
    "tap_select": ([_PTR] * 4 + [_I32] * 4 + [_PTR], _I32),
    # table, blk0, rel, offs, out, n_rows, slab, n_steps, spg, group, wblk, stream
    "tap_streamed": ([_PTR] * 5 + [_I32] * 6 + [_PTR], _I32),
}


def _lib() -> ctypes.CDLL:
    return kbuild.library("tap_gather", _SIGNATURES)


def _pow2ceil(x: int) -> int:
    return 1 << max(int(math.ceil(math.log2(max(x, 1)))), 0)


def default_slab(n_rows: int, n_idx: int, group: int) -> int:
    """Slab size from the mean table-rows-per-index density (`tap_gather.py:
    77-92`): ~2.7x the mean group span (pow2ceil of 2x), at least 512 and at
    most 65536 rows. Group spans are heavy-tailed, so a mean-sized slab
    would overflow ~6% of groups, past any repair budget."""
    density = max(n_rows // max(n_idx, 1), 1)
    return min(max(_pow2ceil(2 * group * density), 512), 1 << 16)


def _planes_lookup(slabs2: torch.Tensor, slab: int, idx: torch.Tensor) -> torch.Tensor:
    """Exact (M, 2) rows for flat indices, read from the plane-concat slab
    table (`tap_gather.py:188-196`)."""
    j = (idx // slab).long()
    m = (idx % slab).long()
    return torch.stack([slabs2[j, m], slabs2[j, m + slab]], dim=-1)


def _check_cuda(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name} must be on {device} (CUDA), got {t.device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 8:
        raise ValueError(f"{name} must be contiguous and 8-byte aligned")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# K3: the selection step of the slabbed gather
# ---------------------------------------------------------------------------


def select_slabbed_plain(slabs2, slab_id, offs, slab: int) -> torch.Tensor:
    """The twin of K3: (ng, G, 2) words ``slabs2[slab_id + (o >= slab)]
    [c*slab + o % slab]`` for o = offs[g, p] in [0, 2*slab), i.e. the
    output of `_local_select(take(slabs, slab_id), take(slabs, slab_id+1),
    offs)` (`tap_gather.py:157-185`) without materialising the windows."""
    row = (slab_id[:, None] + (offs >= slab).to(slab_id.dtype)).long()
    col = (offs % slab).long()
    return torch.stack([slabs2[row, col], slabs2[row, col + slab]], dim=-1)


def select_slabbed_cuda(slabs2, slab_id, offs, slab: int) -> torch.Tensor:
    """K3 on the card; same contract as :func:`select_slabbed_plain`."""
    n_slabs = slabs2.shape[0]
    ng, group = offs.shape
    dev = slabs2.device
    _check_cuda("slabs", slabs2, (n_slabs, 2 * slab), dev)
    _check_cuda("slab_id", slab_id, (ng,), dev)
    _check_cuda("offs", offs, (ng, group), dev)
    if n_slabs < 2 or ng * group >= 2**31:
        raise ValueError(f"K3: {n_slabs} slabs / {ng}x{group} points out of range")
    out = torch.empty((ng, group, 2), dtype=torch.int32, device=dev)
    err = _lib().tap_select(
        slabs2.data_ptr(), slab_id.data_ptr(), offs.data_ptr(), out.data_ptr(),
        n_slabs, slab, ng, group, _stream(slabs2),
    )
    if err != 0:
        raise RuntimeError(f"tap_select launch failed: CUDA error {err}")
    launch_counts["tap_select"] += 1
    return out


def select_slabbed(slabs2, slab_id, offs, slab: int) -> torch.Tensor:
    """(ng, G, 2) selected words: the twin on CPU tensors, K3 on CUDA ones."""
    dev = slabs2.device.type
    if dev == "cpu":
        return select_slabbed_plain(slabs2, slab_id, offs, slab)
    if dev == "cuda":
        return select_slabbed_cuda(slabs2, slab_id, offs, slab)
    raise NotImplementedError(f"select_slabbed: no kernel for device {slabs2.device}")


# ---------------------------------------------------------------------------
# K4: the selection step of the streamed gather
# ---------------------------------------------------------------------------


def select_streamed_plain(table, blk0, rel, offs, slab: int) -> torch.Tensor:
    """The twin of K4: out[i, g, c, p] = table[r][c*slab + o % slab] with
    r = blk0[i]*64 + rel[i*32 + g] + o // slab and o = offs[i, g, p] in
    [0, 4*slab), shape (n_steps, 32, 2, G).

    The TPU pads the table to whole mega-blocks; here r is clamped to the
    table's last row instead of copying the table. Only a row with ~ok or
    an overflowing group can reach past the end, and both are unspecified
    (the repair rewrites the latter)."""
    n_steps, spg, _ = offs.shape
    start = blk0[:, None].long() * _WBLK + rel.reshape(n_steps, spg).long()
    row = torch.clamp(start[:, :, None] + (offs // slab).long(), max=table.shape[0] - 1)
    col = (offs % slab).long()
    return torch.stack([table[row, col], table[row, col + slab]], dim=2)


def select_streamed_cuda(table, blk0, rel, offs, slab: int) -> torch.Tensor:
    """K4 on the card; same contract as :func:`select_streamed_plain`."""
    n_rows = table.shape[0]
    n_steps, spg, group = offs.shape
    dev = table.device
    _check_cuda("table", table, (n_rows, 2 * slab), dev)
    _check_cuda("blk0", blk0, (n_steps,), dev)
    _check_cuda("rel", rel, (n_steps * spg,), dev)
    _check_cuda("offs", offs, (n_steps, spg, group), dev)
    if n_steps * spg * group >= 2**31 or n_steps > 2**31 - 1:
        raise ValueError(f"K4: {n_steps}x{spg}x{group} points out of range")
    out = torch.empty((n_steps, spg, 2, group), dtype=torch.int32, device=dev)
    err = _lib().tap_streamed(
        table.data_ptr(), blk0.data_ptr(), rel.data_ptr(), offs.data_ptr(),
        out.data_ptr(), n_rows, slab, n_steps, spg, group, _WBLK, _stream(table),
    )
    if err != 0:
        raise RuntimeError(f"tap_streamed launch failed: CUDA error {err}")
    launch_counts["tap_streamed"] += 1
    return out


def select_streamed(table, blk0, rel, offs, slab: int) -> torch.Tensor:
    """(n_steps, 32, 2, G) selected words: the twin on CPU tensors, K4 on
    CUDA ones."""
    dev = table.device.type
    if dev == "cpu":
        return select_streamed_plain(table, blk0, rel, offs, slab)
    if dev == "cuda":
        return select_streamed_cuda(table, blk0, rel, offs, slab)
    raise NotImplementedError(f"select_streamed: no kernel for device {table.device}")


# ---------------------------------------------------------------------------
# The grouped takes
# ---------------------------------------------------------------------------


def _pad_points(idx, ok, block: int):
    n_pad = -idx.shape[0] % block
    if n_pad:
        idx = F.pad(idx, (0, n_pad))
        ok = F.pad(ok, (0, n_pad))
    return idx, ok


def _repair(taps, ovf_grp, idx_eff, f_rep: int, lookup):
    """Bounded repair (`tap_gather.py:305-311`): re-take the rows of the
    ``f_rep`` groups ranked first by overflow flag. Surplus slots rewrite
    healthy groups with their exact rows, which changes no ``ok`` row."""
    _, rep = torch.topk(ovf_grp.to(torch.int32), f_rep)
    group = taps.shape[1]
    taps[rep] = lookup(idx_eff[rep].reshape(-1)).reshape(f_rep, group, 2)
    return taps


class SlabbedPlan(NamedTuple):
    """Index arithmetic of :func:`grouped_take_slabbed` (`tap_gather.py:
    267-296`), for ``ng`` groups of ``group`` points."""

    slabs2: torch.Tensor  # (n_slabs, 2*slab) int32
    idx: torch.Tensor  # (npad,) clamped, padded flat indices
    idx_eff: torch.Tensor  # (ng, G): ~ok points moved to their group's base
    slab_id: torch.Tensor  # (ng,) window start slab
    offs: torch.Tensor  # (ng, G) offsets in the window, clamped to [0, 2*slab)
    ovf_grp: torch.Tensor  # (ng,) bool: an ok point lies past the window
    f_rep: int  # repair budget (groups)


def plan_slabbed(table_slabs, idx, ok, *, slab: int, group: int = 16,
                 repair_groups: int | None = None) -> SlabbedPlan:
    slabs2 = table_slabs.reshape(-1, 2 * slab)
    n_slabs = slabs2.shape[0]
    idx = torch.clamp(idx, max=n_slabs * slab - 1)
    idx, ok = _pad_points(idx, ok, group * _GBLK)
    ng = idx.shape[0] // group
    idx2 = idx.reshape(ng, group)
    ok2 = ok.reshape(ng, group)
    base = torch.amin(torch.where(ok2, idx2, _BIG), dim=1)
    base = torch.where(torch.any(ok2, dim=1), base, 0)
    slab_id = torch.clamp(base // slab, 0, n_slabs - 2)  # window = [id, id+2)*slab
    idx_eff = torch.where(ok2, idx2, base[:, None])
    offs = idx_eff - slab_id[:, None] * slab
    ovf_grp = torch.any(ok2 & (offs >= 2 * slab), dim=1)
    if repair_groups is None:
        # ~1.5% of groups: above the ~1% overflow measured at the default slab.
        repair_groups = max(256, ng // 64)
    return SlabbedPlan(
        slabs2, idx, idx_eff, slab_id.to(torch.int32).contiguous(),
        torch.clamp(offs, 0, 2 * slab - 1).to(torch.int32).contiguous(),
        ovf_grp, min(repair_groups, ng),
    )


def grouped_take_slabbed(table_slabs, idx, ok, *, slab: int, group: int = 16,
                         repair_groups: int | None = None, lookup_rows=None) -> torch.Tensor:
    """Exact (N, 2) ``take`` of every ``ok`` row over the plane-concat slab
    table (`tap_gather.py:246-319`), the K keyframes' tables stacked on a
    leading axis (flat index = kf * R + anchor). ``lookup_rows`` (flat idx
    -> rows) serves the repair and the fallback; the default reads the slab
    planes."""
    call_counts["grouped_take_slabbed"] += 1
    n = idx.shape[0]
    p = plan_slabbed(table_slabs, idx, ok, slab=slab, group=group, repair_groups=repair_groups)
    lookup = lookup_rows or (lambda i: _planes_lookup(p.slabs2, slab, i))
    # The overflow count decides the branch: one device sync.
    if int(torch.sum(p.ovf_grp)) > p.f_rep:
        return lookup(p.idx)[:n]
    taps = select_slabbed(p.slabs2, p.slab_id, p.offs, slab)  # (ng, G, 2)
    taps = _repair(taps, p.ovf_grp, p.idx_eff, p.f_rep, lookup)
    return taps.reshape(-1, 2)[:n]


def grouped_take(table, idx, ok, *, group: int = 16, slab: int | None = None,
                 repair_groups: int | None = None) -> torch.Tensor:
    """:func:`grouped_take_slabbed` over an (R, 2) row table, building the
    slab layout per call (`tap_gather.py:199-243`; tests and small tables)."""
    r, c = table.shape
    if c != 2:
        raise ValueError(f"nibble-packed tap rows are (R, 2) int32, got {tuple(table.shape)}")
    if slab is None:
        slab = default_slab(r, idx.shape[0], group)
    pad = -r % slab
    n_slabs = (r + pad) // slab
    if n_slabs < 2:
        pad += slab * (2 - n_slabs)
        n_slabs = 2
    w0 = F.pad(table[:, 0], (0, pad))
    w1 = F.pad(table[:, 1], (0, pad))
    slabs = torch.cat([w0.reshape(n_slabs, slab), w1.reshape(n_slabs, slab)], dim=1)
    return grouped_take_slabbed(
        slabs, torch.clamp(idx, max=r - 1), ok, slab=slab, group=group,
        repair_groups=repair_groups,
    )


class StreamedPlan(NamedTuple):
    """Index arithmetic of :func:`grouped_take_streamed` (`tap_gather.py:
    427-491`), for ``n_steps`` steps of 32 groups of ``group`` points."""

    slabs2: torch.Tensor  # (n_slabs, 2*slab) int32, not padded
    idx: torch.Tensor  # (npad,)
    idx_eff: torch.Tensor  # (ng, G)
    blk0: torch.Tensor  # (n_steps,) first mega-block of each step's window
    rel: torch.Tensor  # (n_steps*32,) sub-window start, in slab rows past blk0*64
    offs: torch.Tensor  # (n_steps, 32, G) clamped to [0, 4*slab)
    ovf_grp: torch.Tensor  # (ng,) bool
    f_rep: int


def plan_streamed(table_slabs, idx, ok, *, slab: int, group: int = 32,
                  repair_groups: int | None = None) -> StreamedPlan:
    slabs2 = table_slabs.reshape(-1, 2 * slab)
    n_slabs0 = slabs2.shape[0]
    idx = torch.clamp(idx, max=n_slabs0 * slab - 1)
    # Whole mega-blocks, at least 2 (the TPU pads the table to this).
    pad_rows = (-n_slabs0) % _WBLK
    if (n_slabs0 + pad_rows) // _WBLK < 2:
        pad_rows += _WBLK * (2 - (n_slabs0 + pad_rows) // _WBLK)
    n_blocks = (n_slabs0 + pad_rows) // _WBLK

    idx, ok = _pad_points(idx, ok, group * _SPG)
    ng = idx.shape[0] // group
    n_steps = ng // _SPG
    idx2 = idx.reshape(ng, group)
    ok2 = ok.reshape(ng, group)
    any_ok = torch.any(ok2, dim=1)
    base = torch.amin(torch.where(ok2, idx2, _BIG), dim=1)
    # An all-masked group must not drag its step's window to block 0: it is
    # left out of the step minimum and adopts the step's base instead
    # (`tap_gather.py:457-471`).
    slab_id_real = torch.where(any_ok, base // slab, _BIG)
    step_slab0 = torch.amin(slab_id_real.reshape(n_steps, _SPG), dim=1)
    step_slab0 = torch.where(step_slab0 == _BIG, 0, step_slab0)  # all-empty step
    slab_id = torch.where(
        any_ok, base // slab, step_slab0[:, None].expand(n_steps, _SPG).reshape(ng)
    )
    base = torch.where(any_ok, base, slab_id * slab)
    blk0 = torch.clamp(step_slab0 // _WBLK, 0, n_blocks - 2)
    rel = torch.clamp(
        slab_id.reshape(n_steps, _SPG) - blk0[:, None] * _WBLK, 0, 2 * _WBLK - _SUBROWS
    )
    win_start = (blk0[:, None] * _WBLK + rel) * slab  # (n_steps, SPG) rows
    idx_eff = torch.where(ok2, idx2, base[:, None])
    offs = idx_eff.reshape(n_steps, _SPG, group) - win_start[:, :, None]
    ovf_pt = ok2.reshape(n_steps, _SPG, group) & ((offs < 0) | (offs >= _SUBROWS * slab))
    ovf_grp = torch.any(ovf_pt, dim=2).reshape(ng)
    if repair_groups is None:
        repair_groups = max(256, ng // 32)
    return StreamedPlan(
        slabs2, idx, idx_eff, blk0.to(torch.int32).contiguous(),
        rel.to(torch.int32).reshape(-1).contiguous(),
        torch.clamp(offs, 0, _SUBROWS * slab - 1).to(torch.int32).contiguous(),
        ovf_grp, min(repair_groups, ng),
    )


def grouped_take_streamed(table_slabs, idx, ok, *, slab: int, group: int = 32,
                          repair_groups: int | None = None, lookup_rows=None) -> torch.Tensor:
    """Streamed grouped take (`tap_gather.py:414-541`): the same contract as
    :func:`grouped_take_slabbed`, with step-shared mega-block windows."""
    call_counts["grouped_take_streamed"] += 1
    n = idx.shape[0]
    p = plan_streamed(table_slabs, idx, ok, slab=slab, group=group, repair_groups=repair_groups)
    lookup = lookup_rows or (lambda i: _planes_lookup(p.slabs2, slab, i))
    # The overflow count decides the branch: one device sync.
    if int(torch.sum(p.ovf_grp)) > p.f_rep:
        return lookup(p.idx)[:n]
    out = select_streamed(p.slabs2, p.blk0, p.rel, p.offs, slab)  # (n_steps, 32, 2, G)
    taps = out.reshape(-1, 2, group).transpose(1, 2).contiguous()  # (ng, G, 2)
    taps = _repair(taps, p.ovf_grp, p.idx_eff, p.f_rep, lookup)
    return taps.reshape(-1, 2)[:n]
