"""Tap-row gathers: CUDA kernels G1 (the direct take) and K3/K4 (the grouped
takes) with their plain torch twins.

:func:`direct_take` is the main path's gather (`opt/nid._gather_taps`, the
JAX package's `nid.py:490-516`): each (u, v) knot clipped into the image,
the nibble-packed row of its 4x4 window. It reads no tap table: its source
is each keyframe's bin image packed at 4 bits a pixel in 8x8-pixel tiles of
32 bytes, one every 5 pixels each way, so that every 4x4 window lies in one
tile (:func:`pack_bins`, kernel ``bin_pack``; 15.7 MB a 4096x3000 keyframe
against the table's 98 MB), and it assembles the row from the window's 16
nibbles. On CUDA tensors it is one launch of G1 ``tap_take``;
its twin :func:`direct_take_plain` is the same arithmetic in torch ops,
equal to ``build_tap_table(bins)[anchor]`` bit for bit.

The frozen-tap cache (`opt/nid.multi_nid_loss_cached`) adds four kernels
over the same tiles, none of which the JAX package writes in Pallas: G2
``wide_take`` (:func:`wide_take`, JAX's take from its wide table,
`nid.py:630-638`), each point's (4+2m)^2 window at margin m as (K, 4+2m, N)
planes; W1 ``wide_select`` (:func:`wide_select`, `nid.py:641-667`), the
4x4 sub-window at each point's drift and its effective knot; and the block
forms of G1 and G2 (:func:`tap_take_blocks`, :func:`wide_take_blocks`,
`nid.py:566-613, 670-696`), which re-take the points of a list of 128-point
blocks in place. Each is one launch, with a plain twin.

Port of `pointcloudprocessor_tpu/ops/tap_gather.py`: an exact
``take(rows, idx)`` for every ``ok`` row (rows with ``~ok`` hold
unspecified data, which the NID inlier gate zeroes downstream), for
raster-sorted indices that hit near-monotone table rows. The source is the
interleaved (n_rows, 2) row table: the K keyframes' (H*W, 2) tap tables
stacked, flat index kf*H*W + anchor, n_rows a multiple of the slab width S.
Points form groups of consecutive entries, and each group reads a window of
slab rows. The JAX package reads its windows from the plane-concat slab
table (``opt/nid.build_tap_slabs``: row j = [word0 of pixels jS..jS+S-1 |
word1 of the same pixels]); word c of slab row j, column m is word c of row
j*S + m here, so the same window is a row range of the row table and no
second table is built. A point outside its group's window (a sparse
region) is repaired by a per-row re-take of the overflowing groups, and
when more groups overflow than the repair budget (unsorted input, or a pose
far from the sort pose) the whole call falls back to the per-row lookup.

Two variants, each one CUDA kernel that plans the windows and selects:

* :func:`grouped_take_slabbed` (group 16): each group's window is 2 slabs
  from its minimum row's slab. Kernel K3 ``tap_select`` (the TPU's
  `_select_kernel`, `tap_gather.py:95`, and the plan around it).
* :func:`grouped_take_streamed` (group 32): 32 groups form a step sharing a
  2-mega-block window of 2 x 64 slabs; each group selects from a 4-slab
  sub-window at ``rel``. Kernel K4 ``tap_streamed`` (the TPU's
  `_streamed_kernel`, `tap_gather.py:343`, and its plan).

Each kernel returns what :func:`grouped_select_slabbed` /
:func:`grouped_select_streamed` return: the (ng, G, 2) taps, the per-group
overflow flags and their count, on the device. The grouped take reads the
count (``lax.cond(n_ovf > f_rep, slow, fast)`` becomes a Python branch on
that one int32: one device sync) and repairs or falls back in torch.

Dispatch goes by device: CPU tensors take the plain twin
(:func:`grouped_select_slabbed_plain` / :func:`grouped_select_streamed_plain`:
the JAX package's index arithmetic in :func:`plan_slabbed` /
:func:`plan_streamed`, then :func:`select_slabbed_plain` /
:func:`select_streamed_plain`), CUDA tensors take the kernels in
`csrc/tap_gather.cu` or raise. ``launch_counts`` counts kernel launches
(``kernels.build.launch_shapes`` G1's by points a keyframe),
``call_counts`` grouped takes (any device) and ``fallback_counts`` the
takes that fell back to the per-row lookup; on the card every grouped take
launches its kernel once, fallbacks included.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..kernels import build as kbuild
from ..utils.numeric import bits_to_int32

_GBLK = 16  # groups per grid step of the TPU's K3 (sets the index padding)
_SPG = 32  # groups per step of the streamed variant
_WBLK = 64  # slab rows per mega-block
_SUBROWS = 4  # slab rows per group sub-window
_BIG = 2**31 - 1
_KERNEL_GROUP = {"tap_select": 16, "tap_streamed": 32}  # the groups the kernels take

# Launches of each CUDA kernel, grouped takes (any device) and the takes
# that fell back to the per-row lookup, in this process (see
# reset_launch_counts).
launch_counts = {"tap_take": 0, "bin_pack": 0, "tap_select": 0, "tap_streamed": 0,
                 "tap_take_blocks": 0, "wide_take": 0, "wide_take_blocks": 0, "wide_select": 0}
call_counts = {"grouped_take_slabbed": 0, "grouped_take_streamed": 0}
fallback_counts = {"grouped_take_slabbed": 0, "grouped_take_streamed": 0}


def reset_launch_counts() -> None:
    for counts in (launch_counts, call_counts, fallback_counts):
        for name in counts:
            counts[name] = 0
    kbuild.reset_launch_shapes(launch_counts)


_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # idx, ok, rows, taps, ovf, n_ovf, n, ng, n_slabs, slab, stream
    "tap_select": ([_PTR] * 6 + [_I32] * 4 + [_PTR], _I32),
    # idx, ok, rows, taps, ovf, n_ovf, n, n_steps, n_slabs, n_blocks, slab, stream
    "tap_streamed": ([_PTR] * 6 + [_I32] * 5 + [_PTR], _I32),
    # tiles, knot, taps, k, n, width, height, stream
    "tap_take": ([_PTR] * 3 + [_I32] * 4 + [_PTR], _I32),
    # bins, tiles, k, height, width, stream
    "bin_pack": ([_PTR] * 2 + [_I32] * 3 + [_PTR], _I32),
    # tiles, knot, blocks, taps, k, n, cap, width, height, stream
    "tap_take_blocks": ([_PTR] * 4 + [_I32] * 5 + [_PTR], _I32),
    # tiles, knot, wide, k, n, width, height, margin, stream
    "wide_take": ([_PTR] * 3 + [_I32] * 5 + [_PTR], _I32),
    # tiles, knot, blocks, wide, k, n, cap, width, height, margin, stream
    "wide_take_blocks": ([_PTR] * 4 + [_I32] * 6 + [_PTR], _I32),
    # wide, knot_true, knot_cache, taps, eff_knot, k, n, margin, stream
    "wide_select": ([_PTR] * 5 + [_I32] * 3 + [_PTR], _I32),
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


def _n_slabs(rows: torch.Tensor, slab: int) -> int:
    """The slab count of an (n_rows, 2) int32 row table; n_rows must be a
    whole number (at least 2) of slabs."""
    if rows.dim() != 2 or rows.shape[1] != 2 or rows.dtype != torch.int32:
        raise ValueError(
            f"tap rows must be (n_rows, 2) int32, got {tuple(rows.shape)} {rows.dtype}")
    n_rows = rows.shape[0]
    if slab < 1 or n_rows % slab or n_rows // slab < 2 or n_rows >= 2**31:
        raise ValueError(f"{n_rows} tap rows are not a whole number (>= 2) of slabs of {slab}")
    return n_rows // slab


def _n_groups(n: int, group: int, per_step: int) -> int:
    """Groups once n points are padded to whole steps of ``per_step``
    groups (the TPU kernels' grids)."""
    return -(-n // (group * per_step)) * per_step


def _n_blocks(n_slabs: int) -> int:
    """Mega-blocks of the streamed window: whole blocks, at least 2 (the TPU
    pads the table to this, `tap_gather.py:431-434`)."""
    return max(-(-n_slabs // _WBLK), 2)


def _budget(ng: int, repair_groups: int | None, share: int) -> int:
    """Repair budget of a grouped take (`tap_gather.py:294-296`, `:488-490`):
    ``repair_groups``, by default max(256, ng // share) groups."""
    return min(max(256, ng // share) if repair_groups is None else repair_groups, ng)


def _lookup(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Exact rows for flat indices, clamped into the table as the plans
    clamp them (``index_select`` takes the int32 index as it is)."""
    flat = torch.clamp(idx, 0, rows.shape[0] - 1).reshape(-1)
    return torch.index_select(rows, 0, flat).reshape(*idx.shape, 2)


# ---------------------------------------------------------------------------
# G1: the direct take, and the packed bin image it reads
# ---------------------------------------------------------------------------

TILE = 8  # pixels a side of a bin-image tile: 8 rows of 8 nibbles, 32 bytes
STRIDE = 5  # pixels between tiles: any 4 consecutive rows (columns) lie in one tile


def bin_tile_shape(height: int, width: int) -> tuple[int, int]:
    """(tile rows, tile columns) of the packed image: tile (ty, tx) covers
    rows 5 ty .. 5 ty + 7 and columns 5 tx .. 5 tx + 7, and the window of
    an anchor (u, v) in the image lies in tile (max(v - 1, 0) // 5,
    max(u - 1, 0) // 5)."""
    return max(height - 2, 0) // STRIDE + 1, max(width - 2, 0) // STRIDE + 1


def pack_bins_plain(bin_image: torch.Tensor) -> torch.Tensor:
    """The twin of ``bin_pack``: (K, H, W) int32 bins in [0, 16) -> (K, TH,
    TW, 8) int32 tiles. Word r of tile (ty, tx) holds, in nibble c, the bin
    at pixel (5 ty + r, 5 tx + c) (its low 4 bits); pixels past the image
    hold 0. The tiles overlap by 3 pixels, so every 4x4 window lies in one."""
    k, h, w = bin_image.shape
    th, tw = bin_tile_shape(h, w)
    dev = bin_image.device
    step = torch.arange(TILE, device=dev)
    rows = (STRIDE * torch.arange(th, device=dev)[:, None] + step).reshape(-1)
    cols = (STRIDE * torch.arange(tw, device=dev)[:, None] + step).reshape(-1)
    b = bin_image.to(torch.int64) & 0xF
    b = b[:, torch.clamp(rows, max=h - 1)][:, :, torch.clamp(cols, max=w - 1)]
    b = b * ((rows < h)[:, None] & (cols < w)[None, :])
    b = b.reshape(k, th, TILE, tw, TILE).permute(0, 1, 3, 2, 4)  # (K, TH, TW, row, col)
    return bits_to_int32(torch.sum(b << (4 * step), dim=-1))  # distinct nibbles: sum = OR


def pack_bins_cuda(bin_image: torch.Tensor) -> torch.Tensor:
    """``bin_pack`` on the card: one launch, the same contract as
    :func:`pack_bins_plain`, bit for bit."""
    dev = bin_image.device
    if not (dev.type == "cuda" and bin_image.dtype == torch.int32 and bin_image.dim() == 3
            and 1 <= bin_image.shape[0] <= 65_535 and bin_image.is_contiguous()
            and bin_image.shape[1] * bin_image.shape[2] < 2**31):
        raise ValueError(
            f"bin_pack: takes a contiguous (K, H, W) int32 CUDA tensor, 1 <= K <= 65,535, "
            f"H*W < 2^31; got {tuple(bin_image.shape)} {bin_image.dtype} on {dev}")
    k, h, w = bin_image.shape
    th, tw = bin_tile_shape(h, w)
    tiles = torch.empty((k, th, tw, TILE), dtype=torch.int32, device=dev)
    if h == 0 or w == 0:
        return tiles
    err = _kernel("bin_pack")(bin_image.data_ptr(), tiles.data_ptr(), k, h, w,
                              torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bin_pack launch failed: CUDA error {err}")
    launch_counts["bin_pack"] += 1
    return tiles


def pack_bins(bin_image: torch.Tensor) -> torch.Tensor:
    """(K, TH, TW, 8) int32 packed bin tiles of (K, H, W) int32 bin images:
    the twin on CPU tensors, ``bin_pack`` on CUDA ones."""
    dev = bin_image.device.type
    if dev == "cpu":
        return pack_bins_plain(bin_image)
    if dev == "cuda":
        return pack_bins_cuda(bin_image)
    raise NotImplementedError(f"pack_bins: no kernel for device {bin_image.device}")


def anchors(knot: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """(..., 2) int32 (u, v) knots -> (...,) int32 flat pixel indices,
    clipped into the image as the JAX package clips them (`nid.py:508-510`)."""
    return (torch.clamp(knot[..., 1], 0, height - 1) * width
            + torch.clamp(knot[..., 0], 0, width - 1))


def _check_tiles(tiles: torch.Tensor, width: int, height: int) -> None:
    if tiles.dim() != 4 or tuple(tiles.shape[1:]) != (*bin_tile_shape(height, width), TILE) \
            or tiles.dtype != torch.int32:
        raise ValueError(
            f"bin tiles of a {width}x{height} image must be (K, "
            f"{', '.join(map(str, bin_tile_shape(height, width)))}, {TILE}) int32, got "
            f"{tuple(tiles.shape)} {tiles.dtype}")


def direct_take_plain(tiles: torch.Tensor, knot: torch.Tensor, width: int,
                      height: int) -> torch.Tensor:
    """The twin of G1: for every (K, N) knot, the nibble-packed row of its
    clipped anchor's 4x4 window (``build_tap_table(bins)[anchor]``), read
    from the one packed tile that holds the window: tap t = 4 (dy + 1) +
    (dx + 1), dy and dx in -1..2, is the bin at the row and column clamped
    into the image, nibble t % 8 of word t // 8."""
    _check_tiles(tiles, width, height)
    k, _, tw, _ = tiles.shape
    flat = tiles.reshape(k, -1).to(torch.int64) & 0xFFFFFFFF
    u = torch.clamp(knot[..., 0].to(torch.int64), 0, width - 1)
    v = torch.clamp(knot[..., 1].to(torch.int64), 0, height - 1)
    ty, tx = torch.clamp(v - 1, min=0) // STRIDE, torch.clamp(u - 1, min=0) // STRIDE
    base = (ty * tw + tx) * TILE
    kf = torch.arange(k, device=tiles.device)[:, None]
    words = [torch.zeros_like(u), torch.zeros_like(u)]
    for dy in range(-1, 3):
        row = flat[kf, base + torch.clamp(v + dy, 0, height - 1) - STRIDE * ty]
        for dx in range(-1, 3):
            x = torch.clamp(u + dx, 0, width - 1)
            nib = (row >> (4 * (x - STRIDE * tx))) & 0xF
            t = 4 * (dy + 1) + (dx + 1)
            words[t // 8] = words[t // 8] | (nib << (4 * (t % 8)))
    return torch.stack([bits_to_int32(words[0]), bits_to_int32(words[1])], dim=-1)


def direct_take_cuda(tiles: torch.Tensor, knot: torch.Tensor, width: int,
                     height: int) -> torch.Tensor:
    """G1 on the card: one launch of ``tap_take``, the same contract as
    :func:`direct_take_plain`, bit for bit."""
    dev = tiles.device
    k = tiles.shape[0]
    if not (dev.type == "cuda" and knot.device == dev and tiles.dtype == torch.int32
            and knot.dtype == torch.int32 and knot.dim() == 3 and knot.shape[0] == k
            and knot.shape[2] == 2 and 1 <= k <= 65_535 and knot.shape[1] < 2**31
            and tiles.numel() // max(k, 1) < 2**31
            and tiles.is_contiguous() and knot.is_contiguous() and knot.data_ptr() % 8 == 0):
        raise ValueError(
            f"tap_take: takes contiguous int32 CUDA tensors on one device, bin tiles (K, TH, "
            f"TW, 8) and 8-byte aligned knots (K, N, 2), 1 <= K <= 65,535; got tiles "
            f"{tuple(tiles.shape)} {tiles.dtype} on {dev}, knots {tuple(knot.shape)} "
            f"{knot.dtype} on {knot.device}")
    _check_tiles(tiles, width, height)
    n = knot.shape[1]
    taps = torch.empty((k, n, 2), dtype=torch.int32, device=dev)
    if n == 0:
        return taps
    err = _kernel("tap_take")(tiles.data_ptr(), knot.data_ptr(), taps.data_ptr(), k, n, width,
                              height, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tap_take launch failed: CUDA error {err}")
    launch_counts["tap_take"] += 1
    kbuild.launch_shapes["tap_take", n] += 1
    return taps


def direct_take(tiles: torch.Tensor, knot: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """(K, N, 2) int32 tap rows at the (K, N, 2) int32 knots, clipped into
    the image, from the (K, TH, TW, 8) packed bin tiles of
    :func:`pack_bins`: the twin on CPU tensors, G1 on CUDA ones."""
    dev = tiles.device.type
    if dev == "cpu":
        return direct_take_plain(tiles, knot, width, height)
    if dev == "cuda":
        return direct_take_cuda(tiles, knot, width, height)
    raise NotImplementedError(f"direct_take: no kernel for device {tiles.device}")


# ---------------------------------------------------------------------------
# The frozen-tap cache's kernels: G1's block form, G2 (the wide take), its
# block form, and W1 (the sub-window select)
# ---------------------------------------------------------------------------

MAX_MARGIN = 2  # a wide row of 4 + 2 m nibbles fits one 32-bit word
PARTIAL_BLOCK = 128  # points a refresh block (the JAX package's _PARTIAL_BLOCK)


def check_margin(margin: int) -> None:
    """A wide window's margin is 1 or 2 (`nid.py:154` asserts it): its
    rows of 4 + 2 m nibbles fill at most one int32 word."""
    if not 1 <= margin <= MAX_MARGIN:
        raise ValueError(f"the wide window's margin must be in 1..{MAX_MARGIN}, got {margin}")


def wide_take_plain(tiles: torch.Tensor, knot: torch.Tensor, width: int, height: int,
                    margin: int) -> torch.Tensor:
    """The twin of G2: (K, 4 + 2m, N) int32 wide window planes of the (K, N,
    2) knots, ``build_wide_tap_table(bins, m)[anchor]`` transposed
    (`nid.py:143-167, 630-638`). Word r of point p nibble-packs, in nibble
    j, the bin at row clamp(v + r - 1 - m) and column clamp(u - 1 - m + j)
    around the clipped anchor (u, v), j = 0 .. 3 + 2m. Each coordinate is
    clamped into the image before its tile and nibble are chosen: the
    tiles hold 0 past the image, the table repeats its edge."""
    _check_tiles(tiles, width, height)
    check_margin(margin)
    k, th, tw, _ = tiles.shape
    rows = 4 + 2 * margin
    flat = tiles.reshape(k, -1).to(torch.int64) & 0xFFFFFFFF
    u = torch.clamp(knot[..., 0].to(torch.int64), 0, width - 1)
    v = torch.clamp(knot[..., 1].to(torch.int64), 0, height - 1)
    kf = torch.arange(k, device=tiles.device)[:, None]
    cols = [torch.clamp(u - 1 - margin + j, 0, width - 1) for j in range(rows)]
    tx = [torch.clamp(x // STRIDE, max=tw - 1) for x in cols]
    planes = []
    for r in range(rows):
        y = torch.clamp(v + r - 1 - margin, 0, height - 1)
        ty = torch.clamp(y // STRIDE, max=th - 1)
        word = torch.zeros_like(u)
        for j in range(rows):
            w = flat[kf, (ty * tw + tx[j]) * TILE + y - STRIDE * ty]
            word = word | (((w >> (4 * (cols[j] - STRIDE * tx[j]))) & 0xF) << (4 * j))
        planes.append(bits_to_int32(word))
    return torch.stack(planes, dim=1)


def wide_take_plan(tiles: torch.Tensor, knot: torch.Tensor, width: int, height: int,
                   margin: int):
    """G2's addressing in torch ops (the tests' and ``chip_smoke.py``'s
    model of the kernel; :func:`wide_take_plain` stays the twin):
    ``(planes, sectors, loads, read)``, the (K, 4 + 2m, N) int32 planes of
    :func:`wide_take_plain` built as the kernel reads them, (K, N) int32
    counts a point of the 32-byte tiles (sectors) it reads and of the
    16-byte halves of them it needs, and (K, N, 4) int64 the tiles it reads
    (index in the keyframe's (TH * TW) tiles; -1 where it reads none), in
    the order (ty0, a), (ty0, a + 1), (ty0 + 1, a), (ty0 + 1, a + 1).

    The window's rows lie in tile row ty0 = clamp(v - 1 - m) // 5 and,
    only where the last clamped row passes 5 ty0 + 7, in ty0 + 1; its
    columns in tile a = clamp(u - 1 - m) // 5 and, only where the last
    clamped column passes 5 a + 7, in a + 1: at most 2 x 2 tiles. Row r,
    d_r = clamp(v + r - 1 - m) - 5 ty0 (0 <= d_r <= r + 4), is word d_r of
    tile row ty0 up to 7, else word d_r - 5 of ty0 + 1. A half that is not
    needed reads as the complement of its words, so that a word taken from
    one changes the planes."""
    _check_tiles(tiles, width, height)
    check_margin(margin)
    k, th, tw, _ = tiles.shape
    rows = 4 + 2 * margin
    flat = tiles.reshape(k, -1).to(torch.int64) & 0xFFFFFFFF
    u = torch.clamp(knot[..., 0].to(torch.int64), 0, width - 1)
    v = torch.clamp(knot[..., 1].to(torch.int64), 0, height - 1)
    y0 = torch.clamp(v - 1 - margin, min=0)
    ty0 = torch.clamp(y0 // STRIDE, max=th - 1)
    d0 = y0 - STRIDE * ty0
    dl = torch.clamp(v + 2 + margin, max=height - 1) - STRIDE * ty0
    x0 = u - 1 - margin
    ta = torch.clamp(torch.clamp(x0, min=0) // STRIDE, max=tw - 1)
    has_b = torch.clamp(x0 + rows - 1, max=width - 1) - STRIDE * ta > 7
    row2 = dl > 7
    # The halves needed, (tile row ty0 + t, half h): rows d0..dl less 5 t.
    need = {(0, 0): d0 <= 3, (0, 1): dl >= 4, (1, 0): dl >= 8, (1, 1): dl >= 9}
    kf = torch.arange(k, device=tiles.device)[:, None]

    def word(t, c, w):
        read = row2 if t else torch.ones_like(row2)
        read = read & has_b if c else read
        val = flat[kf, torch.where(read, ((ty0 + t) * tw + ta + c) * TILE + w, 0)]
        needed = read & torch.where(w < 4, need[t, 0], need[t, 1])
        return torch.where(needed, val, val ^ 0xFFFFFFFF)

    cols = [torch.clamp(x0 + j, 0, width - 1) - STRIDE * ta for j in range(rows)]
    assert all(bool(((c >= 0) & (c <= 12)).all()) for c in cols), "a column outside a, a + 1"
    planes = []
    for r in range(rows):
        d = torch.clamp(v + r - 1 - margin, 0, height - 1) - STRIDE * ty0
        assert bool(((d >= 0) & (d <= min(12, r + 4))).all()), f"row {r} outside ty0, ty0 + 1"
        below = d > 7
        w = d - STRIDE * below.to(torch.int64)
        wa = torch.where(below, word(1, 0, w), word(0, 0, w))
        wb = torch.where(has_b, torch.where(below, word(1, 1, w), word(0, 1, w)), 0)
        run = wa | ((wb >> 12) << 32)
        out = torch.zeros_like(u)
        for j, c in enumerate(cols):
            out = out | (((run >> (4 * c)) & 0xF) << (4 * j))
        planes.append(bits_to_int32(out))
    tiles_read = 1 + has_b.to(torch.int32)
    sectors = (1 + row2.to(torch.int32)) * tiles_read
    halves = sum(n.to(torch.int32) for n in need.values())
    every = torch.ones_like(row2)
    read = torch.stack([torch.where(r, (ty0 + t) * tw + ta + c, -1) for t, c, r in (
        (0, 0, every), (0, 1, has_b), (1, 0, row2), (1, 1, row2 & has_b))], dim=-1)
    return torch.stack(planes, dim=1), sectors, halves * tiles_read, read


def wide_select_plain(wide: torch.Tensor, knot_true: torch.Tensor, knot_cache: torch.Tensor,
                      margin: int):
    """The twin of W1: ``(taps (K, N, 2), eff_knot (K, N, 2))``, both int32,
    from the (K, 4 + 2m, N) wide planes gathered at ``knot_cache``
    (`nid.py:641-667` with `:858-860`). The window offset dk = clip(knot_true
    - knot_cache, -m, m) is int32 arithmetic that wraps, as XLA's does, for
    knots near +-2^31; the 4x4 sub-window at dk is the tap row at anchor
    knot_cache + dk (bit for bit where both knots lie in the image), and
    eff_knot = knot_cache + dk, wrapping too."""
    check_margin(margin)
    dk = torch.clamp(bits_to_int32(knot_true.to(torch.int64) - knot_cache.to(torch.int64)),
                     -margin, margin).to(torch.int64)
    dv = dk[..., 1] + margin  # (K, N) in [0, 2m]
    sh = 4 * (dk[..., 0] + margin)
    w = wide.to(torch.int64) & 0xFFFFFFFF
    halves = [(torch.gather(w, 1, (dv + i)[:, None, :]).squeeze(1) >> sh) & 0xFFFF
              for i in range(4)]
    taps = torch.stack([bits_to_int32(halves[0] | (halves[1] << 16)),
                        bits_to_int32(halves[2] | (halves[3] << 16))], dim=-1)
    return taps, bits_to_int32(knot_cache.to(torch.int64) + dk)


def _block_points(blocks: torch.Tensor, n: int):
    """(points (K, cap*128), kept (K, cap*128)) of a (K, cap) block list:
    the points of each listed 128-point block, and False for the padding
    ids (nb), which are dropped (`nid.py:597-611`, ``mode="drop"``)."""
    nb = n // PARTIAL_BLOCK
    blk = blocks.to(torch.int64)
    k, cap = blk.shape
    step = torch.arange(PARTIAL_BLOCK, device=blocks.device)
    pts = (torch.clamp(blk, max=nb - 1)[:, :, None] * PARTIAL_BLOCK + step).reshape(k, -1)
    kept = (blk < nb)[:, :, None].expand(k, cap, PARTIAL_BLOCK).reshape(k, -1)
    return pts, kept


def tap_take_blocks_plain(tiles, knot, blocks, taps, width: int, height: int) -> torch.Tensor:
    """The twin of G1's block form: ``taps`` (K, N, 2) with the points of
    the listed blocks re-taken at ``knot`` in place (`nid.py:566-613`,
    `_partial_refresh_taps`); returns ``taps``."""
    _check_blocks(blocks, taps.shape[0], taps.shape[1])
    k, n, _ = taps.shape
    pts, kept = _block_points(blocks, n)
    new = direct_take_plain(tiles, torch.gather(knot, 1, pts[..., None].expand(-1, -1, 2)),
                            width, height)
    kf = torch.arange(k, device=taps.device)[:, None].expand_as(pts)
    taps[kf[kept], pts[kept]] = new[kept]
    return taps


def wide_take_blocks_plain(tiles, knot, blocks, wide, width: int, height: int,
                           margin: int) -> torch.Tensor:
    """The twin of G2's block form: ``wide`` (K, 4 + 2m, N) with the points
    of the listed blocks re-taken at ``knot`` in place (`nid.py:670-696`,
    `_partial_refresh_wide`); returns ``wide``."""
    _check_blocks(blocks, wide.shape[0], wide.shape[2])
    k, _, n = wide.shape
    pts, kept = _block_points(blocks, n)
    new = wide_take_plain(tiles, torch.gather(knot, 1, pts[..., None].expand(-1, -1, 2)),
                          width, height, margin)
    kf = torch.arange(k, device=wide.device)[:, None].expand_as(pts)
    wide[kf[kept], :, pts[kept]] = new.permute(0, 2, 1)[kept]
    return wide


def _check_blocks(blocks: torch.Tensor, k: int, n: int) -> None:
    nb = n // PARTIAL_BLOCK
    if not (blocks.dtype == torch.int32 and blocks.dim() == 2 and blocks.shape[0] == k
            and 1 <= blocks.shape[1] <= nb and n % PARTIAL_BLOCK == 0):
        raise ValueError(
            f"a block list is (K, cap) int32, 1 <= cap <= N / {PARTIAL_BLOCK}, N a multiple of "
            f"{PARTIAL_BLOCK}; got {tuple(blocks.shape)} {blocks.dtype} for K = {k}, N = {n}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _check_cuda(name: str, *tensors) -> None:
    """Contiguous int32 tensors on one CUDA device, 8-byte aligned."""
    dev = tensors[0].device
    if not all(t.device == dev and t.dtype == torch.int32 and t.is_contiguous()
               and t.data_ptr() % 8 == 0 for t in tensors) or dev.type != "cuda":
        raise ValueError(
            f"{name}: takes contiguous 8-byte aligned int32 CUDA tensors on one device; got "
            + ", ".join(f"{tuple(t.shape)} {t.dtype} on {t.device}" for t in tensors))


def _check_knots(name: str, tiles, knot, width: int, height: int) -> None:
    _check_cuda(name, tiles, knot)
    _check_tiles(tiles, width, height)
    k = tiles.shape[0]
    if not (knot.dim() == 3 and knot.shape[0] == k and knot.shape[2] == 2
            and 1 <= k <= 65_535 and knot.shape[1] < 2**31 and tiles.numel() // k < 2**31):
        raise ValueError(f"{name}: knots must be (K, N, 2) for tiles (K, ...), 1 <= K <= "
                         f"65,535; got {tuple(knot.shape)} for {tuple(tiles.shape)}")


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launch_counts[name] += 1


def wide_take_cuda(tiles, knot, width: int, height: int, margin: int) -> torch.Tensor:
    """G2 on the card: one launch of ``wide_take``, the same contract as
    :func:`wide_take_plain`, bit for bit."""
    check_margin(margin)
    _check_knots("wide_take", tiles, knot, width, height)
    k, n, _ = knot.shape
    wide = torch.empty((k, 4 + 2 * margin, n), dtype=torch.int32, device=tiles.device)
    if n == 0:
        return wide
    _launched("wide_take", _kernel("wide_take")(
        tiles.data_ptr(), knot.data_ptr(), wide.data_ptr(), k, n, width, height, margin,
        _stream(tiles.device)))
    return wide


def wide_select_cuda(wide, knot_true, knot_cache, margin: int):
    """W1 on the card: one launch of ``wide_select`` for the taps and the
    effective knots, the same contract as :func:`wide_select_plain`, bit for
    bit."""
    check_margin(margin)
    _check_cuda("wide_select", wide, knot_true, knot_cache)
    k, rows, n = wide.shape
    if not (rows == 4 + 2 * margin and knot_true.shape == knot_cache.shape == (k, n, 2)
            and 1 <= k <= 65_535):
        raise ValueError(f"wide_select: planes (K, 4 + 2m, N) and knots (K, N, 2); got "
                         f"{tuple(wide.shape)}, {tuple(knot_true.shape)}, "
                         f"{tuple(knot_cache.shape)}, m = {margin}")
    taps = torch.empty((k, n, 2), dtype=torch.int32, device=wide.device)
    eff = torch.empty((k, n, 2), dtype=torch.int32, device=wide.device)
    if n == 0:
        return taps, eff
    _launched("wide_select", _kernel("wide_select")(
        wide.data_ptr(), knot_true.data_ptr(), knot_cache.data_ptr(), taps.data_ptr(),
        eff.data_ptr(), k, n, margin, _stream(wide.device)))
    return taps, eff


def tap_take_blocks_cuda(tiles, knot, blocks, taps, width: int, height: int) -> torch.Tensor:
    """G1's block form on the card: one launch of ``tap_take_blocks``, in
    place, the same contract as :func:`tap_take_blocks_plain`, bit for bit."""
    _check_knots("tap_take_blocks", tiles, knot, width, height)
    _check_cuda("tap_take_blocks", tiles, blocks, taps)
    _check_blocks(blocks, taps.shape[0], taps.shape[1])
    k, n, _ = taps.shape
    if tuple(knot.shape) != (k, n, 2):
        raise ValueError(f"tap_take_blocks: knots {tuple(knot.shape)} for taps {tuple(taps.shape)}")
    _launched("tap_take_blocks", _kernel("tap_take_blocks")(
        tiles.data_ptr(), knot.data_ptr(), blocks.data_ptr(), taps.data_ptr(), k, n,
        blocks.shape[1], width, height, _stream(tiles.device)))
    return taps


def wide_take_blocks_cuda(tiles, knot, blocks, wide, width: int, height: int,
                          margin: int) -> torch.Tensor:
    """G2's block form on the card: one launch of ``wide_take_blocks``, in
    place, the same contract as :func:`wide_take_blocks_plain`, bit for bit."""
    check_margin(margin)
    _check_knots("wide_take_blocks", tiles, knot, width, height)
    _check_cuda("wide_take_blocks", tiles, blocks, wide)
    _check_blocks(blocks, wide.shape[0], wide.shape[2])
    k, rows, n = wide.shape
    if tuple(knot.shape) != (k, n, 2) or rows != 4 + 2 * margin:
        raise ValueError(f"wide_take_blocks: knots {tuple(knot.shape)} for planes "
                         f"{tuple(wide.shape)}, m = {margin}")
    _launched("wide_take_blocks", _kernel("wide_take_blocks")(
        tiles.data_ptr(), knot.data_ptr(), blocks.data_ptr(), wide.data_ptr(), k, n,
        blocks.shape[1], width, height, margin, _stream(tiles.device)))
    return wide


def _dispatch(name: str, plain, cuda, device, *args):
    if device.type == "cpu":
        return plain(*args)
    if device.type == "cuda":
        return cuda(*args)
    raise NotImplementedError(f"{name}: no kernel for device {device}")


def wide_take(tiles, knot, width: int, height: int, margin: int) -> torch.Tensor:
    """(K, 4 + 2m, N) int32 wide window planes at the (K, N, 2) knots from
    the packed bin tiles: the twin on CPU tensors, G2 on CUDA ones."""
    return _dispatch("wide_take", wide_take_plain, wide_take_cuda, tiles.device,
                     tiles, knot, width, height, margin)


def wide_select(wide, knot_true, knot_cache, margin: int):
    """(taps, eff_knot) of the wide planes at the current knots: the twin on
    CPU tensors, W1 on CUDA ones."""
    return _dispatch("wide_select", wide_select_plain, wide_select_cuda, wide.device,
                     wide, knot_true, knot_cache, margin)


def tap_take_blocks(tiles, knot, blocks, taps, width: int, height: int) -> torch.Tensor:
    """Re-takes the tap rows of the listed 128-point blocks in place: the
    twin on CPU tensors, G1's block form on CUDA ones."""
    return _dispatch("tap_take_blocks", tap_take_blocks_plain, tap_take_blocks_cuda,
                     tiles.device, tiles, knot, blocks, taps, width, height)


def wide_take_blocks(tiles, knot, blocks, wide, width: int, height: int,
                     margin: int) -> torch.Tensor:
    """Re-takes the wide planes of the listed 128-point blocks in place: the
    twin on CPU tensors, G2's block form on CUDA ones."""
    return _dispatch("wide_take_blocks", wide_take_blocks_plain, wide_take_blocks_cuda,
                     tiles.device, tiles, knot, blocks, wide, width, height, margin)


class GroupedSelect(NamedTuple):
    """What K3 / K4 (and their twins) return."""

    taps: torch.Tensor  # (ng, G, 2) int32: exact for ok points of clean groups
    ovf_grp: torch.Tensor  # (ng,) bool: an ok point lies outside the group's window
    n_ovf: torch.Tensor  # () int32: overflowing groups, on the device


# ---------------------------------------------------------------------------
# The plans and selections of the twins
# ---------------------------------------------------------------------------


def _pad_points(idx, ok, block: int):
    n_pad = -idx.shape[0] % block
    if n_pad:
        idx = F.pad(idx, (0, n_pad))
        ok = F.pad(ok, (0, n_pad))
    return idx, ok


class SlabbedPlan(NamedTuple):
    """Index arithmetic of :func:`grouped_take_slabbed` (`tap_gather.py:
    267-296`), for ``ng`` groups of ``group`` points."""

    slab_id: torch.Tensor  # (ng,) window start slab
    offs: torch.Tensor  # (ng, G) offsets in the window, clamped to [0, 2*slab)
    ovf_grp: torch.Tensor  # (ng,) bool: an ok point lies past the window


def plan_slabbed(rows, idx, ok, *, slab: int, group: int = 16) -> SlabbedPlan:
    n_slabs = _n_slabs(rows, slab)
    idx = torch.clamp(idx, max=n_slabs * slab - 1)
    idx, ok = _pad_points(idx, ok.bool(), group * _GBLK)
    ng = idx.shape[0] // group
    idx2 = idx.reshape(ng, group)
    ok2 = ok.reshape(ng, group)
    base = torch.amin(torch.where(ok2, idx2, _BIG), dim=1)
    base = torch.where(torch.any(ok2, dim=1), base, 0)
    slab_id = torch.clamp(base // slab, 0, n_slabs - 2)  # window = [id, id+2)*slab
    idx_eff = torch.where(ok2, idx2, base[:, None])
    offs = idx_eff - slab_id[:, None] * slab
    ovf_grp = torch.any(ok2 & (offs >= 2 * slab), dim=1)
    return SlabbedPlan(
        slab_id.to(torch.int32),
        torch.clamp(offs, 0, 2 * slab - 1).to(torch.int32), ovf_grp,
    )


def select_slabbed_plain(rows, slab_id, offs, slab: int) -> torch.Tensor:
    """The selection of K3's twin: (ng, G, 2) rows ``rows[slab_id*slab + o]``
    for o = offs[g, p] in [0, 2*slab): the output of `_local_select(take(
    slabs, slab_id), take(slabs, slab_id+1), offs)` (`tap_gather.py:
    157-185`), read from the row table."""
    return rows[slab_id[:, None].long() * slab + offs.long()]


class StreamedPlan(NamedTuple):
    """Index arithmetic of :func:`grouped_take_streamed` (`tap_gather.py:
    427-491`), for ``n_steps`` steps of 32 groups of ``group`` points."""

    blk0: torch.Tensor  # (n_steps,) first mega-block of each step's window
    rel: torch.Tensor  # (n_steps*32,) sub-window start, in slab rows past blk0*64
    offs: torch.Tensor  # (n_steps, 32, G) clamped to [0, 4*slab)
    ovf_grp: torch.Tensor  # (ng,) bool


def plan_streamed(rows, idx, ok, *, slab: int, group: int = 32) -> StreamedPlan:
    n_slabs = _n_slabs(rows, slab)
    idx = torch.clamp(idx, max=n_slabs * slab - 1)
    n_blocks = _n_blocks(n_slabs)
    idx, ok = _pad_points(idx, ok.bool(), group * _SPG)
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
    return StreamedPlan(
        blk0.to(torch.int32), rel.to(torch.int32).reshape(-1),
        torch.clamp(offs, 0, _SUBROWS * slab - 1).to(torch.int32), ovf_grp,
    )


def select_streamed_plain(rows, blk0, rel, offs, slab: int) -> torch.Tensor:
    """The selection of K4's twin: (ng, G, 2) rows ``rows[r*slab + o % slab]``
    with slab row r = blk0[i]*64 + rel[i*32 + g] + o // slab and o =
    offs[i, g, p] in [0, 4*slab), group g of step i.

    The TPU pads the table to whole mega-blocks; here r is clamped to the
    table's last slab row instead of copying the table. Only a row with ~ok
    or an overflowing group can reach past the end, and both are
    unspecified (the repair rewrites the latter)."""
    n_steps, spg, group = offs.shape
    offs = offs.long()
    start = blk0[:, None].long() * _WBLK + rel.reshape(n_steps, spg).long()
    row = torch.clamp(start[:, :, None] + offs // slab, max=rows.shape[0] // slab - 1)
    return rows[row * slab + offs % slab].reshape(n_steps * spg, group, 2)


def grouped_select_slabbed_plain(rows, idx, ok, *, slab: int, group: int = 16) -> GroupedSelect:
    """The twin of K3: :func:`plan_slabbed`, then :func:`select_slabbed_plain`."""
    p = plan_slabbed(rows, idx, ok, slab=slab, group=group)
    return GroupedSelect(select_slabbed_plain(rows, p.slab_id, p.offs, slab), p.ovf_grp,
                         torch.sum(p.ovf_grp, dtype=torch.int32))


def grouped_select_streamed_plain(rows, idx, ok, *, slab: int, group: int = 32) -> GroupedSelect:
    """The twin of K4: :func:`plan_streamed`, then :func:`select_streamed_plain`."""
    p = plan_streamed(rows, idx, ok, slab=slab, group=group)
    return GroupedSelect(select_streamed_plain(rows, p.blk0, p.rel, p.offs, slab), p.ovf_grp,
                         torch.sum(p.ovf_grp, dtype=torch.int32))


# ---------------------------------------------------------------------------
# K3 / K4 on the card
# ---------------------------------------------------------------------------


_MASKS = (torch.bool, torch.uint8)
_kernels: dict = {}  # name -> the library's ctypes function, signature declared


def _kernel(name: str):
    if name not in _kernels:
        _kernels[name] = getattr(_lib(), name)
    return _kernels[name]


def _launch(kernel: str, rows, idx, ok, slab: int, group: int, ng: int, *sizes) -> GroupedSelect:
    """Allocates the outputs and launches ``kernel``. The checks are one
    expression, so that a call costs the host little beside the launch."""
    dev = rows.device
    n = idx.shape[0]
    if not (dev.type == "cuda" and idx.device == dev and ok.device == dev
            and rows.dtype == torch.int32 and idx.dtype == torch.int32 and ok.dtype in _MASKS
            and idx.dim() == 1 and ok.shape == idx.shape and 1 <= n < 2**31 - 2**11
            and rows.is_contiguous() and idx.is_contiguous() and ok.is_contiguous()
            and rows.data_ptr() % 8 == 0 and group == _KERNEL_GROUP[kernel]):
        raise ValueError(
            f"{kernel}: takes contiguous CUDA tensors on one device, int32 rows (8-byte "
            f"aligned) and 1-D int32 idx with a bool or uint8 mask of its length, groups of "
            f"{_KERNEL_GROUP[kernel]}; got rows {rows.dtype} on {dev}, idx "
            f"{tuple(idx.shape)} {idx.dtype} on {idx.device}, ok {tuple(ok.shape)} {ok.dtype} "
            f"on {ok.device}, group {group}")
    taps = torch.empty((ng, group, 2), dtype=torch.int32, device=dev)
    ovf = torch.empty((ng,), dtype=torch.bool, device=dev)
    n_ovf = torch.empty((), dtype=torch.int32, device=dev)
    err = _kernel(kernel)(
        idx.data_ptr(), ok.data_ptr(), rows.data_ptr(), taps.data_ptr(), ovf.data_ptr(),
        n_ovf.data_ptr(), n, *sizes, slab, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")
    launch_counts[kernel] += 1
    return GroupedSelect(taps, ovf, n_ovf)


def grouped_select_slabbed_cuda(rows, idx, ok, *, slab: int, group: int = 16) -> GroupedSelect:
    """K3 on the card: plan and selection in one launch; the same contract
    as :func:`grouped_select_slabbed_plain`, bit for bit."""
    n_slabs = _n_slabs(rows, slab)
    ng = _n_groups(idx.shape[0], group, _GBLK)
    return _launch("tap_select", rows, idx, ok, slab, group, ng, ng, n_slabs)


def grouped_select_streamed_cuda(rows, idx, ok, *, slab: int, group: int = 32) -> GroupedSelect:
    """K4 on the card: plan and selection in one launch; the same contract
    as :func:`grouped_select_streamed_plain`, bit for bit."""
    n_slabs = _n_slabs(rows, slab)
    ng = _n_groups(idx.shape[0], group, _SPG)
    return _launch("tap_streamed", rows, idx, ok, slab, group, ng, ng // _SPG, n_slabs,
                   _n_blocks(n_slabs))


def grouped_select_slabbed(rows, idx, ok, *, slab: int, group: int = 16) -> GroupedSelect:
    """(taps, flags, count) of the slabbed grouped take: the twin on CPU
    tensors, K3 on CUDA ones."""
    dev = rows.device.type
    if dev == "cpu":
        return grouped_select_slabbed_plain(rows, idx, ok, slab=slab, group=group)
    if dev == "cuda":
        return grouped_select_slabbed_cuda(rows, idx, ok, slab=slab, group=group)
    raise NotImplementedError(f"grouped_select_slabbed: no kernel for device {rows.device}")


def grouped_select_streamed(rows, idx, ok, *, slab: int, group: int = 32) -> GroupedSelect:
    """(taps, flags, count) of the streamed grouped take: the twin on CPU
    tensors, K4 on CUDA ones."""
    dev = rows.device.type
    if dev == "cpu":
        return grouped_select_streamed_plain(rows, idx, ok, slab=slab, group=group)
    if dev == "cuda":
        return grouped_select_streamed_cuda(rows, idx, ok, slab=slab, group=group)
    raise NotImplementedError(f"grouped_select_streamed: no kernel for device {rows.device}")


# ---------------------------------------------------------------------------
# The grouped takes
# ---------------------------------------------------------------------------


def _repair(rows, idx, taps, ovf_grp, n_ovf: int) -> torch.Tensor:
    """Re-take every row of the ``n_ovf`` overflowing groups. The JAX
    package re-takes the ``f_rep`` groups ranked first by flag (`tap_gather.
    py:305-311`); its surplus slots rewrite clean groups with their exact
    rows, which changes no ``ok`` row, so only the flagged groups are taken
    here. Rows past the end of ``idx`` belong to padding."""
    _, rep = torch.topk(ovf_grp.to(torch.int32), n_ovf)
    group = taps.shape[1]
    pos = rep[:, None] * group + torch.arange(group, device=rep.device)
    taps[rep] = _lookup(rows, idx[torch.clamp(pos, max=idx.shape[0] - 1)])
    return taps


def _finish(name: str, rows, idx, sel: GroupedSelect, f_rep: int) -> torch.Tensor:
    # The overflow count decides the branch: one 4-byte device-to-host read.
    n_ovf = int(sel.n_ovf)
    if n_ovf > f_rep:
        fallback_counts[name] += 1
        return _lookup(rows, idx)
    taps = _repair(rows, idx, sel.taps, sel.ovf_grp, n_ovf) if n_ovf else sel.taps
    return taps.reshape(-1, 2)[: idx.shape[0]]


def grouped_take_slabbed(rows, idx, ok, *, slab: int, group: int = 16,
                         repair_groups: int | None = None) -> torch.Tensor:
    """Exact (N, 2) ``take(rows, idx)`` of every ``ok`` row over the row
    table (`tap_gather.py:246-319`), ``rows`` a whole number of slabs."""
    call_counts["grouped_take_slabbed"] += 1
    sel = grouped_select_slabbed(rows, idx, ok, slab=slab, group=group)
    return _finish("grouped_take_slabbed", rows, idx, sel,
                   _budget(sel.ovf_grp.shape[0], repair_groups, 64))


def grouped_take_streamed(rows, idx, ok, *, slab: int, group: int = 32,
                          repair_groups: int | None = None) -> torch.Tensor:
    """Streamed grouped take (`tap_gather.py:414-541`): the same contract as
    :func:`grouped_take_slabbed`, with step-shared mega-block windows."""
    call_counts["grouped_take_streamed"] += 1
    sel = grouped_select_streamed(rows, idx, ok, slab=slab, group=group)
    return _finish("grouped_take_streamed", rows, idx, sel,
                   _budget(sel.ovf_grp.shape[0], repair_groups, 32))


def grouped_take(table, idx, ok, *, group: int = 16, slab: int | None = None,
                 repair_groups: int | None = None) -> torch.Tensor:
    """:func:`grouped_take_slabbed` over any (R, 2) row table, padded with
    zero rows to a whole number (at least 2) of slabs per call
    (`tap_gather.py:199-243`; tests and small tables)."""
    r, c = table.shape
    if c != 2:
        raise ValueError(f"nibble-packed tap rows are (R, 2) int32, got {tuple(table.shape)}")
    if slab is None:
        slab = default_slab(r, idx.shape[0], group)
    n_slabs = max(-(-r // slab), 2)
    return grouped_take_slabbed(
        F.pad(table, (0, 0, 0, n_slabs * slab - r)), torch.clamp(idx, max=r - 1), ok,
        slab=slab, group=group, repair_groups=repair_groups,
    )
