"""Probe the costs the frozen-tap cache's wide window and partial refresh
rest on, on the card.

Counterpart of `pointcloudprocessor_tpu/tools/tap_cache_probe.py`, on the
scene of :mod:`.nid_locality`. Four questions, each asked again for Hopper:

1. The row-width tax: does ``index_select`` of (R, w) int32 rows cost the
   same at w = 2, 4 and 8 (a 4x4 window, and 8x8 with +-2 px of margin)?
   Beside it, on the same knots, what the port runs instead: G1
   (``tap_gather.direct_take``) and G2 (``wide_take``, m = 1 and 2), both
   from B1's packed tiles.
2. The wide-table build: the port builds no wide table (G2 reads B1's
   tiles), so the answer is B1's time (``tap_gather.pack_bins``) and the
   bytes a margin-2 table would take (3.1 GB at 8 x 4096x3000).
3. The partial refresh (:func:`timed_refresh`): at 0.1 and 0.33 px of
   drift an evaluation, with a refresh whenever any point drifted, the
   share of dirty 128-point blocks (:func:`dirty_block_share`) and the
   partial refresh's cost against the full one; the two must give the same
   losses bit for bit.
4. The margin-2 cache: no refresh allowed (``noref``: W1 alone), drift
   inside the margin (``inmargin``) and past it (``refresh``: G2 every
   evaluation).

Chained evaluations are timed with CUDA events (median and spread of 3
repeats after a warm-up, ms an evaluation); a time under the physical floor
is null and named under ``below_floor``; single calls by their device time
(``profiling.median_ms(hide_host=True)``).

Usage:
  python -m pointcloudprocessor_tpu_torch.tools.tap_cache_probe [--quick] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import numpy as np
import torch

from ..core import se3
from ..opt import nid
from ..ops import tap_gather
from ..utils import profiling
from .nid_locality import FULL, QUICK, build_scene
from .zbuffer_probe import check_device, device_kind

XI_BASE = (0.01, -0.005, 0.002, 0.001, -0.001, 0.001)


@torch.no_grad()
def timed_take_width(table, idx0, reps: int):
    """``reps`` chained ``index_select``s of ``table``'s rows, each next
    index set moved by the parity of the last sum (`tap_cache_probe.py:
    61-76`). Returns (last indices, the sums' total)."""
    idx, acc = idx0, torch.zeros((), dtype=torch.int64, device=idx0.device)
    for _ in range(reps):
        s = torch.sum(table.index_select(0, idx))
        idx = torch.clamp(idx0 + (s & 1), 0, table.shape[0] - 1)
        acc = acc + s
    return idx, acc


@torch.no_grad()
def timed_refresh(camera, kfs, xi0, reps: int, partial_frac: float, px_step: float,
                  refresh: bool = True):
    """``reps`` chained cached evaluations whose pose moves ~``px_step``
    pixels along x an evaluation (at the scene's 6 m mean depth), with
    guard 0: every evaluation after a drift of a pixel refreshes (unless
    ``refresh`` is False). ``partial_frac`` selects the refresh path.
    Returns (iterate, summed losses, the final cache) (`tap_cache_probe.py:
    122-147`)."""
    cache = nid.make_tap_cache(camera, se3.exp(xi0), kfs)
    dx = px_step * 6.0 / camera.intrinsic[0]
    zero = torch.zeros((), dtype=torch.float32, device=xi0.device)
    x, acc = xi0, zero
    for _ in range(reps):
        loss, cache = nid.multi_nid_loss_cached(
            camera, se3.exp(x), kfs, cache, guard_frac=0.0, allow_refresh=refresh,
            partial_frac=partial_frac)
        x = x + torch.stack([dx, 1e-12 * loss, zero, zero, zero, zero])
        acc = acc + loss
    return x, acc, cache


@torch.no_grad()
def dirty_block_share(camera, kfs, xi0, px_step: float) -> float:
    """The share of 128-point blocks (``tap_gather.PARTIAL_BLOCK``) that
    hold a live point whose knot moved a pixel or more when the pose moves
    ``px_step`` pixels from ``xi0``: the blocks a partial refresh re-takes."""
    dx = torch.zeros(6, dtype=torch.float32, device=xi0.device)
    dx[0] = px_step * 6.0 / camera.intrinsic[0]
    _, k0, i0 = nid._project_all(camera, se3.exp(xi0), kfs)
    _, k1, i1 = nid._project_all(camera, se3.exp(xi0 + dx), kfs)
    shift = torch.amax(torch.abs(k1.float() - k0.float()), dim=-1)
    drifted = (shift >= 1.0) & (i0 | i1)
    k, n = drifted.shape
    block = tap_gather.PARTIAL_BLOCK
    return float(torch.mean(torch.any(drifted[:, : n - n % block].reshape(k, -1, block), dim=2)
                            .to(torch.float32)))


def _chained(fn, reps, device, label, floor_bytes):
    """ms an evaluation of ``fn()`` (``reps`` chained evaluations a call)
    and the last call's result."""
    last = []

    def call():
        last[:] = [fn()]

    with profiling.annotate(f"tap_cache_probe/{label}"):
        t = profiling.repeat_ms(call, device, floor=profiling.floor_ms(floor_bytes * reps))
    ms = None if t["ms"] is None else t["ms"] / reps
    print(f"# {label}: {ms} ms a rep", file=sys.stderr)
    return ms, t["below_floor"], last[0]


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(prog="tap_cache_probe")
    ap.add_argument("--quick", action="store_true", help="512x384, 4 x 32,768 points")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = check_device(args.device)
    width, height, n_pts, k = QUICK if args.quick else FULL
    reps = args.reps
    out = {"device": device_kind(dev),
           "card": profiling.card() if dev.type == "cuda" else "not measured",
           "scale": f"{k}x{n_pts}@{width}x{height}"}
    below = []

    camera, kfs = build_scene(width, height, n_pts, k, dev, seed=args.seed)
    kfs = nid.prepare_keyframes(kfs)

    # --- 1. the row-width tax, and G1 / G2 on the same knots ---------------
    r = width * height
    rs = np.random.default_rng(args.seed)
    flat = np.sort(rs.integers(0, r, k * n_pts))
    idx0 = torch.from_numpy(flat).to(dev)
    for w in (2, 4, 8):
        table = torch.from_numpy(rs.integers(-(2**31), 2**31 - 1, (r, w), dtype=np.int32)).to(dev)
        ms, low, _ = _chained(lambda t=table: timed_take_width(t, idx0, reps), reps, dev,
                              f"take_w{w}", k * n_pts * (8.0 + 4 * w))
        out[f"take_w{w}_ms"] = ms
        out[f"take_w{w}_device_ms"] = profiling.median_ms(lambda t=table: t.index_select(0, idx0),
                                                          dev, hide_host=True)
        below += [f"take_w{w}"] * low
        del table
    # The same pixels as (K, N, 2) knots: keyframe j takes the j-th run of
    # the sorted indices.
    pix = idx0.reshape(k, n_pts).to(torch.int32)
    knot = torch.stack([pix % width, pix // width], -1)
    with profiling.annotate("tap_cache_probe/g1_g2"):
        out["g1_device_ms"] = profiling.median_ms(
            lambda: tap_gather.direct_take(kfs.bin_tiles, knot, width, height), dev,
            hide_host=True)
        for m in (1, 2):
            out[f"g2_m{m}_device_ms"] = profiling.median_ms(
                lambda m=m: tap_gather.wide_take(kfs.bin_tiles, knot, width, height, m), dev,
                hide_host=True)

    # --- 2. the wide table the port does not build ---------------------------
    with profiling.annotate("tap_cache_probe/b1"):
        out["b1_pack_device_ms"] = profiling.median_ms(
            lambda: tap_gather.pack_bins(kfs.bin_image), dev, hide_host=True)
    out["wide_table_m2_bytes"] = k * r * (4 + 2 * 2) * 4

    # --- 3. the partial refresh ----------------------------------------------
    xi_base = torch.tensor(XI_BASE, dtype=torch.float32, device=dev)
    eval_bytes = k * n_pts * 16.0
    for px in (0.1, 0.33):
        accs = {}
        for pf, tag in ((0.0, "full"), (1.0, "partial")):
            ms, low, (_, acc, cache) = _chained(
                lambda pf=pf: timed_refresh(camera, kfs, xi_base, reps, pf, px), reps, dev,
                f"refresh_{tag}_{px}px", eval_bytes)
            out[f"refresh_{tag}_{px}px_ms"] = ms
            out[f"refresh_{tag}_{px}px_refreshes"] = cache.refreshes
            if pf:
                out[f"refresh_partial_{px}px_count"] = cache.partials
            out[f"refresh_{tag}_{px}px_drift"] = float(cache.drift_accum) / max(cache.refreshes, 1)
            below += [f"refresh_{tag}_{px}px"] * low
            accs[tag] = float(acc)
        out[f"refresh_{px}px_losses_equal"] = accs["full"] == accs["partial"]
        out[f"dirty_block_share_{px}px"] = dirty_block_share(camera, kfs, xi_base, px)
    ms, low, _ = _chained(lambda: timed_refresh(camera, kfs, xi_base, reps, 0.0, 0.33, False),
                          reps, dev, "frozen_eval_m0", eval_bytes)
    out["frozen_eval_m0_ms"] = ms
    below += ["frozen_eval_m0"] * low

    # --- 4. the margin-2 cache -------------------------------------------------
    kfs_wide = nid.prepare_keyframes(kfs, wide_margin=2)
    for px, tag, refresh in ((0.33, "noref", False), (0.33, "inmargin", True),
                             (3.5, "refresh", True)):
        ms, low, (_, _, cache) = _chained(
            lambda px=px, refresh=refresh: timed_refresh(camera, kfs_wide, xi_base, reps, 0.0,
                                                         px, refresh),
            reps, dev, f"wide_{tag}", eval_bytes)
        out[f"wide_{tag}_ms"] = ms
        out[f"wide_{tag}_refreshes"] = cache.refreshes
        below += [f"wide_{tag}"] * low
    out["below_floor"] = below
    print(json.dumps(out))
    for px in (0.1, 0.33):
        if not out[f"refresh_{px}px_losses_equal"]:
            raise AssertionError(f"partial and full refresh losses differ at {px} px: {out}")
    return out


if __name__ == "__main__":
    main()
