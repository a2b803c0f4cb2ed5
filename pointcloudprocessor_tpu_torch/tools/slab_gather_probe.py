"""Probe the building blocks of the grouped slab tap gather (K3 / K4) on the
card.

Counterpart of `pointcloudprocessor_tpu/tools/slab_gather_probe.py`. The
TPU's gather emitter paid ~10 ns an index whatever the row's width, so the
grouped design fetched few wide rows (a slab of table rows a group of G
raster-sorted points). Asked again on the card:

1. The take-width sweep (:func:`chain_take`): ``index_select`` at a
   roughly constant gathered volume as the row grows from 8 B to 32 KB — is
   the cost an index or a byte? Each case ms a take, ns an index and GB/s;
   a time under the physical floor (the gathered bytes over 3.35 TB/s) is
   null. 1b: ``torch.topk`` at the repair selection's shapes.
2. The group spans (:func:`span_stats`): for G = 16 raster-sorted points of
   bench scene 1, the table-row span percentiles and the share of groups
   whose rows overflow a window of two slabs, slabs 512-8192, at the sort
   pose (stride 1 and the coarse stride 4) and drifted to the identity.
   Integer arithmetic on the anchors: it does not depend on the hardware.

Usage: python -m pointcloudprocessor_tpu_torch.tools.slab_gather_probe
           [--quick] [--reps 8] [--skip-scene] [--device cuda]
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
from ..utils import profiling
from . import bench_scene
from .solver_sweep import FULL as SCENE_FULL
from .solver_sweep import QUICK as SCENE_QUICK
from .zbuffer_probe import check_device, device_kind

G = 16
SLABS = (512, 1024, 2048, 4096, 8192)
# (slab rows a take row, indices as a share of N): slab 1 is the per-point
# control, 1024 the grouped design's point (G = 16), 4096 the coarse one.
WIDTH_CASES = ((1, 1), (64, 16), (256, 16), (1024, 16), (4096, 64))


@torch.no_grad()
def chain_take(table, idx, reps: int):
    """``reps`` chained ``index_select``s: every gathered element summed,
    the next indices moved by the sum's parity (`slab_gather_probe.py:
    61-79`). Returns the sums' total."""
    acc = torch.zeros((), dtype=torch.int64, device=idx.device)
    for _ in range(reps):
        total = torch.sum(table.index_select(0, idx))
        idx = torch.clamp(idx + (total & 1), max=table.shape[0] - 1)
        acc = acc + total
    return acc


@torch.no_grad()
def chain_topk(flags, k_sel: int, reps: int):
    """``reps`` chained ``torch.topk`` selections of ``k_sel`` of ``flags``."""
    acc = torch.zeros((), dtype=torch.int64, device=flags.device)
    for _ in range(reps):
        vals, idxs = torch.topk(flags, k_sel)
        total = torch.sum(idxs) + torch.sum(vals)
        flags = flags + (total & 1).to(flags.dtype)
        acc = acc + total
    return acc


@torch.no_grad()
def anchors_at(camera, kfs, T: se3.SE3, stride: int = 1):
    """((K, n) int32 raster anchors knot_y * W + knot_x, (K, n) in-image
    gate) of every ``stride``-th point at ``T`` (`slab_gather_probe.py:
    186-197`)."""
    sub = nid.NIDKeyframe(points=kfs.points[:, ::stride], intensity=kfs.intensity[:, ::stride],
                          valid=kfs.valid[:, ::stride], bin_image=kfs.bin_image)
    _, knot, inb = nid._project_all(camera, T, sub)
    return knot[..., 1] * camera.width + knot[..., 0], inb


@torch.no_grad()
def span_stats(anchor: torch.Tensor, inb: torch.Tensor, group: int = G, slabs=SLABS):
    """(spans (groups,) int32, {slab: overflow share (0-dim f32)}) of
    consecutive groups of ``group`` points (each keyframe's last N % group
    dropped), as `slab_gather_probe.py:199-216` computes them: a group's span
    is its in-image anchors' max - min (0 without one); it overflows a slab
    S when an in-image anchor lies at or past 2 S beyond its min rounded
    down to S."""
    n = anchor.shape[1] - anchor.shape[1] % group
    a = anchor[:, :n].reshape(-1, group).to(torch.int64)
    ok = inb[:, :n].reshape(-1, group)
    lo = torch.amin(torch.where(ok, a, 2**31 - 1), dim=1)
    hi = torch.amax(torch.where(ok, a, -1), dim=1)
    has = torch.any(ok, dim=1)
    span = torch.where(has, hi - lo, 0).to(torch.int32)
    ovf = {}
    for slab in slabs:
        base = torch.div(lo, slab, rounding_mode="floor") * slab
        bad = torch.any(ok & (a >= base[:, None] + 2 * slab), dim=1) & has
        ovf[slab] = torch.mean(bad.to(torch.float32))
    return span, ovf


def span_row(span: torch.Tensor, ovf: dict, pose: str, stride: int) -> dict:
    s = np.sort(span.cpu().numpy())
    return {"probe": "group_span", "pose": pose, "stride": stride, "G": G,
            "p50": int(s[len(s) // 2]), "p90": int(s[int(len(s) * 0.9)]),
            "p99": int(s[int(len(s) * 0.99)]), "p999": int(s[int(len(s) * 0.999)]),
            "max": int(s[-1]),
            "overflow_frac_by_slab": {str(k): float(v) for k, v in ovf.items()}}


def span_cases(camera, kfs, T0):
    """The span rows' inputs: (pose tag, stride, anchors, gate) at the sort
    pose (stride 1 and 4) and at the identity, ``kfs`` raster-sorted at T0."""
    ident = se3.identity(kfs.points.device)
    return [(tag, stride, *anchors_at(camera, kfs, T, stride))
            for tag, T, stride in (("sort_pose", T0, 1), ("sort_pose", T0, 4),
                                   ("drifted_to_identity", ident, 1))]


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(prog="slab_gather_probe")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--skip-scene", action="store_true",
                    help="only the take-width sweep (no bench scene build)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = check_device(args.device)
    reps = args.reps
    card = profiling.card() if dev.type == "cuda" else "not measured"
    rows = []

    # 1. The take-width sweep at a roughly constant gathered volume.
    R, N = (1_228_800, 32_768) if args.quick else (12_288_000, 262_144)
    rs = np.random.default_rng(args.seed)
    for slab, share in WIDTH_CASES:
        n_idx, n_rows = N // share, R // slab
        table = torch.arange(n_rows * slab * 2, dtype=torch.int32, device=dev).reshape(
            n_rows, slab * 2)
        idx = torch.from_numpy(np.sort(rs.integers(0, n_rows, n_idx))).to(dev)
        bytes_out = n_idx * slab * 2 * 4
        with profiling.annotate(f"slab_gather_probe/take_slab{slab}"):
            t = profiling.repeat_ms(lambda: chain_take(table, idx, reps), dev,
                                    floor=profiling.floor_ms(bytes_out * reps))
        ms = None if t["ms"] is None else t["ms"] / reps
        row = {"probe": "take_width", "slab_rows": slab, "n_indices": n_idx,
               "row_bytes": slab * 2 * 4, "gathered_mb": bytes_out / 1e6, "ms": ms,
               "spread_ms": None if t["spread_ms"] is None else t["spread_ms"] / reps,
               "ns_per_index": None if ms is None else ms / n_idx * 1e6,
               "gb_per_s": None if ms is None else bytes_out / ms / 1e6,
               "below_floor": t["below_floor"], "card": card}
        rows.append(row)
        print(json.dumps(row))
        del table
    # 1b. top-k at the repair selection's shapes.
    n_flags = 16_384 if args.quick else 131_072
    flags = torch.from_numpy(rs.integers(0, 2, n_flags).astype(np.int32)).to(dev)
    for k_sel in (256, 2048, 8192):
        with profiling.annotate(f"slab_gather_probe/topk{k_sel}"):
            t = profiling.repeat_ms(lambda: chain_topk(flags, k_sel, reps), dev)
        row = {"probe": "top_k", "n": n_flags, "k": k_sel,
               "ms": None if t["ms"] is None else t["ms"] / reps}
        rows.append(row)
        print(json.dumps(row))

    # 2. Group spans on bench scene 1, the points raster-sorted at T0.
    if not args.skip_scene:
        width, height, n_map, n_cull, k = SCENE_QUICK if args.quick else SCENE_FULL
        camera, kfs, T0 = bench_scene.nid_scene(width, height, n_map, n_cull, k, dev, 1,
                                                args.seed)
        kfs = nid.sort_by_raster(camera, T0, kfs)
        for tag, stride, anchor, inb in span_cases(camera, kfs, T0):
            span, ovf = span_stats(anchor, inb)
            # The same statistics of the same anchors on the CPU: integer
            # arithmetic, so the same bits.
            span_c, ovf_c = span_stats(anchor.cpu(), inb.cpu())
            row = span_row(span, ovf, tag, stride)
            row["cpu_equal"] = bool(torch.equal(span.cpu(), span_c) and all(
                float(ovf[s]) == float(ovf_c[s]) for s in SLABS))
            rows.append(row)
            print(json.dumps(row))
    spans_cpu_equal = all(r["cpu_equal"] for r in rows if r["probe"] == "group_span")
    print(json.dumps({"metric": "slab_gather_probe", "rows": len(rows),
                      "spans_cpu_equal": spans_cpu_equal, "device": device_kind(dev),
                      "card": card}))
    if not spans_cpu_equal:
        raise AssertionError("group spans on the device differ from the CPU's")
    return {"rows": rows, "spans_cpu_equal": spans_cpu_equal}


if __name__ == "__main__":
    main()
