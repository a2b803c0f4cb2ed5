"""Does point order change what an NID evaluation costs on the card?

Counterpart of `pointcloudprocessor_tpu/tools/nid_locality.py`, which asked
it of the TPU's gather emitter. Every evaluation of the NID objective takes
one packed 4x4 tap row per point; culled points arrive in map order, so at
the bench's scale (8 x 262,144 points) the rows come from effectively random
pixels. This harness times, on the card, one value+grad evaluation of
``opt/nid.multi_nid_loss`` with the points in map order and in projected
raster order (``nid.sort_by_raster``), and the tap fetch alone:

  gather     : project + anchor + ``index_select`` of the rows of a
               ``nid.build_tap_table`` table (the JAX tool's ``jnp.take``)
  gather_flat: the production ``nid._gather_taps`` (the direct take, G1,
               or the grouped takes K3 / K4 over the row table)
  G1 alone   : ``tap_gather.direct_take``'s device time on map-order and on
               raster-order knots, beside ``index_select`` of the same rows
               (PERF.md's G1 row: 0.0443 ms at the sort pose against 0.0478
               in map order on the smoke scene)

Each case chains ``--reps`` evaluations in a Python loop (each iterate moves
the pose by the last result, as an optimizer's would), timed with CUDA
events after a warm-up, median and spread of 3 repeats; a time below the
physical floor (the points' bytes over 3.35 TB/s) is printed as null and
named under ``below_floor``. The grouped and streamed value+grad chains must
equal the direct take's bit for bit (the accumulators ``acc_*``).

Usage:
  python -m pointcloudprocessor_tpu_torch.tools.nid_locality [--quick] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import numpy as np
import torch

from ..core import se3
from ..models import camera as cam
from ..opt import nid
from ..ops import tap_gather
from ..utils import profiling
from ..utils.numeric import to_int32
from .zbuffer_probe import check_device, device_kind

QUICK = (512, 384, 32_768, 4)  # width, height, points a keyframe, keyframes
FULL = (4096, 3000, 262_144, 8)


def build_scene(width: int, height: int, n_pts: int, k: int, device="cuda", draws=None,
                seed: int = 0):
    """K synthetic camera-frame keyframes (`nid_locality.py:39-83`): points
    back-projected from uniform pixels at uniform depths in [4, 8] m (map
    order is random raster order, as the bench's argsort-culled sets), a
    smooth intensity field and the same field's 16-bin image. ``draws`` (u,
    v, z), each (K, N) f32, gives the pixels and depths (a test passes
    JAX's); None draws them with numpy from ``seed``. Returns (camera,
    keyframes) on ``device``."""
    f_px = 4818.2 * (width / 4096.0)
    camera = cam.create_camera("pinhole", (f_px, f_px, width / 2.0, height / 2.0), (0.0,) * 5,
                               width, height, device)
    if draws is None:
        rs = np.random.default_rng(seed)
        draws = (rs.uniform(2.0, width - 3.0, (k, n_pts)),
                 rs.uniform(2.0, height - 3.0, (k, n_pts)), rs.uniform(4.0, 8.0, (k, n_pts)))
    u, v, z = (torch.as_tensor(np.asarray(a, np.float32), device=device) for a in draws)
    f = torch.tensor(f_px, dtype=torch.float32, device=device)  # exact division on the card too
    x = (u - width / 2.0) / f * z
    y = (v - height / 2.0) / f * z
    inten = torch.clamp(0.5 + 0.25 * torch.sin(0.01 * u) + 0.25 * torch.cos(0.013 * v), 0.0, 1.0)
    uu = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    vv = torch.arange(height, dtype=torch.float32, device=device)[:, None]
    img = torch.clamp(0.5 + 0.25 * torch.sin(0.01 * uu) + 0.25 * torch.cos(0.013 * vv), 0.0, 1.0)
    bins = nid.quantize_image(img, 16)
    kfs = nid.NIDKeyframe(
        points=torch.stack([x, y, z], -1),
        intensity=inten,
        valid=torch.ones((k, n_pts), dtype=torch.bool, device=device),
        bin_image=bins.expand(k, height, width).contiguous(),
    )
    return camera, kfs


def timed_val_grad(camera, kfs, xi0, reps: int, use_grouped=None):
    """``reps`` chained value+grad evaluations of ``multi_nid_loss``, each
    iterate moved by 1e-7 of the last gradient (`nid_locality.py:86-102`).
    Returns (the last iterate, the sum of the values). ``kfs`` should carry
    what the gather reads (``nid.prepare_keyframes``)."""
    x, acc = xi0, torch.zeros((), dtype=torch.float32, device=xi0.device)
    for _ in range(reps):
        xr = x.detach().requires_grad_(True)
        v = nid.multi_nid_loss(camera, se3.exp(xr), kfs, use_grouped=use_grouped)
        (g,) = torch.autograd.grad(v, xr)
        x, acc = x + 1e-7 * g, acc + v.detach()
    return x, acc


@torch.no_grad()
def timed_gather_flat(camera, kfs, xi0, reps: int, use_grouped=None):
    """``reps`` chained gathers through the production ``nid._gather_taps``
    (the direct take, or a grouped take), each reduced to a sum of its rows
    (`nid_locality.py:105-122`). Returns (iterate, accumulated sums)."""
    x, acc = xi0, torch.zeros((), dtype=torch.float32, device=xi0.device)
    for _ in range(reps):
        _, knot, inl = nid._project_all(camera, se3.exp(x), kfs)
        s = torch.sum(nid._gather_taps(camera, kfs, knot, inl, use_grouped).to(torch.float32))
        x, acc = x + 1e-12 * s, acc + s
    return x, acc


def table_anchors(camera, T, kfs):
    """(K, N) int32 clipped anchor pixels of the points at ``T``."""
    proj = cam.project(camera, se3.transform_points(T, kfs.points))
    return tap_gather.anchors(to_int32(torch.floor(proj)), camera.width, camera.height)


@torch.no_grad()
def timed_gather(camera, kfs, xi0, reps: int):
    """``reps`` chained gathers of the rows of the (K, H*W, 2) tap table
    (``kfs.tap_rows``) at the clipped anchors with ``index_select``, the
    JAX tool's ``jnp.take`` (`nid_locality.py:125-147`)."""
    k, r, c = kfs.tap_rows.shape
    table = kfs.tap_rows.reshape(k * r, c)
    base = torch.arange(k, dtype=torch.int64, device=xi0.device)[:, None] * r
    x, acc = xi0, torch.zeros((), dtype=torch.float32, device=xi0.device)
    for _ in range(reps):
        flat = (table_anchors(camera, se3.exp(x), kfs) + base).reshape(-1)
        taps = table.index_select(0, flat).reshape(k, -1, c)
        s = torch.sum(torch.sum(taps.to(torch.float32), dim=(1, 2)))
        x, acc = x + 1e-12 * s, acc + s
    return x, acc


def run_case(fn, camera, kfs, reps: int, label: str, device, floor_bytes: float):
    """Time ``fn(camera, kfs, xi0, reps)`` (3 repeats after a warm-up, under
    the profiler label ``label``): ({"ms": ms an evaluation or None, ...},
    the accumulator of the last call as a float)."""
    xi0 = torch.zeros(6, dtype=torch.float32, device=device)
    last = []

    def call():
        last[:] = [fn(camera, kfs, xi0, reps)]

    with profiling.span(f"nid_locality/{label}"):
        t = profiling.repeat_ms(call, device, floor=profiling.floor_ms(floor_bytes * reps))
    acc = float(last[0][1])
    per = {"ms": None if t["ms"] is None else t["ms"] / reps,
           "calls_ms": [c / reps for c in t["calls_ms"]], "below_floor": t["below_floor"]}
    print(f"# {label}: {per['ms']} ms an evaluation (acc {acc:.6f})", file=sys.stderr)
    return per, acc


def g1_device_ms(camera, kfs, device):
    """Device times (median_ms, hide_host) of the tap fetch alone at the
    identity: G1 (``direct_take``) and ``index_select`` of the table rows."""
    with torch.no_grad():
        _, knot, _ = nid._project_all(camera, se3.identity(device=device), kfs)
        k, r, c = kfs.tap_rows.shape
        flat = (tap_gather.anchors(knot, camera.width, camera.height).long()
                + torch.arange(k, device=device)[:, None] * r).reshape(-1)
        table = kfs.tap_rows.reshape(k * r, c)
        g1 = profiling.median_ms(
            lambda: tap_gather.direct_take(kfs.bin_tiles, knot, camera.width, camera.height),
            device, hide_host=True)
        sel = profiling.median_ms(lambda: table.index_select(0, flat), device, hide_host=True)
    return g1, sel


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(prog="nid_locality")
    ap.add_argument("--quick", action="store_true", help="512x384, 4 x 32,768 points")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = check_device(args.device)
    width, height, n_pts, k = QUICK if args.quick else FULL

    camera, kfs_rand = build_scene(width, height, n_pts, k, dev, seed=args.seed)
    kfs_sorted = nid.sort_by_raster(camera, se3.identity(device=dev), kfs_rand)
    # grouped=True builds the (K, H*W, 2) row table that K3 / K4 and the
    # index_select case read; without it _gather_taps would take the direct
    # take and the grouped cases would measure nothing.
    kfs_rand = nid.prepare_keyframes(kfs_rand, grouped=True)
    kfs_sorted = nid.prepare_keyframes(kfs_sorted, grouped=True)
    print("# scene built", file=sys.stderr)

    r = args.reps
    pts = k * n_pts
    val_bytes, gather_bytes = pts * 16.0, pts * 20.0  # xyz + intensity; xyz + one row

    def grouped(fn, g):
        return lambda c, kk, x, rr: fn(c, kk, x, rr, use_grouped=g)

    cases = [
        ("gather_map", timed_gather, kfs_rand, gather_bytes),
        ("gather_raster", timed_gather, kfs_sorted, gather_bytes),
        ("eval_map", timed_val_grad, kfs_rand, val_bytes),
        ("eval_raster", timed_val_grad, kfs_sorted, val_bytes),
        ("gather_direct_map", grouped(timed_gather_flat, False), kfs_rand, gather_bytes),
        ("gather_grouped_raster", grouped(timed_gather_flat, True), kfs_sorted, gather_bytes),
        ("gather_grouped_map", grouped(timed_gather_flat, True), kfs_rand, gather_bytes),
        ("gather_streamed_raster", grouped(timed_gather_flat, "streamed"), kfs_sorted,
         gather_bytes),
        ("eval_grouped_raster", grouped(timed_val_grad, True), kfs_sorted, val_bytes),
        ("eval_streamed_raster", grouped(timed_val_grad, "streamed"), kfs_sorted, val_bytes),
        ("eval_direct_raster", grouped(timed_val_grad, False), kfs_sorted, val_bytes),
    ]
    times, accs = {}, {}
    for name, fn, kk, nbytes in cases:
        times[name], accs[name] = run_case(fn, camera, kk, r, name, dev, nbytes)
    g1_map, sel_map = g1_device_ms(camera, kfs_rand, dev)
    g1_raster, sel_raster = g1_device_ms(camera, kfs_sorted, dev)
    ms = {name: t["ms"] for name, t in times.items()}

    def ratio(a, b):
        return None if a is None or b is None else a / b

    out = {
        "metric": "nid_eval_ms",
        "map_order_ms": ms["eval_map"],
        "raster_order_ms": ms["eval_raster"],
        "speedup": ratio(ms["eval_map"], ms["eval_raster"]),
        "gather_map_ms": ms["gather_map"],
        "gather_raster_ms": ms["gather_raster"],
        "direct_gather_map_ms": ms["gather_direct_map"],
        "grouped_gather_ms": ms["gather_grouped_raster"],
        "grouped_gather_fallback_ms": ms["gather_grouped_map"],
        "streamed_gather_ms": ms["gather_streamed_raster"],
        "grouped_eval_ms": ms["eval_grouped_raster"],
        "streamed_eval_ms": ms["eval_streamed_raster"],
        "direct_eval_ms": ms["eval_direct_raster"],
        "grouped_eval_speedup": ratio(ms["eval_direct_raster"], ms["eval_grouped_raster"]),
        "streamed_eval_speedup": ratio(ms["eval_direct_raster"], ms["eval_streamed_raster"]),
        "g1_map_device_ms": g1_map,
        "g1_raster_device_ms": g1_raster,
        "index_select_map_device_ms": sel_map,
        "index_select_raster_device_ms": sel_raster,
        "acc_grouped": accs["eval_grouped_raster"],
        "acc_streamed": accs["eval_streamed_raster"],
        "acc_direct": accs["eval_direct_raster"],
        "below_floor": [name for name, t in times.items() if t["below_floor"]],
        "device": device_kind(dev),
        "card": profiling.card() if dev.type == "cuda" else "not measured",
        "scale": f"{k}x{n_pts}@{width}x{height}",
    }
    print(json.dumps(out))
    # The grouped and streamed takes equal the direct take on every live
    # row, so the chained objective accumulators must agree bit for bit.
    if not accs["eval_grouped_raster"] == accs["eval_streamed_raster"] == accs[
            "eval_direct_raster"]:
        raise AssertionError(f"grouped / streamed / direct value+grad chains differ: {out}")
    return out


if __name__ == "__main__":
    main()
