"""Where does an NID evaluation's time go on the card: host or device?

Counterpart of `pointcloudprocessor_tpu/tools/nid_bisect.py`, which split
one XLA fusion of the TPU's evaluation into stripped-down variants. On the
card the question is another: one value+grad evaluation takes 12-17 ms of
wall against ~2.9 ms of CUDA time (PERF.md §5), so what holds it is the
host. This harness times the same variants, each on the scene of
:mod:`.nid_locality`, and splits each evaluation (``profiling.eval_split``)
into wall, host, device-busy ms, kernel launches and host syncs:

  project            : transform + project + anchors, reduced
  gather_take        : + the tap rows (G1, ``tap_gather.direct_take``), in
                       map order and raster-sorted
  gather_sorted_hint : JAX's ``lax.gather`` with ``indices_are_sorted`` has
                       no torch counterpart: G1 on raster-sorted knots
                       stands in for it (the output says so)
  onehot_marginal    : + the point-bin marginal by one-hot sums
  forward            : ``multi_nid_loss`` without gradient, map / sorted
  value_grad         : ``multi_nid_loss`` with its gradient (K1, K2, G1)
  guarded_value_grad : the same through the solve's trust-region guard
                       (``refine._guarded_objective``: one host sync)
  frozen_value_grad  : the frozen-tap cache's evaluation under the guard
                       (``multi_nid_loss_cached`` at guard 0.75, the
                       headline's fine phase)
  per_keyframe       : the per-keyframe solve's evaluation
                       (``refine._guarded_per_keyframe``: (K,) NIDs and
                       gradients to the host)

The chained variants also give ms an evaluation over ``--reps`` chained
calls (CUDA events, median and spread of 3 repeats after a warm-up; a time
under the physical floor is null and named under ``below_floor``). Every
timed region carries a ``torch.profiler`` label ``nid_bisect/<variant>``.

Usage:
  python -m pointcloudprocessor_tpu_torch.tools.nid_bisect [--quick] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import torch
import torch.nn.functional as F

from ..core import se3
from ..models import camera as cam
from ..opt import nid, refine
from ..ops import tap_gather
from ..utils import profiling
from ..utils.numeric import to_int32
from .nid_locality import FULL, QUICK, build_scene, timed_val_grad
from .zbuffer_probe import check_device, device_kind

TRUST_TRANS, TRUST_ROT = 0.2, 0.034907  # refine_pose's defaults
HINT_NOTE = ("no torch counterpart of lax.gather's indices_are_sorted hint: "
             "G1 (tap_gather.direct_take) on raster-sorted knots stands in for it")


def _project_parts(camera, T, points):
    """(proj (K, N, 2), knot (K, N, 2) int32, clipped anchor (K, N) int32)."""
    proj = cam.project(camera, se3.transform_points(T, points))
    knot = to_int32(torch.floor(proj.detach()))
    return proj, knot, tap_gather.anchors(knot, camera.width, camera.height)


def make_variant(name: str):
    """``run(camera, kfs, xi0, reps) -> (iterate, accumulated sums)``:
    ``reps`` chained evaluations of a stripped-down variant, each moving the
    pose by 1e-12 of its result (`nid_bisect.py:46-93`). ``kfs`` must carry
    ``bin_tiles`` (``nid.prepare_keyframes``)."""
    if name not in ("project", "gather_take", "gather_sorted_hint", "onehot_marginal"):
        raise ValueError(name)

    @torch.no_grad()
    def run(camera, kfs, xi0, reps: int):
        x, acc = xi0, torch.zeros((), dtype=torch.float32, device=xi0.device)
        for _ in range(reps):
            proj, knot, anchor = _project_parts(camera, se3.exp(x), kfs.points)
            if name == "project":
                per_kf = torch.sum(proj, dim=(1, 2)) + torch.sum(anchor.to(torch.float32), dim=1)
            elif name in ("gather_take", "gather_sorted_hint"):
                taps = tap_gather.direct_take(kfs.bin_tiles, knot, camera.width, camera.height)
                per_kf = torch.sum(taps.to(torch.float32), dim=(1, 2))
            else:
                bins = 16
                bp = torch.clamp(to_int32(kfs.intensity * bins), 0, bins - 1)
                hp = torch.sum(F.one_hot(bp.long(), bins).to(torch.float32), dim=1)
                per_kf = torch.sum(hp, dim=1) + torch.sum(proj, dim=(1, 2))
            s = torch.sum(per_kf)
            x, acc = x + 1e-12 * s, acc + s
        return x, acc

    return run


@torch.no_grad()
def forward_only(camera, kfs, xi0, reps: int):
    """``reps`` chained ``multi_nid_loss`` values (`nid_bisect.py:96-104`)."""
    x, acc = xi0, torch.zeros((), dtype=torch.float32, device=xi0.device)
    for _ in range(reps):
        v = nid.multi_nid_loss(camera, se3.exp(x), kfs)
        x, acc = x + 1e-12 * v, acc + v
    return x, acc


def guarded_value_grad(camera, kfs):
    """One evaluation as the plain solve makes it: ``xi -> (value, grad)``
    at exp(xi) through ``refine._guarded_objective``."""
    vg = refine._guarded_objective(
        TRUST_TRANS, TRUST_ROT, lambda T, c: (nid.multi_nid_loss(camera, T, kfs), c))
    ident = se3.identity(kfs.points.device)
    return lambda xi: vg(xi, ident, None)[:2]


def frozen_value_grad(camera, kfs, guard: float = 0.75):
    """One evaluation as the headline's fine phase makes it: the guarded
    frozen-tap objective over a cache gathered at the identity."""
    ident = se3.identity(kfs.points.device)
    cache = [nid.make_tap_cache(camera, ident, kfs)]

    def loss(T, c):
        return nid.multi_nid_loss_cached(camera, T, kfs, c, guard_frac=guard)

    vg = refine._guarded_objective(TRUST_TRANS, TRUST_ROT, loss)

    def call(xi):
        v, g, cache[0] = vg(xi, ident, cache[0])
        return v, g

    return call


def per_keyframe_value_grad(camera, kfs):
    """One evaluation as the per-keyframe solve makes it: (K, 6) host
    tangents -> (K,) values and (K, 6) gradients on the host."""
    k = kfs.points.shape[0]
    ident = se3.identity(kfs.points.device, batch_shape=(k,))
    return refine._guarded_per_keyframe(camera, kfs, 16, TRUST_TRANS, TRUST_ROT, ident)


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(prog="nid_bisect")
    ap.add_argument("--quick", action="store_true", help="512x384, 4 x 32,768 points")
    ap.add_argument("--reps", type=int, default=10, help="chained evaluations a timing")
    ap.add_argument("--split-reps", type=int, default=10, help="evaluations a split")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = check_device(args.device)
    width, height, n_pts, k = QUICK if args.quick else FULL

    camera, kfs = build_scene(width, height, n_pts, k, dev, seed=args.seed)
    kfs_sorted = nid.prepare_keyframes(nid.sort_by_raster(camera, se3.identity(dev), kfs))
    kfs = nid.prepare_keyframes(kfs)
    print("# scene built", file=sys.stderr)
    xi0 = torch.zeros(6, dtype=torch.float32, device=dev)
    pts = k * n_pts
    chained = {
        "project": (make_variant("project"), kfs, 12.0),
        "gather_take": (make_variant("gather_take"), kfs, 20.0),
        "gather_take_sorted": (make_variant("gather_take"), kfs_sorted, 20.0),
        "gather_hint_sorted": (make_variant("gather_sorted_hint"), kfs_sorted, 20.0),
        "onehot_marginal": (make_variant("onehot_marginal"), kfs, 16.0),
        "forward": (forward_only, kfs, 16.0),
        "forward_sorted": (forward_only, kfs_sorted, 16.0),
        "value_grad": (timed_val_grad, kfs, 16.0),
        "value_grad_sorted": (timed_val_grad, kfs_sorted, 16.0),
    }
    single = {
        "guarded_value_grad": guarded_value_grad(camera, kfs),
        "frozen_value_grad": frozen_value_grad(camera, kfs),
        "per_keyframe": per_keyframe_value_grad(camera, kfs),
    }
    rows = []
    for name, (fn, kk, bytes_a_point) in chained.items():
        with profiling.span(f"nid_bisect/{name}"):
            t = profiling.repeat_ms(lambda: fn(camera, kk, xi0, args.reps), dev,
                                    floor=profiling.floor_ms(pts * bytes_a_point * args.reps))
            split = profiling.eval_split(lambda: fn(camera, kk, xi0, 1), dev, args.split_reps)
        row = {"variant": name, **split,
               "chain_ms": None if t["ms"] is None else t["ms"] / args.reps,
               "chain_spread_ms": None if t["spread_ms"] is None else t["spread_ms"] / args.reps,
               "below_floor": t["below_floor"]}
        if name == "gather_hint_sorted":
            row["note"] = HINT_NOTE
        rows.append(row)
        print(json.dumps(row))
    xk = torch.zeros((k, 6), dtype=torch.float32)
    for name, fn in single.items():
        arg = xk if name == "per_keyframe" else xi0
        with profiling.span(f"nid_bisect/{name}"):
            split = profiling.eval_split(lambda: fn(arg), dev, args.split_reps)
        row = {"variant": name, **split}
        rows.append(row)
        print(json.dumps(row))
    # The harness's value+grad is multi_nid_loss's own evaluation: at the
    # same pose the value must be the same bits.
    v_chain = timed_val_grad(camera, kfs, xi0, 1)[1]
    v_loss = nid.multi_nid_loss(camera, se3.exp(xi0), kfs).detach()
    by = {r["variant"]: r for r in rows}
    vg = by["value_grad"]
    out = {
        "metric": "nid_eval_split",
        "value_grad_wall_ms": vg["wall_ms"],
        "value_grad_host_ms": vg["host_ms"],
        "value_grad_device_busy_ms": vg["device_busy_ms"],
        "value_grad_idle_share": vg["idle_share"],
        "value_grad_launches": vg["launches"],
        "value_grad_syncs": vg["syncs"],
        "per_keyframe_wall_ms": by["per_keyframe"]["wall_ms"],
        "per_keyframe_host_ms": by["per_keyframe"]["host_ms"],
        "per_keyframe_device_busy_ms": by["per_keyframe"]["device_busy_ms"],
        "per_keyframe_launches": by["per_keyframe"]["launches"],
        "per_keyframe_syncs": by["per_keyframe"]["syncs"],
        "value_grad_equals_multi_nid_loss": bool(torch.equal(v_chain, v_loss)),
        "nid": float(v_loss),
        "gather_hint_sorted_note": HINT_NOTE,
        "below_floor": [r["variant"] for r in rows if r.get("below_floor")],
        "device": device_kind(dev),
        "card": profiling.card() if dev.type == "cuda" else "not measured",
        "scale": f"{k}x{n_pts}@{width}x{height}",
    }
    print(json.dumps(out))
    if not out["value_grad_equals_multi_nid_loss"]:
        raise AssertionError(f"value+grad chain {float(v_chain)!r} != multi_nid_loss "
                             f"{float(v_loss)!r}")
    return {"rows": rows, **out}


if __name__ == "__main__":
    main()
