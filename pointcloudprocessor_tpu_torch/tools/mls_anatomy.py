"""MLS cost anatomy: where the time of the MLS pass goes, stage by stage.

Counterpart of `pointcloudprocessor_tpu/tools/mls_anatomy.py`, on the MLS
bench's hardened corner (``bench_scene.mls_scene``). It times nested
prefixes of the pass through the port's plain functions, as the JAX tool
times them (`mls_anatomy.py:60-160`):

  grid     : the hash grid with coordinate planes (``knn.build(...,
             store_points=True)``)
  cand_pts : + the 27 cells' coordinate rows of every query
  cand     : + the candidate indices and coordinates, the radius mask
             (``knn._candidates_with_points``)
  neigh    : + the top-K selection (``knn.radius_neighbors_with_points``)
  fit      : + the top-K fits (``mls.fit_surfaces``)
  full     : + the projection (``mls.project_onto``)
  m_cand   : the moments path's candidate planes (``knn.candidate_points``)
  m_fit    : + the moments fits (``mls.fit_surfaces_moments``)
  m_full   : + the projection: the plain moments pass

Queries go in chunks of 16,384 (the last padded with zeros, as JAX pads
it); each stage is reduced to one sum. Successive differences attribute the
cost. On the card beside them stands what the main path runs: ``knn.build``
(no planes), the grid's own sort order as the schedule (no device work) and
M1 (``mls.mls_moments_cuda``) as one launch, and the whole ``mls_smooth``
call. Stage times: CUDA events, median and spread of ``--reps`` calls after
a warm-up (seconds); a median under the physical floor (the points' bytes
over 3.35 TB/s) is null. Each stage's region carries the profiler label
``mls_anatomy/<stage>``.

Usage: python -m pointcloudprocessor_tpu_torch.tools.mls_anatomy [--quick] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import torch
import torch.nn.functional as F

from ..ops import knn, mls
from ..ops.voxel import voxel_coords, voxel_hash
from ..utils import profiling
from ..utils.config import MLSConfig
from . import bench_scene
from .zbuffer_probe import check_device, device_kind

STAGES = ("grid", "cand_pts", "cand", "neigh", "fit", "full", "m_cand", "m_fit", "m_full")
CHUNK = 16384


def mls_kw(n: int, cfg: MLSConfig = MLSConfig()) -> dict:
    """The pass's parameters at ``n`` points (`mls_anatomy.py:63-72`)."""
    return dict(search_radius=float(cfg.search_radius), max_neighbors=int(cfg.max_neighbors),
                sqr_gauss_param=float(cfg.sqr_gauss_param),
                polynomial_order=int(cfg.polynomial_order),
                bucket_capacity=int(cfg.bucket_capacity), table_size=max(n // 2, 1024),
                chunk_size=CHUNK)


def _chunk_value(grid, points, q, stage: str, kw: dict) -> torch.Tensor:
    """One chunk's reduced stage output (the body of `mls_anatomy.py:82-156`)."""
    radius = kw["search_radius"]
    if stage.startswith("m_"):
        cx, cy, cz = knn.candidate_points(grid, q)
        if stage == "m_cand":
            return torch.sum(torch.where(torch.isfinite(cz), cx + cy + cz, 0.0))
        surf = mls.fit_surfaces_moments(q, cx, cy, cz, radius, kw["sqr_gauss_param"],
                                        kw["polynomial_order"])
        if stage == "m_fit":
            return torch.sum(surf.origin) + torch.sum(surf.coeffs) + torch.sum(surf.normal)
        pos, nrm = mls.project_onto(surf, q)
        return torch.sum(pos) + torch.sum(nrm)
    if stage == "cand":
        cand, cx, cy, cz = knn._candidates_with_points(grid, points, q)
        dx, dy, dz = cx - q[:, 0:1], cy - q[:, 1:2], cz - q[:, 2:3]
        d2 = dx * dx + dy * dy + dz * dz
        r2 = torch.tensor(radius * radius, dtype=d2.dtype, device=d2.device)
        inr = (cand >= 0) & (d2 <= r2)
        return torch.sum(torch.where(inr, d2, 0.0)) + torch.sum(cand.to(torch.float32))
    if stage == "cand_pts":
        off = torch.tensor(knn.OFFSETS, dtype=torch.int32, device=q.device)
        cells = voxel_coords(q, grid.cell_size)[:, None, :] + off[None]
        rows = grid.bucket_points[voxel_hash(cells, grid.table_size).long()]
        return torch.sum(torch.where(torch.isfinite(rows), rows, 0.0))
    idx, npts, _, ok = knn.radius_neighbors_with_points(grid, points, q, radius,
                                                        kw["max_neighbors"], select="approx")
    if stage == "neigh":
        return (torch.sum(ok.to(torch.float32))
                + torch.sum(torch.where(ok[..., None], npts, 0.0)))
    surf = mls.fit_surfaces(points, q, idx, ok, kw["sqr_gauss_param"], kw["polynomial_order"],
                            neigh_pts=npts)
    if stage == "fit":
        return torch.sum(surf.origin) + torch.sum(surf.coeffs) + torch.sum(surf.normal)
    pos, nrm = mls.project_onto(surf, q)
    return torch.sum(pos) + torch.sum(nrm)


@torch.no_grad()
def stage_value(points: torch.Tensor, valid: torch.Tensor, stage: str, kw: dict) -> torch.Tensor:
    """The pass run up to ``stage`` on every point, reduced to a 0-dim f32
    sum (JAX's ``stage_fn``): the grid, then the queries (the points padded
    with zeros to whole chunks) a chunk at a time, the chunks' sums summed."""
    if stage not in STAGES:
        raise ValueError(f"stage {stage!r} not in {STAGES}")
    grid = knn.build(points, valid, kw["search_radius"], kw["table_size"], kw["bucket_capacity"],
                     store_points=True)
    if stage == "grid":
        return grid.counts.sum().to(torch.float32)
    cs = kw["chunk_size"]
    qp = F.pad(points, (0, 0, 0, (-points.shape[0]) % cs))
    return torch.sum(torch.stack([_chunk_value(grid, points, qp[s: s + cs], stage, kw)
                                  for s in range(0, qp.shape[0], cs)]))


def _seconds(t: dict):
    return None if t["ms"] is None else t["ms"] / 1e3


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(prog="mls_anatomy")
    ap.add_argument("--quick", action="store_true", help="100,000 points")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = check_device(args.device)
    n = 100_000 if args.quick else 1_000_000
    kw = mls_kw(n)
    pts = torch.from_numpy(bench_scene.mls_scene(n)).to(dev)
    valid = torch.ones((n,), dtype=torch.bool, device=dev)
    floor = profiling.floor_ms(n * 12.0)

    res, rows = {}, []
    for stage in STAGES:
        with profiling.annotate(f"mls_anatomy/{stage}"):
            t = profiling.repeat_ms(lambda: stage_value(pts, valid, stage, kw), dev,
                                    reps=args.reps, floor=floor)
        res[stage] = _seconds(t)
        row = {"stage": stage, "s": res[stage], "calls": [c / 1e3 for c in t["calls_ms"]],
               "spread_s": None if t["spread_ms"] is None else t["spread_ms"] / 1e3,
               "below_floor": t["below_floor"]}
        rows.append(row)
        print(json.dumps(row))

    def diff(a, b):
        return None if res[a] is None or res[b] is None else res[a] - res[b]

    out = {
        "metric": "mls_anatomy_s",
        "n_points": n,
        "grid_build": res["grid"],
        "coord_row_gather": diff("cand_pts", "grid"),
        "index_row_gather_and_mask": diff("cand", "cand_pts"),
        "selection_topk": diff("neigh", "cand"),
        "fits": diff("fit", "neigh"),
        "projection": diff("full", "fit"),
        "full": res["full"],
        "moments_coord_gather": diff("m_cand", "grid"),
        "moments_fit": diff("m_fit", "m_cand"),
        "moments_projection": diff("m_full", "m_fit"),
        "moments_full": res["m_full"],
        "moments_mpts_per_s": None if res["m_full"] is None else n / res["m_full"] / 1e6,
    }
    if dev.type == "cuda":
        # What the main path runs (mls.mls_smooth on the card): the grid
        # without planes, its sort order as the schedule, M1 in one launch.
        k5 = {key: kw[key] for key in ("search_radius", "sqr_gauss_param", "polynomial_order",
                                       "bucket_capacity", "table_size")}
        with profiling.annotate("mls_anatomy/m1_path"):
            def build():
                return knn.build(pts, valid, kw["search_radius"], kw["table_size"],
                                 kw["bucket_capacity"])

            grid = build()
            out["path_build_device_ms"] = profiling.median_ms(build, dev, hide_host=True)
            out["path_m1_device_ms"] = profiling.median_ms(
                lambda: mls.mls_moments_cuda(pts, valid, grid=grid, **k5), dev, hide_host=True)
            out["path_mls_smooth_call_ms"] = profiling.median_ms(
                lambda: mls.mls_smooth(pts, valid, MLSConfig()), dev)
        out["path_schedule"] = "the grid's own sort order (HashGrid.order): no device work"
        out["path_mpts_per_s"] = n / out["path_mls_smooth_call_ms"] / 1e3
    out.update(device=device_kind(dev),
               card=profiling.card() if dev.type == "cuda" else "not measured",
               below_floor=[r["stage"] for r in rows if r["below_floor"]])
    print(json.dumps(out))
    return {"rows": rows, **out}


if __name__ == "__main__":
    main()
