"""Does the deduplicated candidate fetch change the MLS pass's cost, and
nothing else?

Counterpart of `pointcloudprocessor_tpu/tools/mls_dedup_probe.py`, on the
MLS bench's hardened corner (``bench_scene.mls_scene``). The plain moments
pass (``mls.mls_pass_plain``) runs with and without ``dedup_candidates``
(queries in cell order, one 27-cell window fetched a run of equal cells):
each timed with CUDA events (median and spread of ``--reps`` calls after a
warm-up, a median under the physical floor null), and the two must give the
same positions and normals bit for bit. Beside them stands M1
(``mls.mls_smooth`` on the card, one ``mls_moments`` launch), where dedup
changes nothing (`ops/mls.py` ``mls_smooth``): the kernel stages each
cell's window once a block itself. That is the probe's answer on Hopper,
and it checks it: ``mls_smooth`` with and without dedup, bit-equal.

Usage: python -m pointcloudprocessor_tpu_torch.tools.mls_dedup_probe [--quick] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import torch

from ..ops import mls
from ..utils import profiling
from ..utils.config import MLSConfig
from . import bench_scene
from .mls_anatomy import mls_kw
from .zbuffer_probe import check_device, device_kind

M1_NOTE = ("M1 fetches no candidates per query: each block stages every cell's 27-bucket "
           "window once (csrc/cell_window.cuh), so dedup_candidates changes nothing on the card")


@torch.no_grad()
def run_pass(points: torch.Tensor, valid: torch.Tensor, dedup: bool, kw: dict):
    """(positions, normals) of the plain moments pass (JAX
    ``_mls_smooth_jit(fit_impl="moments")``) with or without the dedup
    fetch."""
    pos, nrm, _, _ = mls.mls_pass_plain(
        points, valid, search_radius=kw["search_radius"], sqr_gauss_param=kw["sqr_gauss_param"],
        polynomial_order=kw["polynomial_order"], bucket_capacity=kw["bucket_capacity"],
        table_size=kw["table_size"], chunk_size=kw["chunk_size"], fit_impl="moments",
        dedup_candidates=dedup)
    return pos, nrm


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(prog="mls_dedup_probe")
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
    out = {"n_points": n}
    for dedup, tag in ((False, "per_query"), (True, "dedup")):
        with profiling.annotate(f"mls_dedup_probe/{tag}"):
            t = profiling.repeat_ms(lambda: run_pass(pts, valid, dedup, kw), dev,
                                    reps=args.reps, floor=floor)
        s = None if t["ms"] is None else t["ms"] / 1e3
        out[f"{tag}_s"] = s
        out[f"{tag}_calls_s"] = [c / 1e3 for c in t["calls_ms"]]
        out[f"{tag}_mpts_per_s"] = None if s is None else n / s / 1e6
    pa, na = run_pass(pts, valid, False, kw)
    pb, nb = run_pass(pts, valid, True, kw)
    out["exact"] = bool(torch.equal(pa, pb) and torch.equal(na, nb))
    out["speedup"] = (None if out["dedup_s"] is None
                      else out["per_query_s"] / out["dedup_s"])
    if dev.type == "cuda":
        cfg = MLSConfig()
        with profiling.annotate("mls_dedup_probe/m1"):
            for dedup, tag in ((False, "per_query"), (True, "dedup")):
                ms = profiling.median_ms(
                    lambda d=dedup: mls.mls_smooth(pts, valid, cfg, dedup_candidates=d), dev)
                out[f"m1_{tag}_s"] = ms / 1e3
            a = mls.mls_smooth(pts, valid, cfg, dedup_candidates=False)
            b = mls.mls_smooth(pts, valid, cfg, dedup_candidates=True)
        out["m1_dedup_exact"] = bool(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))
        out["m1_mpts_per_s"] = n / out["m1_per_query_s"] / 1e6
    out["m1_note"] = M1_NOTE
    out.update(device=device_kind(dev),
               card=profiling.card() if dev.type == "cuda" else "not measured")
    print(json.dumps(out))
    if not out["exact"] or not out.get("m1_dedup_exact", True):
        raise AssertionError(f"the dedup fetch changed the MLS pass's output: {out}")
    return out


if __name__ == "__main__":
    main()
