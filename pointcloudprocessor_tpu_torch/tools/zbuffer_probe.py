"""Probe of the z-buffer scatter-min: the ``zmin`` kernel against the plain
torch scatter it replaces.

Counterpart of `pointcloudprocessor_tpu/tools/zbuffer_probe.py`, which asked
whether a Pallas scalar-loop kernel (K5, `_zmin_kernel`) beats XLA's
scatter-min on the TPU. Here K5 is the CUDA kernel ``zmin`` of
`csrc/zbuffer.cu`, and :func:`zmin_tiles` keeps `pallas_zmin`'s output
contract: a (rows, 128) f32 buffer, rows = ceil(ceil(n_cells/128)/8)*8,
every slot starting at 3.0e38.

Timed on the card, each the median of 20 CUDA-event timings:

  plain              : the twin, ``scatter_reduce_(..., "amin")`` into an
                       (n_cells + 1,) buffer
  plain_with_gather  : + the per-point cell-min gather back (the production
                       shape of the twin of `ops/zbuffer.cull_mask_uv`)
  kernel             : ``zmin_tiles`` on the kernel

A time below the physical floor (half the time to read the 8 B a point of
cell and range once at the card's 3.35 TB/s) cannot be real: it is printed
as null and named under ``below_floor``, never as a number. The run ends
with an exactness check of kernel against twin (bit-equal buffers) and one
JSON line.

Usage:
  python -m pointcloudprocessor_tpu_torch.tools.zbuffer_probe [--quick] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import numpy as np
import torch

from ..ops import zbuffer
from ..utils import profiling

BLK = 2048  # points per grid step of the TPU kernel: N must be a multiple
FILL = 3.0e38  # the TPU kernel's initial slot value (zbuffer_probe.py:51)
DRAM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet
QUICK = (65_536, 64, 48)  # points, grid width, grid height
FULL = (1_000_000 // BLK * BLK, 293, 215)  # 14x downsample of 4096x3000


def n_rows(n_cells: int) -> int:
    """Rows of the (rows, 128) buffer: whole (8, 128) tiles."""
    rows = -(-n_cells // 128)
    return -(-rows // 8) * 8


def zmin_tiles(cell: torch.Tensor, rng: torch.Tensor, n_cells: int,
               plain: bool = False) -> torch.Tensor:
    """`pallas_zmin`'s counterpart: the (n_rows(n_cells), 128) f32
    scatter-min of ``rng`` at ``cell`` over 3.0e38. ``zbuffer.zmin`` (the
    kernel on the card), or its twin with ``plain``. The TPU kernel drops
    the last N % 2048 points silently (its grid is N // 2048); here such an
    N raises. Cells outside the buffer are dropped. A -0.0 range is stored
    as +0.0, so the buffer is bit-equal to `pallas_zmin`'s on inputs
    without -0.0 and equal in value on any."""
    n = cell.shape[0]
    if n % BLK:
        raise ValueError(f"zmin_tiles: N = {n} is not a multiple of {BLK}")
    rows = n_rows(n_cells)
    fn = zbuffer.zmin_plain if plain else zbuffer.zmin
    return fn(cell, rng, FILL, rows * 128).reshape(rows, 128)


def floor_ms(n_points: int, bytes_per_point: float) -> float:
    """Half the time to move ``bytes_per_point`` a point once at the card's
    DRAM bandwidth: no honest time of the work can be smaller."""
    return 0.5 * n_points * bytes_per_point / DRAM_BYTES_PER_S * 1e3


def refuse_below_floor(times: dict, floors: dict) -> tuple[dict, list]:
    """``times`` with each value under its floor replaced by None, and the
    names so replaced."""
    below = [k for k, t in times.items() if t is not None and t < floors[k]]
    return {k: (None if k in below else t) for k, t in times.items()}, below


def device_kind(device) -> str:
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def check_device(device) -> torch.device:
    """The device to measure on; a CUDA device without CUDA raises (a
    measurement never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(prog="zbuffer_probe")
    ap.add_argument("--quick", action="store_true", help="65,536 points, 64x48 cells")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = check_device(args.device)

    n, gw, gh = QUICK if args.quick else FULL
    n_cells = gw * gh
    rs = np.random.default_rng(0)
    cell = torch.from_numpy(rs.integers(0, n_cells, n).astype(np.int32)).to(dev)
    rng = torch.from_numpy(rs.uniform(2.0, 12.0, n).astype(np.float32)).to(dev)

    def plain_with_gather():
        buf = zbuffer.zmin_plain(cell, rng, FILL, n_cells + 1)
        return buf[cell.long()]

    variants = {
        "plain": lambda: zbuffer.zmin_plain(cell, rng, FILL, n_cells + 1),
        "plain_with_gather": plain_with_gather,
        "kernel": lambda: zmin_tiles(cell, rng, n_cells),
    }
    times = {name: profiling.median_ms(fn, dev, reps=args.reps) for name, fn in variants.items()}
    for name, t in times.items():
        print(f"# zmin {name}: {'not measured' if t is None else f'{t:.4f} ms'}", file=sys.stderr)
    floor = floor_ms(n, 8.0)
    times, below = refuse_below_floor(times, dict.fromkeys(times, floor))

    # Exactness: the kernel's buffer against the twin's, bit for bit.
    buf_k = zmin_tiles(cell, rng, n_cells)
    buf_t = zmin_tiles(cell, rng, n_cells, plain=True)
    exact = bool(torch.equal(buf_k.view(torch.int32), buf_t.view(torch.int32)))
    out = {
        "tool": "zbuffer_probe",
        "device": device_kind(dev),
        "card": profiling.card() if dev.type == "cuda" else "not measured",
        "n_points": n,
        "n_cells": n_cells,
        "floor_ms": floor,
        **{f"{name}_ms": t for name, t in times.items()},
        "below_floor": below,
        "exact": exact,
    }
    print(json.dumps(out))
    if not exact:
        raise AssertionError("zmin_tiles: the kernel's buffer differs from the twin's")
    return out


if __name__ == "__main__":
    main()
