"""Stage timing, profiler capture and structured metrics.

Port of the timing and metrics half of `pointcloudprocessor_tpu/utils/
profiling.py`:

- :class:`StageTimer` — named stage timings; with ``sync`` a stage ends
  only after the CUDA device has finished its queued work, so the time is
  execution, not enqueue;
- :func:`trace` — a torch.profiler capture (CPU + CUDA activities) written
  as a Chrome trace;
- :class:`MetricsLogger` — append-only JSONL metrics, one object per event;
- :func:`median_ms` — the median CUDA-event time of a call on the card (as
  its caller pays it, or its device time alone), and
  :func:`card` — the card's name and power limit, which every such time
  carries;
- :func:`roofline` and the per-stage cost estimates (:func:`nid_cost_estimate`,
  :func:`colorize_fuse_cost`, :func:`mls_cost_estimate`,
  :func:`hpr_cost_estimate`): analytic operation and byte counts from array
  shapes, the JAX module's formulas, placed against the H100's peaks.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import time
from typing import Optional

import torch


def synchronize(device) -> None:
    """Wait for queued work on ``device`` (a no-op off CUDA)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StageTimer:
    """Collects named stage durations (seconds, host clock)."""

    def __init__(self, device=None):
        self.timings: dict[str, float] = {}
        self._device = device

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._device is not None:
                synchronize(self._device)
            self.timings[name] = self.timings.get(name, 0.0) + time.perf_counter() - t0


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler capture around a block, written to
    ``<log_dir>/trace.json`` (open with Perfetto or chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class MetricsLogger:
    """Append-only JSONL metrics: one `{"ts": ..., "event": ..., **fields}`
    object per line. Pass ``path=None`` (or "") to disable."""

    def __init__(self, path: Optional[str]):
        self._path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(self, event: str, **fields) -> None:
        if not self._path:
            return
        rec = {"ts": time.time(), "event": event}
        rec.update(fields)
        with open(self._path, "a") as f:
            f.write(json.dumps(rec) + "\n")


# A sleep kernel of this many cycles (~2.5 ms) queued ahead of a timed call
# keeps the card busy while the host enqueues the call (see median_ms).
_HIDE_CYCLES = 5_000_000


def median_ms(fn, device, reps: int = 20, warmup: int = 3,
              hide_host: bool = False) -> Optional[float]:
    """Median time of ``fn()`` in ms over ``reps`` calls, each timed with
    CUDA events after ``warmup`` calls; None off the card (a CPU run gives
    no device time), where ``fn`` runs once so that its path still runs.

    The events bracket the call as its caller pays it: a short kernel's
    time then includes the host's time to reach its launch. ``hide_host``
    queues a sleep kernel before the start event, so the events bracket only
    the call's work on the card (its device time); for calls that do not
    wait on the device. A rep counts only if the start event was still
    pending when the host had queued the whole call; None if most were not."""
    if torch.device(device).type != "cuda":
        fn()
        return None
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if hide_host:
            torch.cuda._sleep(_HIDE_CYCLES)
        a.record()
        fn()
        b.record()
        hidden = not a.query()
        b.synchronize()
        if hidden or not hide_host:
            times.append(a.elapsed_time(b))
    return float(statistics.median(times)) if 2 * len(times) >= reps else None


# ---------------------------------------------------------------------------
# Per-stage byte/FLOP estimates + roofline positioning.
#
# Analytic counts from array shapes, the formulas of the JAX package's
# `utils/profiling.py`, priced for the card this port runs on: NVIDIA H100
# 80GB HBM3 (SXM), 700.00 W power limit, from NVIDIA's data sheet: 3.35 TB/s
# of HBM3 and 67 TFLOP/s of f32 outside the tensor cores. A card set below
# 700 W runs slower under load, so these are upper bounds of its rates.
# ---------------------------------------------------------------------------

H100_PEAK_F32_FLOPS = 6.7e13  # NVIDIA H100 80GB HBM3, 700.00 W
H100_HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 80GB HBM3, 700.00 W


def roofline(flops: float, bytes_moved: float,
             peak_flops: float = H100_PEAK_F32_FLOPS,
             peak_bw: float = H100_HBM_BYTES_PER_S) -> dict:
    """Arithmetic intensity + bound classification + speed-of-light time."""
    intensity = flops / max(bytes_moved, 1.0)
    ridge = peak_flops / peak_bw
    t_compute = flops / peak_flops
    t_memory = bytes_moved / peak_bw
    return {
        "flops": flops,
        "bytes": bytes_moved,
        "intensity_flop_per_byte": round(intensity, 3),
        "ridge_flop_per_byte": round(ridge, 1),
        "bound": "compute" if intensity >= ridge else "memory",
        "speed_of_light_s": round(max(t_compute, t_memory), 6),
    }


def nid_cost_estimate(n_points: int, k_frames: int, bins: int = 16,
                      with_grad: bool = True) -> dict:
    """One multi-keyframe NID evaluation (ops/nid_hist.py semantics).

    Per point: project (~30 flops), spline weights (2x ~16), 16-tap
    histogram accumulate (16 madd); the adjoint ~= the forward. Bytes:
    points xyz + intensity + 16 nibble-packed taps (8 B) per point."""
    per_point = 30 + 32 + 2 * 16
    total = n_points * k_frames
    flops = total * per_point * (2.0 if with_grad else 1.0)
    bytes_moved = total * (12 + 4 + 8) * (2.0 if with_grad else 1.0)
    return roofline(flops, bytes_moved)


def colorize_fuse_cost(n_map: int, k_frames: int, height: int, width: int,
                       top_k: int = 5) -> dict:
    """Full fuse pass (pipeline/colorize.py): per keyframe per point
    transform+project+score (~60 flops), one packed-int32 image gather, a
    z-buffer scatter+gather, and a top-K register update (~3*top_k)."""
    per_obs = 60 + 3 * top_k
    flops = n_map * k_frames * per_obs
    bytes_moved = (
        k_frames * height * width * 4        # packed image build + gathers
        + n_map * k_frames * (12 + 4 + 4 + 8)  # xyz in, rgb word, cell, topk rw
    )
    return roofline(flops, bytes_moved)


def mls_cost_estimate(n_points: int, max_neighbors: int = 32) -> dict:
    """One MLS pass (ops/mls.py): 27-cell hash probe, per-neighbor weighted
    covariance (~25), 6x6 normal-equation build (~72) and solve (~200/pt)."""
    per_point = 27 * 8 + max_neighbors * (25 + 72) + 200 + 36
    flops = n_points * per_point
    bytes_moved = n_points * (12 + max_neighbors * 16 + 12 + 24)
    return roofline(flops, bytes_moved)


def hpr_cost_estimate(n_points: int, impl: str = "grid",
                      grid_size: int = 512, window: int = 16) -> dict:
    """HPR cull (ops/hpr.py): dense = N^2 support products (3 madd a pair,
    counted as 6 f32-equivalent passes as the JAX package counts them);
    grid = O(N) scatter/gather + separable parabolic erosion."""
    if impl == "dense":
        flops = 6.0 * n_points * n_points * 2 * 3
        bytes_moved = n_points * 16 * 2  # blocked: flipped + dirs stream
    else:
        flops = n_points * 40 + grid_size * grid_size * (2 * window + 1) * 2 * 2
        bytes_moved = n_points * (12 + 4 + 4 + 4) + grid_size * grid_size * 4 * 4
    return roofline(flops, bytes_moved)


def card() -> str:
    """``name, power.limit`` of the first card as nvidia-smi reports them,
    or "not measured" where it cannot."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        return "not measured"
    lines = smi.stdout.strip().splitlines()
    return lines[0] if smi.returncode == 0 and lines else "not measured"
