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
  carries.

The JAX module's byte/FLOP estimates are priced against TPU v5e peaks and
are not carried over.
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
