"""Stage timing, profiler capture, the port's spans and counters, and
structured metrics.

Port of the timing and metrics half of `pointcloudprocessor_tpu/utils/
profiling.py`:

- :class:`StageTimer` — named stage timings; with ``sync`` a stage ends
  only after the CUDA device has finished its queued work, so the time is
  execution, not enqueue; each stage is also the span ``stage.<name>``;
- :func:`trace` — a torch.profiler capture (CPU + CUDA activities) written
  as a Chrome trace;
- :func:`span` (:func:`spanned` for a whole function), :func:`count`,
  :func:`host_read` and :func:`to_device` — the port's named
  regions and counters, recorded in memory while any torch.profiler capture
  records (:func:`span_records`, :func:`counter_values`,
  :func:`reset_trace`) and costing one flag check while none does; inside a
  :func:`trace` each span is also a ``record_function`` on the capture's
  clock;
- :class:`MetricsLogger` — append-only JSONL metrics, one object per event;
- :func:`median_ms` — the median CUDA-event time of a call on the card (as
  its caller pays it, or its device time alone), :func:`repeat_ms` — each
  call's time with its median and spread, :func:`eval_split` — where a
  call's time goes (wall, host, device busy, launches, host syncs), and
  :func:`card` — the card's name and power limit, which every such time
  carries.
"""

from __future__ import annotations

import contextlib
import functools
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
    """Collects named stage durations (seconds, host clock). Each stage is
    also the span ``stage.<name>``, so that a capture nests the port's
    spans under the stages."""

    def __init__(self, device=None):
        self.timings: dict[str, float] = {}
        self._device = device

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        with span(f"stage.{name}"):
            try:
                yield
            finally:
                if self._device is not None:
                    synchronize(self._device)
                self.timings[name] = self.timings.get(name, 0.0) + time.perf_counter() - t0


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler capture around a block, written to
    ``<log_dir>/trace.json`` (open with Perfetto or chrome://tracing). The
    port's spans opened in the block are ``record_function`` regions of the
    capture too, stamped on the clock its kernels carry."""
    global _own_capture
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    outer = _own_capture
    with profile(activities=activities) as prof:
        _own_capture = True
        try:
            yield prof
        finally:
            _own_capture = outer
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# ---------------------------------------------------------------------------
# Spans and counters.
#
# The gate is torch's own flag, true while any torch.profiler capture
# records (the benchmark's, a tool's, :func:`trace`). With it off a span is a
# shared no-op and a count returns at once: the hot path pays one attribute
# read. With it on, each span appends a :class:`SpanRecord` (host clock,
# ``time.perf_counter_ns``) and each count ticks a total and the innermost
# open span. Only inside :func:`trace` does a span open a ``record_function``:
# other captures keep their event lists to themselves.
# ---------------------------------------------------------------------------

_autograd_profiler = torch.autograd.profiler
_own_capture = False  # set by trace(): spans become record_function regions too


class SpanRecord:
    """One closed or open span: ``name``, ``parent`` (the index in
    :func:`span_records` of the span open around it, -1 for a root),
    ``start_ns`` and ``end_ns`` (``time.perf_counter_ns``; ``end_ns`` 0
    while open) and ``counts`` (counter -> ticks while it was the innermost
    open span)."""

    __slots__ = ("name", "parent", "start_ns", "end_ns", "counts")

    def __init__(self, name: str, parent: int):
        self.name, self.parent = name, parent
        self.start_ns = self.end_ns = 0
        self.counts: dict[str, int] = {}


_records: list[SpanRecord] = []
_open: list[int] = []  # indices of the open spans, the innermost last
_counters: dict[str, int] = {}


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "record", "region")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        parent = _open[-1] if _open else -1
        self.record = SpanRecord(self.name, parent)
        _open.append(len(_records))
        _records.append(self.record)
        self.region = torch.profiler.record_function(self.name) if _own_capture else None
        if self.region is not None:
            self.region.__enter__()
        self.record.start_ns = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        self.record.end_ns = time.perf_counter_ns()
        if self.region is not None:
            self.region.__exit__(*exc)
        # reset_trace() inside the span leaves nothing to pop.
        if _open and _records[_open[-1]] is self.record:
            _open.pop()
        return False


def span(name: str):
    """``with span(name): ...`` — a named region of the port's work. While a
    torch.profiler capture records it appends a :class:`SpanRecord` nested
    under the span open around it, and inside :func:`trace` it is also a
    ``record_function`` of that name; otherwise it does nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def spanned(name: str):
    """Decorator: each call of the function is a :func:`span` ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def count(name: str, n: int = 1) -> None:
    """Tick counter ``name`` by ``n`` while a capture records: its total
    (:func:`counter_values`) and the innermost open span's ``counts``."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    _counters[name] = _counters.get(name, 0) + n
    if _open:
        c = _records[_open[-1]].counts
        c[name] = c.get(name, 0) + n


def host_read(value, cast=bool):
    """``cast(value)`` — ``bool``, ``int``, ``float`` or ``torch.Tensor.cpu``
    — counted as one ``host_sync``: every point where the solve or the fuse
    reads a tensor's value on the host goes through here (on the card, one
    wait for the stream)."""
    count("host_sync")
    return cast(value)


def to_device(data, device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(data, dtype=dtype, device=device)``, counted as one
    ``host_sync`` unless ``data`` is a tensor on ``device`` already: a copy
    of host values, which on the card waits for the stream. The solve's and
    the fuse's constants and uploads go through here."""
    if _autograd_profiler._is_profiler_enabled and not (
            isinstance(data, torch.Tensor) and data.device == torch.device(device)):
        count("host_sync")
    return torch.as_tensor(data, dtype=dtype, device=device)


def span_records() -> list[SpanRecord]:
    """The spans recorded since the last :func:`reset_trace`, in the order
    they opened (a parent before its children); not cleared."""
    return list(_records)


def counter_values() -> dict[str, int]:
    """Each counter's total since the last :func:`reset_trace`; not
    cleared."""
    return dict(_counters)


def reset_trace() -> None:
    """Forget every span record and counter."""
    _records.clear()
    _open.clear()
    _counters.clear()


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


# NVIDIA H100 80GB HBM3 (SXM), 700.00 W power limit, from NVIDIA's data
# sheet: a card set below 700 W runs slower under load, so this is an upper
# bound of its rate.
H100_HBM_BYTES_PER_S = 3.35e12


def floor_ms(nbytes: float) -> float:
    """The time to move ``nbytes`` once at the card's memory rate (3.35
    TB/s): no honest time of work that moves them can be smaller."""
    return nbytes / H100_HBM_BYTES_PER_S * 1e3


def repeat_ms(fn, device, reps: int = 3, warmup: int = 1, floor: float = 0.0) -> dict:
    """Each of ``reps`` calls of ``fn()`` timed with CUDA events after
    ``warmup`` calls, as its caller pays it (host included; a call that
    waits on the card is timed to its end): ``{"ms": median, "calls_ms":
    [...], "spread_ms": max - min, "below_floor": bool}``. A median under
    ``floor`` ms cannot be real: it is given as None with ``below_floor``
    set. Off the card ``fn`` runs once and every time is None."""
    if torch.device(device).type != "cuda":
        fn()
        return {"ms": None, "calls_ms": [], "spread_ms": None, "below_floor": False}
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    med = float(statistics.median(times))
    below = med < floor
    return {"ms": None if below else med, "calls_ms": times,
            "spread_ms": max(times) - min(times), "below_floor": below}


def eval_split(fn, device, reps: int = 5, warmup: int = 1) -> dict:
    """Where a call of ``fn()`` spends its time on the card, a call, over
    ``reps`` calls after ``warmup``: ``wall_ms`` (host clock from the call
    to the card's end of its work, median), ``host_ms`` (host clock until
    the call returns, median: the time to queue it, and to wait at its host
    syncs), and from one ``torch.profiler`` capture of ``reps`` calls
    ``device_busy_ms`` (the union of the card's kernel, memset and copy
    intervals), ``idle_share`` (1 - busy / wall), ``launches`` (kernels)
    and ``syncs`` (the host's waits on the card: ``cuda*Synchronize``
    calls, as ``.item()``, ``bool()`` of a card tensor or a copy to the
    host make). Off the card ``fn`` runs once and every entry is None."""
    dev = torch.device(device)
    if dev.type != "cuda":
        fn()
        return dict.fromkeys(("wall_ms", "host_ms", "device_busy_ms", "idle_share", "launches",
                              "syncs"))
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(dev)
    walls, hosts = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize(dev)
        hosts.append(t1 - t0)
        walls.append(time.perf_counter() - t0)

    def capture(calls):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize(dev)
        return prof.events()

    def is_sync(e):
        return (e.device_type != torch.autograd.DeviceType.CUDA and e.name.startswith("cuda")
                and e.name.endswith("Synchronize"))

    # A capture of no call holds the capture's own syncs (its trailing
    # synchronize among them): they are not the calls'.
    syncs = -sum(map(is_sync, capture(0)))
    spans, launches = [], 0
    for e in capture(reps):
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            launches += not e.name.startswith(("Memset", "Memcpy"))
        elif is_sync(e):
            syncs += 1
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    wall = statistics.median(walls) * 1e3
    busy = busy_us / 1e3 / reps
    return {"wall_ms": wall, "host_ms": statistics.median(hosts) * 1e3,
            "device_busy_ms": busy, "idle_share": max(0.0, 1.0 - busy / wall),
            "launches": launches / reps, "syncs": syncs / reps}


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
