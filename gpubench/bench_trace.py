"""The traced slice of a run, in two passes over jobs run after its window.

* :class:`DeviceTrace` records the device alone (``torch.profiler`` with
  CUDA activity only: kernels, memsets and copies, no host op recorded), so
  that the host runs as near its untraced pace as CUPTI lets it (a solve
  of ~500 launches an evaluation still takes ~1.8x its wall). The busy
  time, the launches and each kernel's device time come from it; the idle
  share sets its busy time a job against the untraced jobs' wall.
* :class:`Profiled` records host and device, with spans around the calls
  into each layer of the port, and names each idle gap of the device by the
  innermost benchmark span open on the host at its middle. Its recording of
  every host op slows the host, so it names the gaps and measures nothing.

Spans come from the benchmark's side: for the jobs of the second pass the
module attributes a job names (``Job.spans()``: (module, attribute, span
name)) are replaced by wrappers that open a ``record_function`` span of that
name, and put back afterwards. The port looks these functions up through
their modules when it calls them, so the wrappers see every call. Untraced
runs wrap nothing.
"""

from __future__ import annotations

import functools
import time
from collections import defaultdict
from dataclasses import dataclass, field, replace

import torch

WINDOW_SPAN = "gpubench.traced_window"


def _wrap(fn, span: str):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(span):
            return fn(*args, **kwargs)
    return wrapped


@dataclass
class Summary:
    window_s: float
    busy_s: float
    launches: int  # kernel launches (memsets and copies not counted)
    kernel_s: dict  # kernel name -> device seconds
    kernel_n: dict  # kernel name -> launches
    device_ops: list  # [[name, seconds]], the most time first
    idle_gaps: list = field(default_factory=list)  # [[host span, seconds]], the longest first
    idle_by_span: dict = field(default_factory=dict)  # host span -> idle seconds in all
    spans_pass: dict = field(default_factory=dict)  # window_s, busy_s of the spans' pass

    def matching(self, *parts: str) -> tuple[float, int]:
        """(device seconds, launches) of the kernels whose name holds any
        of ``parts``."""
        s = n = 0
        for name, t in self.kernel_s.items():
            if any(p in name for p in parts):
                s += t
                n += self.kernel_n[name]
        return s, n

    def named(self, spans: "Summary") -> "Summary":
        """This device pass with the idle gaps of the spans' pass."""
        return replace(self, idle_gaps=spans.idle_gaps, idle_by_span=spans.idle_by_span,
                       spans_pass={"window_s": spans.window_s, "busy_s": spans.busy_s})

    def detail(self) -> dict:
        return {"window_s": self.window_s, "busy_s": self.busy_s, "launches": self.launches,
                "device_ops": self.device_ops, "idle_gaps": self.idle_gaps,
                "idle_by_span": self.idle_by_span, "spans_pass": self.spans_pass}


def _device_events(prof, skip):
    """(start us, end us, name) of the device's kernels, memsets and copies;
    the spans' own copies on the device's timeline (``skip``) are no work."""
    return [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in skip]


def _busy(device, win):
    """The union of the device intervals clipped to ``win``, in us, and the
    gaps between them, in time order."""
    busy_us, end = 0.0, win[0]
    gaps = []
    for a, b, _ in sorted(device):
        a, b = max(a, win[0]), min(b, win[1])
        if b <= a:
            continue
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy_us += b - max(a, end)
            end = b
    if win[1] > end:
        gaps.append((end, win[1]))
    return busy_us, gaps


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class DeviceTrace:
    """``with DeviceTrace(device, names) as p: ...`` records the device's
    work in the block; then ``p.summary()``. ``names`` are the spans opened
    in the block, whose marks on the device's timeline are left out. The
    window is the host's clock between two synchronizations around the
    block; on a CPU there is no device and the busy time is 0."""

    def __init__(self, device, names=()):
        self.device = device
        self.names = set(names)

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        cuda = self.device.type == "cuda"
        self.prof = profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
        _sync(self.device)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync(self.device)
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        return False

    def summary(self) -> Summary:
        device = _device_events(self.prof, self.names)
        win = (min((a for a, _, _ in device), default=0.0),
               max((b for _, b, _ in device), default=0.0))
        busy_us, _ = _busy(device, win)
        kernel_s, kernel_n = defaultdict(float), defaultdict(int)
        launches = 0
        for a, b, name in device:
            kernel_s[name] += (b - a) * 1e-6
            kernel_n[name] += 1
            launches += not name.startswith(("Memset", "Memcpy"))
        ops = sorted(([n, s] for n, s in kernel_s.items()), key=lambda x: -x[1])
        return Summary(window_s=self.window_s, busy_s=busy_us * 1e-6, launches=launches,
                       kernel_s=dict(kernel_s), kernel_n=dict(kernel_n), device_ops=ops)


class Profiled:
    """``with Profiled(spans, device, annotations) as p: ...`` profiles the
    block, host and device; then ``p.summary()``. ``annotations`` names the
    spans the job opens itself."""

    def __init__(self, spans, device, annotations=()):
        self.spans = list(spans)
        self.names = {s for _, _, s in self.spans} | {WINDOW_SPAN} | set(annotations)
        self.device = device
        self.saved = []

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        for mod, attr, span in self.spans:
            fn = getattr(mod, attr)
            self.saved.append((mod, attr, fn))
            setattr(mod, attr, _wrap(fn, span))
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        _sync(self.device)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.window = torch.profiler.record_function(WINDOW_SPAN)
        self.window.__enter__()
        return self

    def __exit__(self, *exc):
        _sync(self.device)
        self.window.__exit__(*exc)
        self.prof.__exit__(*exc)
        for mod, attr, fn in reversed(self.saved):
            setattr(mod, attr, fn)
        return False

    def summary(self) -> Summary:
        device = _device_events(self.prof, self.names)
        spans, win = [], None
        for e in self.prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA and e.name in self.names:
                a, b = e.time_range.start, e.time_range.end
                if e.name == WINDOW_SPAN:
                    win = (a, b)
                else:
                    spans.append((a, b, e.name))
        if win is None:
            raise RuntimeError("the profile holds no traced-window span")
        busy_us, gaps = _busy(device, win)
        # A sweep over the gaps' middles in time order: the host spans nest
        # (one thread), so the innermost open span is the top of a stack of
        # the spans started and not yet ended.
        bounds = sorted([(a, 1, j) for j, (a, _, _) in enumerate(spans)]
                        + [(b, 0, j) for j, (_, b, _) in enumerate(spans)])
        stack, closed, k = [], set(), 0
        named, by_span = [], defaultdict(float)
        for a, b in gaps:
            mid = 0.5 * (a + b)
            while k < len(bounds) and bounds[k][0] <= mid:
                _, start, j = bounds[k]
                if start:
                    stack.append(j)
                else:
                    closed.add(j)
                k += 1
            while stack and stack[-1] in closed:
                stack.pop()
            label = spans[stack[-1]][2] if stack else "host"
            named.append([label, (b - a) * 1e-6])
            by_span[label] += (b - a) * 1e-6
        named.sort(key=lambda x: -x[1])
        return Summary(window_s=(win[1] - win[0]) * 1e-6, busy_s=busy_us * 1e-6, launches=0,
                       kernel_s={}, kernel_n={}, device_ops=[], idle_gaps=named,
                       idle_by_span=dict(sorted(by_span.items(), key=lambda x: -x[1])))
