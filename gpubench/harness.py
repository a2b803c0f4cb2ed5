"""The benchmark's core: finds a cell's files by name, runs its set-up,
its measured window and its check, and builds the result line.

Everything that belongs to one cell, configuration, job kind or per-layer
metric lives in a file of its own under ``gpubench/`` and is found by the
name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json`` (the file ``BENCHMARK.json`` names): the
  deployment: ``scene``, ``pipeline`` (fields of the port's
  ``PipelineConfig``), ``precision``, ``source``, ``reduced``, ``assumed``;
* ``workloads/<cell>.json``: ``config``, ``traffic``, ``job`` (the kind),
  ``params`` (the traffic's parameters), ``limits`` (of the numbers its
  check compares) and ``why``;
* ``jobs/<kind>.py``: a class ``Job`` that drives one entry of the port;
* ``metrics/<metric>.py``: a function ``read(reading)`` that returns the
  metric's value, or None where it finds nothing to read.

A metric named ``<base>.<qualifier>`` (``idle_share.calib``) that has no
reader of its own is read by ``metrics/<base>.py``, and an end-to-end one
(``colorize_s.hpr``) takes the job's value of ``<base>``: one quantity split
by cell, where the cells move different end-to-end metrics, needs no copy.

A run: set-up (scene, kernels, one warm job), then jobs back to back, one
client, until ``seconds`` have passed (the job under way when they pass is
finished and counted), then the check against the plain reference. With
``trace``, after the window ``params["trace_jobs"]`` more jobs run with the
device traced and ``params["span_jobs"]`` with host spans (see
``bench_trace``), and the per-layer metrics are read.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
import traceback
from dataclasses import dataclass
from typing import Optional

import torch

from . import bench_trace

FORBIDDEN = ("jax", "jaxlib", "flax", "pointcloudprocessor_tpu")


@dataclass
class Context:
    """What a job is given."""

    name: str
    config: dict
    params: dict
    seed: int
    device: torch.device
    trace: bool


@dataclass
class Reading:
    """What a per-layer metric reader is given, after a traced run."""

    cell: str
    records: list  # every window job's record
    traced: list  # the records of the jobs whose device work was traced
    profiled: set  # the numbers of every job run under a profiler
    trace: Optional[bench_trace.Summary]
    counts: dict  # the job's own counts for the rooflines
    config: dict
    params: dict
    peak_bytes: int  # max_memory_allocated over the window


def forbidden_modules(names) -> list:
    """The loaded modules whose top-level name (before the first dot) is
    one of :data:`FORBIDDEN`, compared whole."""
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def p95(values) -> float:
    """The 95th percentile of ``values``, linear between ranks."""
    v = sorted(values)
    pos = 0.95 * (len(v) - 1)
    lo = int(pos)
    return v[lo] + (v[min(lo + 1, len(v) - 1)] - v[lo]) * (pos - lo)


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_file_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """A cell's entries and files, resolved from ``BENCHMARK.json``."""

    name: str
    entry: dict  # its entry of BENCHMARK.json's workloads
    workload: dict  # workloads/<cell>.json
    config: dict  # the config's file
    job_path: str
    end_to_end: list  # its end-to-end metrics' entries
    per_layer: list  # its per-layer metrics' entries
    metric_paths: dict  # per-layer metric name -> reader path


def base_names(name: str) -> list:
    """``name``, then the names it leaves as its last dot-separated parts
    are taken off: ``a.b.c`` -> ``a.b.c``, ``a.b``, ``a``."""
    parts = name.split(".")
    return [".".join(parts[:n]) for n in range(len(parts), 0, -1)]


def reader_path(base: str, name: str) -> str:
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``, or
    that of the longest of its :func:`base_names` that has one."""
    for b in base_names(name):
        path = os.path.join(base, "metrics", f"{b}.py")
        if os.path.exists(path):
            return path
    raise FileNotFoundError(os.path.join(base, "metrics", f"{name}.py"))


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: str, name: str) -> Cell:
    """Resolve cell ``name`` under the checkout ``root``; raises on a missing
    or inconsistent file."""
    bench = _read_json(os.path.join(root, "BENCHMARK.json"))
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    base = os.path.join(root, "gpubench")
    workload = _read_json(os.path.join(base, "workloads", f"{name}.json"))
    for key in ("config", "traffic"):
        if workload[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json has {key} {workload[key]!r}, "
                             f"BENCHMARK.json {entry[key]!r}")
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(os.path.join(root, configs[entry["config"]]["file"]))
    job_path = os.path.join(base, "jobs", f"{workload['job']}.py")
    if not os.path.exists(job_path):
        raise FileNotFoundError(job_path)
    per_layer = [m for m in bench["per_layer"] if applies(m, name)]
    paths = {m["name"]: reader_path(base, m["name"]) for m in per_layer}
    return Cell(name, entry, workload, config, job_path,
                [m for m in bench["end_to_end"] if applies(m, name)], per_layer, paths)


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def execute(root: str, name: str, seed: int, seconds: float, trace: bool, device="cuda",
            t_start: Optional[float] = None, overrides: Optional[dict] = None, log=None) -> dict:
    """One run of cell ``name``; returns the result (the last line's keys,
    ``checks`` last) and, under ``detail``, what goes to the detail file.
    ``overrides`` is merged into the config (tests shrink the scene with
    it); ``log`` receives progress lines."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda line: print(line, file=sys.stderr, flush=True))
    device = torch.device(device)
    cell = load_cell(root, name)
    config = _merge(cell.config, overrides or {})
    params = cell.workload["params"]
    mod = load_file_module(cell.job_path, f"gpubench_job_{cell.workload['job']}")
    job = mod.Job(Context(name, config, params, seed, device, trace))
    job.setup()
    _sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"[gpubench] {name} seed {seed}: set-up {setup_s:.3f} s ({job.setup_split})")

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    records, traced, failed = [], [], 0
    summary = None
    profiled = set()
    t0 = time.perf_counter()

    def one(i):
        nonlocal failed
        try:
            rec = job.run(i)
        except Exception:  # a failed job counts against the attempted ones
            failed += 1
            log(f"[gpubench] job {i} failed:\n{traceback.format_exc()}")
            return None
        records.append(rec)
        return rec

    i = 0
    while time.perf_counter() - t0 < seconds:
        one(i)
        i += 1
    window_s = time.perf_counter() - t0
    log(f"[gpubench] window {window_s:.3f} s, {i} jobs, {failed} failed")
    if trace:
        # After the window: a profiler leaves the host slower for the jobs
        # that follow it, which would reach the untraced jobs' walls.
        first = i
        with bench_trace.DeviceTrace(device, (job.SPAN,)) as dev_prof:
            for _ in range(params["trace_jobs"]):
                rec = one(i)
                i += 1
                if rec is not None:
                    traced.append(rec)
        with bench_trace.Profiled(job.spans(), device, (job.SPAN,)) as prof:
            for _ in range(params["span_jobs"]):
                one(i)
                i += 1
        profiled = set(range(first, i))
        summary = dev_prof.summary().named(prof.summary())
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    job.release()
    # The reference's float32 is float32: no TF32 in its products.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    values = job.check(records) if records else {}
    limits = cell.workload["limits"]
    # A number that is not finite (a solve that reports +inf) reads as null
    # and fails, so that the line stays JSON.
    checks = {k: {"value": values[k] if math.isfinite(values.get(k, math.nan)) else None,
                  "limit": lim} for k, lim in limits.items()}
    within = all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    correct = bool(records) and failed == 0 and within

    if device.type == "cuda":
        dev_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                    "memory_peak_bytes": int(peak)}
    else:
        dev_info = {"platform": device.type, "kind": device.type, "count": 1,
                    "memory_peak_bytes": int(peak)}
    metrics = {}
    breakdown = None
    if trace:
        reading = Reading(name, records, traced, profiled, summary, job.counts(traced), config,
                          params, peak)
        for m in cell.per_layer:
            reader = load_file_module(cell.metric_paths[m["name"]], "gpubench_metric")
            value = reader.read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if summary is not None:
            dev_info["busy_s"] = summary.busy_s
            dev_info["window_s"] = summary.window_s
            breakdown = {"device_ops": summary.device_ops[:10], "idle_gaps": summary.idle_gaps[:10]}
    else:
        e2e = job.end_to_end(window_s, records)
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            key = next(b for b in base_names(m["name"]) if b in e2e)
            metrics[m["name"]] = {"value": e2e[key], "unit": m["unit"]}
    result = {"correct": correct, "attempted": i, "failed": failed, "metrics": metrics,
              "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    detail = {"workload": name, "seed": seed, "trace": trace, "setup_s": setup_s,
              "setup_split": job.setup_split, "window_s": window_s, "jobs": len(records),
              "check_values": values, "job_detail": job.detail(records),
              "trace_detail": summary.detail() if summary is not None else None}
    return {"result": result, "detail": detail}
