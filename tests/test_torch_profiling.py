"""PyTorch port vs the JAX package: the per-stage cost estimates of
`utils/profiling` and the runner's two cost events.

The estimates' operation and byte counts are the JAX package's formulas,
held equal; their peaks are the H100's (NVIDIA H100 80GB HBM3, 700.00 W:
3.35 TB/s HBM3, 67 TFLOP/s f32 outside the tensor cores), so the derived
fields (ridge, bound, speed of light) follow those. The port's runner logs
``cost_estimate_nid`` after the culls and ``cost_estimate_colorize`` after
the fuse, as the JAX runner does, with the same fields and counts on the
same dataset."""

import json
import os

import pytest
import torch

from pointcloudprocessor_tpu.pipeline import runner as jrunner
from pointcloudprocessor_tpu.utils import profiling as jprof
from pointcloudprocessor_tpu_torch.pipeline import runner as trunner
from pointcloudprocessor_tpu_torch.utils import config as tcfg
from pointcloudprocessor_tpu_torch.utils import profiling as tprof

from test_pipeline_e2e import small_config, write_dataset

CPU = "cpu"
COUNTED = ("flops", "bytes", "intensity_flop_per_byte")
ESTIMATES = [
    ("nid_cost_estimate", (262_144, 8), {}),
    ("nid_cost_estimate", (16_384, 8), dict(bins=12, with_grad=False)),
    ("colorize_fuse_cost", (1_000_000, 8, 3000, 4096), {}),
    ("colorize_fuse_cost", (12_345, 3, 96, 128), dict(top_k=3)),
    ("mls_cost_estimate", (1_000_000,), {}),
    ("mls_cost_estimate", (20_000,), dict(max_neighbors=64)),
    ("hpr_cost_estimate", (262_144,), dict(impl="dense")),
    ("hpr_cost_estimate", (262_144,), dict(impl="grid")),
    ("hpr_cost_estimate", (100_000,), dict(impl="grid", grid_size=256, window=8)),
]


@pytest.mark.parametrize("name,args,kw", ESTIMATES)
def test_cost_estimates_count_as_jax(name, args, kw):
    """flops, bytes and their ratio equal the JAX package's; the peaks are
    the H100's, and the bound and speed of light follow from them."""
    rt = getattr(tprof, name)(*args, **kw)
    rj = getattr(jprof, name)(*args, **kw)
    assert set(rt) == set(rj)
    for key in COUNTED:
        assert rt[key] == rj[key], key
    ridge = tprof.H100_PEAK_F32_FLOPS / tprof.H100_HBM_BYTES_PER_S
    assert rt["ridge_flop_per_byte"] == round(ridge, 1) == 20.0
    assert rt["bound"] == ("compute" if rt["intensity_flop_per_byte"] >= ridge else "memory")
    sol = max(rt["flops"] / tprof.H100_PEAK_F32_FLOPS, rt["bytes"] / tprof.H100_HBM_BYTES_PER_S)
    assert rt["speed_of_light_s"] == round(sol, 6)


def test_roofline_uses_the_h100_peaks():
    assert tprof.H100_HBM_BYTES_PER_S == 3.35e12 and tprof.H100_PEAK_F32_FLOPS == 6.7e13
    assert not [n for n in dir(tprof) if "V5E" in n.upper()]
    r = tprof.roofline(1e9, 1e9)
    assert r["bound"] == "memory"
    assert r["speed_of_light_s"] == round(1e9 / tprof.H100_HBM_BYTES_PER_S, 6)
    r2 = tprof.roofline(1e15, 1e9)
    assert r2["bound"] == "compute" and r2["intensity_flop_per_byte"] > r2["ridge_flop_per_byte"]
    dense = tprof.hpr_cost_estimate(262_144, impl="dense")
    grid = tprof.hpr_cost_estimate(262_144, impl="grid")
    assert dense["flops"] / grid["flops"] > 1e3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """tests/test_pipeline_e2e.py's dataset through both runners (no NID)."""
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("cost")
    write_dataset(root)
    cfg = small_config(root)
    jrunner.process(cfg)
    cfg_t = tcfg.PipelineConfig.from_json(cfg.to_json())
    cfg_t.output_path = str(root / "out_torch") + os.sep
    trunner.process(cfg_t, CPU)
    torch.set_num_threads(torch_threads)

    def events(cfg):
        with open(os.path.join(cfg.output_path, "metrics.jsonl")) as f:
            return [json.loads(line) for line in f]

    return events(cfg), events(cfg_t)


@pytest.mark.parametrize("event", ["cost_estimate_nid", "cost_estimate_colorize"])
def test_runner_logs_cost_estimates(runs, event):
    """The port's metrics.jsonl carries the event once, after the stage the
    JAX runner logs it after, with JAX's fields and counts."""
    ej, et = runs
    (j,) = [e for e in ej if e["event"] == event]
    (t,) = [e for e in et if e["event"] == event]
    assert set(t) == set(j)
    for key in COUNTED:
        assert t[key] == j[key], key
    assert t["bound"] in ("compute", "memory") and t["flops"] > 0
    names = [e["event"] for e in et]
    after = "map_ready" if event == "cost_estimate_nid" else "cost_estimate_nid"
    assert names.index(after) < names.index(event) < names.index("outputs_saved")
