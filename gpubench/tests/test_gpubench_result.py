"""The result line's keys, the check of loaded modules by top-level name and
the refusal to run without a card."""

import json
import os
import subprocess
import sys

import pytest

from gpubench import harness
from tiny import CELLS, ROOT, run


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_keys(cell, trace):
    res = run(cell, trace=trace)["result"]
    keys = list(res)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert ("breakdown" in keys) == trace
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        # Off the card no device metric is read.
        assert not any("roofline" in k or k.startswith("idle_share") for k in res["metrics"])
    else:
        b = harness.load_cell(ROOT, cell)
        assert set(res["metrics"]) == {m["name"] for m in b.end_to_end}
        assert all(m["value"] > 0 for m in res["metrics"].values())
    json.dumps(res)


def test_forbidden_modules_by_whole_top_level_name():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "pointcloudprocessor_tpu",
             "pointcloudprocessor_tpu.ops.nid_hist", "pointcloudprocessor_tpu_torch",
             "pointcloudprocessor_tpu_torch.opt.nid", "jaxtyping", "flaxen", "gpubench.jax"]
    assert harness.forbidden_modules(names) == sorted(names[:6])
    assert harness.forbidden_modules(names[6:]) == []


def test_no_result_without_a_card(tmp_path):
    """Here there is no card: run.py prints nothing on standard output and
    exits with another code than 0; likewise from a directory that holds
    only BENCHMARK.json and gpubench/."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for cwd in (ROOT, tmp_path):
        if cwd == tmp_path:
            import shutil

            shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
            shutil.copytree(os.path.join(ROOT, "gpubench"), tmp_path / "gpubench",
                            ignore=shutil.ignore_patterns("out", ".cache", "__pycache__"))
        p = subprocess.run([sys.executable, "gpubench/run.py", "--workload", CELLS[0],
                            "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
                           capture_output=True, text=True, timeout=120)
        assert p.returncode != 0 and p.stdout == ""
