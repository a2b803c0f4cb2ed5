"""Cells, configurations, job kinds and metrics are found by name, and a new
cell needs only new files and an entry in BENCHMARK.json."""

import json
import os
import re
import shutil

import pytest

from gpubench import harness
from tiny import CELLS, ROOT, run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves(cell):
    c = harness.load_cell(ROOT, cell)
    assert os.path.exists(c.job_path)
    assert [m["name"] for m in c.end_to_end][0] == "setup_s"
    assert len(c.end_to_end) >= 2 and c.per_layer
    assert c.workload["limits"] and c.workload["why"] == c.entry["why"]


def test_benchmark_file_keeps_to_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("gpubench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["source"] == c["source"]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and "\n" not in m["layer"]
        if "roofline" in m["name"]:
            assert m["name"].split(".")[-1 if m["name"].endswith("roofline") else -2].endswith(
                "_roofline") and m["unit"] == "%"
        layers.setdefault(m["layer"], m["layer"])
    assert len(json.dumps(b)) < 64 * 1024


def _copy(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "gpubench"), root / "gpubench",
                    ignore=shutil.ignore_patterns("out", ".cache", "__pycache__"))
    return root


def test_a_new_cell_is_files_and_an_entry(tmp_path):
    """A throwaway cell: a workload file and an entry in BENCHMARK.json, in a
    copy of the checkout, runs with nothing else changed."""
    root = _copy(tmp_path)
    with open(root / "gpubench" / "workloads" / "colorize.s1_k64.json") as f:
        w = json.load(f)
    w["params"]["trans_m"] = [0.0, 0.002]
    w["why"] = "a throwaway cell: the z-buffer fuse within 2 mm of the truth"
    with open(root / "gpubench" / "workloads" / "throwaway.s1_k64.json", "w") as f:
        json.dump(w, f)
    b = _bench(root)
    b["workloads"].append({"name": "throwaway.s1_k64", "config": w["config"],
                           "traffic": w["traffic"], "chips": 1, "why": w["why"]})
    for m in b["end_to_end"] + b["per_layer"]:
        if "colorize.s1_k64" in m.get("workloads", []):
            m["workloads"].append("throwaway.s1_k64")
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(b, f)
    cell = harness.load_cell(str(root), "throwaway.s1_k64")
    assert cell.workload["params"]["trans_m"] == [0.0, 0.002]
    out = run("throwaway.s1_k64", root=str(root))
    assert out["result"]["correct"] is True
    assert set(out["result"]["metrics"]) == {"setup_s", "colorize_s.zbuffer"}


def test_a_split_metric_is_an_entry(tmp_path):
    """A per-layer metric ``<base>.<qualifier>`` is read by ``<base>``'s reader
    and an end-to-end one takes the job's ``<base>`` value: a throwaway split
    of each, in a copy of the checkout, is entries in BENCHMARK.json alone."""
    root = _copy(tmp_path)
    b = _bench(root)
    cell = "calib.s1_k64"
    b["end_to_end"].append({"name": "calib_s.throwaway", "unit": "s", "better": "lower",
                            "bound": 0.25, "source": "host_clock", "workloads": [cell]})
    b["per_layer"].append({"name": "calib.evals_per_solve.throwaway", "unit": "evals",
                           "better": "lower", "source": "program_counter",
                           "layer": "opt/refine + opt/bfgs", "moves": "calib_s.throwaway",
                           "workloads": [cell]})
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(b, f)
    c = harness.load_cell(str(root), cell)
    assert c.metric_paths["calib.evals_per_solve.throwaway"].endswith(
        os.path.join("metrics", "calib.evals_per_solve.py"))
    assert c.metric_paths["idle_share.calib"].endswith(os.path.join("metrics", "idle_share.py"))
    m = run(cell, root=str(root))["result"]["metrics"]
    assert m["calib_s.throwaway"] == m["calib_s"]
    m = run(cell, trace=True, root=str(root))["result"]["metrics"]
    assert m["calib.evals_per_solve.throwaway"] == m["calib.evals_per_solve"]


def test_a_missing_file_is_refused(tmp_path):
    root = _copy(tmp_path)
    os.remove(root / "gpubench" / "metrics" / "calib.eval_ms.py")
    with pytest.raises(FileNotFoundError):
        harness.load_cell(str(root), "calib.s1_k64")
    b = _bench(root)
    b["workloads"][0]["traffic"] = "other"
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(b, f)
    with pytest.raises(ValueError):
        harness.load_cell(str(root), b["workloads"][0]["name"])
