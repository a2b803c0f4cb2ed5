"""The port's runner and `utils/profiling`'s capture: with
``profile_trace_dir`` set, ``metrics.jsonl`` holds one ``counters`` event
(``profiling.counter_values()`` of the run's capture: ``host_sync``, the
host's reads of the card) just before ``pipeline_done``, and the capture's
trace.json nests the port's spans under the runner's stages; without it
there is no such event and nothing is recorded."""

import json
import os

import pytest
import torch

from pointcloudprocessor_tpu_torch.pipeline import runner as trunner
from pointcloudprocessor_tpu_torch.utils import config as tcfg
from pointcloudprocessor_tpu_torch.utils import profiling as tprof

from test_pipeline_e2e import small_config, write_dataset

CPU = "cpu"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """tests/test_pipeline_e2e.py's dataset through the port's runner with a
    short NID solve, once without and once with ``profile_trace_dir``:
    {traced: (events, counters, trace.json text or None)}."""
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("counters")
    write_dataset(root)
    out = {}
    for traced in (False, True):
        cfg = tcfg.PipelineConfig.from_json(small_config(root).to_json())
        cfg.enable_nid_optimize = True
        cfg.nid.max_outer_iterations = 1
        cfg.nid.max_inner_iterations = 3
        cfg.output_path = str(root / f"out_{traced}") + os.sep
        cfg.profile_trace_dir = str(root / "trace") if traced else ""
        tprof.reset_trace()
        trunner.process(cfg, CPU)
        with open(os.path.join(cfg.output_path, "metrics.jsonl")) as f:
            events = [json.loads(line) for line in f]
        text = None
        if traced:
            with open(root / "trace" / "trace.json") as f:
                text = f.read()
        out[traced] = (events, tprof.counter_values(), text)
    tprof.reset_trace()
    torch.set_num_threads(torch_threads)
    return out


@pytest.mark.parametrize("traced", [False, True])
def test_runner_logs_its_counters(runs, traced):
    events, counters, text = runs[traced]
    names = [e["event"] for e in events]
    assert not [n for n in names if n.startswith("cost_estimate_")]
    (refined,) = [e for e in events if e["event"] == "nid_refined"]
    if not traced:
        assert "counters" not in names and counters == {}
        return
    (logged,) = [e for e in events if e["event"] == "counters"]
    assert names.index("counters") == names.index("pipeline_done") - 1
    assert {k: v for k, v in logged.items() if k not in ("ts", "event")} == counters
    # At least the trust-region guard's read an evaluation.
    assert counters["host_sync"] >= refined["evaluations"] > 0
    for span in ("stage.nid_refine", "refine.solve", "bfgs.line_search", "nid.histograms",
                 "stage.colorize_fuse", "colorize.fuse", "colorize.keyframe"):
        assert f'"{span}"' in text, span
