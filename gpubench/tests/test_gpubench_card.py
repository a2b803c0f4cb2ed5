"""On the card: each cell runs through run.py, as the benchmark's command,
and comes out correct with its metrics. Skipped without a CUDA device (the
look is made inside the test). Run on the card with
``python -m pytest gpubench/tests -m card``."""

import json
import subprocess
import sys

import pytest

from tiny import CELLS, ROOT


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: no CUDA device here")
    p = subprocess.run([sys.executable, "gpubench/run.py", "--workload", cell, "--seed",
                        str(2**31 + 5), "--seconds", "3", "--trace", str(trace)], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert p.stderr.strip().splitlines()[-1].startswith("check ")
    if trace:
        assert res["device"]["busy_s"] > 0 and res["breakdown"]["device_ops"]
