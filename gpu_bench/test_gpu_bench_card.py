"""Each cell once on the card, a short window: correct, and the result line
as the contract has it. Marked ``cuda``: each test skips without a card.
Run on the card: ``python3 -m pytest gpu_bench -q``."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("cell", [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_runs_correct_on_the_card(card, cell, trace):
    proc = subprocess.run([sys.executable, "-m", "gpu_bench.run", "--workload", cell, "--seed", str(2**31 + 77),
                           "--seconds", "3", "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert list(res)[-1] == "checks" and res["metrics"]
    if trace:
        assert 0 <= res["device"]["busy_s"] <= res["device"]["window_s"]
