"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped and everything else runs, on the CPU
at a tiny size, with the cells' own limits, the control or a fault planted
in the program's place (``plant.py``)."""

import json
import shutil
from pathlib import Path

import pytest
import torch

from gpu_bench import run

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(pods=9_000, services=1_000, window_edges=40_000)
TINY_REPLAY = dict(pods=40_000, services=4_000, edges=20_000, event_seconds=2, chunk_size=8192,
                   warm_window={"pods": 700, "services": 190, "edges": 800})

REPLAY_CELL = {"name": "sage-fleet-replay", "config": "graphsage-fleet100k", "traffic": "config5-replay", "chips": 1,
               "why": "config5 flat out in one process, native L7 engine and C++ window close, 40k-edge windows"}


@pytest.fixture
def tiny_root(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "gpu_bench", root / "gpu_bench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    # the replay cell waits outside BENCHMARK.json (PERF.md, Open questions);
    # its load, traffic and limits are held here all the same
    bench["workloads"].append(REPLAY_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for f in (root / "gpu_bench" / "configs").glob("*.json"):
        cfg = json.loads(f.read_text())
        cfg["deployment"].update(TINY)
        f.write_text(json.dumps(cfg))
    replay = root / "gpu_bench" / "traffic" / "config5-replay.json"
    replay.write_text(json.dumps(dict(json.loads(replay.read_text()), **TINY_REPLAY)))
    torch.manual_seed(0)
    return root


def _run(root, cell):
    return run.execute(cell, 2**31 + 99, 3.0, False, device="cpu", root=root)


@pytest.mark.parametrize("cell", ["sage-fleet-windows", "gat-fleet-train"])
def test_sound_runs_are_correct(tiny_root, cell):
    assert _run(tiny_root, cell)["correct"]


def test_a_sound_replay_matches_the_reference(tiny_root):
    res = _run(tiny_root, "sage-fleet-replay")
    checks = res["checks"]
    # the small traffic may all be taken in before the window closes: the
    # exhaustion check is for the cell's own size
    assert all(c["value"] <= c["limit"] for k, c in checks.items() if k != "traffic_exhausted"), checks


CELLS = ["sage-fleet-windows", "sage-fleet-replay", "gat-fleet-train"]


@pytest.mark.parametrize("cell,plant,number", [(c, "fp8", None) for c in CELLS]
                         + [(c, "answer_altered", None) for c in CELLS]
                         + [("gat-fleet-train", "half_batch", "logit_grad_err"),
                            ("gat-fleet-train", "state_unchanged", "update_norm_gap"),
                            ("gat-fleet-train", "identity_cache", "logit_grad_err")])
def test_the_control_and_each_fault_come_out_not_correct(tiny_root, cell, plant, number):
    res = run.execute(cell, 2**31 + 99, 3.0, False, device="cpu", root=tiny_root, plant=plant)
    failing = [k for k, c in res["checks"].items() if c["value"] > c["limit"] and k != "traffic_exhausted"]
    assert not res["correct"] and failing, res["checks"]
    if number is not None:
        assert number in failing, res["checks"]


def test_two_hand_offs_of_one_window_score_apart_by_more_than_the_limit(tiny_root):
    """A program that kept a hand-off's arrays or results for a later
    hand-off of the same window would be caught: the two differ in the
    node features' last column, and their scores by more than the limit."""
    from gpu_bench import common, reference, spec

    c = spec.cell(tiny_root, "sage-fleet-windows")
    raw = common.make_raw_windows(c.config, 3, 1)[0]
    params = reference.make_params(c.config, 3, "cpu")
    with torch.no_grad():
        a, b = (torch.sigmoid(reference.forward(params, reference.to_tensors(common.marked(raw, k, 3), "cpu"),
                                                c.config)) for k in (8, 12))
    assert float((a - b).abs().max()) > 2 * c.limits["score_max_abs_err"]
