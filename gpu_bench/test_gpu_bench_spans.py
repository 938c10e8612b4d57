"""The readers of the program's spans (``ranges.py``: ``handoff.ms.score``,
``feed.ms.train``): their arithmetic on a hand-built trace, nothing where a
program has no such span, and a number from each cell's traced run on the
CPU at a tiny size."""

import json
import shutil
from pathlib import Path

import pytest
import torch

from gpu_bench import run, spec, trace

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(pods=900, services=100, window_edges=4_000)


def _trace(host):
    return trace.DeviceTrace(window_s=1e-2, busy_s=1e-3, device=[("k", 0, 1_000_000)], host=host,
                             span_ns=(0, 10_000_000))


def test_span_readers_take_the_mean_of_their_ranges_on_any_thread():
    host = [
        ("alaz.handoff", 0, 1_000_000, 1),
        ("alaz.gauges", 100_000, 900_000, 1),
        ("alaz.handoff", 5_000_000, 8_000_000, 4),
        ("alaz.feed", 2_000_000, 2_500_000, 1),
        ("aten::copy_", 0, 9_000_000, 1),
    ]
    rec = {"trace": _trace(host)}
    assert spec.reader(ROOT, "handoff.ms.score")(rec) == pytest.approx(2.0)
    assert spec.reader(ROOT, "feed.ms.train")(rec) == pytest.approx(0.5)


@pytest.mark.parametrize("name", ["handoff.ms.score", "feed.ms.train"])
def test_span_readers_give_nothing_without_the_span(name):
    read = spec.reader(ROOT, name)
    assert read({}) is None
    assert read({"trace": None}) is None
    # a program without the span: its trace has operations and no range
    assert read({"trace": _trace([("aten::copy_", 0, 9_000_000, 1), ("alaz.other", 0, 10, 1)])}) is None


@pytest.fixture
def tiny_root(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "gpu_bench", root / "gpu_bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for f in (root / "gpu_bench" / "configs").glob("*.json"):
        cfg = json.loads(f.read_text())
        cfg["deployment"].update(TINY)
        f.write_text(json.dumps(cfg))
    torch.manual_seed(0)
    return root


@pytest.mark.parametrize("cell,metric", [("sage-fleet-windows", "handoff.ms.score"),
                                         ("gat-fleet-train", "feed.ms.train")])
def test_a_traced_run_reads_its_span(tiny_root, cell, metric):
    res = run.execute(cell, 2**31 + 17, 1.0, True, device="cpu", root=tiny_root)
    assert res["metrics"][metric]["value"] > 0 and res["metrics"][metric]["unit"] == "ms"
    if cell == "sage-fleet-windows":
        assert res["correct"], res["checks"]
