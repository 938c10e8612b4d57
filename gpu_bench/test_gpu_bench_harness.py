"""The harness on the CPU: files found by name, a cell added by new files
alone, the metric arithmetic, the refusal without a card, and nothing the
benchmark runs importing JAX or the JAX package."""

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from gpu_bench import run, spec, trace, yardstick

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "gpu_bench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_the_contracts_shape():
    b = spec.load(ROOT)
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["gpu_bench"] and 1 <= b["run_seconds"] <= 51
    cells = {w["name"] for w in b["workloads"]}
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]] + list(cells) + [c["name"] for c in b["configs"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and (ROOT / c["file"]).is_file()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert (PKG / "traffic" / f"{w['traffic']}.json").is_file() and (PKG / "limits" / f"{w['name']}.json").is_file()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace") and UNIT.match(m["unit"])
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and (PKG / "metrics" / f"{m['name']}.py").is_file() and UNIT.match(m["unit"])
        for cell in m.get("workloads", cells):
            reported = e2e[m["moves"]].get("workloads", cells)
            assert cell in reported, (m["name"], cell)
    for cell in cells:
        c = spec.cell(ROOT, cell, b)
        assert len(c.end_to_end) >= 2 and c.per_layer


def _copy_tree(tmp_path: Path) -> Path:
    root = tmp_path / "checkout"
    shutil.copytree(PKG, root / "gpu_bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def test_a_cell_added_by_new_files_alone_is_found_by_name(tmp_path):
    root = _copy_tree(tmp_path)
    before = {p: p.read_bytes() for p in (root / "gpu_bench").rglob("*") if p.is_file()}
    b = json.loads((root / "BENCHMARK.json").read_text())
    sage = json.loads((root / "gpu_bench/configs/graphsage-fleet100k.json").read_text())
    sage["deployment"].update(pods=90, services=10, window_edges=400, name="tiny")
    (root / "gpu_bench/configs/tiny.json").write_text(json.dumps(sage))
    (root / "gpu_bench/traffic/tiny-windows.json").write_text(json.dumps(
        {"load": "windows", "distinct_windows": 2, "queue_depth": 1, "warmup_passes": 1, "poll_s": 0.001,
         "alert_share": 0.02}))
    (root / "gpu_bench/limits/tiny-cell.json").write_text(json.dumps({"score_max_abs_err": 0.05}))
    (root / "gpu_bench/metrics/tiny.edges.py").write_text("def read(run):\n    return float(run['n_edges'])\n")
    b["configs"].append({"name": "tiny", "source": "test", "file": "gpu_bench/configs/tiny.json",
                         "reduced": ["deployment"], "why": "test"})
    b["workloads"].append({"name": "tiny-cell", "config": "tiny", "traffic": "tiny-windows", "chips": 1, "why": "test"})
    b["end_to_end"][0]["workloads"].append("tiny-cell")
    b["per_layer"].append({"name": "tiny.edges", "unit": "edges", "better": "higher", "source": "program_counter",
                           "layer": "test", "moves": "window_device_ms", "workloads": ["tiny-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.cell(root, "tiny-cell")
    assert cell.config["deployment"]["window_edges"] == 400 and cell.traffic["distinct_windows"] == 2
    assert [m["name"] for m in cell.per_layer] == ["tiny.edges"]
    assert {m["name"] for m in cell.end_to_end} == {"window_device_ms", "setup_s"}
    assert spec.reader(root, "tiny.edges")({"n_edges": 400}) == 400.0
    # the cell runs end to end (its own load loop on the CPU) and every file
    # that was there before is unchanged
    res = run.execute("tiny-cell", 2**31 + 5, 0.5, True, device="cpu", root=root)
    assert res["correct"] and res["metrics"]["tiny.edges"]["value"] == 400.0
    assert list(res)[-1] == "checks"
    assert all(p.read_bytes() == data for p, data in before.items())


def test_tail_and_rate_take_every_sample_and_the_whole_window():
    samples = list(range(1, 101))
    assert yardstick.p95(samples) == pytest.approx(95.05)
    assert yardstick.p95([]) is None
    assert yardstick.rate(300, 30.0) == 10.0


def test_roofline_and_mfu_from_given_counts_and_times():
    assert yardstick.roofline_pct(3.35e9, 0.0, 2e-3) == pytest.approx(50.0)
    assert yardstick.roofline_pct(0.0, 989e9, 1e-3) == pytest.approx(100.0)
    assert yardstick.mfu_pct(989e12, 2.0) == pytest.approx(50.0)
    cfg = json.loads((PKG / "configs/graphsage-fleet100k.json").read_text())
    # embed + 2 layers x (3 node products + edge_proj) + edge head + node head
    n, e, h, ef = 10, 20, 128, 23
    want = 2 * n * 32 * h + 2 * (3 * 2 * n * h * h + 2 * e * ef * h) + 2 * 2 * n * h * h + 2 * e * ef * h \
        + 2 * e * h + 2 * n * h * h + 2 * n * h
    assert yardstick.forward_flops(cfg, n, e) == want
    assert yardstick.sorted_segment_sum_bytes(cfg, 128, 256) == 256 * (128 * 2 + 4) + 128 * 128 * 2


def _trace(device):
    end = max(e for _, _, e in device)
    return trace.DeviceTrace(window_s=end * 1e-9, busy_s=sum(e - s for _, s, e in device) * 1e-9, device=device,
                             host=[("aten::copy_", 0, 2_000_000, 7)], span_ns=(0, end))


def _reader(name):
    return spec.reader(ROOT, name)


def test_readers_give_null_on_no_match_and_never_zero():
    cfg = json.loads((PKG / "configs/gat-fleet100k.json").read_text())
    run_rec = {"cfg": cfg, "n_pad": 131072, "e_pad": 1048576, "trace": _trace([("other_kernel", 0, 1000)])}
    for name in ("k1_roofline", "k3_roofline", "k4_roofline", "sort_roofline"):
        assert _reader(name)(run_rec) is None
    assert _reader("k1_roofline")(dict(run_rec, trace=None)) is None
    assert _reader("score.mfu")(dict(run_rec, trace=None, windows_scored=3)) is None
    assert _reader("scorer.edges_per_s")(run_rec) is None
    k1 = yardstick.sorted_segment_sum_bytes(cfg, 131072, 1048576)
    dur = int(k1 / yardstick.HBM_BYTES_PER_S * 1e9 * 2)  # twice the bound: 50%
    rec = dict(run_rec, trace=_trace([("void scatter_sum_sorted_kernel<bf16>", 0, dur)]))
    assert _reader("k1_roofline")(rec) == pytest.approx(50.0, rel=1e-6)


def test_idle_share_and_gaps_from_the_timeline():
    tr = _trace([("a", 0, 100_000), ("b", 50_000, 200_000), ("c", 1_200_000, 1_300_000)])
    tr.window_s, tr.busy_s = 1.2e-3, 0.3e-3  # the union of the three: 300 us
    assert _reader("device_idle.score")({"trace": tr}) == pytest.approx(75.0)
    gaps = tr.idle_gaps()
    assert gaps[0][1] == pytest.approx(1e-3) and gaps[0][0].startswith("aten::copy_")


def test_a_run_without_a_card_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "-m", "gpu_bench.run", "--workload", "sage-fleet-windows",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_a_checkout_of_only_the_benchmark_fails_and_prints_no_result(tmp_path):
    root = _copy_tree(tmp_path)
    proc = subprocess.run([sys.executable, "-m", "gpu_bench.run", "--workload", "sage-fleet-windows",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=root, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


FORBIDDEN = {"jax", "jaxlib", "alaz_tpu"}


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py"))
    assert files
    for f in files:
        assert not (_imports(f) & FORBIDDEN), f
    for f in ("reference.py", "gen_windows.py", "yardstick.py"):
        assert "alaz_tpu_torch" not in _imports(PKG / f), f


def test_what_a_run_loads_holds_no_jax_and_the_reference_no_program():
    code = (
        "import sys\n"
        "import gpu_bench.reference, gpu_bench.gen_windows, gpu_bench.yardstick\n"
        "assert not any(m.split('.')[0] == 'alaz_tpu_torch' for m in sys.modules), 'reference loads the program'\n"
        "from gpu_bench import run, spec, plant\n"
        "from gpu_bench.loads import windows, train\n"
        "import alaz_tpu_torch.runtime.service, alaz_tpu_torch.train.trainstep, alaz_tpu_torch.graph.native\n"
        "for m in spec.load(run.ROOT)['per_layer']: spec.reader(run.ROOT, m['name'])\n"
        "bad = run.forbidden_modules()\n"
        "assert bad == [], bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


class _Ev:
    def __init__(self, name, dev, s, d, tid=1):
        self._n, self._dev, self._s, self._d, self._tid = name, dev, s, d, tid

    def name(self):
        return self._n

    def device_type(self):
        return f"DeviceType.{self._dev}"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def start_thread_id(self):
        return self._tid


def test_the_trace_is_clipped_to_the_window_mark_and_the_mark_is_no_work():
    evs = [
        _Ev(trace.MARK, "CPU", 1_000, 10_000),  # the window: [1000, 11000)
        _Ev(trace.MARK, "CUDA", 1_000, 10_000),  # its copy on the device timeline
        _Ev("k_before", "CUDA", 0, 2_000),  # 1000 of it inside
        _Ev("k_a", "CUDA", 3_000, 1_000),
        _Ev("k_b", "CUDA", 3_500, 1_000),  # overlaps k_a: the union counts once
        _Ev("k_after", "CUDA", 12_000, 1_000),
        _Ev("aten::mm", "CPU", 5_000, 3_000),
    ]
    tr = trace.reduce(evs)
    assert tr.window_s == pytest.approx(10_000e-9)
    assert tr.busy_s == pytest.approx((1_000 + 1_500) * 1e-9)
    assert {n for n, _, _ in tr.device} == {"k_before", "k_a", "k_b"}
    gaps = tr.idle_gaps()
    assert gaps[0] == ["aten::mm (thread 1)", pytest.approx(6_500e-9)]  # k_b's end to the window's
    assert gaps[1] == ["no host op recorded", pytest.approx(1_000e-9)]


def test_an_untraced_run_reads_the_devices_busy_time_and_nothing_without_activity():
    evs = [_Ev("k_a", "CUDA", 0, 4_000), _Ev("k_b", "CUDA", 3_000, 2_000), _Ev("Memcpy HtoD", "CUDA", 10_000, 1_000),
           _Ev("aten::mm", "CPU", 0, 20_000)]
    assert trace.busy_seconds(evs) == pytest.approx(6_000e-9)  # k_a and k_b overlap: [0, 5000) and the copy
    assert trace.busy_seconds([_Ev("aten::mm", "CPU", 0, 20_000)]) is None
