"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix. The
configuration's file is the one its ``configs`` entry gives; the traffic
mix is ``traffic/<traffic>.json``; each per-layer metric is read by
``metrics/<metric name>.py``; each cell's correctness limits are in
``limits/<cell>.json``. Adding a cell, a mix or a metric adds files and
entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

PKG = "gpu_bench"


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file's contents
    traffic: dict  # the traffic file's contents
    end_to_end: list  # the BENCHMARK.json metric entries this cell reports
    per_layer: list
    limits: dict


def load(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str, e2e_names: set | None = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def cell(root: Path, name: str, bench: dict | None = None) -> Cell:
    bench = bench if bench is not None else load(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(by_name)})")
    w = by_name[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((root / PKG / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    limits = json.loads((root / PKG / "limits" / f"{name}.json").read_text())
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=e2e, per_layer=per_layer, limits=limits)


def reader(root: Path, metric: str):
    """The ``read(run) -> float | None`` of ``metrics/<metric>.py``."""
    path = root / PKG / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"gpu_bench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
