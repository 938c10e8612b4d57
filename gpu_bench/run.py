"""Run one cell of the benchmark once and print its result line.

    python3 -m gpu_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics (read under the profiler).
The run measures ``alaz_tpu_torch`` on the CUDA device only: with no card,
or fewer cards than the cell asks for, it exits 2 and prints no result.
The last line of standard output is one JSON object; the last lines of
standard error are the numbers ``correct`` was decided on, each beside its
limit.

``--plant <name>`` puts the control or a fault in the program's place
(``plant.py``) for the readings the limits are set from; the benchmark's
own runs never pass it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "alaz_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_info() -> dict:
    """The card's name, power limit and SM clock from ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as exc:
        return {"nvidia_smi": f"unavailable: {exc!r}"}
    return {"nvidia_smi": out[0] if out else ""}


def execute(cell_name: str, seed: int, seconds: float, trace: bool, device: str = "cuda", root: Path = ROOT,
            plant: str | None = None) -> dict:
    """Drive the cell once, with ``plant`` (``plant.py``) in the program's
    place if given; the result object (without the card check)."""
    from gpu_bench import plant as planting, spec

    cell = spec.cell(root, cell_name)
    load = importlib.import_module(f"gpu_bench.loads.{cell.traffic['load']}")
    with planting.planted(plant, cell.config):
        out = load.run(cell, seed, seconds, trace, device)
    setup_s = out.window_start - T_START
    marks = {k: t - T_START for k, t in out.record.get("marks", {}).items()}
    print(f"gpu_bench: set-up {json.dumps(dict(marks, window=setup_s))} s from the process's start", file=sys.stderr)
    metrics = {}
    if trace:
        record = dict(out.record, trace=out.trace, e2e=out.e2e)
        for m in cell.per_layer:
            value = spec.reader(root, m["name"])(record)
            if value is None:
                print(f"gpu_bench: {m['name']}: nothing to read in this run", file=sys.stderr)
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        counts = {k: v for k, v in out.record.items() if isinstance(v, (int, float))}
        print(f"gpu_bench: end-to-end readings {json.dumps(out.e2e, default=float)}; "
              f"counts {json.dumps(counts)}", file=sys.stderr)
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else out.e2e.get(m["name"])
            if value is None and m["source"] == "device_trace" and device != "cuda":
                continue  # no device, no device metric
            if value is None:
                raise RuntimeError(f"{cell_name}: the run gave no {m['name']}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(c["value"] <= c["limit"] for c in out.checks.values())
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": _kind(device), "count": cell.chips,
           "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": dev}
    if trace and out.trace is not None:
        dev["busy_s"] = out.trace.busy_s
        dev["window_s"] = out.trace.window_s
        result["breakdown"] = {"device_ops": out.trace.top_ops(), "idle_gaps": out.trace.idle_gaps()}
    result["checks"] = out.checks
    return result


def _kind(device: str) -> str:
    if device != "cuda":
        return device
    import torch

    return torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--plant", default=None, help="a control or fault of plant.py (readings only)")
    args = ap.parse_args(argv)

    from gpu_bench import plant as planting, spec

    if args.plant is not None and args.plant not in planting.PLANTS:
        print(f"gpu_bench: no plant {args.plant!r} (have {sorted(planting.PLANTS)})", file=sys.stderr)
        return 2

    try:
        cell = spec.cell(ROOT, args.workload)
    except (OSError, KeyError) as exc:
        print(f"gpu_bench: {exc}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"gpu_bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    if importlib.util.find_spec("alaz_tpu_torch") is None:
        print("gpu_bench: the program (alaz_tpu_torch) is not in this checkout", file=sys.stderr)
        return 2
    result = execute(args.workload, args.seed, args.seconds, bool(args.trace), plant=args.plant)
    bad = forbidden_modules()
    if bad:
        print(f"gpu_bench: the run loaded {bad}: the benchmark measures alaz_tpu_torch alone", file=sys.stderr)
        return 3
    print(f"gpu_bench: card {json.dumps(card_info())}; peaks: 989 TFLOP/s bf16, 3.35 TB/s", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"gpu_bench check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
