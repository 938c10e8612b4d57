#!/usr/bin/env python3
"""Run ``python -m alaz_tpu serve --flat-out`` and ``python -m
alaz_tpu_torch serve --flat-out --device cpu`` on the same replayed
traffic and compare what each closed and lost.

    JAX_PLATFORMS=cpu python tests/torch_serve_cli_compare.py \\
        [--config testconfig/config4_temporal.json] [--duration 3.1] [--runs 2]

The traffic is the config with its testDuration cut (the smoke's serve
phases cut it to 3.1 s). Neither run loads a checkpoint, so both close
and trace windows and score nothing. Each CLI runs in its own process,
the two packages alternating; a hook on ``Service.stop`` reads the
service's ``windows.closed`` counter and its drop ledger by cause as the
CLI shuts down. Prints one JSON line per run and a last line with the
counts side by side. Flat out, the replay offers traffic faster than the
Python aggregator takes it, so what the source queues shed varies from
run to run: compare the spread, not one pair.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

# runs the package's CLI in-process with Service.stop hooked to print the
# service's counts as one JSON line on stderr
_RUNNER = """
import json, sys
pkg = sys.argv[1]
service = __import__(pkg + ".runtime.service", fromlist=["Service"])
stop = service.Service.stop

def hooked(self):
    stop(self)
    print("SERVE_COUNTS " + json.dumps({
        "windows_closed": self.metrics.counter("windows.closed").value,
        "events_lost": self.ledger.total,
        "lost_by_cause": {k: v for k, v in self.ledger.snapshot().items() if v},
    }), file=sys.stderr, flush=True)

service.Service.stop = hooked
cli = __import__(pkg + ".__main__", fromlist=["main"])
sys.exit(cli.main(sys.argv[2:]))
"""


def run_once(pkg: str, traffic: str) -> dict:
    args = ["serve", "--config", traffic, "--flat-out", "--debug-port", "0"]
    if pkg == "alaz_tpu_torch":
        args += ["--device", "cpu"]
    env = {k: v for k, v in os.environ.items() if k not in ("MODEL", "EDGE_LAYOUT", "BACKEND_HOST")}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "-c", _RUNNER, pkg, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{pkg} serve exited {proc.returncode}: {proc.stderr[-2000:]}")
    (line,) = [ln for ln in proc.stderr.splitlines() if ln.startswith("SERVE_COUNTS ")]
    return {"package": pkg, **json.loads(line.split(" ", 1)[1])}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default="testconfig/config4_temporal.json")
    p.add_argument("--duration", type=float, default=3.1, help="testDuration of the cut traffic, seconds")
    p.add_argument("--runs", type=int, default=2, help="runs of each package, alternating")
    args = p.parse_args(argv)
    raw = json.loads((REPO / args.config).read_text())
    with tempfile.TemporaryDirectory() as tmp:
        traffic = str(Path(tmp) / "traffic.json")
        Path(traffic).write_text(json.dumps(dict(raw, testDuration=args.duration)))
        runs = []
        for _ in range(args.runs):
            for pkg in ("alaz_tpu", "alaz_tpu_torch"):
                runs.append(run_once(pkg, traffic))
                print(json.dumps(runs[-1]), flush=True)
    print(json.dumps({
        "config": args.config, "duration_s": args.duration,
        **{pkg: {"windows_closed": [r["windows_closed"] for r in runs if r["package"] == pkg],
                 "events_lost": [r["events_lost"] for r in runs if r["package"] == pkg]}
           for pkg in ("alaz_tpu", "alaz_tpu_torch")},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
