#!/usr/bin/env python3
"""Run ``python -m alaz_tpu serve --flat-out`` and ``python -m
alaz_tpu_torch serve --flat-out --device cpu`` on the same replayed
traffic and compare what each closed and lost.

    JAX_PLATFORMS=cpu python tests/torch_serve_cli_compare.py \\
        [--config testconfig/config4_temporal.json] [--duration 3.1] [--runs 2] \\
        [--paced] [--edge-rate N] [--torch-in-jax] [--engine-alone [--hash-seed N]]

The traffic is the config with its testDuration cut (the smoke's serve
phases cut it to 3.1 s). Neither run loads a checkpoint, so both close
and trace windows and score nothing. Each CLI runs in its own process,
the two packages alternating; a hook on ``Service.stop`` reads the
service's ``windows.closed`` counter and its drop ledger by cause as the
CLI shuts down, with what explains a difference between the two: the
CPU time of the replay thread and the l7 worker (each thread's
``time.thread_time`` as its ``run`` returns), the collector's pauses and
collections (``gc.callbacks``), and the gc-tracked objects, threads and
modules at ``Service.start``. ``--paced`` replays at the wall clock's
pace instead; ``--torch-in-jax`` adds a third run a round, the JAX
package with ``torch`` imported into its process first, which separates
the torch runtime from the port's own code. ``--engine-alone`` times
each package's L7 engine alone over the same events, in one thread of a
process of its own, instead of the CLI. Prints one JSON line per run and a last line with the
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
import gc, json, resource, sys, threading, time
pkg, _, preload = sys.argv[1].partition("+")
for mod in filter(None, preload.split(",")):
    __import__(mod)

# each thread's own CPU time, read as its run() returns
thread_cpu = {}
run = threading.Thread.run

def timed_run(self):
    try:
        run(self)
    finally:
        thread_cpu[self.name] = thread_cpu.get(self.name, 0.0) + time.thread_time()

threading.Thread.run = timed_run

# the collector's pauses, by generation
gc_pause = {"s": 0.0, "collections": [0, 0, 0]}
gc_t0 = [0.0]

def on_gc(phase, info):
    if phase == "start":
        gc_t0[0] = time.perf_counter()
    else:
        gc_pause["s"] += time.perf_counter() - gc_t0[0]
        gc_pause["collections"][info["generation"]] += 1

gc.callbacks.append(on_gc)
service = __import__(pkg + ".runtime.service", fromlist=["Service"])
start, stop = service.Service.start, service.Service.stop
at_start = {}

def hooked_start(self):
    at_start["gc_objects"] = len(gc.get_objects())
    at_start["threads"] = sorted(t.name for t in threading.enumerate())
    at_start["modules"] = len(sys.modules)
    at_start["gc_at_start"] = (gc_pause["s"], list(gc_pause["collections"]))
    start(self)

def hooked_stop(self):
    stop(self)
    print("SERVE_COUNTS " + json.dumps({
        "windows_closed": self.metrics.counter("windows.closed").value,
        "events_lost": self.ledger.total,
        "lost_by_cause": {k: v for k, v in self.ledger.snapshot().items() if v},
        "thread_cpu_s": {k: round(v, 3) for k, v in thread_cpu.items() if k in ("alaz-l7", "alaz-replay")},
        "other_threads_cpu_s": round(sum(v for k, v in thread_cpu.items() if k not in ("alaz-l7", "alaz-replay")), 3),
        "process_cpu_s": round(sum(resource.getrusage(resource.RUSAGE_SELF)[:2]), 3),
        "gc_pause_s": round(gc_pause["s"], 4),
        "gc_collections": gc_pause["collections"],
        "gc_pause_s_serving": round(gc_pause["s"] - at_start["gc_at_start"][0], 4),
        "gc_collections_serving": [a - b for a, b in zip(gc_pause["collections"], at_start["gc_at_start"][1])],
        **{k: v for k, v in at_start.items() if k != "gc_at_start"},
    }), file=sys.stderr, flush=True)

service.Service.start, service.Service.stop = hooked_start, hooked_stop
cli = __import__(pkg + ".__main__", fromlist=["main"])
sys.exit(cli.main(sys.argv[2:]))
"""

# the package's copied L7 engine alone, in one thread, over the cut
# traffic's L7 events (generated first, outside the timing); prints the
# thread's CPU time and wall time as one JSON line on stderr
_ENGINE_RUNNER = """
import json, sys, time
pkg, _, preload = sys.argv[1].partition("+")
for mod in filter(None, preload.split(",")):
    __import__(mod)
mod = lambda name, attr: getattr(__import__(pkg + name, fromlist=[attr]), attr)
SimulationConfig, Interner = mod(".config", "SimulationConfig"), mod(".events.intern", "Interner")
Simulator, Aggregator = mod(".replay.simulator", "Simulator"), mod(".aggregator.engine", "Aggregator")
InMemDataStore = mod(".datastore.inmem", "InMemDataStore")
interner = Interner()
sim = Simulator(SimulationConfig.from_json(json.load(open(sys.argv[2]))), interner=interner)
agg = Aggregator(InMemDataStore(), interner=interner)
for msg in sim.setup():
    agg.process_k8s(msg)
agg.process_tcp(sim.tcp_events())
batches = list(sim.iter_l7_batches())
c0, w0 = time.thread_time(), time.perf_counter()
for b in batches:
    agg.process_l7(b, now_ns=int(b["write_time_ns"][-1]))
print("ENGINE_TIME " + json.dumps({"events": sum(len(b) for b in batches),
      "engine_cpu_s": round(time.thread_time() - c0, 3), "engine_wall_s": round(time.perf_counter() - w0, 3)}),
      file=sys.stderr, flush=True)
"""


def cut_traffic(raw: dict, duration_s: float, edge_rate=None) -> dict:
    """The replay config with its testDuration (and, where given, its
    per-edge request rate) cut."""
    out = dict(raw, testDuration=duration_s)
    if edge_rate is not None:
        out["edgeRate"] = edge_rate
    return out


def run_once(pkg: str, traffic: str, paced: bool = False, preload: tuple = ()) -> dict:
    """One CLI run of ``pkg``, with the modules of ``preload`` imported
    into its process first."""
    args = ["serve", "--config", traffic, "--debug-port", "0"] + ([] if paced else ["--flat-out"])
    if pkg == "alaz_tpu_torch":
        args += ["--device", "cpu"]
    env = {k: v for k, v in os.environ.items() if k not in ("MODEL", "EDGE_LAYOUT", "BACKEND_HOST")}
    env["JAX_PLATFORMS"] = "cpu"
    tag = pkg + ("+" + ",".join(preload) if preload else "")
    proc = subprocess.run([sys.executable, "-c", _RUNNER, tag, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{pkg} serve exited {proc.returncode}: {proc.stderr[-2000:]}")
    (line,) = [ln for ln in proc.stderr.splitlines() if ln.startswith("SERVE_COUNTS ")]
    return {"package": tag, **json.loads(line.split(" ", 1)[1])}


def engine_once(pkg: str, traffic: str, preload: tuple = (), hash_seed=None) -> dict:
    """``pkg``'s L7 engine alone over the traffic's events, in a process
    of its own with the modules of ``preload`` imported first (and
    ``PYTHONHASHSEED`` set to ``hash_seed`` where given)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    if hash_seed is not None:
        env["PYTHONHASHSEED"] = str(hash_seed)
    tag = pkg + ("+" + ",".join(preload) if preload else "")
    proc = subprocess.run([sys.executable, "-c", _ENGINE_RUNNER, tag, traffic], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{pkg} engine exited {proc.returncode}: {proc.stderr[-2000:]}")
    (line,) = [ln for ln in proc.stderr.splitlines() if ln.startswith("ENGINE_TIME ")]
    return {"package": tag, **json.loads(line.split(" ", 1)[1])}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default="testconfig/config4_temporal.json")
    p.add_argument("--duration", type=float, default=3.1, help="testDuration of the cut traffic, seconds")
    p.add_argument("--runs", type=int, default=2, help="runs of each package, alternating")
    p.add_argument("--paced", action="store_true", help="replay paced to the wall clock instead of flat out")
    p.add_argument("--edge-rate", type=int, default=None, help="requests a second per edge (default: the config's)")
    p.add_argument("--torch-in-jax", action="store_true",
                   help="also run the JAX package with torch imported into its process first")
    p.add_argument("--engine-alone", action="store_true",
                   help="time each package's L7 engine alone over the traffic instead of its CLI")
    p.add_argument("--hash-seed", type=int, default=None,
                   help="PYTHONHASHSEED of each --engine-alone process (default: random, as Python sets it)")
    args = p.parse_args(argv)
    raw = json.loads((REPO / args.config).read_text())
    with tempfile.TemporaryDirectory() as tmp:
        traffic = str(Path(tmp) / "traffic.json")
        Path(traffic).write_text(json.dumps(cut_traffic(raw, args.duration, args.edge_rate)))
        variants = [("alaz_tpu", ()), ("alaz_tpu_torch", ())]
        if args.torch_in_jax:
            variants.append(("alaz_tpu", ("torch",)))
        runs = []
        for _ in range(args.runs):
            for pkg, preload in variants:
                if args.engine_alone:
                    runs.append(engine_once(pkg, traffic, preload, args.hash_seed))
                else:
                    runs.append(run_once(pkg, traffic, args.paced, preload))
                print(json.dumps(runs[-1]), flush=True)
    tags = list(dict.fromkeys(r["package"] for r in runs))
    if args.engine_alone:
        print(json.dumps({"config": args.config, "duration_s": args.duration, "edge_rate": args.edge_rate,
                          "hash_seed": args.hash_seed,
                          **{tag: {"engine_cpu_s": [r["engine_cpu_s"] for r in runs if r["package"] == tag]}
                             for tag in tags}}))
        return 0
    print(json.dumps({
        "config": args.config, "duration_s": args.duration, "paced": args.paced, "edge_rate": args.edge_rate,
        **{tag: {"windows_closed": [r["windows_closed"] for r in runs if r["package"] == tag],
                 "events_lost": [r["events_lost"] for r in runs if r["package"] == tag],
                 "l7_cpu_s": [r["thread_cpu_s"].get("alaz-l7") for r in runs if r["package"] == tag]}
           for tag in tags},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
