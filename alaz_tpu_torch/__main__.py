"""CLI of the port: the JAX package's ``python -m alaz_tpu``, ``serve``
subcommand.

  python -m alaz_tpu_torch serve --config testconfig/config3_10k_mixed.json \\
      --flat-out [--ckpt DIR] [--debug-port 8181] [--device cuda|cpu]

Runs the streaming scoring ``Service`` over replayed traffic: replay
source → aggregator → window close → scorer (the model through the
hand-written kernels) → score plane → score sink. Scoring runs on the
card unless ``--device cpu`` is given; with no card it raises. Settings
come from the environment as in the JAX package (``RuntimeConfig.
from_env``: ``MODEL``, ``EDGE_LAYOUT``, ``RENUMBER_NODES``,
``SCORE_BATCH_WINDOWS``, ...). Without ``--ckpt`` the service closes and
traces windows and scores nothing, as the JAX package's does. At the
end it prints one JSON line: windows closed and scored, dispatches,
edges scored, and events replayed and lost (the drop ledger: flat out,
the replay offers traffic faster than the Python aggregator takes it,
and the source queues shed what does not fit, as in the JAX package).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _refuse_live_sources(cfg) -> None:
    """The live sources, the HTTP export backend and the health checker
    are not ported yet (so ``--config`` is required): a setting that asks
    for one raises, naming the ROADMAP item that will bring it, rather
    than serving without it."""
    item = "ROADMAP §1 item 1 (the live sources, datastore/backend.py export and runtime/health.py)"
    if cfg.backend.host:
        raise ValueError(f"BACKEND_HOST is set: the HTTP export backend and health checker are not ported yet, {item}")
    if os.environ.get("INGEST_SOCKET"):
        raise ValueError(f"INGEST_SOCKET is set: the ingest socket is not ported yet, {item}")
    if cfg.local_pids:
        raise ValueError(f"LOCAL_PIDS is set: the procfs backfill and the CRI container index are not ported yet, {item}")


def _load_params(path: str, model_cfg):
    from alaz_tpu_torch.models.registry import init_params
    from alaz_tpu_torch.train import checkpoint

    _, state = checkpoint.restore(path, expect_contract=checkpoint.feature_contract(model_cfg))
    params = init_params(model_cfg, key=0, device="cpu")
    params.load_state_dict(state["params"], strict=True)
    return params


def cmd_serve(args) -> int:
    from alaz_tpu_torch.config import RuntimeConfig, SimulationConfig
    from alaz_tpu_torch.events.intern import Interner
    from alaz_tpu_torch.runtime.debug_http import DebugServer
    from alaz_tpu_torch.runtime.service import Service
    from alaz_tpu_torch.sources.replay import ReplaySource

    cfg = RuntimeConfig.from_env()
    _refuse_live_sources(cfg)
    interner = Interner()
    params = _load_params(args.ckpt, cfg.model) if args.ckpt else None
    svc = Service(config=cfg, interner=interner, model_state=params, device=args.device)
    svc.start()
    debug = DebugServer(svc, port=args.debug_port)
    debug.start()
    src = ReplaySource(SimulationConfig.from_json(args.config), interner, realtime=not args.flat_out)
    src.start(svc)
    print(f"serving; debug http on :{debug.port}", file=sys.stderr)
    t0 = time.perf_counter()
    try:
        # bounded-join poll: signals stay deliverable while replay runs
        while src.alive():
            src.join(1.0)
        svc.drain(30)
        svc.flush_windows()
        svc.drain(30)
    except KeyboardInterrupt:
        pass
    finally:
        src.stop()
        debug.stop()
        svc.stop()
    print(json.dumps({
        "windows_closed": svc.metrics.counter("windows.closed").value,
        "windows_scored": svc.scored_batches,
        "score_dispatches": svc.score_dispatches,
        "edges_scored": svc.scored_edges,
        "events": src.emitted,
        "events_lost": svc.ledger.total,
        "seconds": time.perf_counter() - t0,
    }))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="alaz_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("serve", help="run the streaming scoring service over replayed traffic")
    ps.add_argument("--config", required=True, help="replay traffic config (testconfig/*.json)")
    ps.add_argument("--ckpt", default=None, help="a checkpoint directory of train/checkpoint.py")
    ps.add_argument("--debug-port", type=int, default=8181)
    ps.add_argument("--flat-out", action="store_true", help="replay without pacing to the wall clock")
    ps.add_argument("--device", default=None, help="cuda (default) or cpu")
    ps.set_defaults(fn=cmd_serve)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
