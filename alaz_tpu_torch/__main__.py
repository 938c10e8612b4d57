"""CLI of the port: the JAX package's ``python -m alaz_tpu``.

  python -m alaz_tpu_torch replay [--config ...]        # data-plane acceptance
  python -m alaz_tpu_torch train  [--config ...] [--model graphsage] [--ckpt DIR]
  python -m alaz_tpu_torch eval   [--models graphsage,gat,experts,tgn] [--out F]
  python -m alaz_tpu_torch serve  [--config testconfig/config3_10k_mixed.json \\
      --flat-out] [--ingest-socket PATH] [--ckpt DIR] [--debug-port 8181]

``train`` and ``eval`` take ``--device`` (as does ``serve``) and run on
the card unless ``--device cpu`` is given; with no card they raise. Each
subcommand keeps the JAX package's flags, defaults and exit codes:
``replay`` exits 1 unless the replay passed, ``train`` below AUROC 0.9,
``eval`` when a detection model falls below 0.9. Model settings come
from the environment (``ModelConfig.from_env``: ``MODEL``,
``HIDDEN_DIM``, ``SRC_GATHER``, ``EDGE_FEAT_ZNORM``, ...).

``serve`` runs the streaming scoring ``Service``: sources → aggregator →
window close → scorer (the model through the hand-written kernels) →
score plane → score sink. With ``--config`` the source is replayed
traffic; without it the service runs live, as the JAX package's does:
agents' frames on the unix socket of ``--ingest-socket`` (default
``$INGEST_SOCKET``), pods and services from the Kubernetes watch
(in-cluster, or ``K8S_API_SERVER``), request rows and scores exported to
``BACKEND_HOST`` over HTTP with the health checker pausing and resuming
the service, and the procfs backfill and CRI container index under
``LOCAL_PIDS``; it serves until interrupted (SIGINT). Runtime settings
come from the environment (``RuntimeConfig.from_env``: ``EDGE_LAYOUT``,
``RENUMBER_NODES``, ``SCORE_BATCH_WINDOWS``, ``INGEST_WORKERS``, ...).
Without ``--ckpt`` the service closes and traces windows and scores
nothing, as the JAX package's does. At the end it prints one JSON line:
windows closed and scored, dispatches, edges scored, events taken in
(replayed, or the rows of the ingest socket's accepted frames) and lost
(the drop ledger: flat out, the replay offers traffic faster than the
Python aggregator takes it, and the source queues shed what does not
fit, as in the JAX package).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def _sim_config(path: str | None):
    from alaz_tpu_torch.config import SimulationConfig

    if path:
        return SimulationConfig.from_json(path)
    return SimulationConfig(test_duration_s=10.0, pod_count=100, service_count=50, edge_count=40, edge_rate=1000)


def cmd_replay(args) -> int:
    from alaz_tpu_torch.replay.simulator import run_replay

    res = run_replay(_sim_config(args.config))
    print(
        json.dumps(
            {
                "generated": res.generated,
                "persisted": res.persisted,
                "processed_ratio": round(res.processed_ratio, 4),
                "events_per_s": round(res.events_per_s),
                "passed": res.passed,
            }
        )
    )
    return 0 if res.passed else 1


def _stream_tgn_eval(cfg, params, data, collect_next: bool = False, device=None):
    """Stream ALL windows chronologically with the memory threaded through
    ``tgn.step`` (service semantics), on ``device`` (default ``cuda``),
    collecting (scores, labels, masks, kinds[, labels_next]) for the eval
    windows."""
    import numpy as np
    import torch

    from alaz_tpu_torch.convert import graph_to_torch
    from alaz_tpu_torch.device import resolve_device
    from alaz_tpu_torch.models import tgn

    if not data.eval:
        # possible at --windows 1: n_train = max(1, ...) can consume
        # every batch — fail here with the fix, not 4-way-unpack later
        raise RuntimeError(
            "no eval windows were produced (every window landed in the "
            "train split); increase --windows"
        )
    dev = resolve_device(device)
    mem = tgn.init_memory(
        cfg, max(cfg.tgn_max_nodes, max(b.n_pad for b in data.all_batches)), device=dev
    )
    step = tgn.make_step_fn(cfg)
    eval_ids = {id(b) for b in data.eval}
    out_rows = []
    with torch.inference_mode():
        for b in data.all_batches:
            out, mem = step(params, graph_to_torch(b.device_arrays(), dev), mem)
            if id(b) in eval_ids:
                row = [
                    out["edge_logits"].float().cpu().numpy(),
                    b.edge_label,
                    b.edge_mask,
                    getattr(b, "edge_fault_kind", None),
                ]
                if collect_next:
                    row.append(b.edge_label_next)
                out_rows.append(row)
    return [list(col) for col in zip(*out_rows)]


def _train_eval_one(model: str, sim_cfg, windows: int, epochs: int, seed: int,
                    ckpt: str | None = None, device=None) -> dict:
    """Train one model on the anomaly scenario and evaluate AUROC
    (blended + per-fault-class), on ``device`` (default ``cuda``). The
    shared core of ``train`` and ``eval``."""
    import numpy as np

    from alaz_tpu_torch.config import ModelConfig
    from alaz_tpu_torch.replay.faults import FAULT_KINDS
    from alaz_tpu_torch.replay.scenario import run_anomaly_scenario
    from alaz_tpu_torch.train import checkpoint
    from alaz_tpu_torch.train.metrics import auroc, auroc_by_kind
    from alaz_tpu_torch.train.trainstep import (
        make_score_fn,
        score_batch,
        train_on_batches,
        train_tgn_unrolled,
    )

    # from_env so knobs like EDGE_FEAT_ZNORM=0 shape the TRAINED model too:
    # a checkpoint must match the serve config's feature contract
    cfg = dataclasses.replace(ModelConfig.from_env(), model=model)
    data = run_anomaly_scenario(sim_cfg, n_windows=windows, fault_fraction=0.15, seed=seed)
    if not data.eval:
        raise RuntimeError(
            "no eval windows were produced (every window landed in the "
            "train split); increase --windows"
        )
    if model == "tgn":
        # one unrolled update per epoch covers the whole train sequence:
        # epochs * len(train) updates puts TGN at step parity with the
        # per-window models, which take one step per (epoch, window)
        tgn_steps = max(epochs * len(data.train), 20)
        print(
            f"tgn: {tgn_steps} unrolled update steps over "
            f"{len(data.train)} windows (from --epochs {epochs})",
            file=sys.stderr,
        )
        state, losses = train_tgn_unrolled(cfg, data.train, epochs=tgn_steps, seed=seed, device=device)
        scores, labels, masks, kind_arrays = _stream_tgn_eval(cfg, state.params, data, device=device)
    else:
        state, losses = train_on_batches(cfg, data.train, epochs=epochs, seed=seed, device=device)
        scores, labels, masks, kind_arrays = [], [], [], []
        fn = make_score_fn(cfg, device)
        for b in data.eval:
            out = score_batch(cfg, state.params, b, fn)
            scores.append(out["edge_logits"])
            labels.append(b.edge_label)
            masks.append(b.edge_mask)
            kind_arrays.append(getattr(b, "edge_fault_kind", None))
    a = auroc(np.concatenate(scores), np.concatenate(labels), np.concatenate(masks))
    # per-failure-class breakdown: a blended number can hide a blind class
    by_kind = {}
    if kind_arrays and all(k is not None for k in kind_arrays):
        by_kind = {
            k: (round(v, 4) if v == v else None)  # NaN → null
            for k, v in auroc_by_kind(
                np.concatenate(scores),
                np.concatenate(kind_arrays),
                FAULT_KINDS,
                np.concatenate(masks),
            ).items()
        }
    if ckpt:
        checkpoint.save(
            ckpt, step=state.step, params=state.params,
            contract=checkpoint.feature_contract(cfg),
        )
    return {
        "model": model, "auroc": round(float(a), 4),
        "auroc_by_kind": by_kind,
        "loss_final": round(losses[-1], 4), "steps": state.step,
    }


def _tgn_forecast_eval(
    sim_cfg, windows: int, epochs: int, seed: int, train_seeds: int = 3, device=None
) -> dict:
    """The forecasting leg: train TGN on ``edge_label_next`` over
    ``train_seeds`` ramp scenarios (different fault draws, so the model
    cannot memorize which edges ramp), on a cosine-decayed rate, and
    evaluate on a held-out draw (``seed + 1000``) against next-window
    labels: blended AUROC, the persistence baseline (score = current
    label) the memory must beat, and onset AUROC over currently-clean
    edges, the calls persistence cannot make."""
    import numpy as np

    from alaz_tpu_torch.config import ModelConfig
    from alaz_tpu_torch.replay.scenario import run_forecast_scenario
    from alaz_tpu_torch.train.metrics import auroc
    from alaz_tpu_torch.train.trainstep import cosine_decay_schedule, train_tgn_unrolled

    cfg = dataclasses.replace(ModelConfig.from_env(), model="tgn")
    train_seqs = [
        run_forecast_scenario(
            sim_cfg, n_windows=windows, fault_fraction=0.15, seed=seed + s
        ).all_batches
        for s in range(train_seeds)
    ]
    heldout = run_forecast_scenario(
        sim_cfg, n_windows=windows, fault_fraction=0.15, seed=seed + 1000
    )
    tgn_steps = max(epochs * 5, 20)
    state, losses = train_tgn_unrolled(
        cfg,
        train_seqs,
        epochs=tgn_steps,
        lr=cosine_decay_schedule(3e-3, tgn_steps),
        seed=seed,
        label_attr="edge_label_next",
        device=device,
    )
    scores, cur_labels, masks, _kinds, labels_next = _stream_tgn_eval(
        cfg, state.params, heldout, collect_next=True, device=device
    )
    s = np.concatenate(scores)
    c = np.concatenate(cur_labels)
    nx = np.concatenate(labels_next)
    m = np.concatenate(masks).astype(bool)
    f_auroc = auroc(s, nx, m)
    p_auroc = auroc(c, nx, m)
    onset = m & (c == 0)
    o_auroc = auroc(s[onset], nx[onset], np.ones(int(onset.sum())))

    def _r(v: float):
        # NaN when a slice has no positives or no negatives (the onset
        # slice at tiny --forecast-windows); JSON has no NaN: null
        return round(float(v), 4) if v == v else None

    return {
        "model": "tgn", "task": "forecast_next_window",
        "forecast_auroc": _r(f_auroc),
        "onset_auroc": _r(o_auroc),
        "persistence_auroc": _r(p_auroc),
        "n_onset_positives": int(nx[onset].sum()),
        "loss_final": round(losses[-1], 4), "steps": state.step,
    }


def cmd_train(args) -> int:
    sim_cfg = _sim_config(args.config)
    res = _train_eval_one(
        args.model, sim_cfg, args.windows, args.epochs, args.seed, args.ckpt, args.device
    )
    print(json.dumps(res))
    return 0 if res["auroc"] >= 0.9 else 1


def cmd_eval(args) -> int:
    """One-command reproduction of the full quality matrix: the models on
    the 10k-pod mixed config and the TGN forecast leg on the temporal
    config, seeds/windows/epochs pinned by the defaults."""
    from alaz_tpu_torch.config import SimulationConfig

    det_cfg = SimulationConfig.from_json(args.config)
    results = [
        _train_eval_one(m, det_cfg, args.windows, args.epochs, args.seed, device=args.device)
        for m in args.models.split(",")
    ]
    for r in results:
        print(json.dumps(r), file=sys.stderr)
    fc_cfg = SimulationConfig.from_json(args.forecast_config)
    forecast = _tgn_forecast_eval(
        fc_cfg, args.forecast_windows, args.epochs, args.seed, device=args.device
    )
    print(json.dumps(forecast), file=sys.stderr)
    out = {
        "description": (
            "Quality gate at FULL scale: python -m alaz_tpu_torch eval "
            f"--config {args.config} --windows {args.windows} --epochs "
            f"{args.epochs} --seed {args.seed} (deterministic: seeds/"
            "windows/epochs pinned by defaults). Detection: >=0.9 AUROC "
            "north star (BASELINE.json). Forecast: TGN on "
            f"{args.forecast_config} ramped latency faults, AUROC vs "
            "next-window labels."
        ),
        "config": args.config,
        "n_windows": args.windows,
        "epochs": args.epochs,
        "seed": args.seed,
        "fault_fraction": 0.15,
        "results": results,
        "forecast": forecast,
    }
    payload = json.dumps(out, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload + "\n")
    print(payload)
    gate = all(r["auroc"] >= 0.9 for r in results)
    return 0 if gate else 1


def _load_params(path: str, model_cfg):
    from alaz_tpu_torch.models.registry import init_params
    from alaz_tpu_torch.train import checkpoint

    _, state = checkpoint.restore(path, expect_contract=checkpoint.feature_contract(model_cfg))
    params = init_params(model_cfg, key=0, device="cpu")
    params.load_state_dict(state["params"], strict=True)
    return params


def cmd_serve(args) -> int:
    from alaz_tpu_torch.config import RuntimeConfig
    from alaz_tpu_torch.events.intern import Interner
    from alaz_tpu_torch.runtime.debug_http import DebugServer
    from alaz_tpu_torch.runtime.health import HealthChecker
    from alaz_tpu_torch.runtime.service import Service
    from alaz_tpu_torch.sources.replay import ReplaySource

    cfg = RuntimeConfig.from_env()
    if not args.config and not cfg.local_pids:
        # Live serve without LOCAL_PIDS: the procfs backfill and zombie
        # reaper stay off. They are explicit opt-in (LOCAL_PIDS=1, with
        # PROC_ROOT=/host/proc when containerized) because probing agent
        # pids against the wrong pid namespace tears down live join state.
        print(
            "serve: LOCAL_PIDS not set — procfs backfill and zombie "
            "reaper disabled (set LOCAL_PIDS=1 and PROC_ROOT if agent "
            "pids are resolvable on this node)",
            file=sys.stderr,
        )
    interner = Interner()
    params = _load_params(args.ckpt, cfg.model) if args.ckpt else None

    export_backend = None
    if cfg.backend.host:
        from alaz_tpu_torch.datastore.backend import BatchingBackend, http_transport

        export_backend = BatchingBackend(
            http_transport(cfg.backend.host), interner, cfg.backend
        )
        export_backend.start()

    svc = Service(
        config=cfg, interner=interner, model_state=params,
        export_backend=export_backend, device=args.device,
    )
    # pre-existing connections join immediately on restart (reference
    # rebuilds state from /proc; replay configs have no live procfs)
    containers = None
    if cfg.local_pids:
        svc.aggregator.backfill_from_proc()
        # live container index over CRI when a runtime socket answers
        # (cri.go:39-73); replay mode has no runtime
        from alaz_tpu_torch.sources.containers import ContainerIndex
        from alaz_tpu_torch.sources.cri import CriContainerLister, probe_runtime_socket

        cri_sock = probe_runtime_socket()
        if cri_sock:
            containers = ContainerIndex(lister=CriContainerLister(cri_sock))
            containers.start(svc)
    svc.start()
    # live k8s informers (k8s/informer.go:67-157): in-cluster discovery
    # by default, K8S_API_SERVER override for tests/out-of-cluster.
    # Replay configs carry their own k8s messages, so live serve only.
    k8s_src = None
    if cfg.k8s_enabled and not args.config:
        from alaz_tpu_torch.sources.k8s_watch import K8sWatchSource

        k8s_src = K8sWatchSource(
            exclude_namespaces=[
                ns.strip() for ns in cfg.exclude_namespaces.split(",") if ns.strip()
            ],
            api_server=cfg.k8s_api_server or None,
            token_file=cfg.k8s_token_file or None,
            ca_file=cfg.k8s_ca_file or None,
        )
        k8s_src.start(svc)
        if k8s_src.live:
            print("k8s informers watching", file=sys.stderr)
    ingest_srv = None
    if args.ingest_socket:
        from alaz_tpu_torch.sources.ingest_server import IngestServer

        ingest_srv = IngestServer(svc, path=args.ingest_socket)
        ingest_srv.start()  # self-registers its ingest_socket.* gauges
        print(f"ingest socket at {args.ingest_socket}", file=sys.stderr)
    debug = DebugServer(svc, port=args.debug_port)
    debug.start()
    hc = None
    if cfg.backend.host:
        from alaz_tpu_torch.datastore.backend import http_transport

        hc = HealthChecker(
            http_transport(cfg.backend.host),
            on_stop=svc.pause,
            on_resume=svc.resume,
            metrics_snapshot=svc.metrics.snapshot,
        )
        hc.start()
    src = None
    if args.config:
        src = ReplaySource(_sim_config(args.config), interner, realtime=not args.flat_out)
        src.start(svc)
    print(f"serving; debug http on :{debug.port}", file=sys.stderr)
    t0 = time.perf_counter()
    try:
        if src is not None:
            # bounded-join poll: signals stay deliverable while replay runs
            while src.alive():
                src.join(1.0)
            svc.drain(30)
            svc.flush_windows()
            svc.drain(30)
        else:
            while True:
                time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        if src:
            src.stop()
        if ingest_srv is not None:
            ingest_srv.stop()
        if containers is not None:
            containers.stop()
        if k8s_src is not None:
            k8s_src.stop()
        if hc:
            hc.stop()
        debug.stop()
        svc.stop()
        if export_backend is not None:
            export_backend.stop()
    if src is not None:
        events = src.emitted
    else:
        events = ingest_srv.records if ingest_srv is not None else 0
    print(json.dumps({
        "windows_closed": svc.metrics.counter("windows.closed").value,
        "windows_scored": svc.scored_batches,
        "score_dispatches": svc.score_dispatches,
        "edges_scored": svc.scored_edges,
        "events": events,
        "events_lost": svc.ledger.total,
        "seconds": time.perf_counter() - t0,
    }))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="alaz_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("replay", help="data-plane acceptance replay")
    pr.add_argument("--config", default=None)
    pr.set_defaults(fn=cmd_replay)

    pt = sub.add_parser("train", help="train + AUROC-gate an anomaly scorer")
    pt.add_argument("--config", default=None)
    pt.add_argument("--model", default="graphsage")
    pt.add_argument("--epochs", type=int, default=20)
    pt.add_argument("--windows", type=int, default=10)
    pt.add_argument("--seed", type=int, default=0)
    pt.add_argument("--ckpt", default=None)
    pt.add_argument("--device", default=None, help="cuda (default) or cpu")
    pt.set_defaults(fn=cmd_train)

    ps = sub.add_parser("serve", help="run the streaming scoring service")
    ps.add_argument("--config", default=None, help="replay traffic config (omit for external ingest)")
    ps.add_argument("--ckpt", default=None, help="a checkpoint directory of train/checkpoint.py")
    ps.add_argument("--debug-port", type=int, default=8181)
    ps.add_argument("--flat-out", action="store_true", help="replay without pacing to the wall clock")
    ps.add_argument(
        "--ingest-socket", default=os.environ.get("INGEST_SOCKET", ""),
        help="unix socket for out-of-process agents (frame protocol in "
        "sources/ingest_server.py)",
    )
    ps.add_argument("--device", default=None, help="cuda (default) or cpu")
    ps.set_defaults(fn=cmd_serve)

    pe = sub.add_parser("eval", help="regenerate the full quality matrix deterministically")
    pe.add_argument("--config", default="testconfig/config3_10k_mixed.json")
    pe.add_argument("--forecast-config", default="testconfig/config4_temporal.json")
    pe.add_argument("--models", default="graphsage,gat,experts,tgn")
    pe.add_argument("--epochs", type=int, default=30)
    pe.add_argument("--windows", type=int, default=10)
    pe.add_argument("--forecast-windows", type=int, default=20)
    pe.add_argument("--seed", type=int, default=0)
    pe.add_argument("--out", default=None)
    pe.add_argument("--device", default=None, help="cuda (default) or cpu")
    pe.set_defaults(fn=cmd_eval)

    args = p.parse_args(argv)
    return args.fn(args)

if __name__ == "__main__":
    sys.exit(main())
