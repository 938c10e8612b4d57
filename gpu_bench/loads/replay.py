"""Replayed fleet traffic, flat out, through the Service's whole path:
ingest → aggregator join (the native L7 engine) → window close (the C++
window accumulator) → scorer → sink.

Set-up makes the topology from the seed, submits the K8s messages and the
TCP establishes and drains them, generates ``event_seconds`` of L7 traffic
and scores two windows of the replay's bucket (the first launches and
both page-locked staging buffers). In the
window, L7 batches are submitted as fast as the Service takes them: each
waits for room in the L7 queue, and nothing is shed at the mouth.

Correct: every window that closes, and at least the first (if the window
ends before it closes, submission goes on, untimed, until it does), is held
to the reference worked out from the topology alone: its edges and their
request counts (the join), every feature row of its edges and of their
endpoints (the window close), and every edge's score.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from gpu_bench import common, gen_replay, gen_windows, reference, trace as tracing, yardstick

def _submit(svc, batch, poll_s: float) -> bool:
    """Hand ``batch`` to the Service once its L7 queue has room for it: as
    fast as the Service takes traffic, nothing shed at the mouth."""
    q = svc.l7_queue
    while q.pending_events + batch.shape[0] > q.capacity:
        time.sleep(poll_s)
    return svc.submit_l7(batch)


def run(cell, seed: int, seconds: float, trace: bool, device: str) -> common.Outcome:
    import torch

    from alaz_tpu_torch.config import RuntimeConfig
    from alaz_tpu_torch.runtime.service import Service

    cfg, traffic = cell.config, cell.traffic
    on_card = device == "cuda"
    topo = gen_replay.topology(traffic, seed)
    params = reference.make_params(cfg, seed, device)
    mcfg, model = common.program_model(cfg, params, device)

    lock = threading.Lock()
    scored: dict = {}  # window_start_ms -> (batch, scores, t)
    batches: dict = {}

    def observe(batch, tenant, lat):
        with lock:
            batches[batch.window_start_ms] = batch

    def sink(sb):
        with lock:
            scored[sb.window_start_ms] = (sb.score, time.perf_counter())

    rcfg = RuntimeConfig(model=mcfg, window_s=traffic["window_s"], engine_backend="native")
    svc = Service(config=rcfg, score_sink=sink, model_state=model, score_threshold=0.0, device=device,
                  use_native_ingest=True)
    svc.score_observer = observe
    svc.start()
    stop_sampling = threading.Event()
    pending_samples: list = []
    try:
        # the cluster's resources and connections, drained
        for m in gen_replay.k8s_messages(traffic):
            while not svc.submit_k8s(m):
                time.sleep(0.0005)
        if not svc.submit_tcp(gen_replay.tcp_events(topo)):
            raise RuntimeError("the TCP establishes were shed")
        svc.drain(300)
        # two windows of the replay's bucket through the scorer: the first
        # launches, and both of the serial path's page-locked staging buffers
        w = traffic["warm_window"]
        warm = common.to_batch(gen_windows.make_window(
            gen_windows.window_seed(seed, 99), w["pods"], w["services"], w["edges"]))
        for k in range(2):
            svc.graph_store.on_batch(common.handoff(warm, k))
        svc.drain(300)
        l7 = gen_replay.l7_batches(topo, traffic)
        if on_card:
            torch.cuda.synchronize()
        with lock:
            scored.clear()
            batches.clear()
        ledger0 = svc.ledger.total

        def sample():
            while not stop_sampling.wait(traffic["sample_s"]):
                pending_samples.append(svc.l7_queue.pending_events)

        sampler = threading.Thread(target=sample, name="gpu-bench-sampler", daemon=True)
        sink_box: dict = {}
        i = submitted = 0
        with tracing.traced(trace, sink_box):
            if trace:
                sampler.start()
            p0 = svc.l7_queue.pending_events
            t0 = time.perf_counter()
            while time.perf_counter() < t0 + seconds and i < len(l7):
                if not _submit(svc, l7[i], traffic["poll_s"]):
                    raise RuntimeError("an L7 batch was shed at the queue's mouth")
                submitted += l7[i].shape[0]
                i += 1
            t1 = time.perf_counter()
            p1 = svc.l7_queue.pending_events
            stop_sampling.set()
        if trace:
            sampler.join(5)
        exhausted = int(i >= len(l7))
        # untimed: the first window is due; submit until it is scored
        deadline = time.perf_counter() + traffic["due_s"]
        while not scored and i < len(l7) and time.perf_counter() < deadline:
            _submit(svc, l7[i], traffic["poll_s"])
            i += 1
            with lock:
                if scored:
                    break
        svc.drain(120)
        failed = svc.ledger.total - ledger0
    finally:
        stop_sampling.set()
        svc.stop()
    if on_card:
        torch.cuda.synchronize()
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    interner = svc.interner
    del svc, model
    if on_card:
        torch.cuda.empty_cache()

    reference.tf32_off()
    per_edge = int(traffic["edge_rate"] * traffic["event_seconds"])
    wrong_edges, feat_err, score_err = 0, 0.0, 0.0
    for ws, batch in sorted(batches.items()):
        prog_scores = scored.get(ws, (None,))[0]
        ref = reference.replay_window(topo.pod_idx, topo.svc_idx, topo.proto, topo.conn_ts,
                                      traffic["edge_rate"], per_edge, ws // int(1000 * traffic["window_s"]))
        names = np.array([interner.lookup(int(u)) for u in batch.node_uids[: batch.n_nodes]])
        n_e = batch.n_edges
        src, dst = batch.edge_src[:n_e], batch.edge_dst[:n_e]
        prog_keys = {(names[s], names[d], int(t)): j
                     for j, (s, d, t) in enumerate(zip(src, dst, batch.edge_type[:n_e]))}
        ref_keys = {(f"pod-uid-{p}", f"svc-uid-{s}", int(t)): j
                    for j, (p, s, t) in enumerate(zip(ref["pod"], ref["svc"], ref["proto"]))}
        wrong_edges += len(set(prog_keys) ^ set(ref_keys))
        both = sorted(set(prog_keys) & set(ref_keys))
        pj = np.array([prog_keys[k] for k in both], dtype=np.int64)
        rj = np.array([ref_keys[k] for k in both], dtype=np.int64)
        g = ref["graph"]
        feat_err = max(feat_err,
                       float(np.abs(batch.edge_feats[pj] - g["edge_feats"][rj]).max(initial=0.0)),
                       float(np.abs(batch.node_feats[src[pj]] - g["node_feats"][g["edge_src"][rj]]).max(initial=0.0)),
                       float(np.abs(batch.node_feats[dst[pj]] - g["node_feats"][g["edge_dst"][rj]]).max(initial=0.0)))
        if prog_scores is None or prog_scores.shape[0] != n_e:
            score_err = float("inf")
            continue
        with torch.no_grad():
            ref_scores = torch.sigmoid(reference.forward(params, reference.to_tensors(g, device), cfg)).cpu().numpy()
        score_err = max(score_err, float(np.abs(prog_scores[pj].astype(np.float64) - ref_scores[rj]).max(initial=0.0)))

    limits = cell.limits
    taken = submitted - (p1 - p0)
    return common.Outcome(
        window_start=t0,
        e2e={"events_per_s": yardstick.rate(taken, t1 - t0)},
        record={"cfg": cfg, "seconds": t1 - t0, "l7_pending": pending_samples},
        attempted=submitted,
        failed=failed,
        checks={
            "windows_compared_missing": common.check(max(0, 1 - len(batches)), 0),
            "join_edges_wrong": common.check(wrong_edges, 0),
            "feature_max_abs_err": common.check(feat_err, limits["feature_max_abs_err"]),
            "score_max_abs_err": common.check(score_err, limits["score_max_abs_err"]),
            "traffic_exhausted": common.check(exhausted, 0),
            "events_lost": common.check(failed, 0),
        },
        memory_peak_bytes=peak,
        trace=sink_box.get("trace"),
    )
