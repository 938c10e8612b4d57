"""Closed stream loop: the Service scores TGN's windows back to back, its
per-node memory threaded through every hand-off.

Set-up makes ``distinct_windows`` windows of the stream from the seed
(``gen_stream``: the same pod → service pairs in every window over stable
slots, the features drawn per window) and the weights on the device,
starts the Service with its memory pre-sized to ``tgn_max_nodes`` and
hands each window over ``warmup_passes`` times. In the window, the next
window is handed to the Service's window close callback
(``graph_store.on_batch``) whenever fewer than ``queue_depth`` wait. The
windows are handed over from a ring of two copies of each, and each
hand-off first writes its own last node-feature column into its arrays
(``common.mark``): the arrays repeat, their contents never. Scores go to
an in-process sink at the Service's default threshold; set-up shifts the
edge head's output bias so that ``alert_share`` of the first window's
edges reach it from cold memory by the reference.

End to end: the card's busy time (kernels, copies, sets; CUPTI alone,
``trace.device_busy``) a window scored, as the windows cell reads it.

Correct: every hand-off is scored, in hand-off order. After the program
is gone, the reference threads its own float32 memory through every
hand-off, warm-up included, in hand-off order and from the same marked
arrays; one scored hand-off of each distinct window in the window, drawn
from the seed, matches it edge by edge (every edge's score, as the
Service's score plane receives it), and its sink rows are exactly its
scores at or above the threshold; the program's memory after the last
hand-off matches the reference's (‖Δ‖/‖ref‖ over the window's slots, the
rows past them held to zero).
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from gpu_bench import common, gen_stream, gen_windows, reference, reference_tgn, trace as tracing, yardstick

MEMORY_DEVICE = "latency.memory_device_s"  # the program's device time of each memory update


def _hist_totals(svc, name: str):
    """(sum, count) of the Service's histogram ``name``; None where the
    program has no such series."""
    h = svc.metrics.histograms().get(name)
    if h is None:
        return None
    snap = h.snapshot()
    return snap["sum"], snap["count"]


def run(cell, seed: int, seconds: float, trace: bool, device: str) -> common.Outcome:
    import torch

    from alaz_tpu_torch.config import RuntimeConfig
    from alaz_tpu_torch.runtime.service import Service

    cfg, traffic = cell.config, cell.traffic
    on_card = device == "cuda"
    raws = gen_stream.make_windows(cfg, seed, traffic["distinct_windows"])
    batches = [common.to_batch(r) for r in raws]
    params = reference_tgn.make_params(cfg, seed, device)
    marks = {"made": time.perf_counter()}
    reference_tgn.set_alert_share(params, raws[0], traffic["alert_share"], device)
    if on_card:  # the memory peak is the program's alone
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    marks["alert_share_set"] = time.perf_counter()
    mcfg, model = common.program_model(cfg, params, device)
    mcfg = dataclasses.replace(mcfg, tgn_max_nodes=int(cfg["tgn_max_nodes"]))

    lock = threading.Lock()
    scored_at = []  # (t, close to score s, edges): each window as the Service records its scores
    pick_rng = np.random.default_rng(np.random.SeedSequence([int(seed), 7919]))
    seen = [0] * len(raws)
    kept: dict = {}  # distinct window -> (hand-off, its scores)
    kept_rows: dict = {}  # distinct window -> the sink's scores of that hand-off
    state = {"t0": None, "t1": None, "sink_rows": 0, "last": -1, "out_of_order": 0}

    def observe_scores(batch, scores):
        now = time.perf_counter()
        k = batch.window_start_ms // 1_000 - 1
        with lock:
            t0, t1 = state["t0"], state["t1"]
            state["out_of_order"] += int(k != state["last"] + 1)
            state["last"] = k
        if t0 is not None and t0 <= now < t1:
            d = k % len(raws)
            seen[d] += 1  # a reservoir of one: each scored hand-off as likely
            if pick_rng.random() * seen[d] < 1.0:
                kept[d] = (k, scores)
                kept_rows.pop(d, None)

    def sink(sb):
        now = time.perf_counter()
        with lock:
            if state["t0"] is not None and state["t0"] <= now < state["t1"]:
                state["sink_rows"] += sb.score.shape[0]
        k = sb.window_start_ms // 1_000 - 1
        d = k % len(raws)
        if kept.get(d, (None,))[0] == k:
            kept_rows[d] = sb.score

    svc = Service(config=RuntimeConfig(model=mcfg), score_sink=sink, model_state=model, device=device)
    svc.score_observer = lambda batch, tenant, lat: scored_at.append((time.perf_counter(), lat, batch.n_edges))
    plane_observe = svc.scores.observe_window

    def plane(batch, scores):
        observe_scores(batch, scores)
        plane_observe(batch, scores)

    svc.scores.observe_window = plane
    depth = int(traffic["queue_depth"])
    handed = 0

    ring = batches + [common.copied(b) for b in batches]  # a buffer's last hand-off is long staged

    def make(k):
        b = ring[k % len(ring)]
        common.mark(b.node_feats, b.n_nodes, k, seed)
        return common.handoff(b, k)

    svc.start()
    try:
        for _ in range(int(traffic["warmup_passes"])):
            for _ in batches:
                svc.graph_store.on_batch(make(handed))
                handed += 1
            svc.drain(600)
        if on_card:
            torch.cuda.synchronize()
        marks["warmed"] = time.perf_counter()
        hist = svc.metrics.histogram("latency.stage_s")
        before = (svc._scorer_busy_s, hist.snapshot(), _hist_totals(svc, MEMORY_DEVICE))
        first_in_window = handed
        nxt = make(handed)
        sink_box: dict = {}
        busy_box: dict = {}
        with tracing.traced(trace, sink_box), tracing.device_busy(on_card and not trace, busy_box):
            t0 = time.perf_counter()
            with lock:
                state["t0"], state["t1"] = t0, t0 + seconds
            while True:
                now = time.perf_counter()
                if now >= t0 + seconds:
                    break
                if len(svc.window_queue) < depth:
                    svc.graph_store.on_batch(nxt)
                    handed += 1
                    nxt = make(handed)
                else:
                    time.sleep(traffic["poll_s"])
            after = (svc._scorer_busy_s, hist.snapshot(), _hist_totals(svc, MEMORY_DEVICE))
        in_window = handed - first_in_window
        del nxt
        svc.drain(120)
    finally:
        svc.stop()
    if on_card:
        torch.cuda.synchronize()
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    scored = svc.scored_batches
    threshold = svc.score_threshold
    memory_rows = int(svc._tgn_memory.shape[0])
    program_memory = svc._tgn_memory.detach().float()
    snap = svc.metrics.snapshot(histograms=False)
    del svc, model
    if on_card:
        torch.cuda.empty_cache()
    marks["drained"] = time.perf_counter()

    t1 = t0 + seconds
    win = [(lat, n) for t, lat, n in scored_at if t0 <= t < t1]
    edges = sum(n for _, n in win)
    lat_win = [lat for lat, _ in win]
    memory_device_ms = None
    if before[2] is not None and after[2] is not None and after[2][1] > before[2][1]:
        memory_device_ms = 1e3 * (after[2][0] - before[2][0]) / (after[2][1] - before[2][1])

    # the reference, threaded through every hand-off, after the program is gone
    reference.tf32_off()
    worst, rows_wrong = 0.0, 0
    n = raws[0]["node_feats"].shape[0]
    by_handoff = {k: d for d, (k, _) in kept.items()}
    with torch.no_grad():
        graphs = [reference.to_tensors(r, device) for r in raws]
        memory = reference_tgn.init_memory(params, n, device)
        for k in range(handed):
            d = k % len(raws)
            g = graphs[d]
            g["node_feats"][:, -1] = torch.from_numpy(gen_windows.handoff_column(seed, k, n)).to(device)
            logits, memory = reference_tgn.step(params, g, memory)
            if k not in by_handoff:
                continue
            scores = kept[d][1]
            ref = torch.sigmoid(logits).cpu().numpy()[gen_windows.dst_order(raws[d]["edge_dst"])]
            if scores.shape != ref.shape:
                worst = float("inf")
                continue
            worst = max(worst, float(np.max(np.abs(scores.astype(np.float64) - ref.astype(np.float64)))))
            rows = kept_rows.get(d)
            want = scores[scores >= threshold]
            rows_wrong += int(want.shape[0]) if rows is None or rows.shape != want.shape else int(np.sum(rows != want))
        if program_memory.shape[0] < n:
            memory_err = float("inf")
        else:
            gap = torch.linalg.norm(program_memory[:n] - memory) ** 2 + torch.linalg.norm(program_memory[n:]) ** 2
            memory_err = float(torch.sqrt(gap) / torch.linalg.norm(memory))
        del graphs, memory, program_memory
    marks["reference_done"] = time.perf_counter()

    limits = cell.limits
    e = raws[0]["edge_src"].shape[0]
    return common.Outcome(
        window_start=t0,
        e2e={"window_device_ms": (1e3 * busy_box["busy_s"] / len(win)) if "busy_s" in busy_box and win else None},
        record={
            "cfg": cfg, "seconds": seconds, "windows_scored": len(win), "sink_rows": state["sink_rows"],
            "edges_scored_per_s": yardstick.rate(edges, seconds), "marks": marks,
            "close_to_score_p95_ms": None if not lat_win else 1e3 * yardstick.p95(lat_win),
            "scorer_busy_s": after[0] - before[0],
            "stage_s_sum": after[1]["sum"] - before[1]["sum"],
            "stage_count": after[1]["count"] - before[1]["count"],
            "memory_device_ms": memory_device_ms, "memory_rows": memory_rows, "handoffs": handed,
            "memory_grows": snap.get("tgn.memory_grows"),
            "memory_rows_updated": snap.get("tgn.memory_rows_updated"),
            "n_nodes": n, "n_edges": e, "n_pad": batches[0].n_pad, "e_pad": batches[0].e_pad,
        },
        attempted=in_window,
        failed=handed - scored,
        checks={
            "score_max_abs_err": common.check(worst, limits["score_max_abs_err"]),
            "memory_rel_err": common.check(memory_err, limits["memory_rel_err"]),
            "sink_rows_wrong": common.check(rows_wrong, 0),
            "windows_unscored": common.check(handed - scored, 0),
            "handoffs_out_of_order": common.check(state["out_of_order"], 0),
            "distinct_windows_uncompared": common.check(len(raws) - len(kept), 0),
        },
        memory_peak_bytes=peak,
        trace=sink_box.get("trace"),
    )
