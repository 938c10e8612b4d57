"""Closed stateless stream loop: the Service scores the edge-type experts
over config5's windows back to back, each edge's message through the
expert of its protocol, nothing carried from one hand-off to the next.

Set-up makes ``distinct_windows`` windows of the stream from the seed
(``gen_stream``: the same pod → service pairs and protocol codes in every
window over stable slots, the features drawn per window) and the weights
on the device (``reference_experts.make_params``), starts the Service
with the configuration's expert dispatch and hands each window over
``warmup_passes`` times. In the window, the next window is handed to the
Service's window close callback (``graph_store.on_batch``) whenever fewer
than ``queue_depth`` wait. The windows are handed over from a ring of two
copies of each, and each hand-off first writes its own last node-feature
column into its arrays (``common.mark``): the arrays repeat, their
contents never. Scores go to an in-process sink at the Service's default
threshold; set-up shifts the edge head's output bias so that
``alert_share`` of the first window's edges reach it by the reference.

A program without the experts' routing counters cannot be held to this
cell's routing check: the run stops at set-up, before the warm-up, with
an error.

End to end: the card's busy time (kernels, copies, sets; CUPTI alone,
``trace.device_busy``) a window scored, as the windows cell reads it.

Correct: every hand-off is scored. After the program is gone, one scored
hand-off of each distinct window in the window, drawn from the seed,
matches the float32 reference (``reference_experts``) on the same marked
arrays edge by edge (every edge's score, as the Service's score plane
receives it), and its sink rows are exactly its scores at or above the
threshold; the Service's ``experts.edges_routed.e<t>`` totals after the
drain equal the hand-offs' own type counts, every type.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from gpu_bench import common, gen_stream, gen_windows, reference, reference_experts, trace as tracing, yardstick

ROUTED = "experts.edges_routed.e{}"  # the program's live edges routed to each expert, summed over windows


def type_counts(raw: dict, types: int) -> np.ndarray:
    """A window's edges of each type in ``[0, types)``."""
    t = raw["edge_type"]
    return np.bincount(t[(t >= 0) & (t < types)], minlength=types).astype(np.int64)


def run(cell, seed: int, seconds: float, trace: bool, device: str) -> common.Outcome:
    import torch

    from alaz_tpu_torch.config import RuntimeConfig
    from alaz_tpu_torch.runtime.service import Service

    cfg, traffic = cell.config, cell.traffic
    on_card = device == "cuda"
    raws = gen_stream.make_windows(cfg, seed, traffic["distinct_windows"])
    batches = [common.to_batch(r) for r in raws]
    params = reference_experts.make_params(cfg, seed, device)
    marks = {"made": time.perf_counter()}
    reference_experts.set_alert_share(params, raws[0], cfg, traffic["alert_share"], device)
    if on_card:  # the memory peak is the program's alone
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    marks["alert_share_set"] = time.perf_counter()
    mcfg, model = common.program_model(cfg, params, device)
    mcfg = dataclasses.replace(mcfg, expert_dispatch=cfg["expert_dispatch"])
    types = int(cfg["num_edge_types"])

    lock = threading.Lock()
    scored_at = []  # (t, close to score s, edges): each window as the Service records its scores
    pick_rng = np.random.default_rng(np.random.SeedSequence([int(seed), 7919]))
    seen = [0] * len(raws)
    kept: dict = {}  # distinct window -> (hand-off, its scores)
    kept_rows: dict = {}  # distinct window -> the sink's scores of that hand-off
    state = {"t0": None, "t1": None, "sink_rows": 0}

    def observe_scores(batch, scores):
        now = time.perf_counter()
        with lock:
            t0, t1 = state["t0"], state["t1"]
        if t0 is not None and t0 <= now < t1:
            k = batch.window_start_ms // 1_000 - 1
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
    if ROUTED.format(0) not in svc.metrics.snapshot(histograms=False):
        raise RuntimeError(f"{cell.name}: the program counts no {ROUTED.format('<t>')}: its routing cannot be checked")
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
        before = (svc._scorer_busy_s, hist.snapshot())
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
            after = (svc._scorer_busy_s, hist.snapshot())
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
    snap = svc.metrics.snapshot(histograms=False)
    del svc, model
    if on_card:
        torch.cuda.empty_cache()
    marks["drained"] = time.perf_counter()

    t1 = t0 + seconds
    win = [(lat, n) for t, lat, n in scored_at if t0 <= t < t1]
    edges = sum(n for _, n in win)
    lat_win = [lat for lat, _ in win]
    routed = np.asarray([int(snap.get(ROUTED.format(t), 0)) for t in range(types)], dtype=np.int64)
    per_window = [type_counts(r, types) for r in raws]
    want_routed = sum(per_window[k % len(raws)] for k in range(handed))
    routing_wrong = int(np.abs(routed - want_routed).sum())

    # the reference, on the sampled hand-offs, after the program is gone
    reference.tf32_off()
    worst, rows_wrong = 0.0, 0
    for d, (k, scores) in sorted(kept.items()):
        g = reference.to_tensors(common.marked(raws[d], k, seed), device)
        with torch.no_grad():
            ref = torch.sigmoid(reference_experts.forward(params, g, cfg)).cpu().numpy()
        del g
        ref = ref[gen_windows.dst_order(raws[d]["edge_dst"])]
        if scores.shape != ref.shape:
            worst = float("inf")
            break
        worst = max(worst, float(np.max(np.abs(scores.astype(np.float64) - ref.astype(np.float64)))))
        rows = kept_rows.get(d)
        want = scores[scores >= threshold]
        rows_wrong += int(want.shape[0]) if rows is None or rows.shape != want.shape else int(np.sum(rows != want))
    marks["reference_done"] = time.perf_counter()

    limits = cell.limits
    n = raws[0]["node_feats"].shape[0]
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
            "experts_live": snap.get("experts.live"),
            "edges_routed": routed.tolist(), "handoffs": handed,
            "n_nodes": n, "n_edges": e, "n_pad": batches[0].n_pad, "e_pad": batches[0].e_pad,
        },
        attempted=in_window,
        failed=handed - scored,
        checks={
            "score_max_abs_err": common.check(worst, limits["score_max_abs_err"]),
            "sink_rows_wrong": common.check(rows_wrong, 0),
            "windows_unscored": common.check(handed - scored, 0),
            "distinct_windows_uncompared": common.check(len(raws) - len(kept), 0),
            "routing_wrong": common.check(routing_wrong, 0),
        },
        memory_peak_bytes=peak,
        trace=sink_box.get("trace"),
    )
