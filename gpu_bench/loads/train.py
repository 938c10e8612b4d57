"""Back-to-back train steps on labelled windows.

Set-up makes ``distinct_windows`` labelled windows and the weights from the
seed, builds the program's train step (``train/trainstep.py
make_train_step``, AdamW as the train CLI builds it) and drives that one
object through its first steps, one distinct window each, through the
same call and feed as the window. Each step is handed its window as numpy
(the model's arrays, ``GraphBatch.device_arrays``), with the step's own
last node-feature column written into them first (``common.mark``), as a
loader feeds a trainer that retrains on newly labelled windows: the arrays
repeat, their contents never. The first compared step's arrays are a copy
of the first window that the third compared step reuses, refilled in place
with the third window: a program that kept a window's device copy by its
arrays' identity would train on the first window's rows there, and the
comparison would catch it. The window then runs steps until ``--seconds``
is up.

Correct: the reference follows the first ``reference_steps`` steps from
the same weights on the same windows. Compared, by the numbers that
``limits/<cell>.json`` holds: the gradient of each step's loss at each
edge's logit, as the program's backward receives it (``logit_grad_err``,
``logit_grad_worst``); the first gradient as the optimizer got it (its
first moment after one step over 1 − β1) and the params' change over
those steps, read before the next step moves them, leaf by leaf. Leaves
whose reference gradient is under a thousandth of the median leaf's are
left out of the leaf numbers: they move by round-off alone. Every number,
held or not, is printed on standard error.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from gpu_bench import common, gen_windows, reference, trace as tracing

BETA1 = 0.9


def leaf_gap(prog: dict, ref: dict, keep: list) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of the reference leaf's norm and the median leaf's."""
    norms = {k: float(ref[k].norm()) for k in keep}
    med = float(np.median(list(norms.values())))
    return max(abs(float(prog[k].norm()) - norms[k]) / max(norms[k], med, 1e-30) for k in keep)


def leaf_diffs(prog: dict, ref: dict, keep: list) -> dict:
    """Each leaf's norm of the difference, over the reference leaf's norm."""
    return {k: float((prog[k] - ref[k]).norm()) / max(float(ref[k].norm()), 1e-30) for k in keep}


def moved_leaves(grads: dict) -> list:
    norms = {k: float(v.norm()) for k, v in grads.items()}
    med = float(np.median(list(norms.values())))
    return [k for k, n in norms.items() if n >= 1e-3 * med]


def logit_numbers(prog: list, ref: list) -> tuple:
    """Over the compared steps, the edges' loss gradients at their logits:
    the worst step's norm of the difference over the reference's norm, and
    the worst edge's gap over the larger of its reference gradient and a
    hundredth of the step's median edge's."""
    rel, worst = 0.0, 0.0
    for p, r in zip(prog, ref):
        p, r = p.double(), r.double()
        d = (p - r).abs()
        rel = max(rel, float(d.norm() / r.norm().clamp(min=1e-300)))
        floor = 1e-2 * float(r.abs().median())
        worst = max(worst, float((d / r.abs().clamp(min=max(floor, 1e-300))).max()))
    if len(prog) != len(ref):
        rel = worst = float("inf")
    return rel, worst


def numbers(first: dict, ref: dict, p0: dict) -> tuple:
    """(every number the comparison reads, each leaf's [first-gradient,
    change] difference)."""
    keep = moved_leaves(ref["first_grads"])
    gaps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(first["losses"], ref["losses"])]
    d_prog = {k: first["params"][k] - p0[k] for k in keep}
    d_ref = {k: ref["params"][k] - p0[k] for k in keep}
    g_diff = leaf_diffs(first["first_grads"], ref["first_grads"], keep)
    u_diff = leaf_diffs(d_prog, d_ref, keep)
    rel, worst = logit_numbers(first["logit_grads"], ref["logit_grads"])
    nums = {
        "logit_grad_err": rel,
        "logit_grad_worst": worst,
        "loss_rel_err": max(gaps),
        "loss1_rel_err": gaps[0],
        "grad_norm_gap": leaf_gap(first["first_grads"], ref["first_grads"], keep),
        "update_norm_gap": leaf_gap(d_prog, d_ref, keep),
        "grad_diff_median": float(np.median(list(g_diff.values()))),
        "grad_diff_worst": max(g_diff.values()),
        "update_diff_median": float(np.median(list(u_diff.values()))),
        "update_diff_worst": max(u_diff.values()),
    }
    return nums, {k: [g_diff[k], u_diff[k]] for k in keep}


def compare(first: dict, ref: dict, p0: dict, cfg_limits: dict) -> tuple:
    """(every number, each leaf's differences, the checks: each number that
    has a limit, beside it)."""
    nums, leaves = numbers(first, ref, p0)
    return nums, leaves, {k: common.check(nums[k], cfg_limits[k]) for k in nums if k in cfg_limits}


def run(cell, seed: int, seconds: float, trace: bool, device: str) -> common.Outcome:
    import torch

    from alaz_tpu_torch.train import trainstep

    cfg, traffic = cell.config, cell.traffic
    on_card = device == "cuda"
    raws = common.make_raw_windows(cfg, seed, traffic["distinct_windows"], label_rate=traffic["label_rate"])
    batches = [common.to_batch(r) for r in raws]
    params = reference.make_params(cfg, seed, device)
    mcfg, model = common.program_model(cfg, params, device)
    bases = [(b.device_arrays(mcfg.edge_layout), b.edge_label, b.n_nodes) for b in batches]
    opt = trainstep._adamw(model, traffic["lr"])
    step = trainstep.make_train_step(mcfg, traffic["pos_weight"], device)

    spare = {k: v.copy() for k, v in bases[0][0].items()}  # the arrays of compared steps 1 and 3

    def feed(i, into=None):
        graph, label, n_nodes = bases[i % len(bases)]
        if into is not None:
            for k, v in graph.items():
                np.copyto(into[k], v)
            graph = into
        common.mark(graph["node_feats"], n_nodes, i, seed)
        return graph, label

    n_ref = int(traffic["reference_steps"])
    losses, logit_grads, first_grads = [], [], None
    loss_fn = trainstep.edge_bce_loss  # as planted, if a plant is in

    def capturing(logits, *args, **kwargs):
        logits.register_hook(lambda g: logit_grads.append(g.detach().float().clone()))
        return loss_fn(logits, *args, **kwargs)

    trainstep.edge_bce_loss = capturing  # the compared steps' logit gradients
    try:
        for i in range(n_ref):
            losses.append(float(step(model, opt, *feed(i, spare if i % 2 == 0 else None))))
            if i == 0:  # a param the step left without state moved by nothing
                first_grads = {k: opt.state.get(p, {}).get("exp_avg", torch.zeros_like(p)).detach().clone()
                               / (1.0 - BETA1) for k, p in model.named_parameters()}
    finally:
        trainstep.edge_bce_loss = loss_fn
    after = {k: p.detach().clone() for k, p in model.named_parameters()}
    for i in range(n_ref, len(bases)):  # the remaining windows' first steps
        step(model, opt, *feed(i))
    nxt = feed(len(bases))
    if on_card:
        torch.cuda.synchronize()

    sink_box: dict = {}
    steps = 0
    with tracing.traced(trace, sink_box):
        t0 = time.perf_counter()
        while time.perf_counter() < t0 + seconds:
            step(model, opt, *nxt)
            steps += 1
            nxt = feed(len(bases) + steps)
        if on_card:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    del model, opt, step, nxt
    if on_card:
        torch.cuda.empty_cache()

    reference.tf32_off()
    windows = [reference.to_tensors(common.marked(raws[i], i, seed), device) for i in range(n_ref)]
    ref = reference.train_steps(params, windows, cfg, traffic["lr"])
    # the reference's in the program's edge order; the program's live edges
    ref["logit_grads"] = [g[torch.as_tensor(gen_windows.dst_order(raws[i]["edge_dst"]), device=device)]
                          for i, g in enumerate(ref["logit_grads"])]
    prog_grads = [g[: batches[i].n_edges] for i, g in enumerate(logit_grads)]
    b = batches[0]
    nums, leaves, checks = compare({"losses": losses, "logit_grads": prog_grads, "first_grads": first_grads,
                                    "params": after}, ref, params, cell.limits)
    print(f"gpu_bench: train readings {json.dumps(nums)}", file=sys.stderr)
    print(f"gpu_bench: train leaves [first-gradient, change] differences {json.dumps(leaves)}", file=sys.stderr)
    return common.Outcome(
        window_start=t0,
        e2e={"train_step_ms": 1e3 * (t1 - t0) / steps},
        record={"cfg": cfg, "seconds": t1 - t0, "steps": steps, "numbers": nums, "n_nodes": b.n_nodes,
                "n_edges": b.n_edges, "n_pad": b.n_pad, "e_pad": b.e_pad},
        attempted=steps,
        failed=0,
        checks=checks,
        memory_peak_bytes=peak,
        trace=sink_box.get("trace"),
    )
