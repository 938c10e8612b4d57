#!/usr/bin/env python3
"""Drive the PyTorch port's scoring and training paths on one NVIDIA H100.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each raising on failure:

1. build     -- compile ``alaz_tpu_torch/csrc/segment.cu`` with nvcc into
                ``build/alaz_tpu_torch/`` and print ptxas's register,
                shared-memory and spill lines; its K4-timeline build
                compiles alongside;
2. layout    -- the GAT windows' ``cluster_renumber`` pass: its host
                seconds per window and the src-locality gauges of each
                window with and without it;
3. kernels   -- each hand-written kernel against its plain PyTorch version,
                on the card, at the scoring paths' shapes (E=1,048,576
                edges, N=131,072 nodes, F=128): K1 and K2 on the uniform
                GraphSAGE window's dst ids, K3 on the clustered GAT window's
                and on the uniform window's src ids, K4 on both windows
                (COO = blocked bit for bit, two calls alike);
   backward  -- each wrapper's backward pass at the same shapes against its
                plain version or a float64 sum, with the kernel it launches
                counted (K1's is K2, K2's is K1, K3's and K4's dx are K4);
4. slice     -- three uniform windows of bucket n131072xe1048576 scored
                through ``WindowScorer`` under the default ``ModelConfig``
                (GraphSAGE, hidden 128, 2 layers, bf16, kernels on), with
                the kernels' launch counts read around that run and one
                window held against the same model on the plain versions;
5. gat slice -- three community windows laid out by ``cluster_renumber``,
                same bucket, scored through ``WindowScorer`` under
                ``ModelConfig(model="gat", src_gather="banded")`` (hidden
                128, 4 heads, 2 layers, bf16, kernels on), launch counts
                read around that run, one window held against the plain
                versions and against ``src_gather="xla"`` (bit for bit);
   experts   -- the uniform windows through ``WindowScorer`` under
                ``ModelConfig(model="experts")`` (table form), launch
                counts around the run, one window held against the plain
                versions and against the masked form;
   tgn       -- the uniform windows streamed through ``WindowScorer`` under
                ``ModelConfig(model="tgn")``, the memory grown from 4,096 to
                131,072 rows by the first; launch counts; scores and the
                final memory held against the same stream on the plain
                versions;
6. op path   -- the public ``ops.gather_scatter_sum`` (K4) over the GAT
                windows' edges, launch counts read around those calls;
   train     -- GraphSAGE (uniform window), GAT banded (clustered window)
                and the experts: one forward and backward with launch counts
                read around it and every gradient held against the plain
                versions', then AdamW steps with the loss falling; one
                ``train_tgn_unrolled`` epoch over the three uniform windows;
7. numbers   -- kernel times (CUDA events), bounds, plain-version and
                library-call times, forward and in each backward use; for
                K4 on each window also its device time without the host's,
                the CUPTI time of its three kernels, the window's tile and
                reuse counts, its phase timeline and its time with every
                edge on one src row; per-window score time of all four
                models, and a profile of the device time by kernel over
                scored windows of each.

Output: JSON lines for each phase, then the kernels' JSON line, the
card's name and power limit, and last the result line
``{"ok": true, "device": {...}}``. Without a CUDA device it exits
nonzero and prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

E_MAIN = 1_048_576  # edges of the main path's bucket
N_MAIN = 131_072  # nodes of the main path's bucket
F_MAIN = 128  # hidden width of the default ModelConfig
WINDOW = dict(n_pods=100_000, n_svcs=10_000, n_edges=E_MAIN)  # bench.py's default window
# bench.py's GAT run: community structure, cluster_renumber layout
GAT_WINDOW = dict(WINDOW, structure="community", layout="clustered")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 rate outside the tensor cores
K1_SOURCE = "alaz_tpu_torch/csrc/segment.cu"
K1_REPLACES = "alaz_tpu/ops/pallas_segment.py:184"  # scatter_sum_sorted (pallas_call :170)
K2_REPLACES = "alaz_tpu/ops/pallas_segment.py:346"  # segment_expand_sorted (pallas_call :332)
K3_REPLACES = "alaz_tpu/ops/pallas_segment.py:541"  # gather_rows_banded (pallas_call :527)
K4_REPLACES = "alaz_tpu/ops/pallas_segment.py:588"  # pallas_gather_scatter_sum (pallas_call :170)


def emit(tag: str, obj) -> None:
    print(json.dumps({tag: obj}), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def _counts(k1: int, k2: int, k3: int, k4: int) -> dict:
    return {
        "scatter_sum_sorted": k1, "segment_expand_sorted": k2,
        "gather_rows_banded": k3, "pallas_gather_scatter_sum": k4,
    }


# -- phase 1 ----------------------------------------------------------------


def phase_build() -> None:
    """Build the kernels and, in parallel, their K4-timeline build (one nvcc
    each, started together)."""
    from alaz_tpu_torch.ops import _build

    t0 = time.perf_counter()
    timeline = threading.Thread(target=_build.build, kwargs={"extra_flags": _build.TIMELINE_FLAGS})
    timeline.start()
    built = _build.build()
    _build.library()
    timeline.join()
    seconds = time.perf_counter() - t0
    for line in built.log.splitlines():
        if any(k in line for k in ("Compiling entry", "registers", "spill", "smem")):
            print("ptxas:", line.strip())
    emit("build", {"library": built.path.name, "seconds": seconds})


# -- phase 2 ----------------------------------------------------------------


def phase_layout(gat_batches, seeds, window: dict = GAT_WINDOW) -> dict:
    """Re-draw each GAT window in its random layout (the same draws), time
    ``cluster_renumber`` over its real edges, check that the pass gives the
    clustered window's edges, and read the locality gauges of both."""
    from alaz_tpu_torch.graph.builder import cluster_renumber, src_locality_gauges
    from alaz_tpu_torch.replay.synth import example_batch

    renumber_s, gauges = [], []
    for seed, clustered in zip(seeds, gat_batches):
        raw = example_batch(**dict(window, layout="random"), seed=seed)
        n = raw.n_edges
        t0 = time.perf_counter()
        perm = cluster_renumber(raw.edge_src[:n], raw.edge_dst[:n], raw.n_nodes)
        renumber_s.append(time.perf_counter() - t0)
        order = np.argsort(perm[raw.edge_dst[:n]], kind="stable")
        require(
            np.array_equal(perm[raw.edge_src[:n]][order], clustered.edge_src[:n]),
            f"seed {seed}: cluster_renumber does not give the clustered window's src ids",
        )
        before = src_locality_gauges(raw.edge_src[:n], raw.n_nodes)
        after = src_locality_gauges(clustered.edge_src[:n], clustered.n_nodes)
        gauges.append({
            "seed": seed,
            "without_renumber": {"band_windows": before[0], "straggler_fraction": before[1]},
            "with_renumber": {"band_windows": after[0], "straggler_fraction": after[1]},
        })
    out = {"cluster_renumber_s": renumber_s, "src_locality_gauges": gauges}
    emit("layout", out)
    return out


# -- phase 3 ----------------------------------------------------------------


def _k1_tolerance(ref: torch.Tensor) -> torch.Tensor:
    """Kernel and plain version both sum in f32, in another order. f32 out:
    within 1e-5 of the output's largest magnitude. bf16 out: the two f32
    sums may round to adjacent bf16 values, one ulp (≤ 2^-7·|ref|)."""
    scale = 1e-5 * ref.float().abs().max()
    if ref.dtype == torch.float32:
        return scale.expand_as(ref)
    return 2.0**-7 * ref.float().abs() + scale


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def phase_kernels(batch, gat_batch, dev: torch.device) -> dict:
    """Each kernel against its plain version on the windows' edge ids (the
    main paths'). Returns the max abs error per case."""
    from alaz_tpu_torch.ops import segment_kernels as K

    gen = torch.Generator(device=dev).manual_seed(0)
    edge_dst = torch.as_tensor(batch.edge_dst, device=dev)
    bs = torch.as_tensor(batch.block_starts(), device=dev)
    n_pad = batch.n_pad
    e = edge_dst.shape[0]
    msgs32 = torch.randn((e, F_MAIN), generator=gen, device=dev)
    errs = {}
    for name, msgs, out_dtype in (
        ("k1_bf16", msgs32.bfloat16(), None),
        ("k1_f32", msgs32, None),
        ("k1_bf16_to_f32", msgs32.bfloat16(), torch.float32),
    ):
        outs = {}
        for layout, starts in (("coo", None), ("blocked", bs)):
            got = K.scatter_sum_sorted(msgs, edge_dst, n_pad, out_dtype, starts)
            ref = K.scatter_sum_sorted_plain(msgs, edge_dst, n_pad, got.dtype, starts)
            _sync(dev)
            err = (got.float() - ref.float()).abs()
            require(bool((err <= _k1_tolerance(ref)).all()), f"{name}/{layout} disagrees with its plain version")
            errs[f"{name}_{layout}"] = float(err.max())
            outs[layout] = got
        require(
            torch.equal(outs["coo"][: batch.n_nodes], outs["blocked"][: batch.n_nodes]),
            f"{name}: blocked rows differ from COO rows",
        )
    del msgs32
    for name, dtype in (("k2_bf16", torch.bfloat16), ("k2_f32", torch.float32)):
        v = torch.randn((n_pad, F_MAIN), generator=gen, device=dev).to(dtype)
        got = K.segment_expand_sorted(v, edge_dst, n_pad)
        ref = K.segment_expand_sorted_plain(v, edge_dst)
        _sync(dev)
        require(torch.equal(got, ref), f"{name} is not bit-exact")
        errs[name] = float((got.float() - ref.float()).abs().max())

    # K3 on the clustered GAT window's src ids and on the uniform window's:
    # the result must not depend on the ids' locality
    for ids_name, b in (("clustered", gat_batch), ("uniform", batch)):
        src = torch.as_tensor(b.edge_src, device=dev)
        for dname, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            v = torch.randn((b.n_pad, F_MAIN), generator=gen, device=dev).to(dtype)
            got = K.gather_rows_banded(v, src, b.n_pad)
            ref = K.gather_rows_banded_plain(v, src)
            _sync(dev)
            require(torch.equal(got, ref), f"k3_{dname}_{ids_name} is not bit-exact")
            errs[f"k3_{dname}_{ids_name}"] = float((got.float() - ref.float()).abs().max())

    # K4 on the GAT window and on the uniform one, with and without
    # weights; COO and blocked row starts must give the same rows bit for
    # bit, and a second call the same bits
    for win, b in (("", gat_batch), ("_uniform", batch)):
        src = torch.as_tensor(b.edge_src, device=dev)
        dst = torch.as_tensor(b.edge_dst, device=dev)
        gbs = torch.as_tensor(b.block_starts(), device=dev)
        w = torch.rand(dst.shape[0], generator=gen, device=dev) + 0.5
        for dname, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            x = torch.randn((b.n_pad, F_MAIN), generator=gen, device=dev).to(dtype)
            for wname, ww in (("w", w), ("now", None)):
                coo = K.pallas_gather_scatter_sum(x, src, dst, b.n_pad, ww)
                blk = K.pallas_gather_scatter_sum(x, src, dst, b.n_pad, ww, gbs)
                ref = K.pallas_gather_scatter_sum_plain(x, src, dst, b.n_pad, ww)
                _sync(dev)
                err = (coo.float() - ref.float()).abs()
                name = f"k4_{dname}_{wname}{win}"
                require(coo.dtype == dtype, f"{name}: dtype {coo.dtype}")
                require(bool((err <= _k1_tolerance(ref)).all()), f"{name} disagrees with its plain version")
                require(
                    torch.equal(coo[: b.n_nodes], blk[: b.n_nodes]),
                    f"{name}: blocked rows differ from COO rows",
                )
                require(torch.equal(coo, K.pallas_gather_scatter_sum(x, src, dst, b.n_pad, ww)),
                        f"{name}: two calls differ")
                errs[name] = float(err.max())
    emit("kernels_vs_plain", {
        "tolerance": "K2, K3 bit-exact; K1, K4 f32 within 1e-5 of max|out|, bf16 within one bf16 ulp",
        "max_abs_err": errs,
    })
    return errs


# -- phase 3b: the kernels as backward passes ---------------------------------


def _f64_sum(g: torch.Tensor, ids: torch.Tensor, n: int, w=None) -> torch.Tensor:
    """``Σ_{ids[e]=i} w[e]·g[e]`` in float64: a reference whose own sums
    are exact far below the tolerance."""
    src = g.double() if w is None else g.double() * w.double()[:, None]
    return torch.zeros((n, g.shape[1]), dtype=torch.float64, device=g.device).index_add_(0, ids.long(), src)


def phase_backward(batch, gat_batch, dev: torch.device) -> dict:
    """Each wrapper's backward pass on the card at the training paths'
    shapes, against its plain version (or a float64 sum), and the kernel
    it launches, counted: K1's backward is a K2 launch (exact), K2's a K1
    launch, K3's a K4 launch over the ids' stable sort, K4's ``dx`` a K4
    launch with src and dst swapped, in f32. K3's and K4's backward run
    twice and must give the same bits. Returns the max abs error per case."""
    from alaz_tpu_torch.ops import segment_kernels as K

    gen = torch.Generator(device=dev).manual_seed(4)
    on_card = dev.type == "cuda"
    n_pad = batch.n_pad
    dst = torch.as_tensor(batch.edge_dst, device=dev)
    e = dst.shape[0]
    errs, launches = {}, {}

    def run(name, out, g, want):
        K.reset_launch_counts()
        out.backward(g, retain_graph=True)
        _sync(dev)
        launches[name] = K.launch_counts()
        if on_card:
            require(launches[name] == want, f"{name}: backward launches {launches[name]}, expected {want}")

    def randn(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # K1's backward, as GraphSAGE (bf16 → bf16, F=128) and GAT (bf16 → f32, F=132) call K1
    for name, f, out_dtype in (("k1_bwd", F_MAIN, None), ("k1_bwd_gat", F_MAIN + 4, torch.float32)):
        msgs = randn((e, f)).requires_grad_()
        out = K.scatter_sum_sorted(msgs, dst, n_pad, out_dtype)
        g = randn(out.shape, out.dtype)
        run(name, out, g, _counts(0, 1, 0, 0))
        ref = K.segment_expand_sorted_plain(g.to(msgs.dtype), dst)
        require(msgs.grad.dtype == msgs.dtype and torch.equal(msgs.grad, ref), f"{name} is not bit-exact")
        errs[name] = float((msgs.grad.float() - ref.float()).abs().max())
    del msgs, out, g, ref

    # K2's backward: the sorted sum of g over dst
    v = randn((n_pad, F_MAIN)).requires_grad_()
    out = K.segment_expand_sorted(v, dst, n_pad)
    g = randn(out.shape)
    run("k2_bwd", out, g, _counts(1, 0, 0, 0))
    ref = K.scatter_sum_sorted_plain(g, dst, n_pad, torch.bfloat16)
    err = (v.grad.float() - ref.float()).abs()
    require(bool((err <= _k1_tolerance(ref)).all()), "k2_bwd disagrees with its plain version")
    errs["k2_bwd"] = float(err.max())
    del v, out, g

    # K3's backward on the clustered GAT window's src ids and the uniform one's
    for ids_name, b in (("clustered", gat_batch), ("uniform", batch)):
        name = f"k3_bwd_{ids_name}"
        src = torch.as_tensor(b.edge_src, device=dev)
        v = randn((b.n_pad, F_MAIN)).requires_grad_()
        out = K.gather_rows_banded(v, src, b.n_pad)
        g = randn(out.shape)
        run(name, out, g, _counts(0, 0, 0, 1))
        first, v.grad = v.grad, None
        out.backward(g)
        require(torch.equal(first, v.grad), f"{name}: two backward passes differ")
        ref = _f64_sum(g, src, b.n_pad).to(v.dtype)
        err = (first.float() - ref.float()).abs()
        require(bool((err <= _k1_tolerance(ref)).all()), f"{name} disagrees with the float64 sum")
        errs[name] = float(err.max())
        del v, out, g, first, ref

    # K4's backward (dx and dw) on the GAT window's edges, bf16 x, f32 weights
    src = torch.as_tensor(gat_batch.edge_src, device=dev)
    gdst = torch.as_tensor(gat_batch.edge_dst, device=dev)
    x = randn((gat_batch.n_pad, F_MAIN)).requires_grad_()
    w = (torch.rand(gdst.shape[0], generator=gen, device=dev) + 0.5).requires_grad_()
    out = K.pallas_gather_scatter_sum(x, src, gdst, gat_batch.n_pad, w)
    g = randn(out.shape)
    run("k4_bwd", out, g, _counts(0, 0, 0, 1))
    dx, dw = x.grad, w.grad
    x.grad = w.grad = None
    out.backward(g)
    require(torch.equal(dx, x.grad) and torch.equal(dw, w.grad), "k4_bwd: two backward passes differ")
    ref = _f64_sum(g[gdst.long()], src, gat_batch.n_pad, w.detach()).to(x.dtype)
    err = (dx.float() - ref.float()).abs()
    require(bool((err <= _k1_tolerance(ref)).all()), "k4_bwd dx disagrees with the float64 sum")
    errs["k4_bwd_dx"] = float(err.max())
    dw_ref = (x.detach()[src.long()].float() * g.float()[gdst.long()]).sum(dim=1)
    dw_err = (dw - dw_ref).abs()
    require(float(dw_err.max()) <= 1e-5 * float(dw_ref.abs().max()), "k4_bwd dw disagrees with its plain version")
    errs["k4_bwd_dw"] = float(dw_err.max())
    emit("backward_vs_plain", {
        "tolerance": "K1's backward bit-exact; K2's, K3's and K4's dx within one bf16 ulp "
                     "(2^-7·|ref| + 1e-5·max|ref|) of the plain version or the float64 sum; "
                     "K4's dw within 1e-5 of max|ref|",
        "max_abs_err": errs,
        "launches": launches,
    })
    return errs


# -- phases 4 and 5 -----------------------------------------------------------


@contextlib.contextmanager
def plain_kernels():
    """Route the forward and backward passes of every kernel wrapper through
    the kernels' plain versions on the card (for the reference runs only;
    restored on exit)."""
    from alaz_tpu_torch.ops import segment_kernels as K

    saved = K._run_k1, K._run_k2, K._run_k3, K._run_k4
    K._run_k1 = K.scatter_sum_sorted_plain
    K._run_k2 = lambda v, edge_dst, num_nodes: K.segment_expand_sorted_plain(v, edge_dst)
    K._run_k3 = lambda v, ids, num_nodes: K.gather_rows_banded_plain(v, ids)
    K._run_k4 = K.pallas_gather_scatter_sum_plain
    try:
        yield
    finally:
        K._run_k1, K._run_k2, K._run_k3, K._run_k4 = saved


def _score_windows(cfg, batches, device: str):
    """WindowScorer over the windows, serially, with the kernels' launch
    counts set to 0 just before and read just after."""
    from alaz_tpu_torch.models.registry import init_params
    from alaz_tpu_torch.ops import segment_kernels as K
    from alaz_tpu_torch.runtime.scorer import WindowScorer

    params = init_params(cfg, key=0, device=device)
    scorer = WindowScorer(cfg, params, device=device)
    on_card = scorer.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    window_s, all_scores = [], []
    for b in batches:
        t0 = time.perf_counter()
        scores = scorer.score(b)  # ends in a copy to the host: synchronous
        window_s.append(time.perf_counter() - t0)
        all_scores.append(scores)
    launches = K.launch_counts()
    peak_bytes = torch.cuda.max_memory_allocated() if on_card else None
    for b, s in zip(batches, all_scores):
        require(s.shape == (b.n_edges,), f"scores shape {s.shape}")
        require(bool(((s >= 0) & (s <= 1)).all()) and bool(torch.isfinite(torch.from_numpy(s)).all()),
                "scores not finite in [0, 1]")
    return scorer, on_card, window_s, all_scores, launches, peak_bytes


def _vs_plain(cfg, scorer, batch, device) -> tuple:
    """One window against the same model on the plain versions: kernels and
    plain versions differ only in K1's f32 summation order, so logits may
    differ where a bf16 rounding flipped; held at four bf16 ulps of the
    largest logit (2^-6·max|ref|). Returns (errors, the kernels' outputs)."""
    from alaz_tpu_torch.train.trainstep import make_score_fn

    score_fn = make_score_fn(cfg, device)
    arrays = batch.device_arrays(cfg.edge_layout)
    got = score_fn(scorer.params, arrays)
    with plain_kernels():
        ref = score_fn(scorer.params, arrays)
    errs = {}
    for key, n_real in (("edge_logits", batch.n_edges), ("node_logits", batch.n_nodes)):
        g, r = got[key][:n_real], ref[key][:n_real]
        err = float((g - r).abs().max())
        bound = 2.0**-6 * float(r.abs().max())
        require(err <= bound, f"{key}: kernels vs plain versions differ by {err} > {bound}")
        errs[key] = {"max_abs_err": err, "bound": bound}
    return errs, got


def _tf32() -> dict:
    return {
        "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
    }


def phase_slice(batches, device: str = "cuda") -> tuple:
    """GraphSAGE: score the windows through WindowScorer and read the
    kernels' launch counts around exactly that run. Returns (summary,
    scorer)."""
    from alaz_tpu_torch.config import ModelConfig

    cfg = ModelConfig()
    require(
        (cfg.model, cfg.hidden_dim, cfg.num_layers, cfg.dtype, cfg.use_pallas, cfg.edge_layout)
        == ("graphsage", 128, 2, "bfloat16", True, "coo"),
        f"unexpected default ModelConfig {cfg}",
    )
    scorer, on_card, window_s, all_scores, launches, peak_bytes = _score_windows(cfg, batches, device)
    n = len(batches)
    if on_card:
        require(launches == _counts(2 * n, n, 0, 0),
                f"expected 2 K1 and 1 K2 launches per forward, got {launches} for {n} forwards")
    errs, _ = _vs_plain(cfg, scorer, batches[0], device)
    out = {
        "bucket": batches[0].bucket_key,
        "windows": n,
        "edges_per_window": [b.n_edges for b in batches],
        "window_s": window_s,
        "launches": launches,
        "vs_plain_versions": errs,
        "score_mean": float(sum(float(s.mean()) for s in all_scores) / n),
        "tf32": _tf32(),
    }
    if on_card:
        out["max_memory_allocated_bytes"] = peak_bytes
    emit("slice", out)
    return out, scorer


def phase_gat_slice(batches, device: str = "cuda") -> tuple:
    """GAT over cluster-renumbered windows with the banded src gather:
    score through WindowScorer, read the launch counts around that run,
    hold one window against the plain versions and against the plain src
    gather (``src_gather="xla"``), which must agree bit for bit since K3
    is exact. Returns (summary, scorer)."""
    from alaz_tpu_torch.config import ModelConfig
    from alaz_tpu_torch.train.trainstep import make_score_fn

    cfg = ModelConfig(model="gat", src_gather="banded")
    require(
        (cfg.hidden_dim, cfg.num_heads, cfg.num_layers, cfg.dtype, cfg.use_pallas,
         cfg.edge_layout, cfg.edge_feat_dim_in)
        == (128, 4, 2, "bfloat16", True, "coo", 23),
        f"unexpected GAT ModelConfig {cfg}",
    )
    scorer, on_card, window_s, all_scores, launches, peak_bytes = _score_windows(cfg, batches, device)
    n = len(batches)
    if on_card:
        require(launches == _counts(2 * n, 3 * n, 3 * n, 0),
                f"expected 2 K1, 3 K2 and 3 K3 launches per forward, got {launches} for {n} forwards")
    errs, got = _vs_plain(cfg, scorer, batches[0], device)
    xla_cfg = dataclasses.replace(cfg, src_gather="xla")
    xla = make_score_fn(xla_cfg, device)(scorer.params, batches[0].device_arrays(cfg.edge_layout))
    for key in ("edge_logits", "node_logits", "node_h", "attn_clamp_saturation"):
        require(torch.equal(got[key], xla[key]), f"gat {key}: src_gather banded differs from xla")
    out = {
        "bucket": batches[0].bucket_key,
        "windows": n,
        "edges_per_window": [b.n_edges for b in batches],
        "window_s": window_s,
        "launches": launches,
        "vs_plain_versions": errs,
        "banded_equals_xla": True,
        "attn_clamp_saturation": float(got["attn_clamp_saturation"]),
        "score_mean": float(sum(float(s.mean()) for s in all_scores) / n),
        "tf32": _tf32(),
    }
    if on_card:
        out["max_memory_allocated_bytes"] = peak_bytes
    emit("gat_slice", out)
    return out, scorer


def phase_experts_slice(batches, device: str = "cuda") -> tuple:
    """The edge-type experts (``"table"``, hidden 128, 9 experts, 2 layers,
    bf16, kernels on) over the uniform windows through WindowScorer, launch
    counts read around that run (K1 2n, K2 n); one window held against the
    plain versions, and the ``"masked"`` form against ``"table"`` on it:
    the same products, rounded to bf16 at other places (a table row per
    node against a product per edge, T masked terms summed in bf16), held
    at the same four bf16 ulps of the largest logit. Returns (summary,
    scorer)."""
    from alaz_tpu_torch.config import ModelConfig
    from alaz_tpu_torch.train.trainstep import make_score_fn

    cfg = ModelConfig(model="experts")
    require(
        (cfg.hidden_dim, cfg.num_layers, cfg.num_edge_types, cfg.expert_dispatch, cfg.dtype, cfg.use_pallas)
        == (128, 2, 9, "table", "bfloat16", True),
        f"unexpected experts ModelConfig {cfg}",
    )
    scorer, on_card, window_s, all_scores, launches, peak_bytes = _score_windows(cfg, batches, device)
    n = len(batches)
    if on_card:
        require(launches == _counts(2 * n, n, 0, 0),
                f"expected 2 K1 and 1 K2 launches per forward, got {launches} for {n} forwards")
    errs, got = _vs_plain(cfg, scorer, batches[0], device)
    masked_cfg = dataclasses.replace(cfg, expert_dispatch="masked")
    masked = make_score_fn(masked_cfg, device)(scorer.params, batches[0].device_arrays(cfg.edge_layout))
    b = batches[0]
    masked_errs = {}
    for key, n_real in (("edge_logits", b.n_edges), ("node_logits", b.n_nodes)):
        r, m = got[key][:n_real], masked[key][:n_real]
        err, bound = float((m - r).abs().max()), 2.0**-6 * float(r.abs().max())
        require(err <= bound, f"experts {key}: masked vs table differ by {err} > {bound}")
        masked_errs[key] = {"max_abs_err": err, "bound": bound}
    out = {
        "bucket": b.bucket_key,
        "windows": n,
        "window_s": window_s,
        "launches": launches,
        "vs_plain_versions": errs,
        "masked_vs_table": masked_errs,
        "score_mean": float(sum(float(sc.mean()) for sc in all_scores) / n),
    }
    if on_card:
        out["max_memory_allocated_bytes"] = peak_bytes
    emit("experts_slice", out)
    return out, scorer


def _logit_scale(scores: np.ndarray) -> float:
    s = np.clip(scores.astype(np.float64), 1e-12, 1 - 1e-12)
    return float(np.abs(np.log(s) - np.log1p(-s)).max())


def phase_tgn_slice(batches, device: str = "cuda") -> tuple:
    """TGN (hidden 128, 2 layers, bf16, kernels on) streamed over the
    uniform windows, in their random layout (the JAX service refuses to
    renumber nodes under TGN: its memory is slot-indexed across windows),
    through WindowScorer, which owns the memory: presized to
    ``tgn_max_nodes`` (4,096 rows), grown to the 131,072-row bucket by the
    first window. Launch counts read around the stream (K1 2n, K2 n).
    Scores and the final memory held against the same stream on the plain
    versions: scores at a quarter of four bf16 ulps of the largest logit
    (sigmoid's slope is at most 1/4); the memory, whose gates read bf16
    node states (an ulp apart moves a gate; the CPU parity against the JAX
    package sees 0.036 after three windows), at 2^-4 of its ±1 range.
    Returns (summary, scorer)."""
    from alaz_tpu_torch.config import ModelConfig
    from alaz_tpu_torch.runtime.scorer import WindowScorer

    cfg = ModelConfig(model="tgn")
    require((cfg.hidden_dim, cfg.num_layers, cfg.dtype, cfg.use_pallas, cfg.tgn_max_nodes)
            == (128, 2, "bfloat16", True, 4096), f"unexpected TGN ModelConfig {cfg}")
    for b in batches:
        require(b.n_pad > cfg.tgn_max_nodes, "the windows must outgrow the presized memory")
    scorer, on_card, window_s, all_scores, launches, peak_bytes = _score_windows(cfg, batches, device)
    n = len(batches)
    if on_card:
        require(launches == _counts(2 * n, n, 0, 0),
                f"expected 2 K1 and 1 K2 launches per window, got {launches} for {n} windows")
    require(tuple(scorer.memory.shape) == (batches[0].n_pad, cfg.hidden_dim),
            f"memory {tuple(scorer.memory.shape)} did not grow to the bucket")
    plain = WindowScorer(cfg, scorer.params, device=device)
    require(tuple(plain.memory.shape) == (cfg.tgn_max_nodes, cfg.hidden_dim), "memory not presized")
    with plain_kernels():
        plain_scores = [plain.score(b) for b in batches]
    score_errs = []
    for got, ref in zip(all_scores, plain_scores):
        err, bound = float(np.abs(got - ref).max()), 0.25 * 2.0**-6 * _logit_scale(ref)
        require(err <= bound, f"tgn scores: kernels vs plain versions differ by {err} > {bound}")
        score_errs.append({"max_abs_err": err, "bound": bound})
    mem_err = float((scorer.memory - plain.memory).abs().max())
    require(mem_err <= 2.0**-4, f"tgn memory: kernels vs plain versions differ by {mem_err}")
    require(bool(torch.isfinite(scorer.memory).all()), "tgn memory not finite")
    live = int((scorer.memory.abs().sum(dim=1) > 0).sum())
    out = {
        "bucket": batches[0].bucket_key,
        "windows": n,
        "window_s": window_s,
        "launches": launches,
        "memory_rows": [cfg.tgn_max_nodes, int(scorer.memory.shape[0])],
        "memory_rows_nonzero": live,
        "vs_plain_versions": {"scores": score_errs, "memory_max_abs_err": mem_err, "memory_bound": 2.0**-4},
        "score_mean": float(sum(float(sc.mean()) for sc in all_scores) / n),
    }
    if on_card:
        out["max_memory_allocated_bytes"] = peak_bytes
    emit("tgn_slice", out)
    return out, scorer


# -- phase 6 ----------------------------------------------------------------


def phase_op_path(batches, device: str = "cuda") -> dict:
    """The public ``ops.gather_scatter_sum`` as a caller uses it (kernels
    on by default) over each GAT window's edges with random bf16 node
    states and weights: launch counts read around those calls, the output
    held to K4's wrapper bit for bit (deterministic) and to its plain
    version at K1's tolerance."""
    from alaz_tpu_torch import ops
    from alaz_tpu_torch.ops import segment_kernels as K

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(2)
    inputs = []
    for b in batches:
        inputs.append((
            torch.randn((b.n_pad, F_MAIN), generator=gen, device=dev).bfloat16(),
            torch.as_tensor(b.edge_src, device=dev),
            torch.as_tensor(b.edge_dst, device=dev),
            b.n_pad,
            torch.rand(b.e_pad, generator=gen, device=dev) + 0.5,
        ))
    K.reset_launch_counts()
    outs = [ops.gather_scatter_sum(*args) for args in inputs]
    launches = K.launch_counts()
    if dev.type == "cuda":
        require(launches == _counts(0, 0, 0, len(batches)),
                f"expected one K4 launch per call, got {launches}")
    errs = []
    for args, out in zip(inputs, outs):
        require(out.dtype == torch.bfloat16 and out.shape == (args[3], F_MAIN), f"op output {out.dtype} {out.shape}")
        require(torch.equal(out, K.pallas_gather_scatter_sum(*args)), "ops.gather_scatter_sum is not K4's result")
        ref = K.pallas_gather_scatter_sum_plain(*args)
        err = (out.float() - ref.float()).abs()
        require(bool((err <= _k1_tolerance(ref)).all()), "ops.gather_scatter_sum disagrees with K4's plain version")
        errs.append(float(err.max()))
    out = {"calls": len(batches), "launches": launches, "max_abs_err": errs}
    emit("op_path", out)
    return out


# -- phase 6b: training ----------------------------------------------------------


def window_labels(b) -> np.ndarray:
    """Fault labels the smoke draws for a window: an edge whose first
    feature is past that feature's 95th percentile over the real edges."""
    lab = np.zeros(b.e_pad, np.float32)
    f0 = b.edge_feats[: b.n_edges, 0]
    lab[: b.n_edges] = f0 > np.quantile(f0, 0.95)
    return lab


def _grads(cfg, params, graph, label) -> tuple:
    from alaz_tpu_torch.train.trainstep import backward, make_loss_fn

    for p in params.parameters():
        p.grad = None
    loss = make_loss_fn(cfg)(params, graph, label)
    backward(params, loss)
    return float(loss.detach()), {k: p.grad.clone() for k, p in params.named_parameters()}


# launches of one forward and backward: forward K1/K2/K3, then K1's
# backward (a K2 each), K2's (a K1 each), K3's (a K4 each)
TRAIN_LAUNCHES = {
    "graphsage": _counts(2 + 1, 1 + 2, 0, 0),
    "gat": _counts(2 + 3, 3 + 2, 3, 3),
    "experts": _counts(2 + 1, 1 + 2, 0, 0),
}


def phase_train(tag: str, cfg, batch, device: str = "cuda", steps: int = 5) -> dict:
    """Training at full width on one window: one forward and backward with
    the kernels, launch counts read around it; the same on the plain
    versions on the card, every param's gradient held to 2^-4 of that
    param's largest gradient (the two sum in another order, so a bf16
    activation may round an ulp apart and carry that through the
    backward); then ``steps`` steps of ``make_train_step`` (AdamW), each
    loss finite and the last below the first, with the step's time and
    the peak memory over the steps."""
    from alaz_tpu_torch.convert import graph_to_torch
    from alaz_tpu_torch.models.registry import init_params
    from alaz_tpu_torch.ops import segment_kernels as K
    from alaz_tpu_torch.train.trainstep import _adamw, make_train_step

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    params = init_params(cfg, key=0, device=dev)
    graph = graph_to_torch(batch.device_arrays(cfg.edge_layout), dev)
    label = torch.as_tensor(window_labels(batch), device=dev)
    K.reset_launch_counts()
    loss_k, grads_k = _grads(cfg, params, graph, label)
    _sync(dev)
    launches = K.launch_counts()
    if on_card:
        require(launches == TRAIN_LAUNCHES[cfg.model],
                f"{tag}: launches of one forward and backward {launches}, expected {TRAIN_LAUNCHES[cfg.model]}")
    with plain_kernels():
        loss_p, grads_p = _grads(cfg, params, graph, label)
    worst = 0.0
    for k, ref in grads_p.items():
        got = grads_k[k]
        require(bool(torch.isfinite(got).all()), f"{tag}: gradient of {k} not finite")
        rel = float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
        require(rel <= 2.0**-4, f"{tag}: gradient of {k} differs from the plain versions' by {rel} of its max")
        worst = max(worst, rel)
    del grads_k, grads_p
    opt = _adamw(params, 3e-3)
    step = make_train_step(cfg, device=dev)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(step(params, opt, graph, label)))  # float() waits for the step
        step_s.append(time.perf_counter() - t0)
    require(all(np.isfinite(losses)), f"{tag}: loss not finite {losses}")
    require(losses[-1] < losses[0], f"{tag}: loss did not fall {losses}")
    out = {
        "bucket": batch.bucket_key,
        "positives": int(window_labels(batch).sum()),
        "launches_forward_backward": launches,
        "loss_kernels_vs_plain": [loss_k, loss_p],
        "grad_max_err_of_param_max": worst,
        "losses": losses,
        "step_s": step_s,
        "step_s_median_after_first": statistics.median(step_s[1:]) if steps > 1 else step_s[0],
    }
    if on_card:
        out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    emit(tag, out)
    return out


def phase_train_tgn(batches, device: str = "cuda") -> dict:
    """One ``train_tgn_unrolled`` epoch (one AdamW step) over the uniform
    windows as one sequence, the memory threaded through all three without
    a detach; launch counts read around it (per window K1 2 + 1 and K2
    1 + 2), a finite loss and a gradient on the GRU. Its time includes the
    params' init and the windows' move to the card."""
    from alaz_tpu_torch.config import ModelConfig
    from alaz_tpu_torch.ops import segment_kernels as K
    from alaz_tpu_torch.train.trainstep import train_tgn_unrolled

    cfg = ModelConfig(model="tgn")
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    labelled = [dataclasses.replace(b, edge_label=window_labels(b)) for b in batches]
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    state, losses = train_tgn_unrolled(cfg, labelled, epochs=1, device=dev)
    epoch_s = time.perf_counter() - t0
    launches = K.launch_counts()
    n = len(batches)
    if on_card:
        require(launches == _counts(3 * n, 3 * n, 0, 0), f"tgn unrolled: launches {launches} for {n} windows")
    require(np.isfinite(losses).all() and state.step == 1, f"tgn unrolled: losses {losses}")
    gru = state.params.gru_n.w.grad
    require(gru is not None and float(gru.abs().max()) > 0, "tgn unrolled: the GRU got no gradient")
    out = {"windows": n, "launches": launches, "loss": losses[0], "epoch_s": epoch_s}
    if on_card:
        out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    emit("train_tgn", out)
    return out


# -- phase 7 ----------------------------------------------------------------


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _bound(bytes_moved: float, flops: float) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _kernel_entry(name, replaces, launches, err, ms, plain_ms, bound, library_ms) -> dict:
    return {
        "name": name, "route": "cuda", "source": K1_SOURCE, "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library_ms,
    }


def numbers_k1_k2(batches, dev) -> dict:
    """K1 and K2 as the GraphSAGE path calls them (bf16, F=128, COO)."""
    from alaz_tpu_torch.ops import segment_kernels as K

    gen = torch.Generator(device=dev).manual_seed(1)
    edge_dst = torch.as_tensor(batches[0].edge_dst, device=dev)
    bs = torch.as_tensor(batches[0].block_starts(), device=dev)
    e = edge_dst.shape[0]
    f = F_MAIN
    idx64 = edge_dst.long()
    msgs = torch.randn((e, f), generator=gen, device=dev).bfloat16()
    v = torch.randn((N_MAIN, f), generator=gen, device=dev).bfloat16()

    # K1 as the scoring path calls it: bf16 in, bf16 out, COO row starts
    k1_ms = time_ms(lambda: K.scatter_sum_sorted(msgs, edge_dst, N_MAIN))
    k1_plain_ms = time_ms(lambda: K.scatter_sum_sorted_plain(msgs, edge_dst, N_MAIN, torch.bfloat16))
    acc = torch.zeros((N_MAIN, f), dtype=torch.bfloat16, device=dev)
    k1_lib_ms = time_ms(lambda: acc.index_add_(0, edge_dst, msgs))
    k1_bytes = e * (f * 2 + 4) + N_MAIN * f * 2 + (N_MAIN // 128 + 1) * 4

    k2_ms = time_ms(lambda: K.segment_expand_sorted(v, edge_dst, N_MAIN))
    k2_plain_ms = time_ms(lambda: K.segment_expand_sorted_plain(v, edge_dst))
    k2_lib_ms = time_ms(lambda: torch.index_select(v, 0, idx64))
    rows_read = int(torch.unique(edge_dst).numel())
    k2_bytes = e * 4 + e * f * 2 + rows_read * f * 2

    # the other K1 variants the ops expose, for the record; the f32 inputs
    # are cast once, outside the timed calls
    msgs32, v32 = msgs.float(), v.float()
    acc32 = torch.zeros((N_MAIN, f), dtype=torch.float32, device=dev)
    variants = {
        "k1_f32_ms": time_ms(lambda: K.scatter_sum_sorted(msgs32, edge_dst, N_MAIN), iters=20),
        "k1_f32_bound_ms": _bound(e * (f * 4 + 4) + N_MAIN * f * 4 + (N_MAIN // 128 + 1) * 4, e * f)[0],
        "k1_f32_index_add_ms": time_ms(lambda: acc32.index_add_(0, edge_dst, msgs32), iters=20),
        "k1_bf16_to_f32_ms": time_ms(
            lambda: K.scatter_sum_sorted(msgs, edge_dst, N_MAIN, torch.float32), iters=20),
        "k1_bf16_blocked_ms": time_ms(
            lambda: K.scatter_sum_sorted(msgs, edge_dst, N_MAIN, None, bs), iters=20),
        "k2_f32_ms": time_ms(lambda: K.segment_expand_sorted(v32, edge_dst, N_MAIN), iters=20),
        "k1_nonempty_rows": rows_read,
        "k1_nonempty_blocks": int(((bs[1:] - bs[:-1]) > 0).sum()),
    }
    del msgs32, v32, acc32
    emit("kernel_variants", variants)
    return {
        "k1": (k1_ms, k1_plain_ms, _bound(k1_bytes, e * f), k1_lib_ms),
        "k2": (k2_ms, k2_plain_ms, _bound(k2_bytes, 0), k2_lib_ms),
    }


def numbers_k3_k4(batches, gat_batches, dev) -> dict:
    """K3 as the GAT path calls it (bf16 [N, 128] rows gathered by src), on
    the clustered GAT window's ids and on the uniform window's; K4 on both
    windows' edges (``numbers_k4``). The kernels line takes K4's numbers on
    the clustered window."""
    from alaz_tpu_torch.ops import segment_kernels as K

    gen = torch.Generator(device=dev).manual_seed(3)
    f = F_MAIN
    v = torch.randn((N_MAIN, f), generator=gen, device=dev).bfloat16()
    k3 = {}
    for ids_name, b in (("clustered", gat_batches[0]), ("uniform", batches[0])):
        src = torch.as_tensor(b.edge_src, device=dev)
        src64 = src.long()
        e = src.shape[0]
        rows_read = int(torch.unique(src).numel())
        k3[ids_name] = {
            "ms": time_ms(lambda: K.gather_rows_banded(v, src, N_MAIN)),
            "plain_ms": time_ms(lambda: K.gather_rows_banded_plain(v, src)),
            "library_ms": time_ms(lambda: torch.index_select(v, 0, src64)),
            "src_rows_read": rows_read,
            "bound": _bound(e * 4 + e * f * 2 + rows_read * f * 2, 0),
        }
    emit("k3_by_ids", {k: dict(d, bound=list(d["bound"])) for k, d in k3.items()})

    k4 = {}
    x = torch.randn((N_MAIN, f), generator=gen, device=dev).bfloat16()
    for win, b in (("clustered", gat_batches[0]), ("uniform", batches[0])):
        k4[win] = numbers_k4(b, x, gen, dev)
        emit(f"k4_{win}", {k: (list(v) if k == "bound" else v) for k, v in k4[win].items()})
    c = k4["clustered"]
    return {"k3": k3, "k4": (c["ms"], c["plain_ms"], c["bound"], c["library_ms"])}


def k4_window_stats(b, tile: int) -> dict:
    """What sets K4's work on a window: its tiles, the dst blocks that hold
    edges, and how often a src row recurs within a 128-row dst block and
    within a tile (what staging could save)."""
    n = b.n_edges
    dst = b.edge_dst[:n].astype(np.int64)
    src = b.edge_src[:n].astype(np.int64)
    block = dst // 128
    tile_of = np.arange(n) // tile
    return {
        "tiles": -(-b.e_pad // tile),
        "live_tiles": -(-n // tile),
        "busy_blocks": int(np.unique(block).size),
        "edges_per_distinct_src_per_block": n / np.unique(block * (1 << 32) + src).size,
        "edges_per_distinct_src_per_tile": n / np.unique(tile_of * (1 << 32) + src).size,
    }


def device_ms(fn, reps: int = 7) -> float:
    """Device time of one call without the host's: the stream is held by a
    sleep kernel while the call is enqueued, so the CUDA events bracket its
    kernels only. Median over ``reps``."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cupti_us(fn, names, calls: int = 10) -> dict:
    """Device time per call of each named kernel (torch.profiler, CUPTI)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            for name in names:
                if name in evt.key:
                    out[name] += evt.self_device_time_total / calls
    return out


K4_KERNELS = ("block_starts_kernel", "gather_scatter_tile_kernel", "gather_scatter_carry_kernel")


def k4_timeline(call, n_tiles: int) -> dict:
    """One call through the kernels' timeline build: per tile, the time to
    get its ids into shared memory, to walk, and to combine and finish
    (including its share of the empty blocks), in µs, and when the tiles
    start and end relative to the first."""
    from alaz_tpu_torch.ops import _build

    lib = _build.timeline_library()
    saved = _build._LIB
    _build._LIB = lib
    try:
        call()
        torch.cuda.synchronize()
    finally:
        _build._LIB = saved
    stamps = np.zeros(4096 * 5, dtype=np.uint64)
    require(lib.alaz_k4_timeline(stamps.ctypes.data) == 0, "K4 timeline copy failed")
    t = stamps.reshape(-1, 5)[: min(n_tiles, 4096)].astype(np.int64)
    t0 = t[:, 0].min()
    us = lambda a: float(a.mean()) / 1e3
    quantiles = lambda a: [float(q) / 1e3 for q in np.quantile(a - t0, [0, 0.5, 0.9, 1])]
    return {
        "tiles": len(t),
        "span_us": float(t[:, 3].max() - t0) / 1e3,
        "tile_us": us(t[:, 3] - t[:, 0]),
        "load_us": us(t[:, 1] - t[:, 0]),
        "walk_us": us(t[:, 2] - t[:, 1]),
        "combine_us": us(t[:, 3] - t[:, 2]),
        "start_us_quantiles": quantiles(t[:, 0]),
        "end_us_quantiles": quantiles(t[:, 3]),
        "most_tiles_on_one_sm": int(np.bincount(t[:, 4]).max()),
    }


def numbers_k4(b, x, gen, dev) -> dict:
    """K4 on one window's edges (bf16, F=128, weighted, COO): back-to-back
    CUDA-event time, device time of one call, CUPTI time of its three
    kernels, its phase timeline, its time with every edge on one src row,
    its bound, the plain version, ``torch.sparse.mm`` over a CSR of the same
    edges, and ``torch.searchsorted`` for the row starts its kernel finds."""
    from alaz_tpu_torch.ops import segment_kernels as K

    f = x.shape[1]
    src = torch.as_tensor(b.edge_src, device=dev)
    dst = torch.as_tensor(b.edge_dst, device=dev)
    e = dst.shape[0]
    w = (torch.rand(e, generator=gen, device=dev) + 0.5).bfloat16()

    def call():
        return K.pallas_gather_scatter_sum(x, src, dst, N_MAIN, w)

    rows_read = int(torch.unique(src).numel())
    k4_bytes = 2 * e * 4 + e * 2 + rows_read * f * 2 + N_MAIN * f * 2 + (N_MAIN // 128 + 1) * 4
    out = dict(k4_window_stats(b, K.gather_scatter_tile_edges()), src_rows_read=rows_read)
    out["ms"] = time_ms(call)
    out["device_ms"] = device_ms(call)
    cupti = cupti_us(call, K4_KERNELS)
    out["cupti_us"] = cupti
    out["cupti_ms_total"] = sum(cupti.values()) / 1e3
    out["plain_ms"] = time_ms(lambda: K.pallas_gather_scatter_sum_plain(x, src, dst, N_MAIN, w), iters=10)
    # what the kernel's one-pass row starts replace: the COO layout's search
    bounds = torch.arange(0, N_MAIN + 1, 128, dtype=torch.int32, device=dev)
    out["searchsorted_row_starts_ms"] = time_ms(
        lambda: torch.searchsorted(dst, bounds, out_int32=True)
    )
    out["bound"] = _bound(k4_bytes, 2 * e * f)
    # library call: one CSR product out = A @ x, A[d, s] = Σ w over the
    # edges s→d, built once outside the timing (crow: each row's start in
    # the dst-sorted edges, col: src, values: w)
    crow = torch.searchsorted(
        dst, torch.arange(N_MAIN + 1, dtype=torch.int32, device=dev), out_int32=True
    ).long()
    try:
        csr = torch.sparse_csr_tensor(crow, src.long(), w, size=(N_MAIN, N_MAIN))
        out["library_ms"] = time_ms(lambda: torch.sparse.mm(csr, x))
        out["library"] = "torch.sparse.mm(csr[N, N] bf16, x[N, 128])"
    except RuntimeError as exc:
        csr = torch.sparse_csr_tensor(crow, src.long(), w.float(), size=(N_MAIN, N_MAIN))
        x32 = x.float()
        out["library_ms"] = time_ms(lambda: torch.sparse.mm(csr, x32))
        out["library"] = f"torch.sparse.mm in f32 (bf16 refused: {str(exc).splitlines()[0][:120]})"
    # every edge reading one row: the time without the L2 row reads
    same_row = torch.zeros_like(src)
    out["same_src_row_device_ms"] = device_ms(
        lambda: K.pallas_gather_scatter_sum(x, same_row, dst, N_MAIN, w)
    )
    out["timeline"] = k4_timeline(call, out["live_tiles"])
    return out


def numbers_backward(batches, gat_batches, dev) -> dict:
    """Each kernel in its backward use, at the training paths' shapes (bf16,
    F=128, COO), CUDA events: its time, bound and library call.

    - K2 as K1's backward: ``g[dst]`` of a bf16 ``[N, 128]`` cotangent;
      library ``index_select``.
    - K1 as K2's backward: the sorted sum of a bf16 ``[E, 128]`` cotangent;
      library ``index_add_`` (bf16).
    - K4 as K3's backward (``unsorted_segment_sum``, over the clustered
      window's src ids): the whole pass (the ids' stable sort, the gather
      of the sorted ids, K4, the cast) and K4 alone; library ``index_add_``
      of the f32 cotangent (pre-cast).
    - K4 as K4's ``dx`` (f32 ``g``, f32 weights, src and dst swapped): the
      whole pass (sort, gathers, K4, cast) and K4 alone; library
      ``index_add_`` in f32 of the products ``w·g[dst]`` (pre-formed: it
      does less than the function).
    """
    from alaz_tpu_torch.ops import segment_kernels as K

    gen = torch.Generator(device=dev).manual_seed(5)
    f = F_MAIN
    dst = torch.as_tensor(batches[0].edge_dst, device=dev)
    e = dst.shape[0]
    dst64 = dst.long()
    rows_dst = int(torch.unique(dst).numel())
    out = {}

    g_nodes = torch.randn((N_MAIN, f), generator=gen, device=dev).bfloat16()
    out["k1_bwd"] = {  # K2's kernel
        "ms": time_ms(lambda: K._run_k2(g_nodes, dst, N_MAIN)),
        "library_ms": time_ms(lambda: torch.index_select(g_nodes, 0, dst64)),
        "bound": _bound(e * 4 + e * f * 2 + rows_dst * f * 2, 0),
    }
    g_edges = torch.randn((e, f), generator=gen, device=dev).bfloat16()
    acc = torch.zeros((N_MAIN, f), dtype=torch.bfloat16, device=dev)
    out["k2_bwd"] = {  # K1's kernel
        "ms": time_ms(lambda: K._run_k1(g_edges, dst, N_MAIN, torch.bfloat16)),
        "library_ms": time_ms(lambda: acc.index_add_(0, dst, g_edges)),
        "bound": _bound(e * (f * 2 + 4) + N_MAIN * f * 2 + (N_MAIN // 128 + 1) * 4, e * f),
    }

    src = torch.as_tensor(gat_batches[0].edge_src, device=dev)
    perm = torch.argsort(src, stable=True).to(torch.int32)
    sorted_src = src[perm]
    g32 = g_edges.float()
    acc32 = torch.zeros((N_MAIN, f), dtype=torch.float32, device=dev)
    out["k3_bwd"] = {  # K4's kernel over the sorted ids, unweighted
        "ms": time_ms(lambda: K.unsorted_segment_sum(g_edges, src, N_MAIN)),
        "k4_only_ms": time_ms(lambda: K._run_k4(g_edges, perm, sorted_src, N_MAIN)),
        "argsort_ms": time_ms(lambda: torch.argsort(src, stable=True)),
        "library_ms": time_ms(lambda: acc32.index_add_(0, src, g32), iters=20),
        "bound": _bound(e * 4 + e * f * 2 + N_MAIN * f * 2, e * f),
    }
    del g32, acc32

    gdst = torch.as_tensor(gat_batches[0].edge_dst, device=dev)
    w = torch.rand(e, generator=gen, device=dev) + 0.5
    gn32 = torch.randn((N_MAIN, f), generator=gen, device=dev)
    perm_s = torch.argsort(src, stable=True).to(torch.int32)
    dst_by_src, src_sorted, w_sorted = gdst[perm_s], src[perm_s], w[perm_s]

    def dx_pass():
        p = torch.argsort(src, stable=True).to(torch.int32)
        return K._run_k4(gn32, gdst[p], src[p], N_MAIN, w[p]).bfloat16()

    prods = gn32[gdst.long()] * w[:, None]
    acc32 = torch.zeros((N_MAIN, f), dtype=torch.float32, device=dev)
    rows_gdst = int(torch.unique(gdst).numel())
    out["k4_bwd_dx"] = {  # K4's kernel, roles swapped, f32
        "ms": time_ms(dx_pass),
        "k4_only_ms": time_ms(lambda: K._run_k4(gn32, dst_by_src, src_sorted, N_MAIN, w_sorted)),
        "library_ms": time_ms(lambda: acc32.index_add_(0, src, prods), iters=20),
        "bound": _bound(3 * e * 4 + rows_gdst * f * 4 + N_MAIN * f * 2, 2 * e * f),
    }
    emit("backward_kernels", {k: dict(v, bound=list(v["bound"])) for k, v in out.items()})
    return out


def numbers_window(tag: str, scorer, batches, apply, other_cfg=None) -> dict:
    """One model's window, end to end and by part (steady state: library
    built, buffers warm): score time, transfer, and the forward with the
    graph already on the device (also under ``other_cfg`` if given)."""
    from alaz_tpu_torch.convert import graph_to_torch

    dev = torch.device("cuda")
    cfg = scorer.cfg
    steady = []
    for i in range(6):
        b = batches[i % len(batches)]
        t0 = time.perf_counter()
        scorer.score(b)
        steady.append(time.perf_counter() - t0)
    arrays = batches[0].device_arrays(cfg.edge_layout)
    transfer = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph = graph_to_torch(arrays, dev)
        torch.cuda.synchronize()
        transfer.append(time.perf_counter() - t0)

    def forward_ms(c) -> float:
        def forward():
            with torch.inference_mode():
                apply(scorer.params, graph, c)

        return time_ms(forward, iters=10, warmup=2)

    score_s = statistics.median(steady)
    out = {
        "score_s_median": score_s,
        "score_s": steady,
        "edges_per_s": batches[0].n_edges / score_s,
        "transfer_s_median": statistics.median(transfer),
        "forward_ms": forward_ms(cfg),
    }
    if other_cfg is not None:
        out[f"forward_ms_src_gather_{other_cfg.src_gather}"] = forward_ms(other_cfg)
    emit(tag, out)
    return out


def _as_backward(serves: str, n: dict, err: float) -> dict:
    return {
        "serves": serves, "ms": n["ms"], "bound_ms": n["bound"][0], "bound_by": n["bound"][1],
        "library_ms": n["library_ms"], "max_abs_err": err,
        **{k: n[k] for k in ("k4_only_ms", "argsort_ms") if k in n},
    }


def phase_numbers(launches: dict, errs: dict, bwd_errs: dict, train_launches: dict, scorers: dict,
                  batches, gat_batches) -> list:
    """Times and bounds of the four kernels, forward and in their backward
    uses, and of every model's window; returns the kernels' entries."""
    from alaz_tpu_torch.models import experts, gat, graphsage, tgn

    dev = torch.device("cuda")
    k12 = numbers_k1_k2(batches, dev)
    k34 = numbers_k3_k4(batches, gat_batches, dev)
    bwd = numbers_backward(batches, gat_batches, dev)
    sage = numbers_window("window", scorers["graphsage"], batches, graphsage.apply)
    sage["kernels_ms_per_forward"] = 2 * k12["k1"][0] + k12["k2"][0]
    gat_win = numbers_window(
        "gat_window", scorers["gat"], gat_batches, gat.apply,
        dataclasses.replace(scorers["gat"].cfg, src_gather="xla"),
    )
    numbers_window("experts_window", scorers["experts"], batches, experts.apply)
    numbers_window("tgn_window", scorers["tgn"], batches, tgn.apply)
    k3c = k34["k3"]["clustered"]
    emit("kernels_ms_per_forward", {
        "graphsage": sage["kernels_ms_per_forward"],
        "gat_k3_only": 3 * k3c["ms"],
        "gat_forward_ms": gat_win["forward_ms"],
    })
    names = tuple(_counts(0, 0, 0, 0))
    total = {k: sum(p[k] for p in launches.values()) for k in names}
    emit("launches_by_path", launches)
    per_step = {k: {m: c[k] for m, c in train_launches.items()} for k in names}
    entries = [
        _kernel_entry("scatter_sum_sorted", K1_REPLACES, total["scatter_sum_sorted"],
                      errs["k1_bf16_coo"], *k12["k1"]),
        _kernel_entry("segment_expand_sorted", K2_REPLACES, total["segment_expand_sorted"],
                      errs["k2_bf16"], *k12["k2"]),
        _kernel_entry("gather_rows_banded", K3_REPLACES, total["gather_rows_banded"],
                      errs["k3_bf16_clustered"], k3c["ms"], k3c["plain_ms"], k3c["bound"],
                      k3c["library_ms"]),
        _kernel_entry("pallas_gather_scatter_sum", K4_REPLACES, total["pallas_gather_scatter_sum"],
                      errs["k4_bf16_w"], *k34["k4"]),
    ]
    entries[0]["backward"] = [_as_backward(
        "segment_expand_sorted's backward: dv[d] = sum over dst[e]=d of g[e]", bwd["k2_bwd"],
        bwd_errs["k2_bwd"])]
    entries[1]["backward"] = [_as_backward(
        "scatter_sum_sorted's backward: g[dst] in the messages' dtype", bwd["k1_bwd"],
        bwd_errs["k1_bwd"])]
    entries[2]["backward"] = []
    entries[3]["backward"] = [
        _as_backward("gather_rows_banded's backward: dv[i] = sum over ids[e]=i of g[e], over the ids' stable sort",
                     bwd["k3_bwd"], bwd_errs["k3_bwd_clustered"]),
        _as_backward("pallas_gather_scatter_sum's dx: sum over src[e]=s of w[e]*g[dst[e]], f32",
                     bwd["k4_bwd_dx"], bwd_errs["k4_bwd_dx"]),
    ]
    for entry in entries:
        entry["launches_per_train_step"] = per_step[entry["name"]]
    return entries


def phase_profile(tag: str, scorer, batch, windows: int = 2) -> dict:
    """Device time by kernel over whole ``WindowScorer.score`` calls
    (torch.profiler, CUPTI): host-to-device copies, the torch kernels, the
    hand-written kernels and the copy back, and the device's idle share of
    the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    scorer.score(batch)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(windows):
            scorer.score(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [
        (evt.key, evt.self_device_time_total / 1e3 / windows, evt.count / windows)
        for evt in prof.key_averages()
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0
    ]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows) * windows
    out = {
        "windows": windows,
        "wall_ms_per_window": wall_ms / windows,
        "device_busy_ms_per_window": busy_ms / windows if rows else None,
        "device_idle_share": 1.0 - busy_ms / wall_ms if rows else None,
        "top_ms_per_window": [[name[:90], ms, n] for name, ms, n in rows[:15]],
    }
    emit(tag, out)
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    from alaz_tpu_torch.config import ModelConfig
    from alaz_tpu_torch.replay.synth import example_batch

    # f32 matmuls in full f32 (no TF32) for every comparison below
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: off (torch.backends.cuda.matmul.allow_tf32 = False, cudnn.allow_tf32 = False)")

    phase_build()
    seeds = range(3)
    t0 = time.perf_counter()
    batches = [example_batch(**WINDOW, seed=s) for s in seeds]
    synth_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gat_batches = [example_batch(**GAT_WINDOW, seed=s) for s in seeds]
    emit("windows", {"bucket": batches[0].bucket_key, "synth_s": synth_s,
                     "gat_synth_s_with_renumber": time.perf_counter() - t0})
    for b in batches + gat_batches:
        require(b.bucket_key == f"n{N_MAIN}xe{E_MAIN}", f"bucket {b.bucket_key}")
    phase_layout(gat_batches, seeds)

    dev = torch.device("cuda")
    errs = phase_kernels(batches[0], gat_batches[0], dev)
    bwd_errs = phase_backward(batches[0], gat_batches[0], dev)
    sl, scorer = phase_slice(batches)
    gsl, gat_scorer = phase_gat_slice(gat_batches)
    esl, experts_scorer = phase_experts_slice(batches)
    tsl, tgn_scorer = phase_tgn_slice(batches)
    op = phase_op_path(gat_batches)
    trains = {
        "graphsage": phase_train("train_graphsage", ModelConfig(), batches[0]),
        "gat": phase_train("train_gat", ModelConfig(model="gat", src_gather="banded"), gat_batches[0]),
        "experts": phase_train("train_experts", ModelConfig(model="experts"), batches[0]),
    }
    tgn_train = phase_train_tgn(batches)
    launches = {
        "graphsage": sl["launches"], "gat": gsl["launches"], "experts": esl["launches"],
        "tgn": tsl["launches"], "gather_scatter_sum": op["launches"],
        **{f"train_{m}": t["launches_forward_backward"] for m, t in trains.items()},
        "train_tgn_unrolled": tgn_train["launches"],
    }
    train_launches = {m: t["launches_forward_backward"] for m, t in trains.items()}
    train_launches["tgn_unrolled_3_windows"] = tgn_train["launches"]
    scorers = {"graphsage": scorer, "gat": gat_scorer, "experts": experts_scorer, "tgn": tgn_scorer}
    kernels = phase_numbers(launches, errs, bwd_errs, train_launches, scorers, batches, gat_batches)
    phase_profile("profile", scorer, batches[0])
    phase_profile("gat_profile", gat_scorer, gat_batches[0])
    phase_profile("experts_profile", experts_scorer, batches[0])
    phase_profile("tgn_profile", tgn_scorer, batches[0])

    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
