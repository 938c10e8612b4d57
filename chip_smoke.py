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
   serve     -- the streaming ``Service`` on the card over each test
                config's replayed traffic, testDuration cut to 3.1 s
                (hidden 128, 2 layers, bf16, kernels on, window 1 s):
                GraphSAGE on config5 (100,000 pods, 40,000 edges at 25
                req/s), GAT banded, renumbered and blocked, and the
                experts on config3, TGN on config4; traffic in flat out
                through the ingestion surface (nothing shed), every closed
                window scored, no worker exception, the kernels' launches
                per dispatch; each run's windows scored again under the
                plain versions; GraphSAGE's windows, three times over, as a backlog at
                ``score_batch_windows=4`` (the group path) against its
                serial scores; close → score latency, edges/s, arenas,
                peak memory, and the same windows through
                ``WindowScorer``;
   serve native -- the same Service through native ingest: the C++ ingest
                core built with g++ from ``alaz_tpu_torch/native/
                ingest.cc`` into ``build/alaz_tpu_torch/`` (its source
                hash checked), GraphSAGE on config5 with the C++ L7 engine
                (``ENGINE_BACKEND=native``) and window accumulator
                (``use_native_ingest=True``), the same replay through the
                thread-sharded ingest (4 workers, each joining in C++,
                grouping in C++), GAT banded, renumbered and blocked on
                config3 through the C++ accumulator; the serve phase's
                checks, and beside each run the serve phase's Python-engine
                run of the same config: events/s, close → score, scorer
                busy time a window and duty cycle, drops by cause, peak
                memory; GraphSAGE's windows scored again with nothing
                ingesting (the scorer's busy time without ingest load);
   train cli -- ``python -m alaz_tpu_torch train --model m`` in this
                process for each family on the CLI's default replay config
                (full width, ``ModelConfig.from_env()``; GAT with
                ``SRC_GATHER=banded``): exit 0 (AUROC >= 0.9), K1/K2
                launched for every family and K3/K4 for GAT, step time
                and peak memory; the same run on the plain versions (same
                windows, same seed): the same exit code, every step's
                loss and every eval logit within 2^-4 of the largest, and
                the first update's gradients held as in ``train``;
                GraphSAGE's run writes ``--ckpt``;
   serve cli -- ``python -m alaz_tpu_torch serve --flat-out --ckpt`` over
                config4's traffic, serving that checkpoint;
   config3   -- ``train`` of GraphSAGE on config3's traffic (3 windows, 10
                epochs, bucket n6144xe6144): the JAX package's exit code,
                the scenario's rows/s and the train time; held against
                the plain versions as the train cli phase is;
   scenarios -- ``python -m alaz_tpu_torch.replay --seeds 0``: the five
                incident scenarios, host legs over the thread-sharded
                pipeline, detection legs on the card through the plain
                PyTorch path (the suite's config sets ``use_pallas=False``,
                as the JAX package's does: no kernel launches), no
                finding;
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

Not a phase: ``eval_matrix()`` runs ``python -m alaz_tpu_torch eval`` with
its defaults on the card, timed per call, as a chip call of its own:

    python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.eval_matrix())"

Output: JSON lines for each phase, then the kernels' JSON line, the
card's name and power limit, and last the result line
``{"ok": true, "device": {...}}``. Without a CUDA device it exits
nonzero and prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

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


# -- the serving phase --------------------------------------------------------

# testDuration cut: four one-second windows a run, the last a tenth full
# (every edge still live in it); the copied Python aggregator takes
# ~11,000 (config5) to ~67,000 (config4) events/s on the card's host
SERVE_DURATION_S = 3.1
SERVE_RUNS = (
    # family, replay config, ModelConfig and RuntimeConfig settings
    ("graphsage", "testconfig/config5_fleet_100k.json", {}, {}),
    ("gat", "testconfig/config3_10k_mixed.json",
     {"model": "gat", "src_gather": "banded", "edge_layout": "blocked"},
     {"renumber_nodes": True, "edge_layout": "blocked"}),
    ("experts", "testconfig/config3_10k_mixed.json", {"model": "experts"}, {}),
    ("tgn", "testconfig/config4_temporal.json", {"model": "tgn"}, {}),
)
# K1, K2 and K3 launches of one score dispatch: a window, or a group as one
SERVE_LAUNCHES = {"graphsage": (2, 1, 0), "gat": (2, 3, 3), "experts": (2, 1, 0), "tgn": (2, 1, 0)}


def _replay_config(path: str, duration_s: float = SERVE_DURATION_S):
    """The replay config with its testDuration cut to ``duration_s`` and
    nothing else changed. Returns (SimulationConfig, the file's duration)."""
    from alaz_tpu_torch.config import SimulationConfig

    with open(path) as f:
        raw = json.load(f)
    return SimulationConfig.from_json(dict(raw, testDuration=duration_s)), raw["testDuration"]


def _submit(submit, queue, batch, rows: int) -> None:
    """Hand ``batch`` to the service's ``submit`` once ``queue`` has room
    for its rows: flat out, as fast as the service takes traffic, and
    nothing shed at the queue's mouth."""
    while queue.pending_events + rows > queue.capacity:
        time.sleep(0.001)
    require(submit(batch), f"{queue.name}: rows shed at the mouth")


def _replay(svc, sim) -> tuple:
    """The replay source's traffic through the service's ingestion
    surface, in a live node's order: the K8s metadata and the TCP
    establishes first (drained, so every connection is joined), then the
    L7 traffic flat out. Returns (events, seconds from the first L7 batch
    until every closed window was scored)."""
    for m in sim.setup():
        _submit(svc.submit_k8s, svc.k8s_queue, m, 1)
    tcp = sim.tcp_events()
    _submit(svc.submit_tcp, svc.tcp_queue, tcp, tcp.shape[0])
    svc.drain(300)
    events, t0 = 0, time.perf_counter()
    for batch in sim.iter_l7_batches():
        _submit(svc.submit_l7, svc.l7_queue, batch, batch.shape[0])
        events += batch.shape[0]
    svc.drain(600)
    svc.flush_windows()
    svc.drain(600)
    return events, time.perf_counter() - t0


def _serve_once(cfg, params, sim_cfg=None, backlog=None, device: str = "cuda",
                use_native_ingest: bool = False) -> dict:
    """One run of the streaming Service on the card: replayed traffic
    through ingest → aggregator → window close → scorer (``sim_cfg``,
    flat out), or the closed windows of an earlier run handed to the
    window close callback before the workers start, so the scorer finds
    them as a backlog (``backlog``). Launch counts and peak memory are
    read around exactly this run; a worker thread that raises fails the
    phase. ``use_native_ingest`` closes windows in the C++ window
    accumulator."""
    from alaz_tpu_torch.events.intern import Interner
    from alaz_tpu_torch.ops import segment_kernels as K
    from alaz_tpu_torch.replay.simulator import Simulator
    from alaz_tpu_torch.runtime.service import Service

    interner = Interner()
    sunk, windows, latency = [], [], []
    svc = Service(config=cfg, interner=interner, score_sink=sunk.append,
                  model_state=params, score_threshold=0.0, device=device,
                  use_native_ingest=use_native_ingest)
    on_card = svc.torch_device.type == "cuda"
    svc.score_observer = lambda batch, tenant, lat: (windows.append(batch), latency.append(lat))
    raised, hook = [], threading.excepthook
    threading.excepthook = raised.append
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    events = 0
    t0 = time.perf_counter()
    try:
        if backlog is not None:
            for b in backlog:
                svc.graph_store.on_batch(b)
        svc.start()
        if sim_cfg is not None:
            events, wall = _replay(svc, Simulator(sim_cfg, interner=interner))
        else:
            svc.drain(300)
            wall = time.perf_counter() - t0
    finally:
        svc.stop()
        threading.excepthook = hook
    if on_card:
        torch.cuda.synchronize()
    launches = K.launch_counts()
    require(raised == [], f"a worker thread raised: {[(a.thread.name, repr(a.exc_value)) for a in raised]}")
    closed = svc.metrics.counter("windows.closed").value
    require(svc.scored_batches == closed == len(sunk) == len(windows),
            f"scored {svc.scored_batches} of {closed} closed windows, {len(sunk)} sunk")
    for b, sb in zip(windows, sunk):
        s = sb.score
        require(sb.window_start_ms == b.window_start_ms and s.shape == (b.n_edges,)
                and bool(np.isfinite(s).all()) and bool(((s >= 0) & (s <= 1)).all()),
                f"window {b.window_start_ms}: scores not finite in [0, 1]")
    snap = svc.metrics.snapshot()
    lat = np.array(latency)
    return {
        "svc": svc, "windows": windows, "scores": {sb.window_start_ms: sb.score for sb in sunk},
        "summary": {
            "windows_closed": closed,
            "windows_scored": svc.scored_batches,
            "score_dispatches": svc.score_dispatches,
            "buckets": sorted({b.bucket_key for b in windows}),
            "edges_per_window": [b.n_edges for b in windows],
            "events": events,
            "wall_s": wall,
            "events_per_s": events / wall,
            "ledger": svc.ledger.snapshot(),
            "close_to_score_s": {"p50": float(np.percentile(lat, 50)), "p99": float(np.percentile(lat, 99)),
                                 "max": float(lat.max())},
            "latency_histograms": {k: v for k, v in snap.items() if k.startswith("latency.")
                                   and k.endswith((".p50", ".p99")) and ".n" not in k},
            "edges_scored": svc.scored_edges,
            "edges_per_s_wall": svc.scored_edges / wall,
            "scorer_busy_s": svc._scorer_busy_s,
            "edges_per_s_scorer_busy": svc.scored_edges / max(svc._scorer_busy_s, 1e-9),
            "scorer_duty_cycle_pct": 100.0 * svc._scorer_busy_s / wall,
            "group_arenas": {"fills": svc._stage_arenas.fills, "reuses": svc._stage_arenas.reuses,
                             "pinned": svc._stage_arenas.pin},
            "serial_arenas": {"fills": svc._serial_arenas.fills, "reuses": svc._serial_arenas.reuses,
                              "pinned": svc._serial_arenas.pin},
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated() if on_card else None,
            "launches": launches,
        },
    }


def _require_launches(family: str, run: dict) -> None:
    if not run["svc"].torch_device.type == "cuda":
        return
    k1, k2, k3 = SERVE_LAUNCHES[family]
    d = run["summary"]["score_dispatches"]
    require(run["summary"]["launches"] == _counts(k1 * d, k2 * d, k3 * d, 0),
            f"serve {family}: launches {run['summary']['launches']} for {d} dispatches, "
            f"expected K1 {k1}, K2 {k2}, K3 {k3} a dispatch")


def _scores_agree(tag: str, got: dict, ref: dict) -> dict:
    """Per-window scores of two runs over the same windows, at a quarter of
    four bf16 ulps of the largest logit (2^-8 of it: sigmoid's slope is
    at most 1/4), the bound the slice phases hold logits to."""
    require(set(got) == set(ref), f"{tag}: the runs scored different windows")
    worst = {"max_abs_err": 0.0, "bound": float("inf")}
    for k, r in ref.items():
        err, bound = float(np.abs(got[k] - r).max()), 0.25 * 2.0**-6 * _logit_scale(r)
        require(err <= bound, f"{tag}: window {k} differs by {err} > {bound}")
        if err - bound > worst["max_abs_err"] - worst["bound"]:
            worst = {"max_abs_err": err, "bound": bound}
    return worst


def _window_scorer_times(cfg, params, windows, device: str = "cuda") -> dict:
    """The same windows through ``WindowScorer`` (pageable copy, serial),
    in order (TGN threads its memory), for comparison with the Service."""
    from alaz_tpu_torch.runtime.scorer import WindowScorer

    scorer = WindowScorer(cfg, params, device=device)
    times = []
    for b in windows:
        t0 = time.perf_counter()
        scorer.score(b)
        times.append(time.perf_counter() - t0)
    edges = sum(b.n_edges for b in windows[1:]) or 1
    return {"score_s": times, "score_s_median_after_first": statistics.median(times[1:]),
            "edges_per_s_after_first": edges / sum(times[1:])}


def phase_serve(device: str = "cuda", runs=SERVE_RUNS) -> dict:
    """The streaming Service on the card at the JAX package's widths
    (hidden 128, 2 layers, bf16, kernels on, params from seed 0),
    ``window_s`` 1.0, flat-out replay of each run's test config with its
    testDuration cut to SERVE_DURATION_S. Each run: windows scored equal
    windows closed, no worker exception, scores finite in [0, 1], the
    kernels' launches per dispatch; then the same windows re-scored by the
    Service under the plain versions, scores held together. GraphSAGE
    also scores the windows of its replay, three times over, as a backlog
    at ``score_batch_windows=4`` (the group path) against its serial
    scores.
    Returns the launch counts of each run and each run's entry."""
    from alaz_tpu_torch.config import ModelConfig, RuntimeConfig
    from alaz_tpu_torch.graph.snapshot import pad_to_bucket
    from alaz_tpu_torch.models.registry import init_params

    launches, out = {}, {}
    for family, path, model_kw, runtime_kw in runs:
        sim_cfg, full_s = _replay_config(path)
        if family == "tgn":  # the memory presized to the largest bucket this fleet can reach
            model_kw = dict(model_kw, tgn_max_nodes=pad_to_bucket(sim_cfg.pod_count + sim_cfg.service_count))
        mcfg = ModelConfig(**model_kw)
        require((mcfg.hidden_dim, mcfg.num_layers, mcfg.dtype, mcfg.use_pallas) == (128, 2, "bfloat16", True),
                f"unexpected ModelConfig {mcfg}")
        cfg = RuntimeConfig(model=mcfg, window_s=1.0, score_batch_windows=1, **runtime_kw)
        params = init_params(mcfg, key=0, device=device)
        run = _serve_once(cfg, params, sim_cfg=sim_cfg, device=device)
        require(run["summary"]["windows_scored"] >= 4, f"serve {family}: fewer than 4 windows")
        _require_launches(family, run)
        launches[f"serve_{family}"] = run["summary"]["launches"]
        with plain_kernels():
            plain = _serve_once(cfg, params, backlog=run["windows"], device=device)
        entry = {
            "replay": {"config": path, "testDuration_s": [full_s, SERVE_DURATION_S],
                       "pods": sim_cfg.pod_count, "services": sim_cfg.service_count,
                       "edges": sim_cfg.edge_count, "rate_per_edge": sim_cfg.edge_rate},
            "model": {k: getattr(mcfg, k) for k in ("model", "src_gather", "edge_layout", "tgn_max_nodes")},
            "renumber_nodes": cfg.renumber_nodes,
            "serial": run["summary"],
            "vs_plain_versions": _scores_agree(f"serve {family} vs plain", run["scores"], plain["scores"]),
        }
        if family == "graphsage":
            # the windows three times over: three groups of 4, the third
            # through the first group's pinned buffer again
            backlog = run["windows"] * 3
            gcfg = dataclasses.replace(cfg, score_batch_windows=4)
            group = _serve_once(gcfg, params, backlog=backlog, device=device)
            gs = group["summary"]
            require(gs["score_dispatches"] == len(backlog) // 4, f"serve graphsage: groups {gs['score_dispatches']}")
            require(gs["group_arenas"]["reuses"] >= 1, "serve graphsage: no group arena reused")
            _require_launches(family, group)
            launches["serve_graphsage_groups"] = gs["launches"]
            with plain_kernels():
                gplain = _serve_once(gcfg, params, backlog=backlog, device=device)
            entry["group_w4_backlog"] = group["summary"]
            entry["group_vs_serial"] = _scores_agree("serve graphsage groups vs serial", group["scores"], run["scores"])
            entry["group_vs_plain_versions"] = _scores_agree("serve graphsage groups vs plain", group["scores"],
                                                             gplain["scores"])
        entry["window_scorer"] = _window_scorer_times(mcfg, params, run["windows"], device)
        out[family] = entry
        emit(f"serve_{family}", entry)
        del run, plain
    return launches, out


SERVE_NATIVE_RUNS = (
    # tag, family, replay config, testDuration cut, least windows, ModelConfig
    # and RuntimeConfig settings, whether the C++ window accumulator closes
    # the windows
    ("graphsage", "graphsage", "testconfig/config5_fleet_100k.json", SERVE_DURATION_S, 4, {},
     {"engine_backend": "native"}, True),
    # the thread-sharded ingest: four workers, each joining in C++, the
    # window close grouping in C++ through the numpy builder. It takes
    # config5's events at ~14,000/s on the card's host (no faster than one
    # Python engine), so its replay is cut to 1.1 s: one full window and a
    # tenth of one
    ("graphsage_4_workers", "graphsage", "testconfig/config5_fleet_100k.json", 1.1, 2, {},
     {"engine_backend": "native", "ingest_workers": 4}, False),
    ("gat", "gat", "testconfig/config3_10k_mixed.json", SERVE_DURATION_S, 4,
     {"model": "gat", "src_gather": "banded", "edge_layout": "blocked"},
     {"engine_backend": "native", "renumber_nodes": True, "edge_layout": "blocked"}, True),
)


def _native_build() -> dict:
    """The C++ ingest core this checkout built: the library g++ wrote
    under ``build/alaz_tpu_torch/`` from ``alaz_tpu_torch/native/
    ingest.cc``, stamped with that source's hash. The serve phase's
    grouping auto-detect built and loaded it already; one more forced
    build, over the same file, times g++ on this host."""
    import hashlib

    from alaz_tpu_torch.graph import native

    src = Path("alaz_tpu_torch/native/ingest.cc").resolve()
    want = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    require(native.available(), "libalaz_ingest did not load")
    lib = Path(native._LIB_PATH).resolve()
    require(lib.parent == Path("build/alaz_tpu_torch").resolve(), f"native library {lib} is not the checkout's build")
    got = native.loaded_source_hash()
    require(got == want, f"native library stamped {got}, ingest.cc hashes to {want}")
    t0 = time.perf_counter()
    require(native.build(force=True) == native._LIB_PATH, "a forced build wrote another library")
    return {"library": str(lib.relative_to(Path.cwd().resolve())), "source_hash": got,
            "gxx_build_s": time.perf_counter() - t0}


def _host_side(s: dict, snap: dict | None = None) -> dict:
    """What the comparison of ingest paths reads off one run's summary
    (and, where the run's service is at hand, its drop gauges)."""
    out = {
        "events_per_s": s["events_per_s"],
        "close_to_score_s": s["close_to_score_s"],
        "scorer_busy_s_per_window": s["scorer_busy_s"] / max(s["windows_scored"], 1),
        "scorer_duty_cycle_pct": s["scorer_duty_cycle_pct"],
        "ledger_reasons": s["ledger"].get("reasons", {}),
        "max_memory_allocated_bytes": s["max_memory_allocated_bytes"],
    }
    if snap is not None:
        out["drops"] = {k: snap.get(k) for k in ("l7.dropped", "windows.late_dropped", "ingest.ring_dropped",
                                                 "ingest.acc_dropped")}
    return out


def phase_serve_native(python_runs: dict, device: str = "cuda", runs=SERVE_NATIVE_RUNS) -> dict:
    """The streaming Service on the card through native ingest: the C++
    L7 engine (``ENGINE_BACKEND=native``), the C++ window accumulator
    (``use_native_ingest=True``) or the thread-sharded ingest with C++
    grouping, at phase_serve's widths and replays. The library must be
    the checkout's own build, stamped with its source's hash. Each run:
    at least its least windows closed, every closed window scored, no worker
    exception, scores finite in [0, 1], the native path in use, the
    kernels' launches per dispatch, the same windows rescored under the
    plain versions and held to them; beside it, phase_serve's run of the
    same config on the Python engine (``python_runs``), and the same
    windows through ``WindowScorer``. GraphSAGE's native windows are also
    scored again as a backlog with nothing ingesting: the scorer's busy
    time without ingest load. Returns the launch counts of each run."""
    from alaz_tpu_torch.config import ModelConfig, RuntimeConfig
    from alaz_tpu_torch.graph import builder
    from alaz_tpu_torch.graph.native import NativeWindowedStore
    from alaz_tpu_torch.models.registry import init_params

    build = _native_build()
    emit("serve_native_build", build)
    launches = {}
    for tag, family, path, duration_s, min_windows, model_kw, runtime_kw, native_store in runs:
        sim_cfg, full_s = _replay_config(path, duration_s) if isinstance(path, str) else (path, None)
        mcfg = ModelConfig(**model_kw)
        require((mcfg.hidden_dim, mcfg.num_layers, mcfg.dtype, mcfg.use_pallas) == (128, 2, "bfloat16", True),
                f"unexpected ModelConfig {mcfg}")
        cfg = RuntimeConfig(model=mcfg, window_s=1.0, score_batch_windows=1, **runtime_kw)
        params = init_params(mcfg, key=0, device=device)
        run = _serve_once(cfg, params, sim_cfg=sim_cfg, device=device, use_native_ingest=native_store)
        svc = run["svc"]
        require(run["summary"]["windows_scored"] >= min_windows,
                f"serve_native {tag}: fewer than {min_windows} windows")
        if native_store:
            require(isinstance(svc.graph_store, NativeWindowedStore) and svc.aggregator._native_l7 is not None,
                    f"serve_native {tag}: not the native store and engine")
        else:
            require(all(w._native_l7 is not None for w in svc.sharded.workers)
                    and builder._use_native_grouping(), f"serve_native {tag}: not the native engine and grouping")
        _require_launches(family, run)
        launches[f"serve_native_{tag}"] = run["summary"]["launches"]
        with plain_kernels():
            plain = _serve_once(cfg, params, backlog=run["windows"], device=device)
        entry = {
            "replay": {"config": path if isinstance(path, str) else None, "testDuration_s": [full_s, sim_cfg.test_duration_s],
                       "pods": sim_cfg.pod_count, "edges": sim_cfg.edge_count, "rate_per_edge": sim_cfg.edge_rate},
            "runtime": runtime_kw, "native_store": native_store,
            "model": {k: getattr(mcfg, k) for k in ("model", "src_gather", "edge_layout")},
            "serial": run["summary"],
            "native": _host_side(run["summary"], svc.metrics.snapshot()),
            "vs_plain_versions": _scores_agree(f"serve_native {tag} vs plain", run["scores"], plain["scores"]),
            "window_scorer": _window_scorer_times(mcfg, params, run["windows"], device),
        }
        py = python_runs.get(family)
        if py is not None:
            entry["python_engine"] = dict(_host_side(py["serial"]), window_scorer_median_s=py[
                "window_scorer"]["score_s_median_after_first"])
        if tag == "graphsage":
            idle = _serve_once(cfg, params, backlog=run["windows"], device=device)
            _require_launches(family, idle)
            launches["serve_native_graphsage_no_ingest"] = idle["summary"]["launches"]
            entry["no_ingest_backlog"] = {
                "scorer_busy_s_per_window": idle["summary"]["scorer_busy_s"] / idle["summary"]["windows_scored"],
                "vs_ingest_run": _scores_agree("serve_native graphsage backlog vs ingest run", idle["scores"],
                                               run["scores"]),
            }
            del idle
        emit(f"serve_native_{tag}", entry)
        del run, plain, svc
    return launches


SERVE_CLI_MIN_WINDOWS = 2  # the least the JAX package's serve CLI closed (below)


def phase_serve_cli(ckpt: Path) -> dict:
    """``python -m alaz_tpu_torch serve --flat-out --ckpt`` as a user runs
    it, with the default queues: the GraphSAGE checkpoint ``train --ckpt``
    wrote (train → serve, one flow on the card), config4's traffic with
    testDuration cut, the CLI's summary line read back (events lost to
    the queues' mouths included)."""
    work = Path("build/chip_smoke")
    work.mkdir(parents=True, exist_ok=True)
    with open("testconfig/config4_temporal.json") as f:
        raw = json.load(f)
    traffic = work / "config4_cut.json"
    traffic.write_text(json.dumps(dict(raw, testDuration=SERVE_DURATION_S)))
    env = {k: v for k, v in os.environ.items() if k not in ("MODEL", "EDGE_LAYOUT", "BACKEND_HOST")}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "alaz_tpu_torch", "serve", "--config", str(traffic), "--flat-out",
         "--ckpt", str(ckpt), "--debug-port", "0"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    require(proc.returncode == 0, f"serve CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    # the replay source sheds what the source queues cannot hold (drop-not-
    # block, as in the JAX package), so the last windows may get no event;
    # the JAX package's serve CLI closed 2 to 4 windows of this traffic in
    # 11 runs on the CPU (tests/torch_serve_cli_compare.py): at least 2 must
    # close, and every window that closed must be scored
    require(summary["windows_scored"] == summary["windows_closed"] >= SERVE_CLI_MIN_WINDOWS
            and summary["edges_scored"] > 0, f"serve CLI: {summary}")
    out = dict(summary, command_s=time.perf_counter() - t0)
    emit("serve_cli", out)
    return out


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


def _grads_by(params, loss_fn) -> tuple:
    """``loss_fn()`` and every param's gradient of it."""
    from alaz_tpu_torch.train.trainstep import backward

    for p in params.parameters():
        p.grad = None
    loss = loss_fn()
    backward(params, loss)
    return float(loss.detach()), {k: p.grad.clone() for k, p in params.named_parameters()}


def _grads(cfg, params, graph, label) -> tuple:
    from alaz_tpu_torch.train.trainstep import make_loss_fn

    return _grads_by(params, lambda: make_loss_fn(cfg)(params, graph, label))


def _rel_err(got, ref) -> float:
    """Largest |got - ref| over the largest |ref|."""
    got, ref = torch.as_tensor(got, dtype=torch.float64), torch.as_tensor(ref, dtype=torch.float64)
    return float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


def _hold_grads(tag: str, grads_k: dict, grads_p: dict) -> float:
    """Every param's gradient with the kernels finite and within 2^-4 of
    that param's largest gradient on the plain versions (the two sum in
    another order, so a bf16 activation may round an ulp apart and carry
    that through the backward); returns the worst such share."""
    worst = 0.0
    for k, ref in grads_p.items():
        got = grads_k[k]
        require(bool(torch.isfinite(got).all()), f"{tag}: gradient of {k} not finite")
        rel = _rel_err(got, ref)
        require(rel <= 2.0**-4, f"{tag}: gradient of {k} differs from the plain versions' by {rel} of its max")
        worst = max(worst, rel)
    return worst


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
    versions on the card, every gradient held by ``_hold_grads``; then
    ``steps`` steps of ``make_train_step`` (AdamW), each loss finite and
    the last below the first, with the step's time and the peak memory
    over the steps."""
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
    worst = _hold_grads(tag, grads_k, grads_p)
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


# -- the train CLI and the incident suite --------------------------------------

TRAIN_CLI_FAMILIES = ("graphsage", "gat", "experts", "tgn")
# config3 through `train`: the window and epoch counts, and the exit code,
# are the JAX package's CLI run on the CPU with the same arguments
# (`python -m alaz_tpu train --config testconfig/config3_10k_mixed.json
# --windows 3 --epochs 10`: exit 0, AUROC 0.9998, 10 steps)
CONFIG3_TRAIN = ("testconfig/config3_10k_mixed.json", 3, 10, 0)
CONFIG3_BUCKET = "n6144xe6144"


@contextlib.contextmanager
def _train_cli_probe(dev: torch.device, replays: list | None = None):
    """Hooks the CLI's scenario, training and scoring calls. Yields a
    namespace: ``records`` gets one record per scenario or training call,
    in order (a scenario's kind, rows replayed, seconds and windows'
    buckets; a training's seconds, the card synchronized at both ends,
    steps and peak device memory); ``replays`` the scenarios' data;
    ``trains`` each training's call, arguments and every step's loss;
    ``logits`` the eval windows' edge logits over their real edges. With
    ``replays`` given (an earlier run's), each scenario call returns the
    next of those instead of replaying the traffic again."""
    from alaz_tpu_torch import __main__ as cli
    from alaz_tpu_torch.replay import scenario
    from alaz_tpu_torch.train import trainstep

    probe = SimpleNamespace(records=[], replays=[], trains=[], logits=[])
    reuse = list(replays) if replays is not None else None
    rows = [0]
    saved = {m: getattr(scenario, m) for m in ("run_anomaly_scenario", "run_forecast_scenario", "replay_delivery")}
    saved_train = {m: getattr(trainstep, m) for m in ("train_on_batches", "train_tgn_unrolled")}
    saved_score, saved_stream = trainstep.score_batch, cli._stream_tgn_eval

    def count_rows(target, d, *a, **kw):
        rows[0] += len(d)
        return saved["replay_delivery"](target, d, *a, **kw)

    def timed_scenario(name):
        def run(*a, **kw):
            if reuse is not None:
                data = reuse.pop(0)
                probe.replays.append(data)
                return data
            rows[0], t0 = 0, time.perf_counter()
            data = saved[name](*a, **kw)
            sec = time.perf_counter() - t0
            probe.records.append({"call": name, "s": sec, "rows": rows[0], "rows_per_s": rows[0] / sec,
                                  "buckets": sorted({b.bucket_key for b in data.all_batches}),
                                  "windows_train_eval": [len(data.train), len(data.eval)]})
            probe.replays.append(data)
            return data
        return run

    def timed_train(name):
        def run(*a, **kw):
            _sync(dev)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, losses = saved_train[name](*a, **kw)
            _sync(dev)
            sec = time.perf_counter() - t0
            rec = {"call": name, "s": sec, "steps": state.step, "step_ms": 1e3 * sec / state.step}
            if dev.type == "cuda":
                rec["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
            probe.records.append(rec)
            probe.trains.append(SimpleNamespace(call=name, args=a, kw=kw, losses=list(losses)))
            return state, losses
        return run

    def score_batch(cfg, params, batch, *a, **kw):
        out = saved_score(cfg, params, batch, *a, **kw)
        probe.logits.append(out["edge_logits"][np.asarray(batch.edge_mask) > 0])
        return out

    def stream_tgn_eval(*a, **kw):
        cols = saved_stream(*a, **kw)
        probe.logits.extend(s[np.asarray(m) > 0] for s, m in zip(cols[0], cols[2]))
        return cols

    scenario.replay_delivery = count_rows
    for m in ("run_anomaly_scenario", "run_forecast_scenario"):
        setattr(scenario, m, timed_scenario(m))
    for m in saved_train:
        setattr(trainstep, m, timed_train(m))
    trainstep.score_batch, cli._stream_tgn_eval = score_batch, stream_tgn_eval
    try:
        yield probe
    finally:
        for m, fn in saved.items():
            setattr(scenario, m, fn)
        for m, fn in saved_train.items():
            setattr(trainstep, m, fn)
        trainstep.score_batch, cli._stream_tgn_eval = saved_score, saved_stream


def _first_update(train, dev: torch.device) -> tuple:
    """Fresh params from a CLI training's seed and the loss of its first
    update: the first window's, or for TGN the unrolled loss over its
    sequences from fresh memory."""
    from alaz_tpu_torch.convert import graph_to_torch
    from alaz_tpu_torch.models import tgn
    from alaz_tpu_torch.models.registry import get_model
    from alaz_tpu_torch.train.trainstep import make_loss_fn, prep_sequences, unrolled_loss

    cfg, batches = train.args[:2]
    seed, pos_weight = train.kw.get("seed", 0), train.kw.get("pos_weight", 10.0)
    if train.call == "train_tgn_unrolled":
        params = tgn.init(seed, cfg, device=dev)
        prepped = prep_sequences(batches, train.kw.get("label_attr", "edge_label"), dev)
        memory0 = tgn.init_memory(cfg, max(cfg.tgn_max_nodes, prepped[0][0][0]["node_feats"].shape[0]), device=dev)
        return params, lambda: unrolled_loss(params, prepped, memory0, cfg, pos_weight)
    params = get_model(cfg.model)[0](seed, cfg, device=dev)
    b = batches[0]
    graph = graph_to_torch(b.device_arrays(cfg.edge_layout), dev)
    label = torch.as_tensor(b.edge_label, device=dev)
    return params, lambda: make_loss_fn(cfg, pos_weight)(params, graph, label)


def _run_cli(argv: list, device: str, replays: list | None = None) -> tuple:
    """``main(argv + ["--device", device])`` under the probe: exit code,
    the CLI's JSON line, the probe and the kernels' launches."""
    from alaz_tpu_torch import __main__ as cli
    from alaz_tpu_torch.ops import segment_kernels as K

    dev = torch.device(device)
    out = io.StringIO()
    with _train_cli_probe(dev, replays) as probe, contextlib.redirect_stdout(out):
        K.reset_launch_counts()
        rc = cli.main(argv + ["--device", device])
        _sync(dev)
        launches = K.launch_counts()
    return rc, json.loads(out.getvalue().strip().splitlines()[-1]), probe, launches


def _train_cli(tag: str, argv: list, env: dict, device: str = "cuda") -> dict:
    """``python -m alaz_tpu_torch train`` in this process, as a user runs it
    (``main(argv)``), with ``env`` set around it: exit code, its JSON line,
    the kernels' launches, the scenario's rows/s, the train time and the
    peak device memory. Then the same run on the plain versions, on the
    same windows from the same seed, must launch no kernel and give the
    same exit code, with every step's loss and every eval logit within
    2^-4 of the largest of the plain run's; and at the path's shapes, the
    first update's gradients with the kernels are held against the plain
    versions' (``_hold_grads``)."""
    dev = torch.device(device)
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        rc, result, probe, launches = _run_cli(argv, device)
        with plain_kernels():
            rc_p, result_p, probe_p, launches_p = _run_cli(argv, device, probe.replays)
        (train,), (train_p,) = probe.trains, probe_p.trains
        params, loss_fn = _first_update(train, dev)
        loss_k, grads_k = _grads_by(params, loss_fn)
        with plain_kernels():
            loss_p, grads_p = _grads_by(params, loss_fn)
        grad_err = _hold_grads(f"{tag} first update", grads_k, grads_p)
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    loss_err = _rel_err(train.losses, train_p.losses)
    logit_err = _rel_err(np.concatenate(probe.logits), np.concatenate(probe_p.logits))
    require(not any(launches_p.values()), f"{tag}: the plain run launched kernels {launches_p}")
    require(rc == rc_p, f"{tag}: exit {rc} with the kernels, {rc_p} on the plain versions")
    require(loss_err <= 2.0**-4, f"{tag}: step losses differ from the plain run's by {loss_err} of its max")
    require(logit_err <= 2.0**-4, f"{tag}: eval logits differ from the plain run's by {logit_err} of their max")
    (scen, rec) = probe.records
    entry = {
        "argv": argv, "env": env, "exit_code": rc, "result": result,
        "launches": launches, "scenario_rows": scen["rows"], "scenario_s": scen["s"],
        "scenario_rows_per_s": scen["rows_per_s"], "buckets": scen["buckets"],
        "windows_train_eval": scen["windows_train_eval"], **{k: v for k, v in rec.items() if k != "call"},
        "plain": {"exit_code": rc_p, "result": result_p},
        "first_update_loss_kernels_vs_plain": [float(loss_k), float(loss_p)],
        "first_update_grad_max_err_of_param_max": grad_err,
        "losses_max_err_of_max": loss_err, "eval_logits": int(sum(len(x) for x in probe.logits)),
        "eval_logits_max_err_of_max": logit_err,
    }
    entry["train_s"] = entry.pop("s")
    emit(tag, entry)
    return entry


def phase_train_cli(device: str = "cuda") -> dict:
    """``train`` for each family on the CLI's default replay config (10
    windows, 20 epochs, seed 0) at full width (``ModelConfig.from_env()``:
    hidden 128, 2 layers, bf16, kernels on; GAT with
    ``SRC_GATHER=banded``): exit 0, which is AUROC ≥ 0.9, the JAX
    package's gate (its CLI gives exit 0 for all four with the same
    arguments on the CPU); K1 and K2 launched for every family, K3 and K4
    for GAT; each run held against the plain versions by ``_train_cli``.
    GraphSAGE's run writes ``--ckpt`` for the serve CLI."""
    work = Path("build/chip_smoke")
    ckpt = work / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    env = {"MODEL": "graphsage", "SRC_GATHER": "xla", "EDGE_LAYOUT": "coo", "USE_PALLAS": "1"}
    runs = {}
    for family in TRAIN_CLI_FAMILIES:
        argv = ["train", "--model", family]
        if family == "graphsage":
            argv += ["--ckpt", str(ckpt)]
        run = _train_cli(f"train_cli_{family}", argv,
                         dict(env, MODEL=family, SRC_GATHER="banded" if family == "gat" else "xla"), device)
        require(run["exit_code"] == 0, f"train CLI {family}: exit {run['exit_code']}, {run['result']}")
        if device == "cuda":
            n = run["launches"]
            require(n["scatter_sum_sorted"] > 0 and n["segment_expand_sorted"] > 0,
                    f"train CLI {family}: K1/K2 not launched {n}")
            if family == "gat":
                require(n["gather_rows_banded"] > 0 and n["pallas_gather_scatter_sum"] > 0,
                        f"train CLI gat: K3/K4 not launched {n}")
        runs[family] = run
    require((ckpt / str(runs["graphsage"]["result"]["steps"])).is_dir(), "train CLI: no checkpoint written")
    return {"runs": runs, "ckpt": ckpt}


def phase_train_cli_config3(device: str = "cuda") -> dict:
    """``train`` of GraphSAGE on config3's traffic (10,000 pods, 5,000 edges
    at 100 req/s), 3 windows and 10 epochs: the exit code the JAX
    package's CLI gives with the same arguments, windows of bucket
    n6144xe6144; held against the plain versions by ``_train_cli``."""
    path, windows, epochs, want_rc = CONFIG3_TRAIN
    run = _train_cli("train_cli_config3", ["train", "--config", path, "--windows", str(windows), "--epochs",
                                           str(epochs)], {"MODEL": "graphsage", "SRC_GATHER": "xla",
                                                          "EDGE_LAYOUT": "coo", "USE_PALLAS": "1"}, device)
    require(run["exit_code"] == want_rc, f"train CLI config3: exit {run['exit_code']}, {run['result']}")
    require(run["buckets"] == [CONFIG3_BUCKET], f"train CLI config3: buckets {run['buckets']}")
    if device == "cuda":
        n = run["launches"]
        require(n["scatter_sum_sorted"] > 0 and n["segment_expand_sorted"] > 0, f"train CLI config3: {n}")
    return run


def phase_scenarios(device: str = "cuda") -> dict:
    """``python -m alaz_tpu_torch.replay --seeds 0`` as a user runs it: all
    five incident scenarios, host legs over the thread-sharded pipeline
    and detection legs trained and scored on ``device``; exit 0 (no
    finding), each report line printed. The detection legs run the plain
    PyTorch path, not the kernels: the suite's model config sets
    ``use_pallas=False``, as the JAX package's does, so this phase
    launches none of K1-K4 and reads no launch counts."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "alaz_tpu_torch.replay", "--seeds", "0", "--device", device],
                          capture_output=True, text=True, timeout=900)
    reports = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    for rep in reports:
        emit("scenario", rep)
    require(proc.returncode == 0, f"scenario suite exited {proc.returncode}: {proc.stderr[-2000:]}")
    require(len(reports) == 5 and all(r["scenario_findings"] == 0 and r["detection"] for r in reports),
            "scenario suite: a report is missing, has findings or no detection leg")
    out = {"scenarios": len(reports), "command_s": time.perf_counter() - t0,
           "auroc": {r["scenario"]: r["detection"]["auroc"] for r in reports}}
    emit("scenarios", out)
    return out


def eval_matrix(out: str = "build/chip_smoke/eval_card.json") -> int:
    """``python -m alaz_tpu_torch eval --out OUT`` with its defaults, in
    this process, on the card: config3, 10 windows, 30 epochs, seed 0, the
    four families and the TGN forecast leg on config4. Each scenario
    replay and each training is timed; prints them, the card and the
    CLI's exit code. Not a phase of ``main``: 10-20 minutes, almost all
    of it the scenarios' host replay. Run it as its own call:

        python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.eval_matrix())"
    """
    from alaz_tpu_torch import __main__ as cli

    require(torch.cuda.is_available(), "eval_matrix runs on the card only")
    print(card_line(), flush=True)
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with _train_cli_probe(torch.device("cuda")) as probe:
        rc = cli.main(["eval", "--out", out])
    emit("eval_calls", probe.records)
    emit("eval_wall", {"exit_code": rc, "seconds": time.perf_counter() - t0, "card": card_line()})
    return rc


def ingest_profile(config: str = "testconfig/config5_fleet_100k.json", duration_s: float = 1.1,
                   engine: str = "native", native_store: bool = True, top: int = 12) -> dict:
    """Host ingest alone under ``cProfile``: the replay config's traffic,
    its testDuration cut to ``duration_s``, through one tenant partition
    (``ENGINE_BACKEND=engine``, the C++ window accumulator if
    ``native_store``) on this thread, no model and no service threads.
    The K8s metadata and the TCP establishes go in first; the L7 batches
    and the final flush are profiled. Prints and returns one JSON object:
    events, seconds, events/s and the functions with the most own time.
    Not a phase of ``main``; host time only, on whatever host runs it:

        python3 -c "import chip_smoke; chip_smoke.ingest_profile(engine='python', native_store=False)"
    """
    import cProfile
    import pstats

    from alaz_tpu_torch.config import RuntimeConfig
    from alaz_tpu_torch.events.intern import Interner
    from alaz_tpu_torch.replay.simulator import Simulator
    from alaz_tpu_torch.runtime.tenancy import TenantPartition

    sim_cfg, _ = _replay_config(config, duration_s)
    interner, closed = Interner(), []
    part = TenantPartition(0, RuntimeConfig(engine_backend=engine), on_batch=closed.append,
                           interner=interner, use_native_ingest=native_store)
    sim = Simulator(sim_cfg, interner=interner)
    for m in sim.setup():
        part.aggregator.process_k8s(m)
    part.aggregator.process_tcp(sim.tcp_events())
    batches = list(sim.iter_l7_batches())
    events = sum(b.shape[0] for b in batches)
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    for b in batches:
        part.aggregator.process_l7(b)
    part.graph_store.flush()
    prof.disable()
    wall = time.perf_counter() - t0
    own = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: kv[1][2], reverse=True)[:top]
    out = {
        "config": config, "duration_s": duration_s, "engine": engine, "native_store": native_store,
        "events": events, "batches": len(batches), "windows": len(closed), "seconds": wall,
        "events_per_s": events / wall,
        "own_time": [{"function": f"{Path(fn).name}:{line}({name})", "s": tt, "calls": nc}
                     for (fn, line, name), (_, nc, tt, _, _) in own],
    }
    emit("ingest_profile", out)
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
    serve_launches, serve_runs = phase_serve()
    serve_launches.update(phase_serve_native(serve_runs))
    train_cli = phase_train_cli()
    phase_serve_cli(train_cli["ckpt"])
    config3 = phase_train_cli_config3()
    phase_scenarios()
    op = phase_op_path(gat_batches)
    trains = {
        "graphsage": phase_train("train_graphsage", ModelConfig(), batches[0]),
        "gat": phase_train("train_gat", ModelConfig(model="gat", src_gather="banded"), gat_batches[0]),
        "experts": phase_train("train_experts", ModelConfig(model="experts"), batches[0]),
    }
    tgn_train = phase_train_tgn(batches)
    launches = {
        "graphsage": sl["launches"], "gat": gsl["launches"], "experts": esl["launches"],
        "tgn": tsl["launches"], "gather_scatter_sum": op["launches"], **serve_launches,
        **{f"train_{m}": t["launches_forward_backward"] for m, t in trains.items()},
        "train_tgn_unrolled": tgn_train["launches"],
        **{f"train_cli_{m}": r["launches"] for m, r in train_cli["runs"].items()},
        "train_cli_config3": config3["launches"],
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
