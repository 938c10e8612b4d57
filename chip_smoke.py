#!/usr/bin/env python3
"""Drive the PyTorch port's scoring and training paths on one NVIDIA H100.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each raising on failure:

1. build     -- compile ``alaz_tpu_torch/csrc/segment.cu`` and ``gru.cu`` with nvcc into
                ``build/alaz_tpu_torch/`` and print ptxas's register,
                shared-memory and spill lines;
   gpu env   -- the NVML collector (``runtime/gpu_env.py``) registers on
                the card with its default legs under the JAX package's
                gauge names; its gauges, read between two ``nvidia-smi``
                readings, hold to them: device memory in MiB exactly,
                temperature within 3 °C, SM clock and power within the
                readings' range ±10%;
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
                counted (K1's is K2, K2's is K1, K3's and K4's dx are the
                sort kernel and K4); the sort against its plain version on
                both windows' src ids and at the train CLI's shapes (E =
                128, one tile), and K3's backward and K4's dx on both
                windows and K3's at those shapes against
                ``torch.argsort`` + K4 (what the sort replaced), each bit
                for bit;
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
                131,072 rows by the first; launch counts (the GRU kernel's
                one a window); scores and the final memory held against
                the same stream on the plain versions; the GRU kernel at
                the cell's shape against its plain version, and both
                timed beside the kernel's bound;
   prefetch  -- the uniform windows through ``WindowScorer`` and through
                ``runtime/pipeline.py DevicePrefetcher`` (page-locked
                buffers filled and copied on a side stream by a staging
                thread, one window ahead), in turns, each timed with CUDA
                events and the host clock; scores bit-equal;
   serve     -- the streaming ``Service`` on the card over each test
                config's replayed traffic, testDuration cut to 3.1 s
                (config5's to 2.1 s; hidden 128, 2 layers, bf16, kernels
                on, window 1 s):
                GraphSAGE on config5 (100,000 pods, 40,000 edges at 25
                req/s), GAT banded, renumbered and blocked, and the
                experts on config3, TGN on config4; traffic in flat out
                through the ingestion surface (nothing shed), every closed
                window scored, no worker exception, the kernels' launches
                per dispatch; each run's windows scored again under the
                plain versions; GraphSAGE's windows, repeated to
                twelve, as a backlog at ``score_batch_windows=4`` (the
                group path) against its serial scores; close → score latency, edges/s, staging sets,
                peak memory, and the same windows through
                ``WindowScorer``;
   serve native -- the same Service through native ingest: the C++ ingest
                core built with g++ from ``alaz_tpu_torch/native/
                ingest.cc`` into ``build/alaz_tpu_torch/`` (its source
                hash checked), GraphSAGE on config5 (cut to 1.1 s; config3
                to 2.1 s) with the C++ L7 engine
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
   serve process -- the same Service over the process backend
                (``INGEST_BACKEND=process``: spawned shard workers over
                shared-memory rings, each joining in C++): GraphSAGE on
                config5 at 1 and 4 workers (cut to 1.1 s), GAT banded,
                renumbered and blocked on config3 at 2 workers; /dev/shm's
                room for the rings checked first; each worker a live
                process apart from this one, the native library mapped in
                it, its log saying it joins in C++, no NVIDIA device file
                open in it;
                every window scored, launches per dispatch, scores equal
                to the plain versions' (max error 0.0), no worker killed,
                pushed = emitted + ledger exactly; events/s, close →
                score, busy time and the rings' gauges beside the serve
                and serve native runs of the same config;
   tenants   -- ``python -m alaz_tpu_torch.replay --isolation`` (the
                multi-tenant isolation gate on the host scorer): exit 0;
                three tenants' traffic into one Service on the process
                backend scored by GraphSAGE at ``score_batch_windows=8``:
                groups that mix tenants, K1 2 / K2 1 a group dispatch,
                exact books a tenant, each tenant's scores equal to its
                windows scored one at a time on the plain versions;
   serve live -- live ingest as deployed, GraphSAGE at full width on the
                card: config5's pods and services served by a fake
                Kubernetes API server and taken in through the K8s watch
                (every message, LIST time printed); an agent's frames of
                config5's traffic (cut to 1.1 s) flat out over the unix
                socket into the native engine; request rows and scores
                exported over HTTP to a local sink, which then answers the
                health check with 402 and 200 (the Service pauses and
                resumes); every row sent accounted (server, windows,
                ledger), every window scored, K1 2 / K2 1 a dispatch, an
                anomaly row an edge at the sink, scores equal to the plain
                versions' (max error 0.0); events/s, close → score and busy
                time beside serve native's; ``agent_example`` (g++, from
                the checkout) into the C++ window accumulator: three
                windows scored, equal to the plain versions'; ``python -m
                alaz_tpu_torch serve --ingest-socket`` with no ``--config``
                on config3 (cut to 2.1 s), stopped by SIGINT: exit 0, every
                row in, at least two windows, all scored; ``python -m
                alaz_tpu_torch.chaos --seed 0``: exit 0, three legs, no
                finding;
   sanitize  -- GAT banded, renumbered and blocked on config3's traffic
                (cut to 1.1 s) through the C++ engine and window
                accumulator, with the Service and everything it builds
                under ``sanitize.lockorder.instrument()``: the observed
                lock-order graph printed and acyclic, every window scored,
                equal to the plain versions' (max error 0.0);
                every serve run above (``_started_under_budgets``): the
                compile plane counts the kernels' build at ``start()``
                (``compile.segment``, a recorder event with its
                ``duration_ms``), no ``compile.*`` counter moves after it,
                and ``sanitize.retrace_budget`` holds the run to no build
                and every dispatch to its model's K1-K3 launches;
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
   parallel  -- ``alaz_tpu_torch.parallel`` on W = min(cards, 4) ranks
                spawned one a card (NCCL; W = 1 on one H100, where every
                mesh axis has size 1), at full width (hidden 128, 2
                layers, bf16, kernels on): the dp-sharded GraphSAGE train
                step on W windows, 3 steps against the single-device step
                (loss to rel 1e-5 each step; the params after the steps
                equal at W = 1, within 1% of the update's L2 norm past
                it; K1 3 / K2 3 a step); the experts' step on a (dp, tp,
                ep) mesh, masked dispatch, 2 steps held alike; the dp-sharded GAT score step (banded: K1 2 / K2
                3 / K3 3 a window) equal to ``WindowScorer``'s scores; the
                node-sharded GraphSAGE and GAT forwards at S = W against
                the single-device apply (within 2^-5 of the largest
                logit; K1 (S + 1) and S a layer); the ring halo at the
                window's shapes against a float64 segment sum (rtol 1e-4,
                atol 1e-5); a GPipe pipeline against the sequential loop;
                each leg's median milliseconds a call (CUDA events), the
                NCCL version, the card;
6. op path   -- the public ``ops.gather_scatter_sum`` (K4) over the GAT
                windows' edges, launch counts read around those calls;
   train     -- GraphSAGE (uniform window), GAT banded (clustered window)
                and the experts: one forward and backward with launch counts
                read around it (GAT: a sort of edge_src for each of its
                three K3 backwards) and every gradient held against the plain
                versions', then AdamW steps with the loss falling; one
                ``train_tgn_unrolled`` epoch over the three uniform windows;
7. numbers   -- kernel times (CUDA events), bounds, plain-version and
                library-call times, forward and in each backward use (the
                sort alone, with its kernels' CUPTI times, and at the train
                CLI's shapes; both backward passes in turns with the
                argsort pass they replaced); for
                K4 on each window also its device time without the host's,
                the CUPTI time of its three kernels, the window's tile and
                reuse counts and its time with every edge on one src row;
                per-window score time of all four models, and a profile of
                the device time by kernel over scored windows of each.

Not a phase: ``eval_matrix()`` runs ``python -m alaz_tpu_torch eval`` with
its defaults on the card, timed per call, as a chip call of its own:

    python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.eval_matrix())"

and ``sort_small()`` times the sort and the GAT ``train`` CLI's step at
the CLI's shapes, to set two checkouts side by side.

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
import re
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
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 rate outside the tensor cores
K1_SOURCE = "alaz_tpu_torch/csrc/segment.cu"
K1_REPLACES = "alaz_tpu/ops/pallas_segment.py:184"  # scatter_sum_sorted (pallas_call :170)
K2_REPLACES = "alaz_tpu/ops/pallas_segment.py:346"  # segment_expand_sorted (pallas_call :332)
K3_REPLACES = "alaz_tpu/ops/pallas_segment.py:541"  # gather_rows_banded (pallas_call :527)
K4_REPLACES = "alaz_tpu/ops/pallas_segment.py:588"  # pallas_gather_scatter_sum (pallas_call :170)
# the sort of K3's and K4's backward is the port's own: the JAX package's
# backward passes (pallas_segment.py:575-582, :618-634) are XLA scatters
SORT_REPLACES = ("none: no TPU kernel; replaces torch.argsort and its gathers in "
                 "alaz_tpu_torch/ops/segment_kernels.py (K3's backward, K4's dx)")
# the sort's launches by main-path run (outside launch_counts()'s four keys)
SORT_LAUNCHES: dict = {}
# (edges, rows) of the train CLI's sorts: its n128xe128 windows, and one
# whole 4,096-key tile of the sort over the main bucket's rows
SORT_SMALL = ((128, 128), (4_096, N_MAIN))


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
    """Build the kernels and load them."""
    from alaz_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build()
    _build.library(built)
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


def _argsort_unsorted_segment_sum(g, ids, n):
    """K3's backward as it was built before the sort kernel:
    ``torch.argsort``, the gather of the sorted ids, K4; the oracle of the
    sort kernel's version, bit for bit."""
    from alaz_tpu_torch.ops import segment_kernels as K

    perm = torch.argsort(ids, stable=True).to(torch.int32)
    return K._run_k4(K._kernel_dtype(g).contiguous(), perm, ids[perm], K._rows_of_blocks(n))[:n].to(g.dtype)


def _argsort_dx(g32, src, dst, w32, n_x):
    """K4's ``dx`` as it was built before the sort kernel:
    ``torch.argsort`` of src, three gathers, K4 with src and dst swapped,
    f32."""
    from alaz_tpu_torch.ops import segment_kernels as K

    perm = torch.argsort(src, stable=True).to(torch.int32)
    wp = None if w32 is None else w32[perm].contiguous()
    return K._run_k4(g32, dst[perm], src[perm], K._rows_of_blocks(n_x), wp)[:n_x]


def _small_sort_ids(n_e: int, n_rows: int, gen, dev) -> tuple:
    """Src and dst ids of a ``train`` CLI-sized window: ``n_e`` edges
    over ``n_rows`` rows, the src ids drawn with every tenth one a hub's
    and the last two out of range (-1 and ``n_rows``), the dst ids sorted."""
    src = torch.randint(0, n_rows, (n_e,), generator=gen, device=dev, dtype=torch.int32)
    src[::10] = n_rows // 2
    src[-2:] = torch.tensor([-1, n_rows], dtype=torch.int32, device=dev)
    dst = torch.randint(0, n_rows, (n_e,), generator=gen, device=dev, dtype=torch.int32).sort().values
    return src, dst


def phase_backward(batch, gat_batch, dev: torch.device) -> dict:
    """Each wrapper's backward pass on the card at the training paths'
    shapes, against its plain version (or a float64 sum), and the kernel
    it launches, counted: K1's backward is a K2 launch (exact), K2's a K1
    launch, K3's a K4 launch over the ids' stable sort (the sort kernel,
    one launch), K4's ``dx`` a sort launch and a K4 launch with src and
    dst swapped, in f32. The sort kernel against its plain version, bit
    for bit, with and without ``dx``'s payloads: on both windows' src ids
    and at the ``train`` CLI's shapes (``SORT_SMALL``: E = 128 over 128
    rows, and one whole tile), one launch each; K3's backward and K4's
    ``dx`` on both windows, and K3's backward at those shapes, bit for
    bit against ``torch.argsort`` + K4, as they were built before the
    sort kernel. K3's and K4's backward run twice and must give the same
    bits. Returns the max abs error per case."""
    from alaz_tpu_torch.ops import segment_kernels as K

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(4)
    on_card = dev.type == "cuda"
    n_pad = batch.n_pad
    dst = torch.as_tensor(batch.edge_dst, device=dev)
    e = dst.shape[0]
    errs, launches = {}, {}

    def run(name, out, g, want, sorts=0):
        K.reset_launch_counts()
        out.backward(g, retain_graph=True)
        _sync(dev)
        launches[name] = dict(K.launch_counts(), sort_by_ids=K.sort_by_ids.launches)
        if on_card:
            want = dict(want, sort_by_ids=sorts)
            require(launches[name] == want, f"{name}: backward launches {launches[name]}, expected {want}")

    def randn(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # the sort kernel, with K4's dx payloads (dst and f32 weights) and
    # without, against its plain version: on both windows' src ids, and at
    # the train CLI's shapes, where K3's backward is also held to argsort + K4
    windows = [(ids_name, torch.as_tensor(b.edge_src, device=dev), torch.as_tensor(b.edge_dst, device=dev),
                b.n_pad) for ids_name, b in (("clustered", gat_batch), ("uniform", batch))]
    windows += [(f"e{n_e}_rows{n_rows}", *_small_sort_ids(n_e, n_rows, gen, dev), n_rows)
                for n_e, n_rows in SORT_SMALL]
    if on_card:
        require(K.sort_tile_keys() == SORT_SMALL[1][0], f"the sort's tile is {K.sort_tile_keys()} keys")
    for ids_name, src, bdst, n_rows in windows:
        w = torch.rand(src.shape[0], generator=gen, device=dev) + 0.5
        for pname, pays in (("", ()), ("_payloads", (bdst, w))):
            name = f"sort_{ids_name}{pname}"
            K.reset_launch_counts()
            got = K.sort_by_ids(src, n_rows, pays)
            _sync(dev)
            if on_card:
                require(K.sort_by_ids.launches == 1, f"{name}: {K.sort_by_ids.launches} launches")
            ref = K.sort_by_ids_plain(src, n_rows, pays)
            require(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
                    and all(torch.equal(x, y) for x, y in zip(got[2], ref[2])),
                    f"{name} is not bit-exact")
            errs[name] = float(max([(got[0] - ref[0]).abs().max(), (got[1] - ref[1]).abs().max()]
                                   + [(x.float() - y.float()).abs().max() for x, y in zip(got[2], ref[2])]))
        if src.shape[0] < e:
            g = randn((src.shape[0], F_MAIN))
            got = K.unsorted_segment_sum(g, src, n_rows)
            require(torch.equal(got, _argsort_unsorted_segment_sum(g, src, n_rows)),
                    f"k3_bwd_{ids_name}: differs from argsort + K4")
        del src, bdst, w, got, ref
    del windows

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
        run(name, out, g, _counts(0, 0, 0, 1), sorts=1)
        first, v.grad = v.grad, None
        out.backward(g)
        require(torch.equal(first, v.grad), f"{name}: two backward passes differ")
        require(torch.equal(first, _argsort_unsorted_segment_sum(g, src, b.n_pad)),
                f"{name}: differs from argsort + K4")
        ref = _f64_sum(g, src, b.n_pad).to(v.dtype)
        err = (first.float() - ref.float()).abs()
        require(bool((err <= _k1_tolerance(ref)).all()), f"{name} disagrees with the float64 sum")
        errs[name] = float(err.max())
        del v, out, g, first, ref

    # K4's backward (dx and dw) on the GAT window's edges and the uniform
    # window's, bf16 x, f32 weights
    for win, b in (("", gat_batch), ("_uniform", batch)):
        name = f"k4_bwd{win}"
        src = torch.as_tensor(b.edge_src, device=dev)
        gdst = torch.as_tensor(b.edge_dst, device=dev)
        x = randn((b.n_pad, F_MAIN)).requires_grad_()
        w = (torch.rand(gdst.shape[0], generator=gen, device=dev) + 0.5).requires_grad_()
        out = K.pallas_gather_scatter_sum(x, src, gdst, b.n_pad, w)
        g = randn(out.shape)
        run(name, out, g, _counts(0, 0, 0, 1), sorts=1)
        dx, dw = x.grad, w.grad
        x.grad = w.grad = None
        out.backward(g)
        require(torch.equal(dx, x.grad) and torch.equal(dw, w.grad), f"{name}: two backward passes differ")
        require(torch.equal(dx, _argsort_dx(g.float(), src, gdst, w.detach().float(), b.n_pad).to(x.dtype)),
                f"{name} dx: differs from argsort + K4")
        ref = _f64_sum(g[gdst.long()], src, b.n_pad, w.detach()).to(x.dtype)
        err = (dx.float() - ref.float()).abs()
        require(bool((err <= _k1_tolerance(ref)).all()), f"{name} dx disagrees with the float64 sum")
        errs[f"{name}_dx"] = float(err.max())
        dw_ref = (x.detach()[src.long()].float() * g.float()[gdst.long()]).sum(dim=1)
        dw_err = (dw - dw_ref).abs()
        require(float(dw_err.max()) <= 1e-5 * float(dw_ref.abs().max()), f"{name} dw disagrees with its plain version")
        errs[f"{name}_dw"] = float(dw_err.max())
        del src, gdst, x, w, out, g, dx, dw, ref
    emit("backward_vs_plain", {
        "tolerance": "K1's backward bit-exact; the sort bit-exact; K3's backward (also at the train "
                     "CLI's shapes) and K4's dx bit-exact against argsort + K4; K2's, K3's and K4's dx within one bf16 ulp "
                     "(2^-7·|ref| + 1e-5·max|ref|) of the plain version or the float64 sum; "
                     "K4's dw within 1e-5 of max|ref|",
        "max_abs_err": errs,
        "launches": launches,
        "seconds": time.perf_counter() - t0,
    })
    return errs


# -- phases 4 and 5 -----------------------------------------------------------


@contextlib.contextmanager
def plain_kernels():
    """Route the forward and backward passes of every kernel wrapper through
    the kernels' plain versions on the card (for the reference runs only;
    restored on exit)."""
    from alaz_tpu_torch.ops import gru_kernels as G
    from alaz_tpu_torch.ops import segment_kernels as K

    saved = K._run_k1, K._run_k2, K._run_k3, K._run_k4, K._run_sort, G._run_gru
    K._run_k1 = K.scatter_sum_sorted_plain
    K._run_k2 = lambda v, edge_dst, num_nodes: K.segment_expand_sorted_plain(v, edge_dst)
    K._run_k3 = lambda v, ids, num_nodes: K.gather_rows_banded_plain(v, ids)
    K._run_k4 = K.pallas_gather_scatter_sum_plain
    K._run_sort = K.sort_by_ids_plain
    G._run_gru = lambda *a: G.gru_update_plain(*a, torch.bfloat16)
    try:
        yield
    finally:
        K._run_k1, K._run_k2, K._run_k3, K._run_k4, K._run_sort, G._run_gru = saved


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
    first window. Launch counts read around the stream (K1 2n, K2 n, the
    GRU kernel n). Scores and the final memory held against the same
    stream on the plain versions: scores at a quarter of four bf16 ulps of
    the largest logit (sigmoid's slope is at most 1/4); the memory, whose
    gates read bf16 node states (an ulp apart moves a gate; the CPU parity
    against the JAX package sees 0.036 after three windows), at 2^-4 of
    its ±1 range. On the card the GRU kernel is then held and timed alone
    at the cell's shape (``gru_numbers``). Returns (summary, scorer)."""
    from alaz_tpu_torch.config import ModelConfig
    from alaz_tpu_torch.ops import gru_kernels as G
    from alaz_tpu_torch.runtime.scorer import WindowScorer

    cfg = ModelConfig(model="tgn")
    require((cfg.hidden_dim, cfg.num_layers, cfg.dtype, cfg.use_pallas, cfg.tgn_max_nodes)
            == (128, 2, "bfloat16", True, 4096), f"unexpected TGN ModelConfig {cfg}")
    for b in batches:
        require(b.n_pad > cfg.tgn_max_nodes, "the windows must outgrow the presized memory")
    gru0 = G.gru_update.launches
    scorer, on_card, window_s, all_scores, launches, peak_bytes = _score_windows(cfg, batches, device)
    n = len(batches)
    gru_launches = G.gru_update.launches - gru0
    require(gru_launches == (n if on_card else 0),
            f"tgn: {gru_launches} GRU kernel launches for {n} windows")
    if on_card:
        require(launches == _counts(2 * n, n, 0, 0),
                f"expected 2 K1 and 1 K2 launches per window, got {launches} for {n} windows")
    require(tuple(scorer.memory.shape) == (batches[0].n_pad, cfg.hidden_dim),
            f"memory {tuple(scorer.memory.shape)} did not grow to the bucket")
    plain = WindowScorer(cfg, scorer.params, device=device)
    require(tuple(plain.memory.shape) == (cfg.tgn_max_nodes, cfg.hidden_dim), "memory not presized")
    gru0 = G.gru_update.launches
    with plain_kernels():
        plain_scores = [plain.score(b) for b in batches]
    require(G.gru_update.launches == gru0, "tgn: the plain versions' stream launched the GRU kernel")
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
        "gru_update_launches": gru_launches,
        "memory_rows": [cfg.tgn_max_nodes, int(scorer.memory.shape[0])],
        "memory_rows_nonzero": live,
        "vs_plain_versions": {"scores": score_errs, "memory_max_abs_err": mem_err, "memory_bound": 2.0**-4},
        "score_mean": float(sum(float(sc.mean()) for sc in all_scores) / n),
    }
    if on_card:
        out["max_memory_allocated_bytes"] = peak_bytes
    emit("tgn_slice", out)
    if on_card:
        gru_numbers(scorer.params, torch.device(device))
    return out, scorer


# the GRU kernel against its plain version: the kernel and the plain path
# differ only in the order each product's f32 sum is taken, which can land
# a gate's bf16 rounding one ulp apart (2^-8 below 1); m' = (1 - z) n + z m
# with |n|, |m| <= 1 then moves by at most 2^-8 * 2 + two ulps of n: 2^-6
GRU_TOL = 2.0**-6


def gru_numbers(params, dev: torch.device, n_pad: int = N_MAIN, seed: int = 5) -> dict:
    """The GRU kernel alone at the TGN cell's shape (``n_pad`` rows, H =
    128, ~16% of the rows masked out, memory in [-1, 1]) against its plain
    version on the card: live rows within ``GRU_TOL``, masked rows bit for
    bit, one launch a call; then both timed by CUDA events beside the
    kernel's bound (its bytes: m read and m' written in f32, h in bf16, the
    mask, the packed bf16 weights; its products: 3 x rows x 2H x H
    multiply-adds)."""
    from alaz_tpu_torch.ops import gru_kernels as G

    h = params.gru_r.w.shape[1]
    gen = torch.Generator(device=dev).manual_seed(seed)
    memory = torch.rand((n_pad, h), generator=gen, device=dev) * 2 - 1
    node_h = torch.randn((n_pad, h), generator=gen, device=dev).bfloat16()
    mask = torch.rand(n_pad, generator=gen, device=dev) > 0.16
    layers = (params.gru_r, params.gru_z, params.gru_n)
    with torch.inference_mode():
        launches0 = G.gru_update.launches
        got = G.gru_update(*layers, memory, node_h, mask)
        require(G.gru_update.launches == launches0 + 1, "gru_update: not one launch a call")
        ref = G.gru_update_plain(*layers, memory, node_h, mask, torch.bfloat16)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        live_err = float(err[mask].max())
        require(live_err <= GRU_TOL, f"gru_update: live rows {live_err} from the plain version")
        require(torch.equal(got[~mask], memory[~mask]), "gru_update: masked rows not kept bit for bit")
        ms = time_ms(lambda: G.gru_update(*layers, memory, node_h, mask))
        plain_ms = time_ms(lambda: G.gru_update_plain(*layers, memory, node_h, mask, torch.bfloat16), iters=20)
    bytes_moved = n_pad * (h * 4 + h * 2 + 1 + h * 4) + 3 * (2 * h * h + h) * 2
    flops = 3 * 2 * n_pad * 2 * h * h
    bound_ms = max(bytes_moved / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3
    out = {
        "rows": n_pad, "hidden": h, "masked_rows": int((~mask).sum()),
        "max_abs_err_live": live_err, "tol": GRU_TOL,
        "share_exact": float((err[mask] == 0).float().mean()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_moved / HBM_BYTES_PER_S >= flops / BF16_FLOPS_PER_S else "operations",
        "roofline_pct": 100.0 * bound_ms / ms,
    }
    emit("gru_update", out)
    return out


# -- the serving phase --------------------------------------------------------

# testDuration cut: four one-second windows a run, the last a tenth full
# (every edge still live in it); the copied Python aggregator takes
# ~11,000 (config5) to ~67,000 (config4) events/s on the card's host
SERVE_DURATION_S = 3.1
SERVE_RUNS = (
    # family, replay config, testDuration cut, least windows (every started
    # second's), ModelConfig and RuntimeConfig settings. The Python engine
    # takes config5's events at 12,000-19,000/s on the card's host (1.09M
    # offered a second), so its run is cut to 1.1 s, one full window and
    # a tenth, as the thread-sharded run is; config3's GAT and experts runs
    # to 2.1 s, two full windows and a tenth
    ("graphsage", "testconfig/config5_fleet_100k.json", 1.1, 2, {}, {}),
    ("gat", "testconfig/config3_10k_mixed.json", 2.1, 3,
     {"model": "gat", "src_gather": "banded", "edge_layout": "blocked"},
     {"renumber_nodes": True, "edge_layout": "blocked"}),
    ("experts", "testconfig/config3_10k_mixed.json", 2.1, 3, {"model": "experts"}, {}),
    ("tgn", "testconfig/config4_temporal.json", SERVE_DURATION_S, 4, {"model": "tgn"}, {}),
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
                use_native_ingest: bool = False, watch=None) -> dict:
    """One run of the streaming Service on the card: replayed traffic
    through ingest → aggregator → window close → scorer (``sim_cfg``,
    flat out), or the closed windows of an earlier run handed to the
    window close callback before the workers start, so the scorer finds
    them as a backlog (``backlog``). Launch counts and peak memory are
    read around exactly this run; a worker thread that raises fails the
    phase. ``use_native_ingest`` closes windows in the C++ window
    accumulator. A process-backed ingest pool is ready before the run
    starts, so spawning its workers stays outside the numbers. ``watch``,
    where given, is a context manager factory entered with the service
    around the run, before the service stops; what it yields is the
    result's ``"watch"``."""
    from alaz_tpu_torch.events.intern import Interner
    from alaz_tpu_torch.ops import gru_kernels as G
    from alaz_tpu_torch.ops import segment_kernels as K
    from alaz_tpu_torch.replay.simulator import Simulator
    from alaz_tpu_torch.runtime.service import Service

    interner = Interner()
    sunk, windows, latency = [], [], []
    svc = Service(config=cfg, interner=interner, score_sink=sunk.append,
                  model_state=params, score_threshold=0.0, device=device,
                  use_native_ingest=use_native_ingest)
    on_card = svc.torch_device.type == "cuda"
    if hasattr(svc.sharded, "wait_ready"):
        require(svc.sharded.wait_ready(120.0), "the process pool's workers did not report ready")
    svc.score_observer = lambda batch, tenant, lat: (windows.append(batch), latency.append(lat))
    raised, hook = [], threading.excepthook
    threading.excepthook = raised.append
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    split0 = K.k1_split_counts(svc.torch_device)
    gru0 = G.gru_update.launches
    events = 0
    watched = None
    compile_plane = {}
    t0 = time.perf_counter()
    try:
        with (watch(svc) if watch is not None else contextlib.nullcontext()) as watched:
            if backlog is not None:
                for b in backlog:
                    svc.graph_store.on_batch(b)
            with _started_under_budgets(svc, compile_plane):
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
    split = (snap["k1.split_rows"] - split0[0], snap["k1.split_edges"] - split0[1])
    lat = np.array(latency)
    return {
        "svc": svc, "windows": windows, "scores": {sb.window_start_ms: sb.score for sb in sunk}, "watch": watched,
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
            # the scorer's staging sets, serial windows' and groups' fills together
            "staging_sets": {"fills": svc._staging_sets.fills, "reuses": svc._staging_sets.reuses,
                             "pinned": svc._staging_sets.pin},
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated() if on_card else None,
            "launches": launches,
            # K1's rows split across chunk warps in this run, and their edges
            "k1_split": {"rows": split[0], "edges": split[1]},
            # the GRU kernel's launches in this run, and as TGN's gauge
            # tgn.memory_update_kernel reads them (None under other models)
            "gru_update_launches": G.gru_update.launches - gru0,
            "memory_update_kernel": (None if "tgn.memory_update_kernel" not in snap
                                     else snap["tgn.memory_update_kernel"] - gru0),
            "compile_plane": compile_plane,
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
    gru = run["summary"]["gru_update_launches"]
    want = run["summary"]["windows_scored"] if family == "tgn" else 0
    require(gru == want, f"serve {family}: {gru} GRU kernel launches for {want} expected")
    if family == "tgn":
        gauge = run["summary"]["memory_update_kernel"]
        require(gauge == want, f"serve tgn: tgn.memory_update_kernel moved {gauge} for {want} windows")


def _launch_budget(svc) -> dict:
    """One score dispatch's kernel launches for the service's model
    (``SERVE_LAUNCHES``; none on the CPU or under ``plain_kernels``), held
    for each scoring entry point by ``retrace_budget``."""
    from alaz_tpu_torch.ops import segment_kernels as K

    mcfg, k = svc.config.model, (0, 0, 0)
    if svc.torch_device.type == "cuda" and mcfg.use_pallas and K._run_k1 is not K.scatter_sum_sorted_plain:
        require(mcfg.model != "gat" or mcfg.src_gather == "banded", f"serve: GAT with src_gather {mcfg.src_gather}")
        k = SERVE_LAUNCHES[mcfg.model]
    per = _counts(*k, 0)
    return {entry: per for entry in ("score_apply", "batched_score_apply", "tgn_step")}


def _compile_counters(svc) -> dict:
    return {k: v for k, v in svc.metrics.snapshot().items() if k.startswith("compile.")}


@contextlib.contextmanager
def _started_under_budgets(svc, out: dict):
    """``svc.start()`` and the run in the block, held by the compile plane
    and the build and launch budgets (``sanitize/retrace.py``): on the card
    with kernels on, start() counts the kernels' build (or its lookup) into
    ``compile.events`` and ``compile.segment`` and the recorder has its
    ``compile`` event with ``duration_ms``; from then on no build runs and
    no ``compile.*`` counter moves; every dispatch of the run, the first
    included, launches the model's kernels (``_launch_budget``). What the
    plane saw goes into ``out``."""
    from alaz_tpu_torch.sanitize.retrace import STEADY_STATE_BUDGETS, retrace_budget

    require(svc.compile_plane is not None, "the scoring service has no compile plane")
    budget = _launch_budget(svc)
    with retrace_budget({}, launches=budget) as held:
        svc.start()
        at_start = _compile_counters(svc)
        out.update(at_start=at_start, launch_budget=budget["score_apply"])
        if svc.torch_device.type == "cuda" and svc.config.model.use_pallas:
            ev = [e for e in svc.recorder.events() if e.get("kind") == "compile" and e.get("fn") == "segment"]
            require(at_start.get("compile.events", 0) >= 1 and at_start.get("compile.segment", 0) >= 1
                    and ev and ev[-1].get("duration_ms") is not None,
                    f"the compile plane missed the kernels' build at start: {at_start}")
            out["segment_build_ms"] = ev[-1]["duration_ms"]
        with retrace_budget(STEADY_STATE_BUDGETS, watcher=held):
            yield
        moved = _compile_counters(svc)
        require(moved == at_start, f"compile.* moved in steady state: {at_start} -> {moved}")
    require(held.dispatch_total == svc.score_dispatches,
            f"{held.dispatch_total} dispatches held of {svc.score_dispatches}")
    out["dispatches_held"] = held.dispatch_total


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
    testDuration cut as the run's row says. Each run: at least the row's
    least windows, windows scored equal windows closed, no worker
    exception, scores finite in [0, 1], the kernels' launches per
    dispatch; then the same windows re-scored by the Service under the
    plain versions, scores held together. GraphSAGE
    also scores twelve windows (its replay's, repeated) as a backlog at
    ``score_batch_windows=4`` (the group path) against its serial
    scores.
    Returns the launch counts of each run and each run's entry."""
    from alaz_tpu_torch.config import ModelConfig, RuntimeConfig
    from alaz_tpu_torch.graph.snapshot import pad_to_bucket
    from alaz_tpu_torch.models.registry import init_params

    launches, out = {}, {}
    for family, path, duration_s, least, model_kw, runtime_kw in runs:
        sim_cfg, full_s = _replay_config(path, duration_s)
        if family == "tgn":  # the memory presized to the largest bucket this fleet can reach
            model_kw = dict(model_kw, tgn_max_nodes=pad_to_bucket(sim_cfg.pod_count + sim_cfg.service_count))
        mcfg = ModelConfig(**model_kw)
        require((mcfg.hidden_dim, mcfg.num_layers, mcfg.dtype, mcfg.use_pallas) == (128, 2, "bfloat16", True),
                f"unexpected ModelConfig {mcfg}")
        cfg = RuntimeConfig(model=mcfg, window_s=1.0, score_batch_windows=1, **runtime_kw)
        params = init_params(mcfg, key=0, device=device)
        run = _serve_once(cfg, params, sim_cfg=sim_cfg, device=device)
        require(run["summary"]["windows_scored"] >= least, f"serve {family}: fewer than {least} windows")
        _require_launches(family, run)
        launches[f"serve_{family}"] = run["summary"]["launches"]
        with plain_kernels():
            plain = _serve_once(cfg, params, backlog=run["windows"], device=device)
        entry = {
            "replay": {"config": path, "testDuration_s": [full_s, duration_s],
                       "pods": sim_cfg.pod_count, "services": sim_cfg.service_count,
                       "edges": sim_cfg.edge_count, "rate_per_edge": sim_cfg.edge_rate},
            "model": {k: getattr(mcfg, k) for k in ("model", "src_gather", "edge_layout", "tgn_max_nodes")},
            "renumber_nodes": cfg.renumber_nodes,
            "serial": run["summary"],
            "vs_plain_versions": _scores_agree(f"serve {family} vs plain", run["scores"], plain["scores"]),
        }
        if family == "graphsage":
            # twelve windows (the run's, repeated): three groups of 4, the
            # third through the first group's pinned buffer again
            backlog = (run["windows"] * 12)[:12]
            gcfg = dataclasses.replace(cfg, score_batch_windows=4)
            group = _serve_once(gcfg, params, backlog=backlog, device=device)
            gs = group["summary"]
            require(gs["score_dispatches"] == len(backlog) // 4, f"serve graphsage: groups {gs['score_dispatches']}")
            require(gs["staging_sets"]["reuses"] >= 1, "serve graphsage: no staging set reused")
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
    # config5 cut to 1.1 s as every other config5 run (the smoke's time:
    # the serve_live phase adds a minute); config3 to 2.1 s
    ("graphsage", "graphsage", "testconfig/config5_fleet_100k.json", 1.1, 2, {},
     {"engine_backend": "native"}, True),
    # the thread-sharded ingest: four workers, each joining in C++, the
    # window close grouping in C++ through the numpy builder. It takes
    # config5's events at ~14,000/s on the card's host (no faster than one
    # Python engine), so its replay is cut to 1.1 s: one full window and a
    # tenth of one
    ("graphsage_4_workers", "graphsage", "testconfig/config5_fleet_100k.json", 1.1, 2, {},
     {"engine_backend": "native", "ingest_workers": 4}, False),
    ("gat", "gat", "testconfig/config3_10k_mixed.json", 2.1, 3,
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
    time without ingest load. Returns the launch counts of each run and
    each run's host side (``_host_side``), by tag."""
    from alaz_tpu_torch.config import ModelConfig, RuntimeConfig
    from alaz_tpu_torch.graph import builder
    from alaz_tpu_torch.graph.native import NativeWindowedStore
    from alaz_tpu_torch.models.registry import init_params

    build = _native_build()
    emit("serve_native_build", build)
    launches, host = {}, {}
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
        host[tag] = entry["native"]
        del run, plain, svc
    return launches, host


# -- process ingest and tenants ----------------------------------------------

SERVE_PROCESS_RUNS = (
    # tag, family, replay config, testDuration cut, least windows, ModelConfig
    # and RuntimeConfig settings; every run ingests on the process backend
    # (spawned shard workers over shared-memory rings), each worker
    # joining in its own C++ L7 engine. Config5 is cut to 1.1 s, as the
    # thread-sharded run of phase_serve_native is: one full window and a
    # tenth of one
    ("graphsage_1_worker", "graphsage", "testconfig/config5_fleet_100k.json", 1.1, 1, {},
     {"ingest_workers": 1}),
    ("graphsage_4_workers", "graphsage", "testconfig/config5_fleet_100k.json", 1.1, 1, {},
     {"ingest_workers": 4}),
    ("gat_2_workers", "gat", "testconfig/config3_10k_mixed.json", SERVE_DURATION_S, 2,
     {"model": "gat", "src_gather": "banded", "edge_layout": "blocked"},
     {"ingest_workers": 2, "renumber_nodes": True, "edge_layout": "blocked"}),
)
# the runs of phase_serve_native each process run is set beside
PROCESS_BESIDE = {"graphsage": ("graphsage", "graphsage_4_workers"), "gat": ("gat",)}
ENGINE_LINE = re.compile(r"shm shard(\d+) L7 engine backend: native \(loaded=True\)")


def _dev_shm_room(workers: int, cfg) -> dict:
    """``/dev/shm``'s size and free space against what ``workers`` shard
    workers' rings take (two rings a worker at the config's geometry,
    every page touched when a ring is made). Too little room fails here:
    past a tmpfs limit the rings' first touch ends in SIGBUS, and they are
    never shrunk to fit."""
    from alaz_tpu_torch.shm.ring import DATA_OFFSET

    st = os.statvfs("/dev/shm")
    ring = DATA_OFFSET + cfg.shm_slot_bytes * cfg.shm_ring_slots
    out = {"size_bytes": st.f_blocks * st.f_frsize, "free_bytes": st.f_bavail * st.f_frsize,
           "ring_bytes": ring, "workers": workers, "need_bytes": 2 * workers * ring}
    emit("dev_shm", out)
    require(out["free_bytes"] >= out["need_bytes"],
            f"/dev/shm has {out['free_bytes']} bytes free of {out['size_bytes']}, and {workers} shard workers' "
            f"rings need {out['need_bytes']} (2 x {ring} a worker): give the machine a larger /dev/shm")
    return out


@contextlib.contextmanager
def _stderr_to(path: Path):
    """File descriptor 2 redirected to ``path``: what this process and the
    processes it spawns meanwhile log to standard error."""
    sys.stderr.flush()
    saved = os.dup(2)
    with open(path, "wb") as f:
        os.dup2(f.fileno(), 2)
    try:
        yield path
    finally:
        sys.stderr.flush()
        os.dup2(saved, 2)
        os.close(saved)


def _nvidia_fds(pid: int) -> list:
    """The NVIDIA device files ``pid`` holds open: a process that
    initialised CUDA holds ``/dev/nvidiactl`` and its card's file (loading
    ``libcuda`` alone, as ``import torch`` does, opens none)."""
    fds = Path(f"/proc/{pid}/fd")
    out = set()
    for fd in fds.iterdir():
        try:
            target = os.readlink(fd)
        except OSError:  # closed since the listing
            continue
        if target.startswith("/dev/nvidia"):
            out.add(target)
    return sorted(out)


@contextlib.contextmanager
def _pool_watch(svc):
    """Around a run on the process backend: the rings' pending slots,
    sampled every 5 ms (most seen), and, before the service stops, the
    workers' pids and liveness, whether each has the native library
    mapped, the NVIDIA device files each (and this process) holds open,
    the rings' gauges and the respawns."""
    from alaz_tpu_torch.graph import native

    pool = svc.sharded
    seen = {"req_pending_slots_max": 0, "resp_pending_slots_max": 0, "samples": 0}
    done = threading.Event()

    def sample():
        while not done.wait(0.005):
            seen["req_pending_slots_max"] = max(seen["req_pending_slots_max"], pool.shm_req_pending())
            seen["resp_pending_slots_max"] = max(seen["resp_pending_slots_max"], pool.shm_resp_pending())
            seen["samples"] += 1

    th = threading.Thread(target=sample, name="smoke-ring-sampler", daemon=True)
    th.start()
    try:
        yield seen
    finally:
        done.set()
        th.join(5)
        lib = Path(native._LIB_PATH).name if native._LIB_PATH else None
        seen["pids"] = [h.proc.pid for h in pool.workers]
        seen["alive"] = [h.proc.is_alive() for h in pool.workers]
        maps = [Path(f"/proc/{pid}/maps").read_text() for pid in seen["pids"]]
        seen["native_library"] = lib
        seen["library_mapped"] = [lib is not None and lib in m for m in maps]
        seen["nvidia_fds"] = [_nvidia_fds(pid) for pid in seen["pids"]]
        seen["smoke_nvidia_fds"] = _nvidia_fds(os.getpid())
        seen["ring_stats"] = pool.ring_stats()
        seen["worker_restarts"] = pool.worker_restarts


def phase_serve_process(python_runs: dict, native_host: dict, device: str = "cuda",
                        runs=SERVE_PROCESS_RUNS) -> dict:
    """The streaming Service on the card over the process backend
    (``INGEST_BACKEND=process``, ``ENGINE_BACKEND=native``) at phase_serve's
    widths: a ``ProcessShardedIngest`` serving, its workers live processes
    apart from this one, each with the checkout's native library mapped
    and its log saying it joins in C++, none with the card open; at
    least the run's least windows closed, every one scored, the kernels'
    launches per dispatch, the scores equal to the same windows rescored
    under the plain versions (max error 0.0), no worker killed, and every
    replayed row in a scored window or in the drop ledger. ``/dev/shm``
    is checked for the rings' room first. Beside each run, the
    Python-engine (``python_runs``), native and thread-sharded runs
    (``native_host``) of the same config. Returns the launch counts."""
    from alaz_tpu_torch.config import ModelConfig, RuntimeConfig
    from alaz_tpu_torch.models.registry import init_params
    from alaz_tpu_torch.shm.process_pool import ProcessShardedIngest

    work = Path("build/chip_smoke")
    work.mkdir(parents=True, exist_ok=True)
    launches = {}
    for tag, family, path, duration_s, min_windows, model_kw, runtime_kw in runs:
        sim_cfg, full_s = _replay_config(path, duration_s) if isinstance(path, str) else (path, None)
        mcfg = ModelConfig(**model_kw)
        require((mcfg.hidden_dim, mcfg.num_layers, mcfg.dtype, mcfg.use_pallas) == (128, 2, "bfloat16", True),
                f"unexpected ModelConfig {mcfg}")
        cfg = RuntimeConfig(model=mcfg, window_s=1.0, score_batch_windows=1, ingest_backend="process",
                            engine_backend="native", **runtime_kw)
        shm = _dev_shm_room(cfg.ingest_workers, cfg)
        params = init_params(mcfg, key=0, device=device)
        log_path = work / f"serve_process_{tag}.log"
        with _stderr_to(log_path):
            run = _serve_once(cfg, params, sim_cfg=sim_cfg, device=device, watch=_pool_watch)
        svc, seen, s = run["svc"], run["watch"], run["summary"]
        log = log_path.read_text(errors="replace")
        n = cfg.ingest_workers
        require(isinstance(svc.sharded, ProcessShardedIngest) and svc.sharded.n == n,
                f"serve_process {tag}: not a ProcessShardedIngest of {n} workers")
        require(all(seen["alive"]) and len(set(seen["pids"])) == n and os.getpid() not in seen["pids"],
                f"serve_process {tag}: workers {seen['pids']} alive {seen['alive']}")
        require(all(seen["library_mapped"]), f"serve_process {tag}: {seen['native_library']} not in every worker")
        require(sorted(int(i) for i in ENGINE_LINE.findall(log)) == list(range(n))
                and "falling back to the python L7 engine" not in log,
                f"serve_process {tag}: the workers' logs do not each say native (see {log_path})")
        require(not any(seen["nvidia_fds"]), f"serve_process {tag}: a worker opened the card: {seen['nvidia_fds']}")
        require(s["windows_scored"] >= min_windows, f"serve_process {tag}: fewer than {min_windows} windows")
        _require_launches(family, run)
        reasons = s["ledger"].get("reasons", {})
        require(seen["worker_restarts"] == 0 and not any(r.startswith("dropped/shm") for r in reasons),
                f"serve_process {tag}: a worker died: restarts {seen['worker_restarts']}, {reasons}")
        emitted = sum(b.aggregated_rows() for b in run["windows"])
        gap = svc.ledger.conservation_gap(s["events"], emitted)
        require(gap == 0, f"serve_process {tag}: pushed {s['events']} != emitted {emitted} + ledger "
                          f"{svc.ledger.total} (gap {gap})")
        launches[f"serve_process_{tag}"] = s["launches"]
        # the plain versions score the windows as a backlog: no ingest, so
        # no pool to spawn for it
        rescore = dataclasses.replace(cfg, ingest_backend="thread", ingest_workers=1)
        with plain_kernels():
            plain = _serve_once(rescore, params, backlog=run["windows"], device=device)
        vs_plain = _scores_agree(f"serve_process {tag} vs plain", run["scores"], plain["scores"])
        require(vs_plain["max_abs_err"] == 0.0, f"serve_process {tag}: scores differ from the plain versions' "
                                                 f"by {vs_plain['max_abs_err']}")
        entry = {
            "replay": {"config": path if isinstance(path, str) else None,
                       "testDuration_s": [full_s, sim_cfg.test_duration_s],
                       "pods": sim_cfg.pod_count, "edges": sim_cfg.edge_count, "rate_per_edge": sim_cfg.edge_rate},
            "runtime": dict(runtime_kw, ingest_backend="process", engine_backend="native"),
            "model": {k: getattr(mcfg, k) for k in ("model", "src_gather", "edge_layout")},
            "dev_shm": shm, "workers": {k: seen[k] for k in ("pids", "library_mapped", "nvidia_fds")},
            "smoke_nvidia_fds": seen["smoke_nvidia_fds"],
            "conservation": {"pushed": s["events"], "emitted": emitted, "ledger": svc.ledger.total, "gap": gap},
            "rings": {k: seen[k] for k in ("req_pending_slots_max", "resp_pending_slots_max", "samples",
                                           "ring_stats")},
            "serial": s,
            "process": _host_side(s, svc.metrics.snapshot()),
            "vs_plain_versions": vs_plain,
            "window_scorer": _window_scorer_times(mcfg, params, run["windows"], device),
            "log": str(log_path),
        }
        py = python_runs.get(family)
        entry["beside"] = {"python_engine": _host_side(py["serial"]) if py is not None else None,
                           **{f"native_{t}": native_host.get(t) for t in PROCESS_BESIDE[family]}}
        emit(f"serve_process_{tag}", entry)
        del run, plain, svc
    return launches


def _feed_tenants(svc, tenant_traffic) -> dict:
    """Each tenant's stream into its partition's aggregator on this thread,
    deliveries round-robin across tenants (as a fleet of agents sends
    them), then every window closed; returns the L7 rows pushed a tenant."""
    aggs = {t: svc.partitions[t].aggregator for t in tenant_traffic}
    for t, (kube, traffic) in tenant_traffic.items():
        for m in kube:
            aggs[t].process_k8s(m)
        if traffic.tcp is not None and len(traffic.tcp):
            aggs[t].process_tcp(traffic.tcp)
    for i in range(max(len(tr.deliveries) for _, tr in tenant_traffic.values())):
        for t, (_, traffic) in tenant_traffic.items():
            if i < len(traffic.deliveries):
                d = traffic.deliveries[i]
                for kind, payload in d.pre:
                    if kind == "k8s":
                        for m in payload:
                            aggs[t].process_k8s(m)
                    else:
                        aggs[t].process_tcp(payload)
                aggs[t].process_l7(d.batch)
    svc.flush_windows()
    return {t: traffic.total_rows for t, (_, traffic) in tenant_traffic.items()}


TENANTS = 3
TENANT_WINDOWS = 4  # windows of each tenant's traffic (replay/tenants.py)
TENANT_GROUP_W = 8  # a group of 8 of 3 tenants' 4 windows each mixes tenants


def phase_tenants(device: str = "cuda") -> dict:
    """Multi-tenant serving. The isolation gate as a user runs it
    (``python -m alaz_tpu_torch.replay --isolation``, the host scorer: no
    model, no card; one host-only scenario beside it): exit 0, no
    finding. Then three tenants' traffic (``replay/tenants.py``'s
    personalities, seed 0) into one Service on the process backend (a
    worker a tenant, native engine), scored by GraphSAGE on the card at
    phase_serve's widths with ``score_batch_windows=8``: windows closed
    before the scorer starts, so they wait as a backlog and group across
    tenants. Every group dispatch launches K1 2 / K2 1, at least one
    group mixes tenants, each tenant's books are exact, and each
    tenant's scores equal its windows scored one at a time on the plain
    versions. Returns the launch counts."""
    from alaz_tpu_torch.config import ModelConfig, RuntimeConfig
    from alaz_tpu_torch.events.intern import Interner
    from alaz_tpu_torch.models.registry import init_params
    from alaz_tpu_torch.ops import segment_kernels as K
    from alaz_tpu_torch.replay.tenants import make_tenant_traffic
    from alaz_tpu_torch.runtime.scorer import WindowScorer
    from alaz_tpu_torch.runtime.service import Service

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "alaz_tpu_torch.replay", "--isolation", "--no-detection",
                           "--scenarios", "retry_storm", "--workers", "1"],
                          capture_output=True, text=True, timeout=600)
    reports = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    require(proc.returncode == 0, f"isolation gate exited {proc.returncode}: {proc.stderr[-2000:]}")
    iso = [r for r in reports if r.get("scenario") == "multi_tenant_isolation"]
    require(len(iso) == 1 and iso[0]["scenario_findings"] == 0, f"isolation gate: {reports}")
    emit("tenants_isolation_gate", dict(iso[0], command_s=time.perf_counter() - t0))

    mcfg = ModelConfig()
    require((mcfg.hidden_dim, mcfg.num_layers, mcfg.dtype, mcfg.use_pallas) == (128, 2, "bfloat16", True),
            f"unexpected ModelConfig {mcfg}")
    cfg = RuntimeConfig(model=mcfg, window_s=1.0, tenants=TENANTS, score_batch_windows=TENANT_GROUP_W,
                        ingest_backend="process", ingest_workers=1, engine_backend="native")
    _dev_shm_room(TENANTS, cfg)
    params = init_params(mcfg, key=0, device=device)
    traffic = {t: make_tenant_traffic(t, 0, TENANT_WINDOWS) for t in range(TENANTS)}
    wins, sunk = {t: [] for t in range(TENANTS)}, []
    svc = Service(config=cfg, interner=Interner(), score_sink=sunk.append, model_state=params,
                  score_threshold=0.0, device=device)
    svc.score_observer = lambda batch, tenant, lat: wins[tenant].append(batch)
    raised, hook = [], threading.excepthook
    threading.excepthook = raised.append
    try:
        for p in svc.partitions:
            require(type(p.sharded).__name__ == "ProcessShardedIngest" and p.sharded.wait_ready(120.0),
                    "tenants: a partition's process pool is not ready")
        pushed = _feed_tenants(svc, traffic)
        _sync(svc.torch_device)
        K.reset_launch_counts()
        t1 = time.perf_counter()
        compile_plane = {}
        with _started_under_budgets(svc, compile_plane):
            svc.drain(300)
        _sync(svc.torch_device)
        launches = K.launch_counts()
        wall = time.perf_counter() - t1
    finally:
        svc.stop()
        threading.excepthook = hook
    require(raised == [], f"tenants: a worker thread raised: {[repr(a.exc_value) for a in raised]}")
    d, n_windows = svc.score_dispatches, svc.scored_batches
    require(n_windows == sum(len(w) for w in wins.values()) == len(sunk) == svc.metrics.counter("windows.closed").value,
            f"tenants: scored {n_windows} windows, sunk {len(sunk)}")
    require(svc.multi_tenant_groups >= 1 and d < n_windows,
            f"tenants: {d} dispatches for {n_windows} windows, {svc.multi_tenant_groups} mixing tenants")
    if svc.torch_device.type == "cuda":
        require(launches == _counts(2 * d, d, 0, 0), f"tenants: launches {launches} for {d} group dispatches")
    by_interner = {id(p.interner): p.tenant for p in svc.partitions}
    scores = {t: {} for t in range(TENANTS)}
    for sb in sunk:
        scores[by_interner[id(sb.interner)]][sb.window_start_ms] = sb.score
    books, agree = {}, {}
    for t in range(TENANTS):
        part = svc.partitions[t]
        emitted = sum(b.aggregated_rows() for b in wins[t])
        gap = part.ledger.conservation_gap(pushed[t], emitted)
        require(wins[t] and gap == 0, f"tenants: tenant {t} pushed {pushed[t]}, emitted {emitted}, "
                                      f"ledger {part.ledger.total}")
        books[str(t)] = {"pushed": pushed[t], "emitted": emitted, "ledger": part.ledger.snapshot(),
                         "windows": len(wins[t]), "buckets": sorted({b.bucket_key for b in wins[t]})}
        with plain_kernels():
            serial = WindowScorer(mcfg, params, device=device)
            ref = {b.window_start_ms: serial.score(b) for b in wins[t]}
        agree[str(t)] = _scores_agree(f"tenants: tenant {t} groups vs serial plain", scores[t], ref)
    out = {"tenants": TENANTS, "score_batch_windows": TENANT_GROUP_W, "windows": n_windows, "dispatches": d,
           "multi_tenant_groups": svc.multi_tenant_groups, "launches": launches, "compile_plane": compile_plane,
           "scorer_wall_s": wall,
           "scorer_busy_s": svc._scorer_busy_s, "books": books, "groups_vs_serial_plain": agree}
    emit("tenants_groups", out)
    return {"tenants_groups": launches}


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


# -- live ingest: the agent socket, the K8s watch, HTTP export and health ------

LIVE_CONFIG = "testconfig/config5_fleet_100k.json"
LIVE_DURATION_S = 1.1  # one full window and a tenth, as serve_process's config5 runs
LIVE_CLI_CONFIG = "testconfig/config3_10k_mixed.json"
LIVE_CLI_DURATION_S = 2.1  # two full windows close, the third stays open
LIVE_L7_FRAME_ROWS = 4096  # an agent's batch: one frame, one writev
# the queues sized to the burst, as an operator sets them: the K8s queue
# holds the whole LIST of the cluster (KUBE_EVENTS_BUFFER_SIZE; its
# default, 1,000 messages, is the reference's channel size, and a
# 100,000-pod cluster's LIST is 210,000 messages with the pods'
# containers), the L7 queue the agent's whole flat-out burst
# (EVENTS_BUFFER_SIZE; config5's 1,100,000 events past its default of
# 200,000), so nothing sheds and the runs measure the ingest pace
LIVE_KUBE_EVENTS = 1 << 20
LIVE_L7_EVENTS = 1 << 21
# a CLI's TCP worker counts a batch as it starts on it: the agent waits
# this long more before its requests (config3's 5,000 establishes fold
# into socket lines in well under it). Requests that outrun their
# connections retry for 60 ms and then drop (filtered/no_socket), and
# requests that outrun their pods' K8s messages drop as not_pod: a live
# agent's order, connections and metadata first, is the service's
# contract (PERF.md §6)
LIVE_TCP_SETTLE_S = 0.5
AGENT_RECORDS = 3000  # agent_example's records: three one-second windows


def api_items(msgs) -> dict:
    """The pods and services of ``msgs`` (``Simulator.setup()``'s) as an
    API server's LIST items (camelCase, ``resourceVersion``), by path."""
    from alaz_tpu_torch.events.k8s import ResourceType

    out = {"/api/v1/pods": [], "/api/v1/services": []}
    for i, m in enumerate(msgs):
        o = m.object
        meta = {"uid": o.uid, "name": o.name, "namespace": o.namespace, "resourceVersion": str(i + 1)}
        if m.resource_type == ResourceType.POD:
            out["/api/v1/pods"].append({"metadata": meta, "status": {"podIP": o.ip},
                                        "spec": {"containers": [{"image": o.image}] if o.image else []}})
        elif m.resource_type == ResourceType.SERVICE:
            out["/api/v1/services"].append({"metadata": meta, "spec": {
                "type": o.type or "ClusterIP", "clusterIP": o.cluster_ip, "clusterIPs": list(o.cluster_ips),
                "ports": [{"name": n, "port": p, "targetPort": t, "protocol": pr} for n, p, t, pr in o.ports]}})
    return out


class FakeApiServer:
    """A Kubernetes API server on loopback for the K8s watch: each LIST
    path of ``items`` answers its items (every other kind an empty list),
    and every WATCH is a quiet stream until ``close()``."""

    def __init__(self, items: dict):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import urlsplit

        bodies = {p: json.dumps({"kind": "List", "metadata": {"resourceVersion": str(len(v) + 1)},
                                 "items": v}).encode() for p, v in items.items()}
        empty = json.dumps({"kind": "List", "metadata": {"resourceVersion": "1"}, "items": []}).encode()
        self.release = threading.Event()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                path, _, query = self.path.partition("?")
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                if "watch=1" in query.split("&"):
                    self.end_headers()
                    self.wfile.flush()
                    outer.release.wait(600)
                    return
                body = bodies.get(urlsplit(path).path, empty)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.server.server_port}"
        self._thread = threading.Thread(target=self.server.serve_forever, name="smoke-apiserver", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self.release.set()
        self.server.shutdown()
        self.server.server_close()
        self._thread.join(10)


# the backend sink's server, run as a process of its own (a backend is
# remote: its JSON decoding must not take the serving process's GIL)
_SINK_SERVER = r"""
import json, sys, threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

state = {"rows": {}, "anomaly_windows": {}, "health_status": 200, "health_puts": 0}
lock = threading.Lock()


class Handler(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def _read(self):
        return json.loads(self.rfile.read(int(self.headers.get("Content-Length") or 0)) or b"null")

    def _reply(self, status, body=b""):
        self.send_response(status)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        with lock:
            body = json.dumps(state).encode()
        self._reply(200, body)

    def do_POST(self):
        body, ep = self._read(), self.path.partition("?")[0]
        with lock:
            if ep == "/control/":
                state["health_status"] = int(body["health_status"])
            else:
                rows = body.get("data", []) if isinstance(body, dict) else []
                state["rows"][ep] = state["rows"].get(ep, 0) + len(rows)
                if ep == "/anomalies/":
                    for r in rows:
                        w = str(r[0])
                        state["anomaly_windows"][w] = state["anomaly_windows"].get(w, 0) + 1
        self._reply(200)

    def do_PUT(self):
        self._read()
        with lock:
            state["health_puts"] += 1
            status = state["health_status"]
        self._reply(status)


server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
server.daemon_threads = True
print(server.server_port, flush=True)
threading.Thread(target=server.serve_forever, daemon=True).start()
sys.stdin.read()  # serves until its parent closes the pipe
"""


class BackendSink:
    """A backend on loopback, in a process of its own: records the rows of
    every POST by endpoint (``/requests/``, ``/anomalies/``, ...) and the
    anomaly rows by window, and answers the health checker's PUT
    ``/healthcheck/`` with the status ``set_health`` gave (402 commands
    the service to stop). ``snapshot()`` reads what it recorded."""

    def __init__(self):
        self._proc = subprocess.Popen([sys.executable, "-c", _SINK_SERVER], stdin=subprocess.PIPE,
                                      stdout=subprocess.PIPE, text=True)
        line = self._proc.stdout.readline()
        require(line.strip().isdigit(), f"the backend sink did not start: {line!r}")
        self.url = f"http://127.0.0.1:{int(line)}"

    def _call(self, method: str, path: str, body=None) -> dict:
        import urllib.request

        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(self.url + path, data=data, method=method)
        with urllib.request.urlopen(req, timeout=30) as r:
            out = r.read()
        return json.loads(out) if out else {}

    def set_health(self, status: int) -> None:
        self._call("POST", "/control/", {"health_status": status})

    def snapshot(self) -> dict:
        out = self._call("GET", "/")
        out["anomaly_windows"] = {int(k): v for k, v in out["anomaly_windows"].items()}
        return out

    def close(self) -> None:
        if self._proc.poll() is None:
            self._proc.stdin.close()
            try:
                self._proc.wait(10)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait(10)
        self._proc.stdout.close()


def agent_frames(sim, rows: int = LIVE_L7_FRAME_ROWS) -> tuple:
    """A Python agent's frames of ``sim``'s traffic (after ``setup()``):
    the TCP establishes, then the L7 events in frames of ``rows``.
    Returns (frames, TCP rows, L7 rows)."""
    from alaz_tpu_torch.sources.ingest_server import KIND_L7, KIND_TCP, pack_frame

    tcp = sim.tcp_events()
    frames, l7 = [pack_frame(KIND_TCP, tcp)], 0
    for b in sim.iter_l7_batches():
        for i in range(0, b.shape[0], rows):
            frames.append(pack_frame(KIND_L7, b[i:i + rows]))
        l7 += b.shape[0]
    return frames, tcp.shape[0], l7


def send_frames(path: str, frames) -> float:
    """``frames`` over one unix-socket connection, flat out; returns the
    seconds the sends took."""
    import socket

    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(120)
    t0 = time.perf_counter()
    try:
        s.connect(path)
        for f in frames:
            s.sendall(f)
    finally:
        s.close()
    return time.perf_counter() - t0


def _until(pred, what: str, timeout_s: float, poll_s: float = 0.01) -> float:
    t0 = time.perf_counter()
    while not pred():
        require(time.perf_counter() - t0 < timeout_s, f"timed out after {timeout_s} s waiting for {what}")
        time.sleep(poll_s)
    return time.perf_counter() - t0


def scrape(port: int) -> dict:
    """The debug server's ``/metrics`` as {name: value} and its ``/stats``."""
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
        text = r.read().decode()
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=10) as r:
        stats = json.loads(r.read())
    out = {}
    for line in text.splitlines():
        name, _, value = line.partition(" ")
        if line and not line.startswith("#") and "{" not in name:
            try:
                out[name] = float(value)
            except ValueError:
                pass
    return {"metrics": out, "stats": stats}


def run_live_cli(module: str, argv: list, env: dict, socket_path: str, frames, rows: int, min_windows: int,
                 scored: bool, tcp_rows: int = 0, k8s_msgs: int = 0, timeout_s: float = 300.0) -> dict:
    """``python -m <module> serve --ingest-socket`` as an operator runs it,
    with no ``--config``: once it serves and has taken in ``k8s_msgs``
    K8s messages (its debug server's ``k8s_in``), the first frame (the
    agent's ``tcp_rows`` TCP establishes) sent and taken in (``tcp_in``,
    then ``LIVE_TCP_SETTLE_S``), the rest flat out; then
    (read from its debug server) every row taken in, at least
    ``min_windows`` windows closed and, where ``scored``, scored, the L7
    queue empty; then SIGINT. Returns its exit code, its standard
    output's last line, the scrape before the signal and the seconds."""
    import signal

    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", module, "serve", "--ingest-socket", socket_path,
                             "--debug-port", "0", *argv], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    out_lines, err_lines, port = [], [], []

    def read_out():
        out_lines.extend(proc.stdout)

    def read_err():
        for line in proc.stderr:
            err_lines.append(line)
            m = re.search(r"serving; debug http on :(\d+)", line)
            if m:
                port.append(int(m.group(1)))

    readers = [threading.Thread(target=fn, name=f"smoke-cli-{fn.__name__}", daemon=True)
               for fn in (read_out, read_err)]
    for r in readers:
        r.start()
    try:
        _until(lambda: port or proc.poll() is not None, "the CLI to serve", timeout_s, 0.05)
        require(proc.poll() is None, f"{module} serve exited {proc.returncode}: {''.join(err_lines)[-3000:]}")
        if k8s_msgs:
            _until(lambda: scrape(port[0])["stats"]["aggregator"]["k8s_in"] >= k8s_msgs, "the K8s LIST",
                   timeout_s, 0.05)
        if tcp_rows:
            send_frames(socket_path, frames[:1])
            _until(lambda: scrape(port[0])["stats"]["aggregator"]["tcp_in"] >= tcp_rows, "the TCP establishes",
                   timeout_s, 0.05)
            time.sleep(LIVE_TCP_SETTLE_S)
            frames = frames[1:]
        send_s = send_frames(socket_path, frames)

        def settled():
            snap = scrape(port[0])
            m, st = snap["metrics"], snap["stats"]
            closed = m.get("alaz_tpu_windows_closed", 0)
            return (m.get("alaz_tpu_ingest_socket_records", 0) >= rows and closed >= min_windows
                    and (not scored or st["scored_batches"] == closed) and st["queues"]["l7"]["pending_batches"] == 0)

        _until(settled, f"{module} serve to take {rows} rows and close {min_windows} windows", timeout_s, 0.2)
        last = scrape(port[0])
        proc.send_signal(signal.SIGINT)
        proc.wait(120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        for r in readers:
            r.join(10)
    return {"exit_code": proc.returncode, "last_line": ("".join(out_lines).strip().splitlines() or [""])[-1],
            "scrape": last, "send_s": send_s, "command_s": time.perf_counter() - t0,
            "stderr": "".join(err_lines), "stderr_tail": "".join(err_lines)[-2000:]}


def _live_inprocess(native_host: dict, device: str, sim_cfg=None) -> tuple:
    """Config5's pods from the fake API server through the K8s watch, an
    agent's frames over the unix socket, request rows and scores exported
    over HTTP, a stretch of health 402s, GraphSAGE on the card."""
    from collections import Counter

    from alaz_tpu_torch.config import BackendConfig, ModelConfig, QueueConfig, RuntimeConfig
    from alaz_tpu_torch.datastore.backend import BatchingBackend, http_transport
    from alaz_tpu_torch.events.intern import Interner
    from alaz_tpu_torch.events.k8s import ResourceType
    from alaz_tpu_torch.events.schema import make_l7_events
    from alaz_tpu_torch.models.registry import init_params
    from alaz_tpu_torch.ops import segment_kernels as K
    from alaz_tpu_torch.replay.simulator import Simulator
    from alaz_tpu_torch.runtime.health import HealthChecker, HealthState
    from alaz_tpu_torch.runtime.service import Service
    from alaz_tpu_torch.sources.ingest_server import IngestServer
    from alaz_tpu_torch.sources.k8s_watch import K8sWatchSource

    work = Path("build/chip_smoke")
    work.mkdir(parents=True, exist_ok=True)
    full_s = None
    if sim_cfg is None:
        sim_cfg, full_s = _replay_config(LIVE_CONFIG, LIVE_DURATION_S)
    sim = Simulator(sim_cfg, interner=Interner())  # the agent's: the service learns names from the watch
    msgs = sim.setup()
    t0 = time.perf_counter()
    frames, tcp_rows, l7_rows = agent_frames(sim)
    agent_s = time.perf_counter() - t0
    want = Counter(m.resource_type for m in msgs)
    want[ResourceType.CONTAINER] = sum(1 for m in msgs if m.resource_type == ResourceType.POD and m.object.image)
    api, sink = FakeApiServer(api_items(msgs)), BackendSink()
    mcfg = ModelConfig()
    require((mcfg.hidden_dim, mcfg.num_layers, mcfg.dtype, mcfg.use_pallas) == (128, 2, "bfloat16", True),
            f"unexpected ModelConfig {mcfg}")
    cfg = RuntimeConfig(model=mcfg, window_s=1.0, score_batch_windows=1, engine_backend="native",
                        queues=dataclasses.replace(QueueConfig(), kube_events=LIVE_KUBE_EVENTS,
                                                   l7_events=LIVE_L7_EVENTS),
                        backend=dataclasses.replace(BackendConfig(), host=sink.url))
    params = init_params(mcfg, key=0, device=device)
    interner = Interner()
    backend = BatchingBackend(http_transport(cfg.backend.host), interner, cfg.backend)
    sunk, windows, latency = [], [], []

    def score_sink(sb):  # the service's default wiring to the backend, recorded
        sunk.append(sb)
        backend.persist_scores(sb)

    svc = Service(config=cfg, interner=interner, model_state=params, export_backend=backend,
                  score_sink=score_sink, score_threshold=0.0, device=device)
    svc.score_observer = lambda batch, tenant, lat: (windows.append(batch), latency.append(lat))
    received = Counter()
    submit_k8s = svc.submit_k8s

    def counting_submit(msg, tenant: int = 0):
        received[msg.resource_type] += 1
        return submit_k8s(msg, tenant)

    svc.submit_k8s = counting_submit
    transitions = []

    def on_stop():
        transitions.append(HealthState.STOPPED.value)
        svc.pause()

    def on_resume():
        transitions.append(HealthState.RUNNING.value)
        svc.resume()

    hc = HealthChecker(http_transport(cfg.backend.host), interval_s=0.5, on_stop=on_stop, on_resume=on_resume,
                       metrics_snapshot=svc.metrics.snapshot, degraded_snapshot=svc.degraded_snapshot)
    k8s_src = K8sWatchSource(api_server=api.url, resync_interval_s=3600.0)
    srv = IngestServer(svc, path=str(work / "live.sock"))
    raised, hook = [], threading.excepthook
    threading.excepthook = raised.append
    compile_plane = {}
    try:
        backend.start()
        with _started_under_budgets(svc, compile_plane):
            t0 = time.perf_counter()
            k8s_src.start(svc)
            _until(lambda: sum(received.values()) >= sum(want.values()), "the K8s LIST", 300)
            list_s = time.perf_counter() - t0
            svc.drain(300)
            k8s_s = time.perf_counter() - t0
            require(k8s_src.live and dict(received) == dict(want),
                    f"the K8s watch delivered {dict(received)}, setup() has {dict(want)}")
            require(svc.k8s_queue.dropped == 0, f"{svc.k8s_queue.dropped} K8s messages shed")
            srv.start()
            hc.start()
            # the agent's connections first, taken in before their requests
            # (the join retries a request for 60 ms, less than a 40,000-row
            # TCP batch takes: see PERF.md), as phase_serve's replay does
            send_frames(str(work / "live.sock"), frames[:1])
            _until(lambda: srv.records >= tcp_rows, "the TCP establishes", 60)
            svc.drain(300)
            _sync(svc.torch_device)
            K.reset_launch_counts()
            t1 = time.perf_counter()
            send_s = send_frames(str(work / "live.sock"), frames[1:])
            _until(lambda: srv.records + srv.quarantined_frames >= tcp_rows + l7_rows or srv.bad_frames,
                   "the ingest server to take every frame", 300)
            svc.drain(600)
            svc.flush_windows()
            svc.drain(600)
            _sync(svc.torch_device)
            wall = time.perf_counter() - t1
            launches = K.launch_counts()
            # the backend commands a stop (402), then a resume
            sink.set_health(402)
            _until(lambda: hc.state == HealthState.STOPPED and svc._paused.is_set(), "the health stop", 30)
            refused = not svc.submit_l7(make_l7_events(1))
            sink.set_health(200)
            _until(lambda: hc.state == HealthState.RUNNING and not svc._paused.is_set(), "the health resume", 30)
    finally:
        for stop in (srv.stop, hc.stop, k8s_src.stop, svc.stop, backend.stop, api.close):
            stop()
        threading.excepthook = hook
    try:
        posted = sink.snapshot()
    finally:
        sink.close()
    require(raised == [], f"serve_live: a thread raised: {[(a.thread.name, repr(a.exc_value)) for a in raised]}")
    require((srv.bad_frames, srv.quarantined_frames, srv.resyncs, srv.unsupported_frames) == (0, 0, 0, 0),
            f"serve_live: bad {srv.bad_frames}, quarantined {srv.quarantined_frames}, resyncs {srv.resyncs}")
    require(srv.records == tcp_rows + l7_rows and srv.frames == len(frames),
            f"serve_live: the server took {srv.records} rows in {srv.frames} frames, the agent sent "
            f"{tcp_rows + l7_rows} in {len(frames)}")
    closed = svc.metrics.counter("windows.closed").value
    require(closed >= 1 and svc.scored_batches == closed == len(windows) == len(sunk),
            f"serve_live: scored {svc.scored_batches} of {closed} closed windows")
    emitted = sum(b.aggregated_rows() for b in windows)
    gap = svc.ledger.conservation_gap(l7_rows, emitted)
    require(gap == 0, f"serve_live: L7 rows sent {l7_rows} != emitted {emitted} + ledger {svc.ledger.total}")
    d = svc.score_dispatches
    if svc.torch_device.type == "cuda":
        require(launches == _counts(2 * d, d, 0, 0), f"serve_live: launches {launches} for {d} dispatches")
    require(transitions == ["stopped", "running"] and refused, f"serve_live: health transitions {transitions}, "
                                                              f"submit while stopped refused: {refused}")
    stats = backend.stats()
    require(posted["rows"].get("/requests/", 0) == stats["requests"]["sent"] > 0
            and stats["requests"]["failed"] == stats["requests"]["shed"] == 0,
            f"serve_live: request rows at the sink {posted['rows'].get('/requests/')}, backend {stats['requests']}")
    per_window = {b.window_start_ms: b.n_edges for b in windows}
    require(posted["anomaly_windows"] == per_window, f"serve_live: anomaly rows by window "
                                                     f"{posted['anomaly_windows']}, edges by window {per_window}")
    scores = {sb.window_start_ms: sb.score for sb in sunk}
    plain_cfg = dataclasses.replace(cfg, backend=BackendConfig())
    with plain_kernels():
        plain = _serve_once(plain_cfg, params, backlog=windows, device=device)
    vs_plain = _scores_agree("serve_live vs plain", scores, plain["scores"])
    require(vs_plain["max_abs_err"] == 0.0, f"serve_live: scores differ from the plain versions' by "
                                             f"{vs_plain['max_abs_err']}")
    lat = np.array(latency)
    shed = svc.ledger.snapshot().get("shed", 0)
    export = _export_cost(interner)
    live = {
        "replay": {"config": LIVE_CONFIG if full_s else None, "testDuration_s": [full_s, sim_cfg.test_duration_s],
                   "pods": sim_cfg.pod_count,
                   "services": sim_cfg.service_count, "edges": sim_cfg.edge_count, "rate_per_edge": sim_cfg.edge_rate},
        "k8s": {"messages": {k.value: v for k, v in received.items()}, "list_and_translate_s": list_s,
                "until_processed_s": k8s_s},
        "agent": {"frames": len(frames), "tcp_rows": tcp_rows, "l7_rows": l7_rows, "pack_s": agent_s,
                  "send_s": send_s, "l7_frame_rows": LIVE_L7_FRAME_ROWS},
        "server": {k: getattr(srv, k) for k in ("frames", "records", "bad_frames", "unsupported_frames",
                                                  "quarantined_frames", "resyncs")},
        "conservation": {"l7_sent": l7_rows, "emitted": emitted, "ledger": svc.ledger.snapshot(), "gap": gap},
        "windows_closed": closed, "windows_scored": svc.scored_batches, "score_dispatches": d,
        "edges_per_window": [b.n_edges for b in windows],
        "wall_s": wall,
        "events_per_s_taken": (l7_rows - shed) / wall,
        "events_per_s_offered": l7_rows / wall,
        "close_to_score_s": {"p50": float(np.percentile(lat, 50)), "p99": float(np.percentile(lat, 99))},
        "scorer_busy_s_per_window": svc._scorer_busy_s / max(svc.scored_batches, 1),
        "launches": launches,
        "compile_plane": compile_plane,
        "sink_rows": posted["rows"], "backend": stats, "health": {"transitions": transitions,
                                                                  "puts": posted["health_puts"]},
        "vs_plain_versions": vs_plain,
        "beside_serve_native_config5": native_host.get("graphsage"),
        "export_cost_per_request_row": export,
    }
    emit("serve_live_config5", live)
    return launches, live


def _export_cost(interner, n: int = 100_000) -> dict:
    """The HTTP export leg's host cost a request row, alone on one thread:
    ``BatchingBackend.persist_requests`` (rows to payload lists, names
    resolved through ``interner``) and the JSON encoding of a 1,000-row
    batch, as ``http_transport`` encodes it."""
    from alaz_tpu_torch.datastore import dto
    from alaz_tpu_torch.datastore.backend import BatchingBackend

    rows = dto.make_requests(n)
    rows["start_time_ms"] = 1_700_000_000_000 + np.arange(n)
    rows["from_ip"], rows["to_ip"] = 0x0A000001, 0x0A600001
    rows["from_type"], rows["to_type"], rows["protocol"], rows["method"], rows["status_code"] = 1, 2, 1, 1, 200
    rows["from_uid"] = np.arange(n) % max(len(interner), 1)
    rows["to_uid"] = (np.arange(n) * 7) % max(len(interner), 1)
    be = BatchingBackend(lambda endpoint, payload: 200, interner)
    t0 = time.perf_counter()
    be.persist_requests(rows)
    persist_s = time.perf_counter() - t0
    batch = {"data": be._streams["requests"].pending[:1000]}
    t0 = time.perf_counter()
    for _ in range(n // 1000):
        json.dumps(batch).encode()
    json_s = time.perf_counter() - t0
    return {"rows": n, "persist_us": 1e6 * persist_s / n, "json_us": 1e6 * json_s / n}


def _live_agent(device: str) -> tuple:
    """``agent_example`` (built with g++ from the checkout) sends its
    AlzRecords to a Service with the C++ window accumulator on the card:
    three windows closed and scored, equal to the plain versions'."""
    from alaz_tpu_torch.config import ModelConfig, RuntimeConfig
    from alaz_tpu_torch.events.intern import Interner
    from alaz_tpu_torch.graph import native
    from alaz_tpu_torch.models.registry import init_params
    from alaz_tpu_torch.ops import segment_kernels as K
    from alaz_tpu_torch.runtime.service import Service
    from alaz_tpu_torch.sources.ingest_server import IngestServer

    import hashlib

    t0 = time.perf_counter()
    exe = native.build_agent(force=True)
    build_s = time.perf_counter() - t0
    stamp = hashlib.sha256(Path("alaz_tpu_torch/native/agent_example.cc").read_bytes()).hexdigest()[:16]
    require(f"ALZ_SOURCE_STAMP:{stamp}".encode() in exe.read_bytes(), f"{exe} does not carry stamp {stamp}")
    mcfg = ModelConfig()
    cfg = RuntimeConfig(model=mcfg, window_s=1.0, score_batch_windows=1)
    params = init_params(mcfg, key=0, device=device)
    sunk, windows = [], []
    svc = Service(config=cfg, interner=Interner(), model_state=params, score_sink=sunk.append,
                  score_threshold=0.0, use_native_ingest=True, device=device)
    svc.score_observer = lambda batch, tenant, lat: windows.append(batch)
    path = Path("build/chip_smoke/agent.sock")
    srv = IngestServer(svc, path=str(path))
    compile_plane = {}
    try:
        srv.start()
        with _started_under_budgets(svc, compile_plane):
            _sync(svc.torch_device)
            K.reset_launch_counts()
            run = subprocess.run([str(exe), str(path), str(AGENT_RECORDS)], capture_output=True, text=True,
                                 timeout=60)
            require(run.returncode == 0, f"agent_example exited {run.returncode}: {run.stderr[-2000:]}")
            _until(lambda: srv.records >= AGENT_RECORDS, "the agent's records", 60)
            svc.flush_windows()
            svc.drain(120)
        _sync(svc.torch_device)
        launches = K.launch_counts()
    finally:
        srv.stop()
        svc.stop()
        svc.graph_store.close()
    d = svc.score_dispatches
    require(srv.records == AGENT_RECORDS and srv.bad_frames == 0, f"agent: the server took {srv.records} rows")
    require(svc.scored_batches == len(windows) == len(sunk) == 3, f"agent: {svc.scored_batches} windows scored")
    if svc.torch_device.type == "cuda":
        require(launches == _counts(2 * d, d, 0, 0), f"agent: launches {launches} for {d} dispatches")
    with plain_kernels():
        plain = _serve_once(cfg, params, backlog=windows, device=device)
    vs_plain = _scores_agree("serve_live agent vs plain", {sb.window_start_ms: sb.score for sb in sunk},
                             plain["scores"])
    require(vs_plain["max_abs_err"] == 0.0, f"agent: scores differ from the plain versions' by "
                                             f"{vs_plain['max_abs_err']}")
    out = {"binary": str(exe.relative_to(Path.cwd().resolve())) if exe.is_absolute() else str(exe),
           "stamp": stamp, "gxx_build_s": build_s, "records": srv.records, "frames": srv.frames,
           "windows": [b.window_start_ms for b in windows], "edges_per_window": [b.n_edges for b in windows],
           "launches": launches, "compile_plane": compile_plane, "vs_plain_versions": vs_plain}
    emit("serve_live_agent", out)
    return launches, out


def _live_cli(sim_cfg=None, device_args: tuple = ()) -> dict:
    """``python -m alaz_tpu_torch serve --ingest-socket`` as an operator
    runs it, with no ``--config``: config3's pods from the fake API server
    (``K8S_API_SERVER``), its frames (cut to 2.1 s) from an agent, the
    requests flat out once the connections are in, the native engine
    (``ENGINE_BACKEND``) and the queues sized to the burst, no export
    backend (the in-process run has it), GraphSAGE at full width from a
    checkpoint of seed-0 weights; stopped by SIGINT once every row is in
    and two windows are scored. Its summary: every closed window scored,
    every row sent taken in."""
    from alaz_tpu_torch.config import ModelConfig
    from alaz_tpu_torch.events.intern import Interner
    from alaz_tpu_torch.models.registry import init_params
    from alaz_tpu_torch.replay.simulator import Simulator
    from alaz_tpu_torch.train import checkpoint

    work = Path("build/chip_smoke")
    ckpt = work / "live_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    mcfg = ModelConfig()
    checkpoint.save(ckpt, 0, init_params(mcfg, key=0, device="cpu"), contract=checkpoint.feature_contract(mcfg))
    full_s = None
    if sim_cfg is None:
        sim_cfg, full_s = _replay_config(LIVE_CLI_CONFIG, LIVE_CLI_DURATION_S)
    sim = Simulator(sim_cfg, interner=Interner())
    msgs = sim.setup()
    frames, tcp_rows, l7_rows = agent_frames(sim)
    api = FakeApiServer(api_items(msgs))
    env = {k: v for k, v in os.environ.items()
           if k not in ("MODEL", "EDGE_LAYOUT", "LOCAL_PIDS", "INGEST_SOCKET", "INGEST_BACKEND", "BACKEND_HOST")}
    env.update(K8S_API_SERVER=api.url, KUBE_EVENTS_BUFFER_SIZE=str(LIVE_KUBE_EVENTS),
               EVENTS_BUFFER_SIZE=str(LIVE_L7_EVENTS), ENGINE_BACKEND="native")
    sock = work / "live_cli.sock"
    try:
        n_k8s = len(msgs) + sum(1 for m in msgs if m.resource_type.value == "Pod" and m.object.image)
        run = run_live_cli("alaz_tpu_torch", ["--ckpt", str(ckpt), *device_args], env, str(sock), frames,
                           tcp_rows + l7_rows, SERVE_CLI_MIN_WINDOWS, scored=True, tcp_rows=tcp_rows,
                           k8s_msgs=n_k8s)
    finally:
        api.close()
    require(run["exit_code"] == 0, f"serve --ingest-socket exited {run['exit_code']}: {run['stderr_tail']}")
    summary = json.loads(run["last_line"])
    require(summary["windows_scored"] == summary["windows_closed"] >= SERVE_CLI_MIN_WINDOWS
            and summary["edges_scored"] > 0, f"serve --ingest-socket: {summary}")
    require(summary["events"] == tcp_rows + l7_rows, f"serve --ingest-socket took {summary['events']} rows, "
                                                     f"the agent sent {tcp_rows + l7_rows}")
    require("k8s informers watching" in run["stderr"], "serve --ingest-socket: the K8s watch is not live")
    out = {"replay": {"config": LIVE_CLI_CONFIG if full_s else None,
                      "testDuration_s": [full_s, sim_cfg.test_duration_s]},
           "summary": summary, "rows_sent": tcp_rows + l7_rows, "send_s": run["send_s"],
           "command_s": run["command_s"], "aggregator": run["scrape"]["stats"]["aggregator"],
           "ledger": {k: v for k, v in run["scrape"]["metrics"].items() if k.startswith("alaz_tpu_ledger_")}}
    emit("serve_live_cli", out)
    return out


def _live_chaos() -> dict:
    """``python -m alaz_tpu_torch.chaos --seed 0``: the pipeline, frame
    and backend legs (and the composed scenario) with no finding."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "alaz_tpu_torch.chaos", "--seed", "0"],
                          capture_output=True, text=True, timeout=600)
    reports = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    require(proc.returncode == 0, f"chaos CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    suite = [r for r in reports if "pipeline" in r]
    require(len(suite) == 1 and all(suite[0][leg] for leg in ("pipeline", "frames", "backend"))
            and suite[0]["findings"] == [], f"chaos CLI: {reports}")
    out = {"legs": {leg: sorted(suite[0][leg]) for leg in ("pipeline", "frames", "backend")},
           "reports": len(reports), "command_s": time.perf_counter() - t0}
    emit("serve_live_chaos", out)
    return out


def phase_serve_live(native_host: dict, device: str = "cuda") -> dict:
    """Live ingest as deployed: the K8s watch over a fake API server with
    config5's pods and services, an agent's frames over the unix socket,
    request rows and scores exported over HTTP to a sink whose health
    answers stop and resume the Service, GraphSAGE on the card at full
    width (``_live_inprocess``); ``agent_example``'s records into the C++
    window accumulator (``_live_agent``); the ``serve`` CLI stopped by
    SIGINT (``_live_cli``); the chaos CLI (``_live_chaos``). Returns the
    launch counts of the two in-process runs."""
    inproc, _ = _live_inprocess(native_host, device)
    agent, _ = _live_agent(device)
    _live_cli()
    _live_chaos()
    return {"serve_live": inproc, "serve_live_agent": agent}


# -- the sanitizers and the device-side observability -------------------------

# config3's GAT on the native engine and store, cut to one full window and
# a tenth: the lock-order monitor's run
SANITIZE_RUN = ("testconfig/config3_10k_mixed.json", 1.1,
                {"model": "gat", "src_gather": "banded", "edge_layout": "blocked"},
                {"engine_backend": "native", "renumber_nodes": True, "edge_layout": "blocked"})


def phase_sanitize(device: str = "cuda", run=SANITIZE_RUN) -> dict:
    """The Service on the card built under ``lockorder.instrument()`` (its
    queues, the native store, the aggregators and every lock the run
    creates wrapped), GAT banded, renumbered and blocked on config3's
    traffic through the C++ engine and window accumulator (K1-K3): the
    observed lock-order graph acyclic, every window scored, each equal to
    its rescore on the plain versions (max error 0.0); the compile plane
    and budgets as in every serve run."""
    from alaz_tpu_torch.config import ModelConfig, RuntimeConfig
    from alaz_tpu_torch.models.registry import init_params
    from alaz_tpu_torch.sanitize import lockorder

    path, duration_s, model_kw, runtime_kw = run
    sim_cfg, full_s = _replay_config(path, duration_s) if isinstance(path, str) else (path, None)
    mcfg = ModelConfig(**model_kw)
    cfg = RuntimeConfig(model=mcfg, window_s=1.0, score_batch_windows=1, **runtime_kw)
    params = init_params(mcfg, key=0, device=device)
    t0 = time.perf_counter()
    with lockorder.instrument() as mon:
        served = _serve_once(cfg, params, sim_cfg=sim_cfg, device=device, use_native_ingest=True)
    served_s = time.perf_counter() - t0
    graph = mon.graph_summary()
    mon.assert_acyclic()
    require(graph["locks"] >= 8 and graph["acquisitions"] > 100, f"sanitize: a thin lock graph {graph}")
    require(served["summary"]["windows_scored"] >= 1, "sanitize: no window scored")
    _require_launches("gat", served)
    with plain_kernels():
        plain = _serve_once(cfg, params, backlog=served["windows"], device=device)
    vs_plain = _scores_agree("sanitize vs plain", served["scores"], plain["scores"])
    require(vs_plain["max_abs_err"] == 0.0, f"sanitize: scores differ from the plain versions' by "
                                             f"{vs_plain['max_abs_err']}")
    out = {"replay": {"config": path if isinstance(path, str) else None,
                      "testDuration_s": [full_s, sim_cfg.test_duration_s]},
           "lock_graph": graph, "acyclic": True, "violations": len(mon.violations),
           "serial": {k: served["summary"][k] for k in ("windows_scored", "score_dispatches", "events_per_s",
                                                         "launches", "compile_plane")},
           "vs_plain_versions": vs_plain, "instrumented_run_s": served_s,
           "seconds": time.perf_counter() - t0}
    print("lock graph:", json.dumps(graph))
    emit("sanitize", out)
    return {"sanitize_gat": served["summary"]["launches"]}


GPU_ENV_SMI_FIELDS = "memory.total,memory.used,temperature.gpu,clocks.sm,power.draw"


def _smi_values() -> list:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={GPU_ENV_SMI_FIELDS}", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    return [float(v) for v in out.stdout.strip().splitlines()[0].split(",")]


def phase_gpu_env() -> dict:
    """The NVML collector (``runtime/gpu_env.py``) on the card: it
    registers, with every default leg under the JAX package's gauge names;
    its gauges read between two ``nvidia-smi`` readings agree with them:
    device memory in MiB exactly, temperature within 3 °C, SM clock and
    power within the two readings' range ±10%."""
    from alaz_tpu_torch.runtime.gpu_env import DEFAULT_METRICS, GpuEnvCollector, gauge_suffix
    from alaz_tpu_torch.runtime.metrics import Metrics

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    before = _smi_values()
    metrics = Metrics()
    require(GpuEnvCollector().register(metrics), "GpuEnvCollector: NVML answered nothing on the card")
    gauges = {k: v for k, v in metrics.snapshot().items() if k.startswith("device")}
    after = _smi_values()
    for leg in DEFAULT_METRICS:
        require(f"device0.{gauge_suffix(leg)}" in gauges, f"gpu_env: no {leg} gauge")
    smi = {f: [b, a] for f, b, a in zip(GPU_ENV_SMI_FIELDS.split(","), before, after)}
    total_mib = int(gauges["device0.runtime_hbm_total_bytes"]) // 2**20
    require(total_mib == int(before[0]), f"gpu_env: memory.total {total_mib} MiB, nvidia-smi {before[0]}")
    temp = gauges["device0.temperature_c"]
    require(min(before[2], after[2]) - 3 <= temp <= max(before[2], after[2]) + 3,
            f"gpu_env: temperature {temp} °C, nvidia-smi {before[2]} / {after[2]}")
    for i, leg in ((3, "sm_clock_mhz"), (4, "power_draw_w")):
        got = gauges[f"device0.{leg}"]
        lo, hi = min(before[i], after[i]) * 0.9, max(before[i], after[i]) * 1.1
        require(lo <= got <= hi, f"gpu_env: {leg} {got} outside [{lo}, {hi}] (nvidia-smi {before[i]}, {after[i]})")
    out = {"card": card_line(), "gauges": gauges, "nvidia_smi": smi, "memory_total_mib": total_mib,
           "seconds": time.perf_counter() - t0}
    emit("gpu_env", out)
    return out


def phase_prefetch(batches, device: str = "cuda") -> dict:
    """The slice phase's three n131072xe1048576 GraphSAGE windows (hidden
    128, 2 layers, bf16, kernels on) iterated twice: through
    ``WindowScorer`` (a pageable copy inside each score) and through
    ``DevicePrefetcher`` (window N+1's copy from page-locked buffers on a
    side stream while N scores), each timed with CUDA events and the host
    clock; the scores equal bit for bit."""
    from alaz_tpu_torch.config import ModelConfig
    from alaz_tpu_torch.models.registry import init_params
    from alaz_tpu_torch.runtime.pipeline import DevicePrefetcher
    from alaz_tpu_torch.runtime.scorer import WindowScorer
    from alaz_tpu_torch.train.trainstep import make_score_fn

    t_phase = time.perf_counter()
    cfg = ModelConfig()
    params = init_params(cfg, key=0, device=device)
    scorer = WindowScorer(cfg, params, device=device)
    score_fn = make_score_fn(cfg, device)
    dev = torch.device(device)

    def timed(run) -> tuple:
        _sync(dev)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2)) if dev.type == "cuda" else (None, None)
        t0 = time.perf_counter()
        if start is not None:
            start.record()
        scores, marks = run()
        if end is not None:
            end.record()
        _sync(dev)
        wall = time.perf_counter() - t0
        per = np.diff([t0] + marks).tolist()
        return scores, {"host_s": wall, "device_ms": start.elapsed_time(end) if start is not None else None,
                        "per_window_host_s": per}

    def plain_feed():
        scores, marks = [], []
        for b in batches:
            scores.append(scorer.score(b))
            marks.append(time.perf_counter())
        return scores, marks

    def prefetched():
        scores, marks = [], []
        for b, tensors in DevicePrefetcher(batches, device=device):
            scores.append(torch.sigmoid(score_fn(params, tensors)["edge_logits"][: b.n_edges]).cpu().numpy())
            marks.append(time.perf_counter())
        return scores, marks

    plain_feed()  # warm both paths once
    prefetched()
    ref, without = timed(plain_feed)
    got, with_pf = timed(prefetched)
    ref2, without2 = timed(plain_feed)
    got2, with_pf2 = timed(prefetched)
    for r, g in zip(ref + ref2, got + got2):
        require(r.shape == g.shape and np.array_equal(r, g), "prefetch: scores differ from WindowScorer's")
    out = {"bucket": batches[0].bucket_key, "windows": len(batches),
           "window_scorer": [without, without2], "device_prefetcher": [with_pf, with_pf2],
           "bit_equal": True, "dispatch_recording": _dispatch_recording_cost(score_fn, params, batches[0], dev),
           "seconds": time.perf_counter() - t_phase}
    emit("prefetch", out)
    return out


def _dispatch_recording_cost(score_fn, params, batch, dev, reps: int = 10) -> dict:
    """What the launch-budget recording costs a dispatch: one window's
    ``score_apply`` and readback on staged tensors, timed with no compile
    watcher open and with one open (each dispatch then reads the kernels'
    launch counts twice), in blocks of ``reps``, in turns (off, on, on,
    off); and ``dispatch()``'s own host time with a watcher open, over
    10,000 empty blocks."""
    from alaz_tpu_torch.sanitize.retrace import CompileWatcher, dispatch

    graph = {k: torch.from_numpy(v).to(dev) for k, v in batch.device_arrays().items()}

    def block() -> list:
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            score_fn(params, graph)["edge_logits"].cpu()
            times.append(time.perf_counter() - t0)
        return times

    block()
    off, on = [], []
    for watched in (False, True, True, False):
        if watched:
            with CompileWatcher() as w:
                on += block()
            require(w.dispatch_total == reps, f"dispatch recording: {w.dispatch_total} of {reps} dispatches")
        else:
            off += block()
    with CompileWatcher():
        t0 = time.perf_counter()
        for _ in range(10_000):
            with dispatch("score_apply", graph):
                pass
        per_record = (time.perf_counter() - t0) / 10_000
    return {"dispatch_ms_median_unwatched": 1e3 * statistics.median(off),
            "dispatch_ms_median_watched": 1e3 * statistics.median(on),
            "dispatch_ms_unwatched": [1e3 * t for t in off], "dispatch_ms_watched": [1e3 * t for t in on],
            "record_us": 1e6 * per_record}


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
    sort_launches = K.sort_by_ids.launches
    SORT_LAUNCHES[tag] = sort_launches
    if on_card:
        require(launches == TRAIN_LAUNCHES[cfg.model],
                f"{tag}: launches of one forward and backward {launches}, expected {TRAIN_LAUNCHES[cfg.model]}")
        # each K3 backward (a K4 launch: GAT's three) sorts edge_src
        want = launches["pallas_gather_scatter_sum"] if cfg.src_gather == "banded" else 0
        require(sort_launches == want, f"{tag}: {sort_launches} sort launches, expected {want}")
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
        "sort_launches_forward_backward": sort_launches,
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
    from alaz_tpu_torch.ops import gru_kernels as G
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
    gru0 = G.gru_update.launches
    t0 = time.perf_counter()
    state, losses = train_tgn_unrolled(cfg, labelled, epochs=1, device=dev)
    epoch_s = time.perf_counter() - t0
    launches = K.launch_counts()
    n = len(batches)
    require(G.gru_update.launches == gru0, "tgn unrolled: the GRU kernel ran under autograd")
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


# -- parallel: the sharded steps, node-sharded forwards, halo and GPipe on ranks ---

PARALLEL_LR = 3e-3
PARALLEL_STEPS = 3  # sharded train steps held against the single-device steps
PARALLEL_EXPERT_STEPS = 2  # the experts' sharded steps: the second loss sees the first update
# past one rank the dp all-reduce sums the windows' f32 gradients in
# another order than the single-device backward, so they differ in their
# last bits; AdamW's first steps normalise each element (lr·g/(|g|+eps)),
# so a parameter whose gradient is near 0 may step either way (2·lr
# apart). Held at 1% of the update's L2 norm: a few such flips in 10^5
# parameters; a missing, zero or wrong-sign update misses by 100% or more
PARALLEL_UPDATE_RTOL = 1e-2
PARALLEL_TIMED = 5  # calls per leg timed by `device_ms` (the median is printed)
# node-sharded forwards vs the single-device apply in bf16: the sharded
# forward sums its remote and edge-feature messages apart in f32 where the
# single-device one adds them in bf16 first, so a logit may land a few
# bf16 ulps away: held within eight ulps of the largest (2^-5·max|ref|)
NODE_SHARDED_TOL = 2.0**-5


def _median_ms(fn, dev: torch.device) -> float | None:
    """``device_ms`` over ``PARALLEL_TIMED`` calls of a warm path; None on
    the CPU, which has no device time."""
    return device_ms(fn, reps=PARALLEL_TIMED) if dev.type == "cuda" else None


def _launches_of(fn, dev: torch.device) -> tuple:
    """``fn()`` with the kernels' counts set to 0 just before and read just
    after: (its result, the counts)."""
    from alaz_tpu_torch.ops import segment_kernels as K

    _sync(dev)
    K.reset_launch_counts()
    out = fn()
    _sync(dev)
    return out, K.launch_counts()


def _parallel_train(tag, cfg, mesh, dp: int, window: dict, dev, steps: int) -> dict:
    """``steps`` sharded train steps over a stack of ``dp`` windows on
    ``mesh``, against the single-device step on the same card, params
    and windows (the mean edge BCE over the windows, backward, AdamW:
    ``make_train_step``'s body, which it is at one window). The loss is
    held to rel 1e-5 each step; a later step's loss sees the earlier
    updates. The params after the steps: equal at one rank, where every
    gather is a copy and every all-reduce a sum of one; past one, within
    ``PARALLEL_UPDATE_RTOL`` of the single-device update's norm."""
    import torch.distributed as dist

    from alaz_tpu_torch.models.registry import init_params
    from alaz_tpu_torch.parallel.sharding import adamw, make_sharded_train_step, stack_graphs
    from alaz_tpu_torch.replay.synth import example_batch
    from alaz_tpu_torch.train.trainstep import backward, make_loss_fn

    require(steps >= 2, f"{tag}: {steps} step(s): a later loss must see an update")
    batches = [example_batch(**window, seed=s) for s in range(dp)]
    stacked, _ = stack_graphs(batches)
    labels = np.stack([window_labels(b) for b in batches])
    params = init_params(cfg, key=0, device=dev)
    step = make_sharded_train_step(cfg, mesh, adamw(PARALLEL_LR), params)
    state = step.init(params)
    # the single-device reference, on a copy of the same params
    ref_params = init_params(cfg, key=0, device=dev)
    start = {k: p.detach().clone() for k, p in ref_params.named_parameters()}
    ref_opt = adamw(PARALLEL_LR)(list(ref_params.parameters()))
    loss_fn = make_loss_fn(step.cfg)
    all_graphs = [
        (
            {k: torch.as_tensor(np.ascontiguousarray(v[i]), device=dev) for k, v in stacked.items()},
            torch.as_tensor(labels[i], device=dev),
        )
        for i in range(dp)
    ]

    def ref_step():
        ref_opt.zero_grad(set_to_none=True)
        loss = sum(loss_fn(ref_params, g, lab) for g, lab in all_graphs) / dp
        backward(ref_params, loss)
        ref_opt.step()
        return float(loss.detach())

    losses, ref_losses, launches = [], [], None
    for i in range(steps):
        loss, counts = _launches_of(lambda: float(step(state, stacked, labels)), dev)
        launches = launches or counts
        losses.append(loss)
        ref_losses.append(ref_step())
        require(abs(loss - ref_losses[-1]) <= 1e-5 * abs(ref_losses[-1]),
                f"{tag}: step {i} loss {loss} vs single-device {ref_losses[-1]}")
    with torch.no_grad():
        full = step.gather(state.shards)
        ref = dict(ref_params.named_parameters())
        param_err = max(float((full[k] - p).abs().max()) for k, p in ref.items())
        miss = sum(float((full[k] - p).double().square().sum()) for k, p in ref.items()) ** 0.5
        moved = sum(float((p - start[k]).double().square().sum()) for k, p in ref.items()) ** 0.5
    require(moved > 0, f"{tag}: the single-device steps left the params where they were")
    world = dist.get_world_size()
    tol = 0.0 if world == 1 else PARALLEL_UPDATE_RTOL * moved
    require(miss <= tol, f"{tag}: params after {steps} steps {miss} from the single-device ones "
            f"(update norm {moved}, limit {tol}, max |Δ| {param_err})")
    step_ms = _median_ms(lambda: step(state, stacked, labels), dev)
    return {"windows": dp, "steps": steps, "losses": losses, "single_device_losses": ref_losses,
            "param_max_abs_err": param_err, "param_l2_err": miss, "update_l2": moved, "param_l2_limit": tol,
            "launches": launches, "ms_per_step": step_ms, "dispatch": step.cfg.expert_dispatch}


def parallel_rank(world: int, device: str = "cuda", window: dict = WINDOW, gat_window: dict = GAT_WINDOW) -> dict:
    """Every leg of ``phase_parallel`` on this rank (one of ``world``), on
    ``window``s and ``gat_window``s. Returns numpy/float results; the
    kernels' launches of each leg are read around its main-path run
    only."""
    import torch.distributed as dist

    from alaz_tpu_torch.config import MeshConfig, ModelConfig
    from alaz_tpu_torch.convert import graph_to_torch
    from alaz_tpu_torch.models.registry import get_model, init_params
    from alaz_tpu_torch.ops.segment import segment_sum
    from alaz_tpu_torch.parallel.gpipe import make_pipeline, sequential_reference
    from alaz_tpu_torch.parallel.halo import make_halo_aggregate, shard_graph
    from alaz_tpu_torch.parallel.mesh import make_mesh
    from alaz_tpu_torch.parallel.sharded_model import (
        make_node_sharded_gat,
        make_node_sharded_graphsage,
        rank_shard,
        shard_graph_batch,
    )
    from alaz_tpu_torch.parallel.sharding import make_sharded_score_step, stack_graphs
    from alaz_tpu_torch.replay.synth import example_batch
    from alaz_tpu_torch.runtime.scorer import WindowScorer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device, torch.cuda.current_device()) if device == "cuda" else torch.device("cpu")
    on_card = dev.type == "cuda"
    rank = dist.get_rank()
    out: dict = {"rank": rank, "device": str(dev)}

    # -- the sharded train step: GraphSAGE, dp over a stack of `world` windows
    dp_mesh = make_mesh(MeshConfig(dp=world), device=device)
    out["train"] = _parallel_train("parallel train", ModelConfig(), dp_mesh, world, window, dev, PARALLEL_STEPS)

    # -- the experts' sharded train step on a (dp, tp, ep) mesh, masked dispatch
    tp = 2 if world % 2 == 0 else 1
    ep = 2 if world % (tp * 2) == 0 else 1
    ep_mesh = make_mesh(MeshConfig(dp=world // (tp * ep), tp=tp, ep=ep), device=device)
    out["experts_train"] = _parallel_train(
        "parallel experts train", ModelConfig(model="experts", expert_dispatch="masked"), ep_mesh,
        world // (tp * ep), window, dev, PARALLEL_EXPERT_STEPS)
    out["experts_train"]["mesh"] = [world // (tp * ep), tp, ep, 1]

    # -- the dp-sharded score step: GAT, banded src gather, held to WindowScorer
    gat_cfg = ModelConfig(model="gat", src_gather="banded")
    gat_batches = [example_batch(**gat_window, seed=s) for s in range(world)]
    gat_params = init_params(gat_cfg, key=0, device=dev)
    score = make_sharded_score_step(gat_cfg, dp_mesh, gat_params)
    stacked, _ = stack_graphs(gat_batches)
    logits, launches = _launches_of(lambda: score(gat_params, stacked), dev)
    scorer = WindowScorer(gat_cfg, gat_params, device=dev)
    per = world // dp_mesh.size(0)
    dp_idx = dp_mesh.get_local_rank("dp")
    mine = gat_batches[dp_idx * per : (dp_idx + 1) * per]
    require(logits.shape[0] == per == len(mine), f"gat score step: {logits.shape[0]} windows on this rank")
    for b, row in zip(mine, logits):
        ref = torch.as_tensor(scorer.score(b))
        got = torch.sigmoid(row[: b.n_edges]).cpu()
        require(torch.equal(got, ref), "parallel gat score step: scores differ from WindowScorer's")
    out["gat_score"] = {"windows_here": int(logits.shape[0]), "launches": launches,
                        "ms_per_call": _median_ms(lambda: score(gat_params, stacked), dev),
                        "equal_to_window_scorer": True}

    # -- the node-sharded forwards at S = world, against the single-device apply
    sp_mesh = make_mesh(MeshConfig(sp=world), device=device)
    s_idx = sp_mesh.get_local_rank("sp")
    for tag, cfg, window, maker in (
        ("node_sharded_graphsage", ModelConfig(), window, make_node_sharded_graphsage),
        ("node_sharded_gat", gat_cfg, gat_window, make_node_sharded_gat),
    ):
        b = example_batch(**window, seed=0)
        params = init_params(cfg, key=0, device=dev)
        sharded, perm = shard_graph_batch(b, world)
        shard = rank_shard(sharded, s_idx, dev)
        run = maker(cfg, sp_mesh)
        with torch.inference_mode():
            (el, nl), launches = _launches_of(lambda: run(params, shard), dev)
            ref = get_model(cfg.model)[1](params, graph_to_torch(b.device_arrays(), dev), cfg)
            ms = _median_ms(lambda: run(params, shard), dev)
        valid = torch.as_tensor(perm[s_idx] >= 0, device=dev)
        slots = torch.as_tensor(perm[s_idx][perm[s_idx] >= 0], device=dev)
        n_loc = nl.shape[1]
        errs = {}
        for key, got, want in (
            ("edge_logits", el[0][valid], ref["edge_logits"][slots]),
            ("node_logits", nl[0], ref["node_logits"][s_idx * n_loc : (s_idx + 1) * n_loc]),
        ):
            scale = float(ref[key].abs().max())
            err = float((got - want).abs().max()) if got.numel() else 0.0
            require(err <= NODE_SHARDED_TOL * scale, f"{tag} {key}: {err} past {NODE_SHARDED_TOL} x {scale}")
            errs[key] = {"max_abs_err": err, "bound": NODE_SHARDED_TOL * scale}
        out[tag] = {"shards": world, "edges_here": int(valid.sum()), "launches": launches,
                    "vs_single_device": errs, "ms_per_forward": ms}

    # -- the halo aggregate at the window's shapes, f32, against segment_sum
    # (in float64: the f32 sum's own rounding is not charged to the ring)
    b = example_batch(**window, seed=0)
    src, dst = b.edge_src[: b.n_edges], b.edge_dst[: b.n_edges]
    feats = np.random.default_rng(11).normal(size=(b.n_pad, F_MAIN)).astype(np.float32)
    blocks = shard_graph(feats, src, dst, world)
    halo = make_halo_aggregate(sp_mesh, axis="sp")
    args = [torch.as_tensor(a[s_idx : s_idx + 1], device=dev) for a in blocks]
    got, launches = _launches_of(lambda: halo(*args), dev)
    x = torch.as_tensor(feats, device=dev)
    want = segment_sum(x.double()[torch.as_tensor(src, device=dev).long()], torch.as_tensor(dst, device=dev).long(),
                       b.n_pad)
    n_loc = b.n_pad // world
    want = want[s_idx * n_loc : (s_idx + 1) * n_loc].float()
    err = float((got[0] - want).abs().max())
    require(torch.allclose(got[0], want, rtol=1e-4, atol=1e-5), f"halo vs segment_sum: max |Δ| {err}")
    out["halo"] = {"launches": launches, "max_abs_err": err, "rtol": 1e-4, "atol": 1e-5,
                   "ms_per_call": _median_ms(lambda: halo(*args), dev)}

    # -- GPipe over the `world` ranks: two layers a stage, against the loop
    from torch.distributed.device_mesh import DeviceMesh

    pp_mesh = DeviceMesh(dev.type, torch.arange(world), mesh_dim_names=("pp",))
    rng = np.random.default_rng(2)
    d, layers, m, rows = F_MAIN, 2 * world, 4 * world, 4096
    w = torch.as_tensor(rng.normal(size=(layers, d, d)).astype(np.float32) * d**-0.5, device=dev)
    bias = torch.as_tensor(rng.normal(size=(layers, d)).astype(np.float32) * 0.1, device=dev)
    micro = torch.as_tensor(rng.normal(size=(m, rows, d)).astype(np.float32), device=dev)

    def stage_fn(layer, h):
        return torch.tanh(h @ layer["w"] + layer["b"])

    pipe = make_pipeline(stage_fn, pp_mesh, axis="pp")
    mine_layers = {"w": w[2 * rank : 2 * rank + 2], "b": bias[2 * rank : 2 * rank + 2]}
    mine_micro = micro[4 * rank : 4 * rank + 4]
    with torch.inference_mode():
        got = pipe(mine_layers, mine_micro)
        want = sequential_reference(stage_fn, {"w": w, "b": bias}, micro)[4 * rank : 4 * rank + 4]
        err = float((got - want).abs().max())
        require(torch.allclose(got, want, rtol=1e-5, atol=1e-5), f"gpipe vs sequential: max |Δ| {err}")
        out["gpipe"] = {"stages": world, "layers": layers, "microbatches": [m, rows, d], "max_abs_err": err,
                        "ms_per_call": _median_ms(lambda: pipe(mine_layers, mine_micro), dev)}
    if on_card:
        out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    return out


def phase_parallel(device: str = "cuda", world: int | None = None, windows: tuple = (WINDOW, GAT_WINDOW)) -> dict:
    """``alaz_tpu_torch.parallel`` on W = min(cards, 4) spawned ranks (NCCL,
    one a card): each leg of ``parallel_rank`` held to its single-device
    counterpart, K1/K2 launched under sharding by the train steps, the
    node-sharded forwards and the halo, K3 by the GAT score step.
    Returns the launches of each leg, summed over the ranks."""
    from alaz_tpu_torch.parallel.multislice import spawn

    if world is None:
        world = min(torch.cuda.device_count(), 4)
    on_card = device == "cuda"
    if on_card:
        torch.cuda.empty_cache()  # the ranks share the card(s) with this process
    t0 = time.perf_counter()
    ranks = spawn(parallel_rank, world, (world, device, *windows), device=device, timeout_s=900.0)
    seconds = time.perf_counter() - t0
    legs = ("train", "experts_train", "gat_score", "node_sharded_graphsage", "node_sharded_gat", "halo")
    launches = {
        f"parallel_{leg}": {k: sum(r[leg]["launches"][k] for r in ranks) for k in _counts(0, 0, 0, 0)}
        for leg in legs
    }
    if on_card:
        layers = 2
        require(launches["parallel_train"] == _counts(3 * world, 3 * world, 0, 0),
                f"parallel train step launches {launches['parallel_train']}")
        require(launches["parallel_experts_train"] == _counts(3 * world, 3 * world, 0, 0),
                f"parallel experts step launches {launches['parallel_experts_train']}")
        require(launches["parallel_gat_score"] == _counts(2 * world, 3 * world, 3 * world, 0),
                f"parallel gat score launches {launches['parallel_gat_score']}")
        require(launches["parallel_node_sharded_graphsage"]
                == _counts(world * layers * (world + 1), 0, 0, 0),
                f"node-sharded graphsage launches {launches['parallel_node_sharded_graphsage']}")
        require(launches["parallel_node_sharded_gat"] == _counts(world * layers * world, 0, 0, 0),
                f"node-sharded gat launches {launches['parallel_node_sharded_gat']}")
        require(launches["parallel_halo"] == _counts(world * world, 0, 0, 0),
                f"halo launches {launches['parallel_halo']}")
    out = {
        "world": world, "seconds": seconds,
        "nccl": ".".join(map(str, torch.cuda.nccl.version())) if on_card else None,
        "card": card_line() if on_card else None,
        "ranks": ranks,
    }
    emit("parallel", out)
    return launches


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
        probe.sort_launches = K.sort_by_ids.launches
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
    require(not any(launches_p.values()) and probe_p.sort_launches == 0,
            f"{tag}: the plain run launched kernels {launches_p}, the sort {probe_p.sort_launches}")
    require(rc == rc_p, f"{tag}: exit {rc} with the kernels, {rc_p} on the plain versions")
    require(loss_err <= 2.0**-4, f"{tag}: step losses differ from the plain run's by {loss_err} of its max")
    require(logit_err <= 2.0**-4, f"{tag}: eval logits differ from the plain run's by {logit_err} of their max")
    (scen, rec) = probe.records
    entry = {
        "argv": argv, "env": env, "exit_code": rc, "result": result,
        "launches": launches, "sort_launches": probe.sort_launches,
        "scenario_rows": scen["rows"], "scenario_s": scen["s"],
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
                require(run["sort_launches"] == n["pallas_gather_scatter_sum"],
                        f"train CLI gat: {run['sort_launches']} sort launches "
                        f"for {n['pallas_gather_scatter_sum']} K3 backwards")
            SORT_LAUNCHES[f"train_cli_{family}"] = run["sort_launches"]
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


def sort_small(cli_runs: int = 3) -> dict:
    """The sort at the ``train`` CLI's shapes in the checkout it is
    imported from: at each of ``SORT_SMALL`` (E = 128 also with ``dx``'s
    payloads) its back-to-back and device times and its launches a call,
    then ``cli_runs`` runs of ``train --model gat`` (banded, kernels on)
    with each run's step time and sort launches. Not a phase of ``main``;
    to hold two checkouts' sorts against each other, run it from each in
    one call, in turns:

        python3 -c "import chip_smoke; chip_smoke.sort_small()"
    """
    from alaz_tpu_torch.ops import segment_kernels as K

    require(torch.cuda.is_available(), "sort_small runs on the card only")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    out = {"card": card_line(), "sorts": {}, "cli": []}
    for n_e, n_rows in SORT_SMALL:
        ids, dst = _small_sort_ids(n_e, n_rows, gen, dev)
        w = torch.rand(n_e, generator=gen, device=dev)
        for name, pays in ((f"e{n_e}_rows{n_rows}", ()), (f"e{n_e}_rows{n_rows}_payloads", (dst, w))):
            if pays and n_e != SORT_SMALL[0][0]:
                continue
            K.reset_launch_counts()
            K.sort_by_ids(ids, n_rows, pays)
            out["sorts"][name] = {
                "launches": K.sort_by_ids.launches,
                "ms": time_ms(lambda: K.sort_by_ids(ids, n_rows, pays), iters=200),
                "device_ms": device_ms(lambda: K.sort_by_ids(ids, n_rows, pays), reps=21),
            }
    env = {"MODEL": "gat", "SRC_GATHER": "banded", "EDGE_LAYOUT": "coo", "USE_PALLAS": "1"}
    os.environ.update(env)
    for _ in range(cli_runs):
        rc, _, probe, launches = _run_cli(["train", "--model", "gat"], "cuda")
        (rec,) = [r for r in probe.records if r["call"] == "train_on_batches"]
        out["cli"].append({"exit_code": rc, "step_ms": rec["step_ms"], "steps": rec["steps"],
                           "sort_launches": probe.sort_launches,
                           "k4_launches": launches["pallas_gather_scatter_sum"]})
    emit("sort_small", out)
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
SORT_KERNELS = ("sort_upsweep_kernel", "sort_scan_kernel", "sort_downsweep_kernel")


def numbers_k4(b, x, gen, dev) -> dict:
    """K4 on one window's edges (bf16, F=128, weighted, COO): back-to-back
    CUDA-event time, device time of one call, CUPTI time of its three
    kernels, its time with every edge on one src row,
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
    return out


def numbers_backward(batches, gat_batches, dev) -> dict:
    """Each kernel in its backward use, at the training paths' shapes (bf16,
    F=128, COO), CUDA events: its time, bound and library call.

    - K2 as K1's backward: ``g[dst]`` of a bf16 ``[N, 128]`` cotangent;
      library ``index_select``.
    - K1 as K2's backward: the sorted sum of a bf16 ``[E, 128]`` cotangent;
      library ``index_add_`` (bf16).
    - The sort kernel (``sort_by_ids``) on the clustered window's src ids,
      as K3's backward calls it: back-to-back time, device time, CUPTI time
      of each of its kernels, the plain version, and on the uniform
      window's ids and with ``dx``'s payloads (dst, f32 weights); library
      ``torch.argsort(stable=True)`` (the permutation only). At the
      ``train`` CLI's shapes (``SORT_SMALL``) its back-to-back and device
      times, and ``torch.argsort``'s.
    - K4 as K3's backward (``unsorted_segment_sum``, over the clustered
      window's src ids): the whole pass (the sort kernel, K4, the cast),
      the pass the sort kernel replaced (``torch.argsort``, the gather of
      the sorted ids, K4, the cast) in turns with it (old, new, new, old),
      and K4 alone; library ``index_add_`` of the f32 cotangent (pre-cast).
    - K4 as K4's ``dx`` (f32 ``g``, f32 weights, src and dst swapped): the
      whole pass (the sort carrying dst and the weights, K4, cast), the
      pass it replaced (``torch.argsort``, three gathers, K4, cast) in turns
      with it, and K4 alone; library ``index_add_`` in f32 of the products
      ``w·g[dst]`` (pre-formed: it does less than the function).
    """
    from alaz_tpu_torch.ops import segment_kernels as K

    t0 = time.perf_counter()
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
    gdst = torch.as_tensor(gat_batches[0].edge_dst, device=dev)
    w = torch.rand(e, generator=gen, device=dev) + 0.5

    def sort():
        return K.sort_by_ids(src, N_MAIN)

    uniform_src = torch.as_tensor(batches[0].edge_src, device=dev)
    out["sort"] = {  # the sort kernel: 12 B an edge, 28 with dx's payloads
        "ms": time_ms(sort),
        "device_ms": device_ms(sort),
        "cupti_us": cupti_us(sort, SORT_KERNELS),
        "plain_ms": time_ms(lambda: K.sort_by_ids_plain(src, N_MAIN)),
        "library_ms": time_ms(lambda: torch.argsort(src, stable=True)),
        "uniform_ids_ms": time_ms(lambda: K.sort_by_ids(uniform_src, N_MAIN)),
        "with_dx_payloads_ms": time_ms(lambda: K.sort_by_ids(src, N_MAIN, (gdst, w))),
        "with_dx_payloads_bound_ms": _bound(e * 12 + 2 * e * 8, 0)[0],
        "bound": _bound(e * 12, 0),
    }
    for n_e, n_rows in SORT_SMALL:
        ids, _ = _small_sort_ids(n_e, n_rows, gen, dev)
        out["sort"][f"e{n_e}_rows{n_rows}"] = {
            "ms": time_ms(lambda: K.sort_by_ids(ids, n_rows)),
            "device_ms": device_ms(lambda: K.sort_by_ids(ids, n_rows)),
            "library_ms": time_ms(lambda: torch.argsort(ids, stable=True)),
        }
    del uniform_src, ids

    perm = torch.argsort(src, stable=True).to(torch.int32)
    sorted_src = src[perm]
    g32 = g_edges.float()
    acc32 = torch.zeros((N_MAIN, f), dtype=torch.float32, device=dev)

    def k3_pass():
        return K.unsorted_segment_sum(g_edges, src, N_MAIN)

    def k3_argsort():
        return _argsort_unsorted_segment_sum(g_edges, src, N_MAIN)

    turns = [time_ms(k3_argsort), time_ms(k3_pass), time_ms(k3_pass), time_ms(k3_argsort)]
    out["k3_bwd"] = {  # the sort kernel and K4's kernel over the sorted ids, unweighted
        "ms": (turns[1] + turns[2]) / 2,
        "argsort_pass_ms": (turns[0] + turns[3]) / 2,
        "turns_old_new_new_old_ms": turns,
        "k4_only_ms": time_ms(lambda: K._run_k4(g_edges, perm, sorted_src, N_MAIN)),
        "library_ms": time_ms(lambda: acc32.index_add_(0, src, g32), iters=20),
        "bound": _bound(e * 4 + e * f * 2 + N_MAIN * f * 2, e * f),
    }
    del g32, acc32

    gn32 = torch.randn((N_MAIN, f), generator=gen, device=dev)
    perm_s = torch.argsort(src, stable=True).to(torch.int32)
    dst_by_src, src_sorted, w_sorted = gdst[perm_s], src[perm_s], w[perm_s]

    def dx_pass():
        return K.gather_scatter_dx(gn32, src, gdst, w, N_MAIN).bfloat16()

    def dx_argsort():
        return _argsort_dx(gn32, src, gdst, w, N_MAIN).bfloat16()

    prods = gn32[gdst.long()] * w[:, None]
    acc32 = torch.zeros((N_MAIN, f), dtype=torch.float32, device=dev)
    rows_gdst = int(torch.unique(gdst).numel())
    turns = [time_ms(dx_argsort), time_ms(dx_pass), time_ms(dx_pass), time_ms(dx_argsort)]
    out["k4_bwd_dx"] = {  # the sort kernel with payloads, K4's kernel, roles swapped, f32
        "ms": (turns[1] + turns[2]) / 2,
        "argsort_pass_ms": (turns[0] + turns[3]) / 2,
        "turns_old_new_new_old_ms": turns,
        "k4_only_ms": time_ms(lambda: K._run_k4(gn32, dst_by_src, src_sorted, N_MAIN, w_sorted)),
        "library_ms": time_ms(lambda: acc32.index_add_(0, src, prods), iters=20),
        "bound": _bound(3 * e * 4 + rows_gdst * f * 4 + N_MAIN * f * 2, 2 * e * f),
    }
    emit("backward_kernels", {**{k: dict(v, bound=list(v["bound"])) for k, v in out.items()},
                              "seconds": time.perf_counter() - t0})
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
        **{k: n[k] for k in ("k4_only_ms", "argsort_pass_ms") if k in n},
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
    srt = bwd["sort"]
    sort_entry = _kernel_entry("sort_by_ids", SORT_REPLACES, sum(SORT_LAUNCHES.values()),
                               bwd_errs["sort_clustered"], srt["ms"], srt["plain_ms"], srt["bound"],
                               srt["library_ms"])
    require(sort_entry["launches"] > 0, f"the sort kernel was not launched on the main path: {SORT_LAUNCHES}")
    sort_entry["launches_by_path"] = dict(SORT_LAUNCHES)
    sort_entry["launches_per_train_step"] = {
        m: SORT_LAUNCHES[f"train_{m}"] for m in ("graphsage", "gat", "experts")}
    entries.append(sort_entry)
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
    phase_gpu_env()
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
    phase_prefetch(batches)
    serve_launches, serve_runs = phase_serve()
    native_launches, native_host = phase_serve_native(serve_runs)
    serve_launches.update(native_launches)
    serve_launches.update(phase_serve_process(serve_runs, native_host))
    serve_launches.update(phase_tenants())
    serve_launches.update(phase_serve_live(native_host))
    serve_launches.update(phase_sanitize())
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
    parallel_launches = phase_parallel()
    launches = {
        "graphsage": sl["launches"], "gat": gsl["launches"], "experts": esl["launches"],
        "tgn": tsl["launches"], "gather_scatter_sum": op["launches"], **serve_launches,
        **{f"train_{m}": t["launches_forward_backward"] for m, t in trains.items()},
        "train_tgn_unrolled": tgn_train["launches"],
        **{f"train_cli_{m}": r["launches"] for m, r in train_cli["runs"].items()},
        "train_cli_config3": config3["launches"],
        **parallel_launches,
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
