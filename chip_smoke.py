#!/usr/bin/env python3
"""Drive the PyTorch port's scoring path on one NVIDIA H100.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each raising on failure:

1. build    -- compile ``alaz_tpu_torch/csrc/segment.cu`` with nvcc into
               ``build/alaz_tpu_torch/`` and print ptxas's register,
               shared-memory and spill lines;
2. kernels  -- each hand-written kernel against its plain PyTorch version,
               on the card, at the scoring path's shapes (E=1,048,576
               edges, N=131,072 nodes, F=128);
3. slice    -- three synthetic windows of bucket n131072xe1048576 scored
               through ``WindowScorer`` under the default ``ModelConfig``
               (GraphSAGE, hidden 128, 2 layers, bf16, kernels on), with
               the kernels' launch counts read around that run and one
               window held against the same model on the plain versions;
4. numbers  -- kernel times (CUDA events), bounds, plain-version and
               library-call times, per-window score time, and a profile of
               the device time by kernel over scored windows.

Output: JSON lines for each phase, then the kernels' JSON line, the
card's name and power limit, and last the result line
``{"ok": true, "device": {...}}``. Without a CUDA device it exits
nonzero and prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

import torch

E_MAIN = 1_048_576  # edges of the main path's bucket
N_MAIN = 131_072  # nodes of the main path's bucket
F_MAIN = 128  # hidden width of the default ModelConfig
WINDOW = dict(n_pods=100_000, n_svcs=10_000, n_edges=E_MAIN)  # bench.py's default window
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 rate outside the tensor cores
K1_SOURCE = "alaz_tpu_torch/csrc/segment.cu"
K1_REPLACES = "alaz_tpu/ops/pallas_segment.py:184"  # scatter_sum_sorted (pallas_call :170)
K2_REPLACES = "alaz_tpu/ops/pallas_segment.py:346"  # segment_expand_sorted (pallas_call :332)


def emit(tag: str, obj) -> None:
    print(json.dumps({tag: obj}), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


# -- phase 1 ----------------------------------------------------------------


def phase_build() -> None:
    from alaz_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build()
    _build.library()
    seconds = time.perf_counter() - t0
    for line in built.log.splitlines():
        if any(k in line for k in ("Compiling entry", "registers", "spill", "smem")):
            print("ptxas:", line.strip())
    emit("build", {"library": built.path.name, "seconds": seconds})


# -- phase 2 ----------------------------------------------------------------


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


def phase_kernels(batch, dev: torch.device) -> dict:
    """Each kernel against its plain version on the window's dst-sorted
    edge ids (the main path's). Returns the max abs error per case."""
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
    for name, dtype in (("k2_bf16", torch.bfloat16), ("k2_f32", torch.float32)):
        v = torch.randn((n_pad, F_MAIN), generator=gen, device=dev).to(dtype)
        got = K.segment_expand_sorted(v, edge_dst, n_pad)
        ref = K.segment_expand_sorted_plain(v, edge_dst)
        _sync(dev)
        require(torch.equal(got, ref), f"{name} is not bit-exact")
        errs[name] = float((got.float() - ref.float()).abs().max())
    emit("kernels_vs_plain", {
        "tolerance": "K2 bit-exact; K1 f32 within 1e-5 of max|out|; K1 bf16 within one bf16 ulp",
        "max_abs_err": errs,
    })
    return errs


# -- phase 3 ----------------------------------------------------------------


@contextlib.contextmanager
def plain_kernels():
    """Route the scoring path through the kernels' plain versions (for the
    reference forward only; restored on exit)."""
    from alaz_tpu_torch.ops import segment_kernels as K

    saved = K.scatter_sum_sorted, K.segment_expand_sorted

    def scatter(msgs, edge_dst, num_nodes, out_dtype=None, block_starts=None):
        return K.scatter_sum_sorted_plain(
            msgs, edge_dst, num_nodes, msgs.dtype if out_dtype is None else out_dtype, block_starts
        )

    K.scatter_sum_sorted = scatter
    K.segment_expand_sorted = lambda v, edge_dst, num_nodes: K.segment_expand_sorted_plain(v, edge_dst)
    try:
        yield
    finally:
        K.scatter_sum_sorted, K.segment_expand_sorted = saved


def phase_slice(batches, device: str = "cuda") -> tuple:
    """Score the windows through WindowScorer, serially; read the kernels'
    launch counts around exactly that run. Returns (summary, scorer)."""
    from alaz_tpu_torch.config import ModelConfig
    from alaz_tpu_torch.models.registry import init_params
    from alaz_tpu_torch.ops import segment_kernels as K
    from alaz_tpu_torch.runtime.scorer import WindowScorer
    from alaz_tpu_torch.train.trainstep import make_score_fn

    cfg = ModelConfig()
    require(
        (cfg.model, cfg.hidden_dim, cfg.num_layers, cfg.dtype, cfg.use_pallas, cfg.edge_layout)
        == ("graphsage", 128, 2, "bfloat16", True, "coo"),
        f"unexpected default ModelConfig {cfg}",
    )
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
    if on_card:
        n = len(batches)
        require(launches == {"scatter_sum_sorted": 2 * n, "segment_expand_sorted": n},
                f"expected 2 K1 and 1 K2 launches per forward, got {launches} for {n} forwards")

    # one window against the same model on the plain versions: kernels and
    # plain versions differ only in K1's f32 summation order, so logits may
    # differ where a bf16 rounding flipped; held at four bf16 ulps of the
    # largest logit (2^-6·max|ref|)
    score_fn = make_score_fn(cfg, device)
    arrays = batches[0].device_arrays(cfg.edge_layout)
    got = score_fn(scorer.params, arrays)
    with plain_kernels():
        ref = score_fn(scorer.params, arrays)
    errs = {}
    for key, n_real in (("edge_logits", batches[0].n_edges), ("node_logits", batches[0].n_nodes)):
        g, r = got[key][:n_real], ref[key][:n_real]
        err = float((g - r).abs().max())
        bound = 2.0**-6 * float(r.abs().max())
        require(err <= bound, f"{key}: kernels vs plain versions differ by {err} > {bound}")
        errs[key] = {"max_abs_err": err, "bound": bound}

    out = {
        "bucket": batches[0].bucket_key,
        "windows": len(batches),
        "edges_per_window": [b.n_edges for b in batches],
        "window_s": window_s,
        "launches": launches,
        "vs_plain_versions": errs,
        "score_mean": float(sum(float(s.mean()) for s in all_scores) / len(all_scores)),
        "tf32": {
            "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
        },
    }
    if on_card:
        out["max_memory_allocated_bytes"] = peak_bytes
    emit("slice", out)
    return out, scorer


# -- phase 4 ----------------------------------------------------------------


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


def phase_numbers(launches: dict, errs: dict, scorer, batches) -> list:
    from alaz_tpu_torch.ops import segment_kernels as K

    dev = torch.device("cuda")
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
    k1_bound, k1_by = _bound(k1_bytes, e * f)

    k2_ms = time_ms(lambda: K.segment_expand_sorted(v, edge_dst, N_MAIN))
    k2_plain_ms = time_ms(lambda: K.segment_expand_sorted_plain(v, edge_dst))
    k2_lib_ms = time_ms(lambda: torch.index_select(v, 0, idx64))
    rows_read = int(torch.unique(edge_dst).numel())
    k2_bytes = e * 4 + e * f * 2 + rows_read * f * 2
    k2_bound, k2_by = _bound(k2_bytes, 0)

    # the other K1 variants the ops expose, for the record
    variants = {
        "k1_f32_ms": time_ms(lambda: K.scatter_sum_sorted(msgs.float(), edge_dst, N_MAIN), iters=20),
        "k1_bf16_to_f32_ms": time_ms(
            lambda: K.scatter_sum_sorted(msgs, edge_dst, N_MAIN, torch.float32), iters=20),
        "k1_bf16_blocked_ms": time_ms(
            lambda: K.scatter_sum_sorted(msgs, edge_dst, N_MAIN, None, bs), iters=20),
        "k2_f32_ms": time_ms(lambda: K.segment_expand_sorted(v.float(), edge_dst, N_MAIN), iters=20),
        "k1_nonempty_rows": rows_read,
        "k1_nonempty_blocks": int(((bs[1:] - bs[:-1]) > 0).sum()),
    }
    emit("kernel_variants", variants)

    # bounds of the TPU kernels still to port, at the same window's shapes
    # (bf16, F=128): K3 gathers v[src]; K4 fuses that gather with K1
    src_rows = int(torch.unique(torch.as_tensor(batches[0].edge_src, device=dev)).numel())
    k3_bytes = e * 4 + e * f * 2 + src_rows * f * 2
    k4_bytes = 2 * e * 4 + src_rows * f * 2 + N_MAIN * f * 2
    emit("bounds_still_to_port", {
        "gather_rows_banded": {"bytes": k3_bytes, "bound_ms": _bound(k3_bytes, 0)[0]},
        "pallas_gather_scatter_sum": {"bytes": k4_bytes, "bound_ms": _bound(k4_bytes, e * f)[0]},
        "src_rows": src_rows,
    })

    # the window, end to end and by part (steady state: library built,
    # buffers warm)
    from alaz_tpu_torch.convert import graph_to_torch

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
    from alaz_tpu_torch.models.graphsage import apply

    def forward():
        with torch.inference_mode():
            apply(scorer.params, graph, cfg)

    forward_ms = time_ms(forward, iters=10, warmup=2)
    score_s = statistics.median(steady)
    emit("window", {
        "score_s_median": score_s,
        "score_s": steady,
        "edges_per_s": batches[0].n_edges / score_s,
        "transfer_s_median": statistics.median(transfer),
        "forward_ms": forward_ms,
        "kernels_ms_per_forward": 2 * k1_ms + k2_ms,
    })

    return [
        {
            "name": "scatter_sum_sorted", "route": "cuda", "source": K1_SOURCE,
            "replaces": K1_REPLACES, "launches": launches["scatter_sum_sorted"],
            "max_abs_err": errs["k1_bf16_coo"], "ms": k1_ms, "plain_ms": k1_plain_ms,
            "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": k1_lib_ms,
        },
        {
            "name": "segment_expand_sorted", "route": "cuda", "source": K1_SOURCE,
            "replaces": K2_REPLACES, "launches": launches["segment_expand_sorted"],
            "max_abs_err": errs["k2_bf16"], "ms": k2_ms, "plain_ms": k2_plain_ms,
            "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": k2_lib_ms,
        },
    ]


def phase_profile(scorer, batch, windows: int = 2) -> dict:
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
    emit("profile", out)
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
    from alaz_tpu_torch.replay.synth import example_batch

    # f32 matmuls in full f32 (no TF32) for every comparison below
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: off (torch.backends.cuda.matmul.allow_tf32 = False, cudnn.allow_tf32 = False)")

    phase_build()
    t0 = time.perf_counter()
    batches = [example_batch(**WINDOW, seed=s) for s in range(3)]
    emit("windows", {"bucket": batches[0].bucket_key, "synth_s": time.perf_counter() - t0})
    require(batches[0].bucket_key == f"n{N_MAIN}xe{E_MAIN}", f"bucket {batches[0].bucket_key}")

    errs = phase_kernels(batches[0], torch.device("cuda"))
    sl, scorer = phase_slice(batches)
    kernels = phase_numbers(sl["launches"], errs, scorer, batches)
    phase_profile(scorer, batches[0])

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
