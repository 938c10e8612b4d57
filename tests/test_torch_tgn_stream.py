"""TGN threaded through a stream, on the CPU: the port against the
benchmark's plain reference (``gpu_bench/reference_tgn.py``), the
``tgn-fleet-stream`` cell's load through the Service at a small size, the
faults the cell exists to catch, its stream generator, the memory
update's series and the cell's metric readers.

Tolerances:
- float32 (``use_pallas`` False): rtol/atol 1e-4 on the logits and the
  memory after each window, the ROADMAP's oracle: both sides compute the
  same equations in f32, apart only in summation order.
- bfloat16 (the cell's configuration): the cell's own limits
  (``limits/tgn-fleet-stream.json``: the worst edge's score gap, and the
  memory's ‖Δ‖/‖ref‖), since the port rounds every matrix product's
  operands to bf16 and the reference does not; the GRU keeps the gap
  bounded from window to window (the update gate mixes each window's
  rounding into a memory that forgets the older ones).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from alaz_tpu_torch.config import RuntimeConfig
from alaz_tpu_torch.convert import graph_to_torch
from alaz_tpu_torch.models import tgn
from alaz_tpu_torch.obs.spans import SpanTracer
from alaz_tpu_torch.runtime.service import Service
from gpu_bench import (common, gen_stream, gen_windows, plant_tgn, reference, reference_tgn, spec, trace, yardstick,
                       yardstick_tgn)
from gpu_bench.loads import stream

ROOT = Path(__file__).resolve().parent.parent
CELL = "tgn-fleet-stream"
LIMITS = json.loads((ROOT / "gpu_bench" / "limits" / f"{CELL}.json").read_text())
PODS, SERVICES, EDGES = 600, 60, 400


def _cfg(dtype="bfloat16", max_nodes=1024) -> dict:
    cfg = json.loads((ROOT / "gpu_bench" / "configs" / "tgn-fleet100k.json").read_text())
    cfg["deployment"].update(pods=PODS, services=SERVICES, window_edges=EDGES)
    cfg.update(tgn_max_nodes=max_nodes, dtype=dtype, use_pallas=dtype == "bfloat16")
    return cfg


def _program(cfg: dict, params: dict):
    mcfg, model = common.program_model(cfg, params, "cpu")
    return dataclasses.replace(mcfg, tgn_max_nodes=cfg["tgn_max_nodes"]), model


def _thread(cfg: dict, seed: int, handoffs: int, reset_memory: bool = False):
    """The program and the reference threaded over ``handoffs`` marked
    hand-offs of 4 distinct windows: each hand-off's (program scores,
    reference scores) in the program's edge order, and the two final
    memories (the program's cut to the window's slots) with the program's
    rows past them."""
    raws = gen_stream.make_windows(cfg, seed, 4)
    params = reference_tgn.make_params(cfg, seed, "cpu")
    reference_tgn.set_alert_share(params, raws[0], 0.02, "cpu")
    mcfg, model = _program(cfg, params)
    batches = [common.to_batch(r) for r in raws]
    n = raws[0]["node_feats"].shape[0]
    mem = tgn.init_memory(mcfg, mcfg.tgn_max_nodes, "cpu")
    ref_mem = reference_tgn.init_memory(params, n, "cpu")
    scores = []
    reference.tf32_off()
    with torch.no_grad():
        for k in range(handoffs):
            d = k % len(raws)
            b = batches[d]
            common.mark(b.node_feats, b.n_nodes, k, seed)
            if reset_memory:
                mem = torch.zeros_like(mem)
            out, mem = tgn.step(model, graph_to_torch(b.device_arrays(), "cpu"), mem, mcfg)
            logits, ref_mem = reference_tgn.step(params, reference.to_tensors(common.marked(raws[d], k, seed), "cpu"),
                                                 ref_mem)
            got = torch.sigmoid(out["edge_logits"][: b.n_edges]).numpy()
            want = torch.sigmoid(logits).numpy()[gen_windows.dst_order(raws[d]["edge_dst"])]
            scores.append((got, want, out["edge_logits"][: b.n_edges].numpy(),
                           logits.numpy()[gen_windows.dst_order(raws[d]["edge_dst"])]))
    return scores, mem[:n], ref_mem, mem[n:]


def _memory_rel_err(mem, ref_mem, rest) -> float:
    gap = torch.linalg.norm(mem - ref_mem) ** 2 + torch.linalg.norm(rest) ** 2
    return float(torch.sqrt(gap) / torch.linalg.norm(ref_mem))


def test_step_threaded_over_five_windows_matches_the_reference_in_f32():
    scores, mem, ref_mem, rest = _thread(_cfg("float32"), seed=3, handoffs=5)
    for _, _, got, want in scores:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(mem.numpy(), ref_mem.numpy(), rtol=1e-4, atol=1e-4)
    assert not rest.any()


def test_step_threaded_over_five_windows_holds_the_cells_limits_in_bf16():
    scores, mem, ref_mem, rest = _thread(_cfg(), seed=4, handoffs=5)
    worst = max(float(np.abs(got.astype(np.float64) - want).max()) for got, want, _, _ in scores)
    assert worst <= LIMITS["score_max_abs_err"] / 2, worst
    assert _memory_rel_err(mem, ref_mem, rest) <= LIMITS["memory_rel_err"] / 2


def test_memory_reset_every_window_exceeds_the_limits():
    scores, mem, ref_mem, rest = _thread(_cfg(), seed=5, handoffs=5, reset_memory=True)
    worst = max(float(np.abs(got.astype(np.float64) - want).max()) for got, want, _, _ in scores[1:])
    assert worst > 2 * LIMITS["score_max_abs_err"]
    assert _memory_rel_err(mem, ref_mem, rest) > 2 * LIMITS["memory_rel_err"]


def test_a_skipped_update_gate_exceeds_the_limits(monkeypatch):
    """The GRU's update gate left out (``m_t = n``): the memory forgets
    everything each window."""

    def no_gate(params, graph, memory, node_h, cfg):
        # tgn.update with z = 0: m_t = n on every active row
        dtype, n_pad = torch.bfloat16, node_h.shape[0]
        m_prev = memory[:n_pad]
        hz = torch.cat([m_prev.to(dtype), node_h.to(dtype)], dim=-1)
        r = torch.sigmoid(hz @ params.gru_r.w.to(dtype) + params.gru_r.b.to(dtype)).float()
        hn = torch.cat([(r * m_prev).to(dtype), node_h.to(dtype)], dim=-1)
        n_t = torch.tanh(hn @ params.gru_n.w.to(dtype) + params.gru_n.b.to(dtype)).float()
        return torch.cat([torch.where(graph["node_mask"][:, None], n_t, m_prev), memory[n_pad:]])

    monkeypatch.setattr(tgn, "update", no_gate)
    _, mem, ref_mem, rest = _thread(_cfg(), seed=6, handoffs=5)
    assert _memory_rel_err(mem, ref_mem, rest) > 2 * LIMITS["memory_rel_err"]


def _tiny_cell(max_nodes=1024):
    cell = spec.cell(ROOT, CELL)
    traffic = dict(cell.traffic, distinct_windows=3, warmup_passes=1, poll_s=0.001)
    return dataclasses.replace(cell, config=_cfg(max_nodes=max_nodes), traffic=traffic)


def test_the_cells_load_through_the_service_matches_the_threaded_reference():
    """The cell's own loop on the CPU: the Service's TGN path, its memory
    threaded through every hand-off, against the reference threaded over
    the same hand-offs; every check within its limit."""
    out = stream.run(_tiny_cell(), 2718281931, 1.5, False, "cpu")
    assert out.record["handoffs"] >= 6 and out.failed == 0
    assert out.record["memory_rows"] == 1024 and out.record["memory_grows"] == 0
    assert out.record["memory_rows_updated"] == out.record["handoffs"] * (PODS + SERVICES)
    for name, c in out.checks.items():
        assert c["value"] <= c["limit"], (name, c)
    assert out.checks["memory_rel_err"]["value"] > 0  # compared, not skipped


def test_the_cells_load_catches_a_memory_reset():
    """``plant_tgn``'s fault: the program's step with its memory zeroed
    before every window fails both limits of the cell's comparison."""
    with plant_tgn.planted("memory_reset"):
        out = stream.run(_tiny_cell(), 2718281932, 1.0, False, "cpu")
    checks = out.checks
    assert checks["memory_rel_err"]["value"] > checks["memory_rel_err"]["limit"]
    assert checks["score_max_abs_err"]["value"] > checks["score_max_abs_err"]["limit"]
    assert tgn.make_step_fn.__name__ == "make_step_fn"  # put back


def test_the_cells_load_catches_the_fp8_control():
    """``plant_tgn``'s control: the reference threaded in fp8 in the
    program's place, held by the cell's comparison to itself threaded in
    float32, comes out not correct."""
    with plant_tgn.planted("fp8"):
        out = stream.run(_tiny_cell(), 2718281933, 1.5, False, "cpu")
    checks = out.checks
    assert out.failed == 0 and checks["sink_rows_wrong"]["value"] == 0  # the Service took the control's scores
    assert checks["memory_rel_err"]["value"] > checks["memory_rel_err"]["limit"]


def test_gen_stream_is_deterministic_with_stable_slots_and_pairs():
    cfg = _cfg()
    a = gen_stream.make_windows(cfg, 11, 3)
    b = gen_stream.make_windows(cfg, 11, 3)
    c = gen_stream.make_windows(cfg, 12, 1)
    for wa, wb in zip(a, b):
        for k, v in wa.items():
            assert (v is None and wb[k] is None) or np.array_equal(v, wb[k])
    for w in a:
        for k in ("edge_src", "edge_dst", "edge_type"):
            assert np.array_equal(w[k], a[0][k])
        assert w["node_feats"].shape == (PODS + SERVICES, gen_windows.NODE_FEATURE_DIM)
        assert np.array_equal(w["node_type"], np.where(np.arange(PODS + SERVICES) < PODS, 1, 2))
    assert not np.array_equal(a[0]["node_feats"], a[1]["node_feats"])
    assert not np.array_equal(a[0]["edge_src"], c[0]["edge_src"])
    src, dst = a[0]["edge_src"], a[0]["edge_dst"]
    assert src.shape == (EDGES,) and src.min() >= 0 and src.max() < PODS
    assert dst.min() >= PODS and dst.max() < PODS + SERVICES
    assert set(np.unique(a[0]["edge_type"])) <= set(gen_stream.PROTOCOL_TYPES.values())


def _served(model: str, max_nodes: int, device="cpu", windows=2, on_score=None):
    cfg = _cfg(max_nodes=max_nodes)
    raws = gen_stream.make_windows(cfg, 7, windows)
    if model == "tgn":
        params = reference_tgn.make_params(cfg, 7, "cpu")
        mcfg, module = common.program_model(cfg, params, device)
        mcfg = dataclasses.replace(mcfg, tgn_max_nodes=max_nodes)
    else:
        mcfg = dataclasses.replace(common.model_config(dict(cfg, model="graphsage")), tgn_max_nodes=max_nodes)
        params = reference.make_params(dict(cfg, model="graphsage"), 7, "cpu")
        _, module = common.program_model(dict(cfg, model="graphsage"), params, device)
    svc = Service(config=RuntimeConfig(model=mcfg), model_state=module, device=device)
    if on_score is not None:
        real = svc.device.observe_score
        svc.device.observe_score = lambda batch, dur_s: (on_score(dur_s), real(batch, dur_s))
    svc.start()
    try:
        for k, r in enumerate(raws):
            svc.graph_store.on_batch(common.handoff(common.to_batch(r), k))
        svc.drain(60)
    finally:
        svc.stop()
    return svc


def test_memory_grows_counted_and_the_memory_series_only_under_tgn():
    """A memory pre-sized below the bucket grows once (one reallocation),
    and the memory update's span and series register in the TGN Service
    alone."""
    svc = _served("tgn", max_nodes=256)
    snap = svc.metrics.snapshot()
    assert svc.scored_batches == 2
    assert snap["tgn.memory_grows"] == 1 and snap["tgn.memory_rows"] == 768  # the 660 slots' bucket
    assert snap["tgn.memory_rows_updated"] == 2 * (PODS + SERVICES)
    assert snap["latency.memory_s.count"] == 2 and snap["cpu.memory_s"] >= 0
    assert "latency.memory_device_s.count" not in snap  # a card's series
    assert "memory" in svc.tracer.stage_snapshot()

    sage = _served("graphsage", max_nodes=256)
    names = set(sage.metrics.snapshot())
    assert sage.scored_batches == 2
    assert not {n for n in names if n.startswith(("tgn.", "latency.memory", "cpu.memory"))}
    assert "memory" not in sage.tracer.stage_snapshot()


def test_memory_update_kernel_gauge_reads_the_kernels_launches(monkeypatch):
    """``tgn.memory_update_kernel`` reads ``gru_update.launches`` (the GRU
    kernel's launches in the process): 0 after a CPU stream, whose update
    is the plain version, and whatever the counter holds when read; the
    Service registers it under TGN alone."""
    from alaz_tpu_torch.ops import gru_kernels

    before = gru_kernels.gru_update.launches
    svc = _served("tgn", max_nodes=1024)
    assert svc.scored_batches == 2
    assert svc.metrics.snapshot()["tgn.memory_update_kernel"] == before
    monkeypatch.setattr(gru_kernels.gru_update, "launches", before + 7)
    assert svc.metrics.snapshot()["tgn.memory_update_kernel"] == before + 7
    sage = _served("graphsage", max_nodes=256)
    assert "tgn.memory_update_kernel" not in sage.metrics.snapshot()


def test_add_stage_registers_a_models_stage_in_a_private_tracer():
    tracer = SpanTracer()
    assert "memory" not in tracer.hists and "memory" not in tracer.cpu
    tracer.add_stage("memory")
    with tracer.span("memory"):
        pass
    assert tracer.hists["memory"].snapshot()["count"] == 1 and tracer.cpu["memory"].value >= 0
    assert tracer.stage_snapshot()["memory"]["count"] == 1


def _reader(name):
    return spec.reader(ROOT, name)


def test_the_cells_readers_read_a_record_and_nothing_without_their_series():
    cfg = spec.cell(ROOT, CELL).config
    k1_bytes = yardstick.sorted_segment_sum_bytes(dict(cfg, model="graphsage"), 131_072, 49_152)
    k1_ns = int(2 * k1_bytes / 3.35e12 / 0.25 * 1e9)  # two launches at a quarter of the bound
    tr = trace.DeviceTrace(window_s=2.0, busy_s=0.5, device=[
        ("scatter_sum_sorted_kernel<bf16>", 0, k1_ns // 2), ("scatter_sum_sorted_kernel<bf16>", k1_ns // 2, k1_ns),
        ("gemm", k1_ns, k1_ns + 1_000)])
    full = {"cfg": cfg, "n_nodes": 110_000, "n_edges": 40_000, "n_pad": 131_072, "e_pad": 49_152,
            "windows_scored": 100, "memory_device_ms": 1.25, "trace": tr, "scorer_busy_s": 2.0,
            "stage_s_sum": 0.05, "stage_count": 100, "close_to_score_p95_ms": 70.0, "edges_scored_per_s": 1e5}
    assert _reader("memory.device_ms.stream")(full) == 1.25
    bytes_ = yardstick_tgn.memory_update_bytes(cfg, 131_072)
    assert bytes_ == 131_072 * (128 * 4 + 128 * 2 + 1 + 128 * 4) + 3 * (2 * 128 * 128 + 128) * 4
    assert _reader("memory_roofline")(full) == pytest.approx(100 * bytes_ / 3.35e12 / 1.25e-3)
    flops = yardstick_tgn.step_flops(cfg, 110_000, 40_000)
    assert _reader("stream.mfu")(full) == pytest.approx(100 * flops * 100 / (0.5 * 989e12))
    assert _reader("k1_roofline.stream")(full) == pytest.approx(25.0, rel=1e-4)  # ns rounding
    # the windows cell's readers the cell's record also serves
    assert _reader("device_idle.score")(full) == pytest.approx(75.0)
    assert _reader("scorer.busy_ms.score")(full) == pytest.approx(20.0)
    assert _reader("stage.ms.score")(full) == pytest.approx(0.5)
    assert _reader("close_to_score.p95_ms.score")(full) == 70.0
    assert _reader("scorer.edges_per_s")(full) == 1e5
    # a parent's run: no memory series, and an untraced one: no trace
    parent = dict(full, memory_device_ms=None, trace=None)
    for name in ("memory.device_ms.stream", "memory_roofline", "stream.mfu", "k1_roofline.stream",
                 "device_idle.score"):
        assert _reader(name)(parent) is None
    cell = spec.cell(ROOT, CELL)
    assert {m["name"] for m in cell.per_layer} == {
        "memory.device_ms.stream", "memory_roofline", "stream.mfu", "k1_roofline.stream", "device_idle.score",
        "scorer.busy_ms.score", "stage.ms.score", "close_to_score.p95_ms.score", "scorer.edges_per_s"}


@pytest.mark.cuda
def test_memory_device_time_from_events_on_card():
    """On a card each window's ``latency.memory_device_s`` observation is
    the update's device time: positive, within the score step's device
    time around it, read (with the window's rows) when the next window is
    scored, so the last window's waits; the event pairs go back to their
    pool."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    score_s = []
    svc = _served("tgn", max_nodes=1024, device="cuda", windows=6, on_score=score_s.append)
    memory = svc.metrics.histogram("latency.memory_device_s").snapshot()
    snap = svc.metrics.snapshot()
    assert svc.scored_batches == 6 and len(score_s) == 6
    assert memory["count"] == 5 and 0 < memory["sum"] <= sum(score_s[:5])
    assert snap["latency.memory_s.count"] == 6 and snap["tgn.memory_rows_updated"] == 5 * (PODS + SERVICES)


@pytest.mark.cuda
def test_memory_update_kernel_gauge_counts_a_launch_a_window_on_card():
    """On a card every window's memory update is one GRU kernel launch:
    ``tgn.memory_update_kernel`` moves by the windows scored."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from alaz_tpu_torch.ops import gru_kernels

    before = gru_kernels.gru_update.launches
    svc = _served("tgn", max_nodes=1024, device="cuda", windows=4)
    assert svc.scored_batches == 4
    assert svc.metrics.snapshot()["tgn.memory_update_kernel"] - before == 4
