"""The edge-type experts through the Service, on the CPU: the port against
the benchmark's plain reference (``gpu_bench/reference_experts.py``), the
``experts-fleet-stream`` cell's load through ``run.execute`` at a small
size, the control and the fault the cell exists to catch, the expert
dispatch's span and routing series, and the cell's counts and readers.

Tolerances:
- float32 (``use_pallas`` False): rtol/atol 1e-5 on the logits. Both
  sides compute the same equations in f32 and differ only in summation
  order (the program's table form sums each message's product over the
  same 128 terms as the reference's routed one; the segment sums add the
  same messages in another order).
- bfloat16 (the cell's configuration): half the cell's own score limit
  (``limits/experts-fleet-stream.json``), since the port rounds every
  matrix product's operands, the degree and the residual stream to bf16
  and the reference keeps them in f32; through two layers and the edge
  head that moves a score by ~1e-2 at these sizes, as in the other cells.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from alaz_tpu_torch.config import ModelConfig, RuntimeConfig
from alaz_tpu_torch.convert import graph_to_torch
from alaz_tpu_torch.models import experts
from alaz_tpu_torch.runtime.service import Service
from gpu_bench import (common, gen_stream, gen_windows, plant_experts, reference, reference_experts, run, spec, trace,
                       yardstick, yardstick_experts)
from gpu_bench.loads import stream_stateless

ROOT = Path(__file__).resolve().parent.parent
CELL = "experts-fleet-stream"
CONFIG = ROOT / "gpu_bench" / "configs" / "experts-fleet100k.json"
LIMITS = json.loads((ROOT / "gpu_bench" / "limits" / f"{CELL}.json").read_text())
PODS, SERVICES, EDGES = 600, 60, 400
T = 9
# every slot's code, and codes outside [0, T), which route to no expert
ODD_CODES = np.asarray([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 12, -1, -3], dtype=np.int32)


def _cfg(dtype="bfloat16") -> dict:
    cfg = json.loads(CONFIG.read_text())
    cfg["deployment"].update(pods=PODS, services=SERVICES, window_edges=EDGES)
    cfg.update(dtype=dtype, use_pallas=dtype == "bfloat16")
    return cfg


def _windows(cfg: dict, seed: int, count: int, odd: bool = True) -> list:
    raws = gen_stream.make_windows(cfg, seed, count)
    if odd:
        for r in raws:
            r["edge_type"][: ODD_CODES.shape[0]] = ODD_CODES
    return raws


def _scores(cfg: dict, seed: int, count: int = 2) -> list:
    """Each window's (program logits, reference logits), both in the
    program's edge order."""
    raws = _windows(cfg, seed, count)
    params = reference_experts.make_params(cfg, seed, "cpu")
    reference_experts.set_alert_share(params, raws[0], cfg, 0.02, "cpu")
    mcfg, model = common.program_model(cfg, params, "cpu")
    reference.tf32_off()
    out = []
    with torch.no_grad():
        for r in raws:
            b = common.to_batch(r)
            got = experts.apply(model, graph_to_torch(b.device_arrays(), "cpu"), mcfg)["edge_logits"][: b.n_edges]
            want = reference_experts.forward(params, reference.to_tensors(r, "cpu"), cfg)
            out.append((got.numpy(), want.numpy()[gen_windows.dst_order(r["edge_dst"])]))
    return out


def test_the_program_matches_the_reference_in_f32():
    for got, want in _scores(_cfg("float32"), seed=3):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_the_program_holds_half_the_cells_score_limit_in_bf16():
    worst = 0.0
    for got, want in _scores(_cfg(), seed=4):
        gap = np.abs(torch.sigmoid(torch.from_numpy(got)).numpy() - torch.sigmoid(torch.from_numpy(want)).numpy())
        worst = max(worst, float(gap.max()))
    assert 0 < worst <= LIMITS["score_max_abs_err"] / 2, worst


def test_the_reference_routes_each_edge_to_its_own_expert():
    """The routed message of an edge of type t is ``h[src]·W_t + b_t``, and
    an edge outside [0, T) gets none: the reference against the product
    written out edge by edge."""
    cfg = _cfg("float32")
    p = reference_experts.make_params(cfg, 9, "cpu")
    h = torch.randn(20, cfg["hidden_dim"], generator=torch.Generator().manual_seed(1))
    src = torch.arange(ODD_CODES.shape[0]) % 20
    etype = torch.from_numpy(ODD_CODES).long()
    msgs = reference_experts.expert_messages(p, "layers.0", h, src, etype)
    for e, t in enumerate(ODD_CODES.tolist()):
        want = h[src[e]] @ p["layers.0.expert_w"][t] + p["layers.0.expert_b"][t] if 0 <= t < T else torch.zeros(128)
        torch.testing.assert_close(msgs[e], want, rtol=0, atol=0)


def test_the_references_params_load_into_the_programs_model():
    cfg = _cfg()
    params = reference_experts.make_params(cfg, 5, "cpu")
    _, model = common.program_model(cfg, params, "cpu")  # strict: every name and shape
    assert params["layers.1.expert_w"].shape == (T, 128, 128) and params["layers.1.expert_b"].shape == (T, 128)
    assert set(reference_experts.param_spec(cfg)) == set(model.state_dict())


def test_around_dispatch_is_entered_once_a_layer_and_changes_no_number():
    cfg = _cfg()
    raws = _windows(cfg, 6, 1)
    params = reference_experts.make_params(cfg, 6, "cpu")
    mcfg, model = common.program_model(cfg, params, "cpu")
    graph = graph_to_torch(common.to_batch(raws[0]).device_arrays(), "cpu")
    entered = []

    class Hook:
        def __enter__(self):
            entered.append(1)

        def __exit__(self, *exc):
            return False

    with torch.no_grad():
        plain = experts.apply(model, graph, mcfg)["edge_logits"]
        hooked = experts.apply(model, graph, mcfg, around_dispatch=Hook)["edge_logits"]
    assert len(entered) == cfg["num_layers"]
    assert torch.equal(plain, hooked)


# -- the cell's load through run.execute, on a tiny deployment ----------------


@pytest.fixture
def tiny_root(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "gpu_bench", root / "gpu_bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    cfg = json.loads(CONFIG.read_text())
    cfg["deployment"].update(pods=PODS, services=SERVICES, window_edges=EDGES)
    (root / "gpu_bench" / "configs" / CONFIG.name).write_text(json.dumps(cfg))
    traffic = root / "gpu_bench" / "traffic" / "fleet-stream-stateless.json"
    traffic.write_text(json.dumps(dict(json.loads(traffic.read_text()), distinct_windows=3, warmup_passes=1,
                                       poll_s=0.001)))
    return root


def _execute(root, seed, seconds=1.0):
    return run.execute(CELL, seed, seconds, False, device="cpu", root=root)


def test_the_cells_load_through_run_execute_is_correct(tiny_root):
    result = _execute(tiny_root, 2**31 + 2718)
    checks = result["checks"]
    assert result["correct"], checks
    assert set(checks) == {"score_max_abs_err", "sink_rows_wrong", "windows_unscored",
                           "distinct_windows_uncompared", "routing_wrong"}
    assert 0 < checks["score_max_abs_err"]["value"] <= checks["score_max_abs_err"]["limit"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert result["device"]["platform"] == "cpu"


def test_the_cells_load_records_the_routing_its_checks_read(tiny_root):
    cell = spec.cell(tiny_root, CELL)
    out = stream_stateless.run(cell, 2**31 + 2719, 1.0, False, "cpu")
    raws = gen_stream.make_windows(cell.config, 2**31 + 2719, 3)
    per_window = np.bincount(raws[0]["edge_type"], minlength=T)
    assert out.record["edges_routed"] == (out.record["handoffs"] * per_window).tolist()
    assert out.record["experts_live"] == 4  # config5's four protocols
    assert out.checks["routing_wrong"]["value"] == 0


@pytest.mark.parametrize("name, check", [("fp8", "score_max_abs_err"), ("expert_shift", "score_max_abs_err")])
def test_the_control_and_the_fault_come_out_not_correct(tiny_root, name, check):
    cfg = spec.cell(tiny_root, CELL).config
    with plant_experts.planted(name, cfg):
        result = _execute(tiny_root, 2**31 + 2720)
    checks = result["checks"]
    assert not result["correct"]
    assert checks[check]["value"] > checks[check]["limit"], checks
    # the plant reached the scores alone: every window scored, routed and compared
    assert checks["windows_unscored"]["value"] == 0 and checks["routing_wrong"]["value"] == 0
    assert checks["distinct_windows_uncompared"]["value"] == 0
    assert experts.apply.__name__ == "apply" and experts._expert_messages_table.__name__ == "_expert_messages_table"


def test_a_program_without_the_routing_counters_stops_at_set_up(tiny_root, monkeypatch):
    """The parent's program scores the experts without counting their
    routes: the cell stops before its warm-up, with an error."""
    monkeypatch.setattr(Service, "_experts_score_fn", lambda self, score_apply: score_apply)
    with pytest.raises(RuntimeError, match="experts.edges_routed"):
        _execute(tiny_root, 2**31 + 2721)


# -- the Service's expert series ---------------------------------------------


def _served(model: str, windows: int = 3, batch_windows: int = 1, backlog: bool = False):
    cfg = _cfg()
    raws = _windows(cfg, 7, windows)
    mcfg = common.model_config(dict(cfg, model=model))
    if model == "experts":
        params = reference_experts.make_params(cfg, 7, "cpu")
    else:
        params = reference.make_params(dict(cfg, model=model), 7, "cpu")
    _, module = common.program_model(dict(cfg, model=model), params, "cpu")
    svc = Service(config=RuntimeConfig(model=mcfg, score_batch_windows=batch_windows), model_state=module,
                  device="cpu")

    def hand_over():
        for k, r in enumerate(raws):
            svc.graph_store.on_batch(common.handoff(common.to_batch(r), k))

    if backlog:
        hand_over()
    svc.start()
    try:
        if not backlog:
            hand_over()
        svc.drain(60)
    finally:
        svc.stop()
    live = [np.bincount(r["edge_type"][(r["edge_type"] >= 0) & (r["edge_type"] < T)], minlength=T) for r in raws]
    return svc, np.sum(live, axis=0), live[-1]


def test_the_routing_counters_and_the_span_stage_under_experts_alone():
    svc, routed, last = _served("experts")
    snap = svc.metrics.snapshot()
    assert svc.scored_batches == 3
    assert [snap[f"experts.edges_routed.e{t}"] for t in range(T)] == routed.tolist()
    assert snap["experts.live"] == np.count_nonzero(last) == T  # every slot's code is in each window
    assert snap["latency.experts_s.count"] == 3 * 2 and snap["cpu.experts_s"] >= 0  # a span a layer
    assert "latency.experts_device_s.count" not in snap  # a card's series
    assert "experts" in svc.tracer.stage_snapshot()

    sage, _, _ = _served("graphsage")
    names = set(sage.metrics.snapshot())
    assert sage.scored_batches == 3
    assert not {n for n in names if n.startswith(("experts.", "latency.experts", "cpu.experts"))}
    assert "experts" not in sage.tracer.stage_snapshot()


def test_the_stacked_group_path_scores_the_experts_and_counts_their_routes():
    """A backlog under ``score_batch_windows`` 4 goes through the stacked
    twin (``_batched_score_fn``): its windows score as the serial path's,
    and their routes are counted at staging all the same."""
    group, routed, _ = _served("experts", windows=4, batch_windows=4, backlog=True)
    serial, _, _ = _served("experts", windows=4)
    assert group.scored_batches == 4 and group.score_dispatches < 4
    snap = group.metrics.snapshot()
    assert [snap[f"experts.edges_routed.e{t}"] for t in range(T)] == routed.tolist()
    assert snap["scored.edges"] == serial.metrics.snapshot()["scored.edges"]


# -- counts and readers -------------------------------------------------------


def test_yardstick_counts_against_hand_worked_numbers():
    cfg = json.loads(CONFIG.read_text())
    # one layer over 49,152 slots: 4 + 4 B of ids, a 256 B bf16 row read and
    # a 256 B message written each; 9 f32 experts of 128 x 128 and their biases
    assert yardstick_experts.dispatch_bytes(cfg, 49_152) == 49_152 * 520 + 9 * (16_384 + 128) * 4 == 26_153_472
    assert yardstick_experts.dispatch_bytes(dict(cfg, dtype="float32"), 1) == 8 + 2 * 512 + 9 * 16_512 * 4
    # embed 2·N·32·128; each layer 2·E·128·128 routed, 2·E·23·128 edge
    # projection, 2 × 2·N·128·128 self and neighbour; the edge head 2 × 2·N·128·128,
    # 2·E·23·128, 2·E·128; the node head 2·N·128·128 + 2·N·128
    n, e = 110_000, 40_000
    want = (2 * n * 32 * 128 + 2 * (2 * e * 128 * 128 + 2 * e * 23 * 128 + 2 * 2 * n * 128 * 128)
            + 2 * 2 * n * 128 * 128 + 2 * e * 23 * 128 + 2 * e * 128 + 2 * n * 128 * 128 + 2 * n * 128)
    assert yardstick_experts.forward_flops(cfg, n, e) == want


def _reader(name):
    return spec.reader(ROOT, name)


def test_the_cells_readers_read_a_record_and_nothing_without_their_series():
    cfg = spec.cell(ROOT, CELL).config
    k1_bytes = yardstick.sorted_segment_sum_bytes(dict(cfg, model="graphsage"), 131_072, 49_152)
    k1_ns = int(2 * k1_bytes / 3.35e12 / 0.25 * 1e9)  # two launches at a quarter of the bound
    tr = trace.DeviceTrace(window_s=2.0, busy_s=0.5, device=[
        ("scatter_sum_sorted_kernel<bf16>", 0, k1_ns // 2), ("scatter_sum_sorted_kernel<bf16>", k1_ns // 2, k1_ns)],
        host=[("alaz.handoff", 0, 3_000_000, 1), ("alaz.handoff", 5_000_000, 6_000_000, 1),
              ("alaz.experts", 0, 9_000_000, 2)])
    full = {"cfg": cfg, "n_nodes": 110_000, "n_edges": 40_000, "n_pad": 131_072, "e_pad": 49_152,
            "windows_scored": 100, "trace": tr, "scorer_busy_s": 2.0,
            "stage_s_sum": 0.05, "stage_count": 100, "close_to_score_p95_ms": 70.0, "edges_scored_per_s": 1e5}
    assert _reader("handoff.ms.score")(full) == pytest.approx(2.0)  # the load's hand-offs alone
    flops = yardstick_experts.forward_flops(cfg, 110_000, 40_000)
    assert _reader("experts.mfu")(full) == pytest.approx(100 * flops * 100 / (0.5 * 989e12))
    assert _reader("k1_roofline.stream")(full) == pytest.approx(25.0, rel=1e-4)  # ns rounding
    assert _reader("device_idle.score")(full) == pytest.approx(75.0)
    assert _reader("scorer.busy_ms.score")(full) == pytest.approx(20.0)
    # an untraced run: nothing on the device or in the spans to read
    parent = dict(full, trace=None)
    for name in ("experts.mfu", "k1_roofline.stream", "device_idle.score", "handoff.ms.score"):
        assert _reader(name)(parent) is None
    assert {m["name"] for m in spec.cell(ROOT, CELL).per_layer} == {
        "experts.mfu", "k1_roofline.stream", "device_idle.score", "handoff.ms.score",
        "scorer.busy_ms.score", "stage.ms.score", "close_to_score.p95_ms.score", "scorer.edges_per_s"}
    assert {m["name"] for m in spec.cell(ROOT, CELL).end_to_end} == {"window_device_ms", "setup_s"}


def test_the_configuration_is_the_programs_default_widths_under_config5():
    cfg = json.loads(CONFIG.read_text())
    default = ModelConfig()
    for key in ("hidden_dim", "num_layers", "num_edge_types", "node_feature_dim", "edge_feature_dim",
                "edge_feat_znorm", "dtype", "expert_dispatch"):
        assert cfg[key] == getattr(default, key), key
    mcfg = dataclasses.replace(common.model_config(cfg), expert_dispatch=cfg["expert_dispatch"])
    assert mcfg.model == "experts" and mcfg.expert_dispatch == "table"
    tgn = json.loads((ROOT / "gpu_bench" / "configs" / "tgn-fleet100k.json").read_text())
    assert cfg["deployment"]["protocol_mix"] == tgn["deployment"]["protocol_mix"]
    for key in ("pods", "services", "window_edges"):
        assert cfg["deployment"][key] == tgn["deployment"][key]
    codes = set(gen_stream.PROTOCOL_TYPES[k] for k in cfg["deployment"]["protocol_mix"])
    assert codes == {1, 3, 5, 7} and all(0 <= c < cfg["num_edge_types"] for c in codes)


@pytest.mark.cuda
def test_the_dispatch_device_time_from_events_on_card():
    """On a card each window's ``latency.experts_device_s`` observation is
    the sum over its layers of the dispatch's device time: positive, within
    the score step's device time, read when the next window is scored, so
    the last window's waits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = _cfg()
    raws = _windows(cfg, 8, 5)
    params = reference_experts.make_params(cfg, 8, "cpu")
    mcfg, module = common.program_model(cfg, params, "cuda")
    svc = Service(config=RuntimeConfig(model=mcfg), model_state=module, device="cuda")
    score_s = []
    real = svc.device.observe_score
    svc.device.observe_score = lambda batch, dur_s: (score_s.append(dur_s), real(batch, dur_s))
    svc.start()
    try:
        for k, r in enumerate(raws):
            svc.graph_store.on_batch(common.handoff(common.to_batch(r), k))
        svc.drain(60)
    finally:
        svc.stop()
    dev = svc.metrics.histogram("latency.experts_device_s").snapshot()
    assert svc.scored_batches == 5 and len(score_s) == 5
    assert dev["count"] == 4 and 0 < dev["sum"] <= sum(score_s[:4])
    assert svc.metrics.snapshot()["latency.experts_s.count"] == 5 * 2
