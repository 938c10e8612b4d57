"""The reference and the frozen window generator against the program's
plain path, on the CPU at tiny sizes."""

import numpy as np
import pytest
import torch

from gpu_bench import common, gen_windows, reference

TINY = dict(pods=300, services=40, window_edges=2_000)


def _cfg(model: str, dtype: str = "float32") -> dict:
    return {
        "model": model, "hidden_dim": 32, "num_layers": 2, "num_heads": 4, "num_edge_types": 9,
        "node_feature_dim": 32, "edge_feature_dim": 16, "edge_feat_znorm": True, "dtype": dtype,
        "use_pallas": True, "src_gather": "banded" if model == "gat" else "xla", "edge_layout": "coo",
        "deployment": dict(TINY, structure="community" if model == "gat" else "uniform",
                           layout="clustered" if model == "gat" else "random"),
    }


@pytest.mark.parametrize("structure,layout", [("uniform", "random"), ("community", "clustered")])
def test_frozen_generator_draws_the_programs_windows(structure, layout):
    from alaz_tpu_torch.replay.synth import example_batch

    raw = gen_windows.make_window(7, 300, 40, 2_000, structure, layout)
    batch = common.to_batch(raw)
    ref = example_batch(n_pods=300, n_svcs=40, n_edges=2_000, seed=7, structure=structure, layout=layout)
    for k in ("node_feats", "node_type", "edge_src", "edge_dst", "edge_type", "edge_feats"):
        np.testing.assert_array_equal(getattr(batch, k), getattr(ref, k))


@pytest.mark.parametrize("model", ["graphsage", "gat"])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 0.25)])
def test_reference_forward_matches_the_programs_plain_path(model, dtype, tol):
    from alaz_tpu_torch.convert import graph_to_torch
    from alaz_tpu_torch.models.registry import get_model

    torch.manual_seed(0)
    cfg = _cfg(model, dtype)
    raw = common.make_raw_windows(cfg, 11, 1)[0]
    params = reference.make_params(cfg, 11, "cpu")
    mcfg, module = common.program_model(cfg, params, "cpu")
    batch = common.to_batch(raw)
    _, apply = get_model(model)
    with torch.no_grad():
        prog = apply(module, graph_to_torch(batch.device_arrays(), "cpu"), mcfg)["edge_logits"][: batch.n_edges]
        ref = reference.forward(params, reference.to_tensors(raw, "cpu"), cfg)
    ref = ref[torch.as_tensor(gen_windows.dst_order(raw["edge_dst"]))]
    assert float((prog - ref).abs().max()) < tol


def test_reference_train_steps_match_the_programs_train_step():
    from alaz_tpu_torch.train import trainstep

    cfg = _cfg("gat")
    raws = common.make_raw_windows(cfg, 5, 3, label_rate=0.05)
    params = reference.make_params(cfg, 5, "cpu")
    mcfg, module = common.program_model(cfg, params, "cpu")
    opt = trainstep._adamw(module, 3e-3)
    step = trainstep.make_train_step(mcfg, 10.0, "cpu")
    losses = [float(step(module, opt, b.device_arrays(), b.edge_label)) for b in map(common.to_batch, raws)]
    ref = reference.train_steps(params, [reference.to_tensors(r, "cpu") for r in raws], cfg, 3e-3)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    for k, p in module.named_parameters():
        assert float((p.detach() - ref["params"][k]).abs().max()) < 1e-5, k


def test_fp8_control_rounds_operands_and_their_gradients():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    y = reference.fp8_quant(x)
    err = (y - x).abs()
    assert float(err.max()) > 0 and bool((err <= x.abs() / 16 + 1e-6).all())  # e4m3: 3 mantissa bits
    g = torch.linspace(0.1, 1.3, 101)
    y.backward(g)
    gerr = (x.grad - g).abs()
    assert float(gerr.max()) > 0 and bool((gerr <= g / 8 + 1e-6).all())  # e5m2: 2 mantissa bits


def test_frozen_replay_generator_draws_the_programs_traffic():
    from alaz_tpu_torch.config import SimulationConfig
    from alaz_tpu_torch.replay.simulator import Simulator

    from gpu_bench import gen_replay

    mix = {"HTTP": 0.6, "POSTGRES": 0.15, "REDIS": 0.15, "MYSQL": 0.1}
    traffic = dict(pods=300, services=40, edges=200, edge_rate=25, protocol_mix=mix, event_seconds=2, chunk_size=512)
    sim = Simulator(SimulationConfig(test_duration_s=2, pod_count=300, service_count=40, edge_count=200,
                                     edge_rate=25, protocol_mix=mix, seed=9, chunk_size=512))
    msgs = sim.setup()
    topo = gen_replay.topology(traffic, 9)
    mine = gen_replay.k8s_messages(traffic)
    assert mine == msgs
    assert gen_replay.tcp_events(topo).tobytes() == sim.tcp_events().tobytes()
    theirs = list(sim.iter_l7_batches())
    ours = gen_replay.l7_batches(topo, traffic)
    assert len(ours) == len(theirs) and all(a.tobytes() == b.tobytes() for a, b in zip(ours, theirs))
