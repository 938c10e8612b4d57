"""The port's GraphSAGE forward against the JAX package's, on the CPU.

The JAX ``graphsage.init`` params are carried across with
``convert.params_from_jax`` and both packages score the same synthetic
window (bucket 256x1024, the specfiles' bucket). Outputs are compared
on real edges (``edge_logits[:n_edges]``) and real nodes
(``node_logits[:n_nodes]``).

Tolerances:
- f32: rtol/atol 1e-4, what the JAX package holds its sharded twins to.
- bf16 (the default config; JAX runs its kernels in interpret mode): the
  two frameworks round to bf16 at the same points, but their matmuls
  accumulate in another order, so a bf16 activation may land an ulp
  apart and carry that through two layers and the heads. bf16 keeps 8
  significant bits; logits are held to |Δ| ≤ 2^-6·max|ref|, four bf16
  ulps of the largest logit.
"""

from __future__ import annotations

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from alaz_tpu.config import ModelConfig as JaxConfig
from alaz_tpu.models import graphsage as jsage
from alaz_tpu_torch.config import ModelConfig
from alaz_tpu_torch.convert import graph_to_torch, params_from_jax, params_to_numpy
from alaz_tpu_torch.models import experts, gat, graphsage, registry, tgn
from alaz_tpu_torch.replay.synth import example_batch

SPEC = Path(__file__).resolve().parent.parent / "resources" / "specs" / "graphsage_256x1024.json"
WINDOW = dict(n_pods=180, n_svcs=20, n_edges=1000, seed=1)


@pytest.fixture(scope="module")
def batch():
    return jax_entry._example_batch(**WINDOW)


def _jax_forward(cfg: JaxConfig, batch, layout="coo"):
    params = jsage.init(jax.random.PRNGKey(0), cfg)
    graph = {k: jax.numpy.asarray(v) for k, v in batch.device_arrays(layout).items()}
    out = jax.jit(lambda p, g: jsage.apply(p, g, cfg))(params, graph)
    return jax.tree_util.tree_map(np.asarray, params), {k: np.asarray(v, np.float32) for k, v in out.items()}


def _port_model(np_params, cfg: ModelConfig):
    model = graphsage.GraphSAGE(cfg)
    model.load_state_dict(params_from_jax(np_params))
    return model


def _port_forward(model, cfg: ModelConfig, batch, layout="coo"):
    cfg = ModelConfig(**{**cfg.__dict__, "edge_layout": layout})
    with torch.no_grad():
        out = graphsage.apply(model, graph_to_torch(batch.device_arrays(layout), "cpu"), cfg)
    return out


def _real(out, batch):
    e = out["edge_logits"][: batch.n_edges]
    n = out["node_logits"][: batch.n_nodes]
    if isinstance(e, torch.Tensor):
        e, n = e.numpy(), n.numpy()
    return e, n


def _assert_bf16_close(got, ref):
    bound = 2.0**-6 * np.abs(ref).max()
    assert np.abs(got - ref).max() <= bound, (np.abs(got - ref).max(), bound)


@pytest.mark.parametrize("layout", ["coo", "blocked"])
def test_f32_forward_matches(batch, layout):
    jcfg = JaxConfig(hidden_dim=32, dtype="float32", use_pallas=False, edge_layout=layout)
    np_params, ref = _jax_forward(jcfg, batch, layout)
    cfg = ModelConfig(hidden_dim=32, dtype="float32")
    got = _port_forward(_port_model(np_params, cfg), cfg, batch, layout)
    for g, r in zip(_real(got, batch), _real(ref, batch)):
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("hidden", [32, 128])
def test_bf16_forward_matches_interpret_kernels(batch, hidden):
    jcfg = JaxConfig(hidden_dim=hidden, use_pallas="interpret")
    np_params, ref = _jax_forward(jcfg, batch)
    cfg = ModelConfig(hidden_dim=hidden)
    model = _port_model(np_params, cfg)
    coo = _port_forward(model, cfg, batch, "coo")
    for g, r in zip(_real(coo, batch), _real(ref, batch)):
        _assert_bf16_close(g, r)
    # the port's blocked forward is the COO forward, bit for bit, on
    # real rows
    blk = _port_forward(model, cfg, batch, "blocked")
    for g, r in zip(_real(blk, batch), _real(coo, batch)):
        np.testing.assert_array_equal(g, r)
    assert torch.equal(blk["node_h"][: batch.n_nodes], coo["node_h"][: batch.n_nodes])


def test_param_and_output_shapes_match_specfile(batch):
    spec = json.loads(SPEC.read_text())
    cfg = ModelConfig()
    assert spec["bucket"] == {"n_pad": 256, "e_pad": 1024}
    assert spec["config"] == {k: getattr(cfg, k) for k in spec["config"]}
    model = graphsage.init(0, cfg, device="cpu")
    shapes = {k.replace(".", "/"): list(v.shape) for k, v in model.state_dict().items()}
    assert shapes == {k: v["shape"] for k, v in spec["params"].items()}
    out = _port_forward(model, cfg, example_batch(**WINDOW))
    dt = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    assert {k: {"dtype": dt[v.dtype], "shape": list(v.shape)} for k, v in out.items()} == spec["outputs"]


def test_params_round_trip():
    cfg = JaxConfig(hidden_dim=32)
    tree = jax.tree_util.tree_map(np.asarray, jsage.init(jax.random.PRNGKey(3), cfg))
    back = params_to_numpy(_port_model(tree, ModelConfig(hidden_dim=32)))
    flat_a, struct_a = jax.tree_util.tree_flatten(tree)
    flat_b, struct_b = jax.tree_util.tree_flatten(back)
    assert struct_a == struct_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_init_is_seeded():
    cfg = ModelConfig(hidden_dim=32)
    a = graphsage.init(5, cfg, device="cpu").state_dict()
    b = graphsage.init(torch.Generator().manual_seed(5), cfg, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["embed.w"].std()) == pytest.approx((2.0 / 32) ** 0.5, rel=0.2)


def test_blocked_config_without_extents_raises(batch):
    cfg = ModelConfig(hidden_dim=32, edge_layout="blocked")
    model = graphsage.init(0, cfg, device="cpu")
    with torch.no_grad(), pytest.raises(ValueError, match="edge_block_starts"):
        graphsage.apply(model, graph_to_torch(batch.device_arrays("coo"), "cpu"), cfg)


def test_registry():
    """Every family of the JAX package's registry is ported: the registry
    returns each one's init and apply, and an unknown name raises."""
    assert registry.get_model("graphsage") == (graphsage.init, graphsage.apply)
    assert registry.get_model("gat") == (gat.init, gat.apply)
    assert registry.get_model("tgn") == (tgn.init, tgn.apply)
    assert registry.get_model("experts") == (experts.init, experts.apply)
    assert registry.REGISTERED_MODELS == ("graphsage", "gat", "tgn", "experts")
    with pytest.raises(ValueError, match="unknown model"):
        registry.get_model("gcn")
