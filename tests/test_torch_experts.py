"""The port's edge-type experts model against the JAX package's, on the CPU.

The JAX ``experts.init`` params are carried across with
``convert.params_from_jax`` and both packages score the same synthetic
window (bucket 256x1024). Outputs are compared on real edges and nodes.

Tolerances:
- f32: rtol/atol 1e-4, the ROADMAP's oracle.
- bf16 (JAX with its kernels in interpret mode): the two frameworks
  round to bf16 at the same points but their matmuls accumulate in
  another order, and this model keeps its residual stream and degree in
  bf16 too, so an activation may land an ulp apart and carry that
  through two layers and the heads: logits held to |Δ| ≤ 2^-6·max|ref|,
  four bf16 ulps of the largest.
- table against masked: the same products and sums, taken as [N]-row
  matmuls then a gather, or [E]-row matmuls: f32 within 1e-5 of the
  largest logit; in bf16 the two round the expert products at different
  places (``u_t + b_t`` rounds once per node, ``h_src @ W + b`` per edge,
  and the masked sum adds T rounded terms): four bf16 ulps of the largest
  logit, as above.
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
from alaz_tpu.models import experts as jexperts
from alaz_tpu_torch.config import ModelConfig
from alaz_tpu_torch.convert import graph_to_torch, params_from_jax, params_to_numpy
from alaz_tpu_torch.models import experts, registry
from alaz_tpu_torch.ops import segment_kernels as K
from alaz_tpu_torch.runtime.scorer import WindowScorer
from test_torch_train import (
    assert_adamw_steps_match,
    assert_grads_match,
    jax_value_and_grad,
    labels_from_window,
    port_loss_and_grads,
)

SPEC = Path(__file__).resolve().parent.parent / "resources" / "specs" / "experts_256x1024.json"
WINDOW = dict(n_pods=180, n_svcs=20, n_edges=1000, seed=1)
CLUSTERED = dict(WINDOW, structure="community", layout="clustered")


@pytest.fixture(scope="module")
def batch():
    return jax_entry._example_batch(**WINDOW)


def _jax_forward(jcfg: JaxConfig, batch):
    params = jexperts.init(jax.random.PRNGKey(0), jcfg)
    graph = {k: jax.numpy.asarray(v) for k, v in batch.device_arrays().items()}
    out = jax.jit(lambda p, g: jexperts.apply(p, g, jcfg))(params, graph)
    return jax.tree_util.tree_map(np.asarray, params), {k: np.asarray(v, np.float32) for k, v in out.items()}


def _port_model(np_params, cfg: ModelConfig):
    model = experts.Experts(cfg)
    model.load_state_dict(params_from_jax(np_params), strict=True)
    return model


def _port_forward(model, cfg: ModelConfig, batch):
    with torch.no_grad():
        out = experts.apply(model, graph_to_torch(batch.device_arrays(), "cpu"), cfg)
    return {k: v.float().numpy() for k, v in out.items()}


def _real(out, batch):
    return out["edge_logits"][: batch.n_edges], out["node_logits"][: batch.n_nodes]


def _assert_bf16_close(got, ref):
    bound = 2.0**-6 * np.abs(ref).max()
    assert np.abs(got - ref).max() <= bound, (np.abs(got - ref).max(), bound)


@pytest.mark.parametrize("dispatch", ["table", "masked"])
def test_f32_forward_matches(batch, dispatch):
    jcfg = JaxConfig(model="experts", hidden_dim=32, dtype="float32", use_pallas=False, expert_dispatch=dispatch)
    np_params, ref = _jax_forward(jcfg, batch)
    cfg = ModelConfig(model="experts", hidden_dim=32, dtype="float32", expert_dispatch=dispatch)
    got = _port_forward(_port_model(np_params, cfg), cfg, batch)
    for g, r in zip(_real(got, batch), _real(ref, batch)):
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["node_h"][: batch.n_nodes], ref["node_h"][: batch.n_nodes], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dispatch,src_gather", [("table", "xla"), ("masked", "banded")])
def test_bf16_forward_matches_interpret_kernels(dispatch, src_gather):
    """The default width and dtype; the masked form over a clustered
    window with the banded src gather (K3), JAX in interpret mode."""
    b = jax_entry._example_batch(**CLUSTERED)
    jgather = "banded-interpret" if src_gather == "banded" else "xla"
    jcfg = JaxConfig(model="experts", use_pallas="interpret", expert_dispatch=dispatch, src_gather=jgather)
    np_params, ref = _jax_forward(jcfg, b)
    cfg = ModelConfig(model="experts", expert_dispatch=dispatch, src_gather=src_gather)
    K.reset_launch_counts()
    got = _port_forward(_port_model(np_params, cfg), cfg, b)
    assert K.launch_counts() == dict.fromkeys(K.launch_counts(), 0)  # CPU: plain versions
    for g, r in zip(_real(got, b), _real(ref, b)):
        _assert_bf16_close(g, r)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_table_and_masked_agree(batch, dtype):
    cfg = ModelConfig(model="experts", hidden_dim=32, dtype=dtype)
    model = experts.init(0, cfg, device="cpu")
    table = _port_forward(model, cfg, batch)
    masked = _port_forward(model, ModelConfig(model="experts", hidden_dim=32, dtype=dtype, expert_dispatch="masked"), batch)
    for g, r in zip(_real(masked, batch), _real(table, batch)):
        if dtype == "float32":
            assert np.abs(g - r).max() <= 1e-5 * np.abs(r).max()
        else:
            _assert_bf16_close(g, r)


def test_unknown_dispatch_raises(batch):
    cfg = ModelConfig(model="experts", hidden_dim=16, expert_dispatch="tabel")
    model = experts.init(0, cfg, device="cpu")
    with torch.no_grad(), pytest.raises(ValueError, match="expert_dispatch 'tabel'"):
        experts.apply(model, graph_to_torch(batch.device_arrays(), "cpu"), cfg)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_out_of_range_codes_give_zero_messages(dtype):
    """Protocol codes -1 and T (outside the T experts) get zero messages in
    both forms; the codes in range get their expert's message."""
    cfg = ModelConfig(model="experts", hidden_dim=8)
    layer = experts.init(0, cfg, device="cpu").layers[0]
    with torch.no_grad():
        layer.expert_b.copy_(torch.randn(layer.expert_b.shape))
    t = cfg.num_edge_types
    h = torch.randn(16, 8).to(dtype)
    src = torch.tensor([1, 2, 3, 4, 5], dtype=torch.int32)
    etype = torch.tensor([-1, t, 0, t - 1, 3], dtype=torch.int32)
    with torch.no_grad():
        table = experts._expert_messages_table(layer, h, src, etype, dtype)
        masked = experts._expert_messages_masked(layer, h[src], etype, dtype)
    for out in (table, masked):
        assert float(out[:2].float().abs().max()) == 0.0
        assert float(out[2:].float().abs().min()) > 0.0
    want = h[src[2]].float() @ layer.expert_w[0].detach() + layer.expert_b[0].detach()
    np.testing.assert_allclose(table[2].float().numpy(), want.numpy(), rtol=2**-6, atol=2**-6)


def test_registry_and_specfile(batch):
    assert registry.get_model("experts") == (experts.init, experts.apply)
    spec = json.loads(SPEC.read_text())
    cfg = ModelConfig(model="experts")
    assert spec["config"] == {k: getattr(cfg, k) for k in spec["config"]}
    model = registry.init_params(cfg, key=0, device="cpu")
    assert isinstance(model, experts.Experts)
    shapes = {k.replace(".", "/"): list(v.shape) for k, v in model.state_dict().items()}
    assert shapes == {k: v["shape"] for k, v in spec["params"].items()}
    out = _port_forward(model, cfg, jax_entry._example_batch(**WINDOW))
    assert {k: list(v.shape) for k, v in out.items()} == {k: v["shape"] for k, v in spec["outputs"].items()}


def test_params_round_trip_and_init():
    tree = jax.tree_util.tree_map(np.asarray, jexperts.init(jax.random.PRNGKey(3), JaxConfig(model="experts", hidden_dim=32)))
    back = params_to_numpy(_port_model(tree, ModelConfig(model="experts", hidden_dim=32)))
    flat_a, struct_a = jax.tree_util.tree_flatten(tree)
    flat_b, struct_b = jax.tree_util.tree_flatten(back)
    assert struct_a == struct_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    assert back["layers"][0]["expert_w"].shape == (9, 32, 32)
    cfg = ModelConfig(model="experts", hidden_dim=32)
    a = experts.init(5, cfg, device="cpu").state_dict()
    b = experts.init(torch.Generator().manual_seed(5), cfg, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["layers.0.expert_w"].std()) == pytest.approx((2.0 / 32) ** 0.5, rel=0.1)
    assert float(a["layers.0.expert_b"].abs().max()) == 0.0


@pytest.mark.parametrize("dispatch,src_gather", [("table", "xla"), ("masked", "banded")])
def test_gradients_match(dispatch, src_gather):
    """One step's loss and every param's gradient, f32, JAX with its
    kernels in interpret mode; the masked form reaches K3 (and its
    backward) through the banded src gather. rtol/atol 1e-4."""
    b = jax_entry._example_batch(**CLUSTERED)
    label = labels_from_window(b)
    jgather = "banded-interpret" if src_gather == "banded" else "xla"
    jcfg = JaxConfig(model="experts", hidden_dim=32, dtype="float32", use_pallas="interpret",
                     expert_dispatch=dispatch, src_gather=jgather)
    np_params, ref_loss, ref_grads = jax_value_and_grad(jcfg, b, label)
    cfg = ModelConfig(model="experts", hidden_dim=32, dtype="float32", expert_dispatch=dispatch, src_gather=src_gather)
    _, loss, grads = port_loss_and_grads(np_params, cfg, b, label)
    assert loss == pytest.approx(ref_loss, rel=1e-5)
    assert_grads_match(grads, ref_grads)


def test_adamw_three_steps_match_optax(batch):
    assert_adamw_steps_match("experts", batch)


def test_window_scorer_scores_experts(batch):
    cfg = ModelConfig(model="experts", hidden_dim=32)
    scorer = WindowScorer(cfg, registry.init_params(cfg, key=0, device="cpu"), device="cpu")
    scores = scorer.score(batch)
    assert scores.dtype == np.float32 and scores.shape == (batch.n_edges,)
    assert np.isfinite(scores).all() and ((scores >= 0) & (scores <= 1)).all()
    assert scorer.memory is None
