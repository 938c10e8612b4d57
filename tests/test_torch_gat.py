"""The port's GAT forward against the JAX package's, on the CPU.

The JAX ``gat.init`` params are carried across with
``convert.params_from_jax`` (``load_state_dict(strict=True)``) and both
packages score the same synthetic window (bucket 256x1024, the
specfiles' bucket). Logits are compared on real edges and real nodes,
``node_h`` on real nodes.

Tolerances:
- f32: rtol/atol 1e-4, what the JAX package holds its sharded twins to.
- bf16 (the default config, on a community window laid out by
  ``cluster_renumber`` and gathered with ``src_gather="banded"``; JAX
  runs its kernels in interpret mode): the two frameworks round to bf16
  at the same points (the einsums, the weights cast twice, the f32
  denominator) but their matmuls accumulate in another order, so a bf16
  activation may land an ulp apart and carry that through two layers and
  the heads: logits are held to |Δ| ≤ 2^-6·max|ref|, four bf16 ulps of
  the largest.
- ``attn_clamp_saturation``: equal. It counts logits at or past ±30; the
  scaled-up case is run in f32, where no logit of this window lies
  within rounding of the clamp.
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
from alaz_tpu.models import gat as jgat
from alaz_tpu_torch.config import ModelConfig
from alaz_tpu_torch.convert import graph_to_torch, params_from_jax, params_to_numpy
from alaz_tpu_torch.models import gat, registry
from alaz_tpu_torch.ops import segment_kernels as K
from alaz_tpu_torch.replay.synth import example_batch
from alaz_tpu_torch.runtime.scorer import WindowScorer
from alaz_tpu_torch.train.trainstep import score_batch

SPEC = Path(__file__).resolve().parent.parent / "resources" / "specs" / "gat_256x1024.json"
WINDOW = dict(n_pods=180, n_svcs=20, n_edges=1000, seed=1)
CLUSTERED = dict(WINDOW, structure="community", layout="clustered")


@pytest.fixture(scope="module")
def batch():
    return jax_entry._example_batch(**WINDOW)


@pytest.fixture(scope="module")
def clustered():
    return jax_entry._example_batch(**CLUSTERED)


def _jax_forward(cfg: JaxConfig, batch, layout="coo", scale_attn=1.0):
    params = jgat.init(jax.random.PRNGKey(0), cfg)
    for layer in params["layers"]:
        layer["attn"] = layer["attn"] * scale_attn
    graph = {k: jax.numpy.asarray(v) for k, v in batch.device_arrays(layout).items()}
    out = jax.jit(lambda p, g: jgat.apply(p, g, cfg))(params, graph)
    return jax.tree_util.tree_map(np.asarray, params), {k: np.asarray(v, np.float32) for k, v in out.items()}


def _port_model(np_params, cfg: ModelConfig):
    model = gat.GAT(cfg)
    model.load_state_dict(params_from_jax(np_params), strict=True)
    return model


def _port_forward(model, cfg: ModelConfig, batch, layout="coo"):
    cfg = ModelConfig(**{**cfg.__dict__, "edge_layout": layout})
    with torch.no_grad():
        out = gat.apply(model, graph_to_torch(batch.device_arrays(layout), "cpu"), cfg)
    return {k: v.float().numpy() for k, v in out.items()}


def _real(out, batch):
    return (
        out["edge_logits"][: batch.n_edges],
        out["node_logits"][: batch.n_nodes],
        out["node_h"][: batch.n_nodes],
    )


@pytest.mark.parametrize("layout", ["coo", "blocked"])
@pytest.mark.parametrize("src_gather", ["xla", "banded"])
def test_f32_forward_matches(batch, layout, src_gather):
    jcfg = JaxConfig(model="gat", hidden_dim=32, dtype="float32", use_pallas=False, edge_layout=layout)
    np_params, ref = _jax_forward(jcfg, batch, layout)
    cfg = ModelConfig(model="gat", hidden_dim=32, dtype="float32", src_gather=src_gather)
    got = _port_forward(_port_model(np_params, cfg), cfg, batch, layout)
    for g, r in zip(_real(got, batch), _real(ref, batch)):
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4)
    assert got["attn_clamp_saturation"] == ref["attn_clamp_saturation"]


def test_bf16_banded_forward_matches_interpret_kernels(clustered):
    """The default width and dtype, JAX with its kernels (K1-K3) in
    interpret mode; the port through its wrappers' plain versions. The
    port's blocked forward equals its COO forward bit for bit, and its
    xla src gather equals its banded one bit for bit (K3 is exact)."""
    jcfg = JaxConfig(model="gat", use_pallas="interpret", src_gather="banded-interpret")
    np_params, ref = _jax_forward(jcfg, clustered)
    cfg = ModelConfig(model="gat", src_gather="banded")
    model = _port_model(np_params, cfg)
    K.reset_launch_counts()
    coo = _port_forward(model, cfg, clustered)
    assert K.launch_counts() == dict.fromkeys(K.launch_counts(), 0)  # CPU: plain versions
    got_e, got_n, _ = _real(coo, clustered)
    ref_e, ref_n, _ = _real(ref, clustered)
    for g, r in ((got_e, ref_e), (got_n, ref_n)):
        assert np.abs(g - r).max() <= 2.0**-6 * np.abs(r).max(), (np.abs(g - r).max(), np.abs(r).max())
    assert coo["attn_clamp_saturation"] == ref["attn_clamp_saturation"]
    blk = _port_forward(model, cfg, clustered, "blocked")
    xla = _port_forward(model, ModelConfig(model="gat", src_gather="xla"), clustered)
    for other in (blk, xla):
        for g, r in zip(_real(other, clustered), _real(coo, clustered)):
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("scale", [1.0, 400.0])
def test_attn_clamp_saturation_matches(batch, scale):
    """Scaled up, the attention vectors push logits past ±30: the gauge
    turns on and both packages count the same logits."""
    jcfg = JaxConfig(model="gat", hidden_dim=32, dtype="float32", use_pallas=False)
    np_params, ref = _jax_forward(jcfg, batch, scale_attn=scale)
    cfg = ModelConfig(model="gat", hidden_dim=32, dtype="float32")
    got = _port_forward(_port_model(np_params, cfg), cfg, batch)
    sat = float(got["attn_clamp_saturation"])
    assert sat == float(ref["attn_clamp_saturation"])
    assert (sat > 0.05) if scale > 1 else (sat == 0.0)
    for g, r in zip(_real(got, batch), _real(ref, batch)):
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4)


def test_param_and_output_shapes_match_specfile():
    spec = json.loads(SPEC.read_text())
    cfg = ModelConfig(model="gat")
    assert spec["bucket"] == {"n_pad": 256, "e_pad": 1024}
    assert spec["config"] == {k: getattr(cfg, k) for k in spec["config"]}
    model = gat.init(0, cfg, device="cpu")
    shapes = {k.replace(".", "/"): list(v.shape) for k, v in model.state_dict().items()}
    assert shapes == {k: v["shape"] for k, v in spec["params"].items()}
    with torch.no_grad():
        out = gat.apply(model, graph_to_torch(example_batch(**WINDOW).device_arrays(), "cpu"), cfg)
    dt = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    assert {k: {"dtype": dt[v.dtype], "shape": list(v.shape)} for k, v in out.items()} == spec["outputs"]


def test_params_round_trip_and_init():
    cfg = JaxConfig(model="gat", hidden_dim=32)
    tree = jax.tree_util.tree_map(np.asarray, jgat.init(jax.random.PRNGKey(3), cfg))
    back = params_to_numpy(_port_model(tree, ModelConfig(model="gat", hidden_dim=32)))
    flat_a, struct_a = jax.tree_util.tree_flatten(tree)
    flat_b, struct_b = jax.tree_util.tree_flatten(back)
    assert struct_a == struct_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    tcfg = ModelConfig(model="gat", hidden_dim=32)
    a = gat.init(5, tcfg, device="cpu").state_dict()
    b = gat.init(torch.Generator().manual_seed(5), tcfg, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["layers.0.attn"].std()) == pytest.approx(0.05, rel=0.3)
    with pytest.raises(ValueError, match="num_heads"):
        gat.GAT(ModelConfig(model="gat", hidden_dim=30))


@pytest.mark.parametrize("model,layout,expected", [
    ("gat", "coo", {"scatter_sum_sorted": 2, "segment_expand_sorted": 3, "gather_rows_banded": 3}),
    ("gat", "blocked", {"scatter_sum_sorted": 2, "segment_expand_sorted": 3, "gather_rows_banded": 3}),
    ("graphsage", "coo", {"scatter_sum_sorted": 2, "segment_expand_sorted": 1, "gather_rows_banded": 3}),
])
def test_kernel_inputs_meet_the_card_contract(clustered, monkeypatch, model, layout, expected):
    """On a CUDA tensor a wrapper takes only contiguous tensors and int32
    ids, and raises otherwise; on the CPU it takes its plain version and
    would not notice. So record what a banded forward hands each wrapper:
    the calls per forward, every tensor contiguous, every id vector int32."""
    calls = []

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls.append(name)
            tensors = [a for a in (*args, *kwargs.values()) if isinstance(a, torch.Tensor)]
            assert all(t.is_contiguous() for t in tensors), name
            assert args[1].dtype == torch.int32, name
            return fn(*args, **kwargs)

        return wrapped

    for name in expected:
        monkeypatch.setattr(K, name, spy(name, getattr(K, name)))
    cfg = ModelConfig(model=model, hidden_dim=32, src_gather="banded", edge_layout=layout)
    params = registry.init_params(cfg, key=0, device="cpu")
    with torch.no_grad():
        registry.get_model(model)[1](params, graph_to_torch(clustered.device_arrays(layout), "cpu"), cfg)
    assert {k: calls.count(k) for k in expected} == expected


def test_window_scorer_scores_gat(clustered):
    cfg = ModelConfig(model="gat", hidden_dim=32, src_gather="banded")
    model = registry.init_params(cfg, key=0, device="cpu")
    assert isinstance(model, gat.GAT)
    scorer = WindowScorer(cfg, model, device="cpu")
    scores = scorer.score(clustered)
    assert scores.dtype == np.float32 and scores.shape == (clustered.n_edges,)
    assert np.isfinite(scores).all() and ((scores >= 0) & (scores <= 1)).all()
    out = score_batch(cfg, model, clustered, device="cpu")
    assert isinstance(out["attn_clamp_saturation"], np.float32)
    logits = torch.from_numpy(out["edge_logits"][: clustered.n_edges])
    np.testing.assert_array_equal(torch.sigmoid(logits).numpy(), scores)
