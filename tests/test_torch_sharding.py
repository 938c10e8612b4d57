"""The port's partition specs and its sharded train and score steps
against the JAX package's, on gloo ranks.

The port runs per rank in four spawned processes (one gloo group for
the module, ``torch_parallel_ranks.py``); the JAX side runs its jitted
steps over a mesh of the test process's virtual CPU devices, with the
same params (``convert.params_from_jax``), windows and labels.

- specs: every JAX leaf's ``PartitionSpec``, as a tuple, equals the
  port's spec for the same name (params and AdamW state), exactly;
- train steps: (dp=2, tp=2) GraphSAGE and the experts on (dp=1, tp=2,
  ep=2) and (dp=2, tp=1, ep=2): the loss and the params after one AdamW
  step against optax's, f32 at rtol/atol 1e-4; each rank stores only
  its shard of every param and of its moments; each rank's shard
  gradients against the same slice of ``jax.grad`` of the reference's
  mean loss, f32 at rtol/atol 1e-4 (AdamW's first update does not see
  a gradient's scale, so the dp average and the gather's unreduced
  backward are held here);
- score steps: GAT with the banded src gather on dp=4 and GraphSAGE on
  (dp=2, tp=2): every window's edge logits, f32 at rtol/atol 1e-4.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import __graft_entry__ as jax_entry
import torch_parallel_ranks as ranks
from alaz_tpu.config import ModelConfig as JaxConfig
from alaz_tpu.models.registry import get_model as jax_get_model
from alaz_tpu.parallel import sharding as jsh
from alaz_tpu.parallel.mesh import make_mesh as jax_make_mesh
from alaz_tpu.parallel.mesh import mesh_shape_for as jax_mesh_shape_for
from alaz_tpu.train.objective import edge_bce_loss
from alaz_tpu_torch.config import ModelConfig
from alaz_tpu_torch.convert import params_from_jax
from alaz_tpu_torch.models.registry import get_model
from alaz_tpu_torch.parallel import sharding
from alaz_tpu_torch.parallel.multislice import spawn

WORLD = 4
LR = 1e-3
TRAINS = {  # key: (model, (dp, tp, ep, sp))
    "graphsage_dp2_tp2": ("graphsage", (2, 2, 1, 1)),
    "experts_dp1_tp2_ep2": ("experts", (1, 2, 2, 1)),
    "experts_dp2_tp1_ep2": ("experts", (2, 1, 2, 1)),
}
SCORES = {  # key: (model, (dp, tp, ep, sp), windows)
    "gat_banded_dp4": ("gat", (4, 1, 1, 1), 4),
    "graphsage_dp2_tp2": ("graphsage", (2, 2, 1, 1), 4),
}


def _cfg_kw(model: str) -> dict:
    kw = dict(model=model, hidden_dim=32, num_heads=4, dtype="float32")
    if model == "experts":
        kw["num_edge_types"] = 8
    return kw


def _jax_params(model: str):
    cfg = JaxConfig(**_cfg_kw(model), use_pallas=False)
    return jax_get_model(model)[0](jax.random.PRNGKey(0), cfg)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _windows(model: str, n: int):
    """``n`` labelled windows of one bucket; the experts' edge types
    folded onto their 8 experts, GAT's windows community-laid-out."""
    extra = dict(structure="community", layout="clustered") if model == "gat" else {}
    batches = [jax_entry._example_batch(n_pods=60, n_svcs=12, n_edges=200, seed=s, **extra) for s in range(n)]
    for b in batches:
        if model == "experts":
            b.edge_type = (b.edge_type % 8).astype(np.int32)
        b.edge_label = (np.random.default_rng(0).random(b.e_pad) < 0.1).astype(np.float32)
    return batches


def _cases() -> list:
    cases = []
    for key, (model, shape) in TRAINS.items():
        stacked, labels = sharding.stack_graphs(_windows(model, 2))
        cases.append((f"train_{key}", "train_step", dict(
            shape=shape, cfg_kw=_cfg_kw(model), state=params_from_jax(_np_tree(_jax_params(model))),
            stacked=stacked, labels=labels, lr=LR)))
    for key, (model, shape, n) in SCORES.items():
        stacked, _ = sharding.stack_graphs(_windows(model, n))
        kw = dict(_cfg_kw(model), src_gather="banded") if model == "gat" else _cfg_kw(model)
        cases.append((f"score_{key}", "score_step", dict(
            shape=shape, cfg_kw=kw, state=params_from_jax(_np_tree(_jax_params(model))), stacked=stacked)))
    return cases


@pytest.fixture(scope="module")
def port():
    """Every case on four gloo ranks, spawned once; ``port[key]`` is the
    list of the ranks' results."""
    out = spawn(ranks.run_cases, WORLD, (_cases(),), device="cpu", timeout_s=180.0)
    return {key: [r[key] for r in out] for key in out[0]}


def _jax_mesh(shape):
    dp, tp, ep, sp = shape
    return jax_make_mesh(jax_mesh_shape_for(4, tp=tp, ep=ep, sp=sp), devices=jax.devices()[:4])


# -- specs ---------------------------------------------------------------------------


def _by_name(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {".".join(jsh._path_keys(path)): leaf for path, leaf in flat}


@pytest.mark.parametrize("model,tp,ep", [("graphsage", 2, 1), ("gat", 2, 1), ("experts", 2, 2), ("experts", 1, 2)])
def test_param_specs_match_reference(model, tp, ep):
    jparams = _jax_params(model)
    ref = _by_name(jsh.param_pspec(jparams, tp=tp, ep=ep))
    module = get_model(model)[0](0, ModelConfig(**_cfg_kw(model)), device="cpu")
    got = sharding.param_pspec(module, tp=tp, ep=ep)
    assert got == {k: tuple(v) for k, v in ref.items()}
    assert sharding.param_pspec(params_from_jax(_np_tree(jparams)), tp=tp, ep=ep) == got
    if model == "experts" and tp == 2:
        assert got["layers.0.expert_w"] == ("ep", None, "tp") and got["layers.0.expert_b"] == ("ep", None)
    if model == "graphsage":
        assert got["edge_head.1.w"] == ()  # the width-1 head replicates


@pytest.mark.parametrize("model,tp,ep", [("graphsage", 2, 1), ("experts", 2, 2)])
def test_opt_state_specs_match_reference(model, tp, ep):
    """AdamW's moments shard like their params and its step counts
    replicate, as optax's ``mu``/``nu`` and ``count`` do in the
    reference's rule; before the first step and after it."""
    jparams = _jax_params(model)
    ref = _by_name(jsh.opt_state_pspec(optax.adamw(LR).init(jparams), jparams, tp=tp, ep=ep))
    module = get_model(model)[0](0, ModelConfig(**_cfg_kw(model)), device="cpu")
    opt = sharding.adamw(LR)(module.parameters())
    got = sharding.opt_state_pspec(opt, module, tp=tp, ep=ep)
    names = {"mu": "exp_avg", "nu": "exp_avg_sq"}
    for path, spec in ref.items():
        head, *rest = path.split(".")[1:]  # "0.mu.layers.0.msg.w" → "mu", layers.0.msg.w
        if head == "count":
            assert spec == P()
            continue
        assert got[".".join(rest) + "." + names[head]] == tuple(spec), path
    assert all(v == () for k, v in got.items() if k.endswith(".step"))
    for p in module.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    assert sharding.opt_state_pspec(opt, module, tp=tp, ep=ep) == got


def test_graph_spec_and_stack():
    assert sharding.graph_pspec() == {k: tuple(v) for k, v in jsh.graph_pspec().items()}
    assert sharding.graph_pspec(stacked=False) == {k: tuple(v) for k, v in jsh.graph_pspec(False).items()}
    batches = _windows("graphsage", 2)
    got, labels = sharding.stack_graphs(batches)
    ref, ref_labels = jsh.stack_graphs(batches)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    np.testing.assert_array_equal(labels, ref_labels)


# -- the train steps ----------------------------------------------------------------------


@pytest.mark.parametrize("key", sorted(TRAINS))
def test_train_step_matches_optax(port, key):
    """One sharded step's loss (the mean over both windows) and params
    after one AdamW update against the reference's sharded step under
    ``optax.adamw``; each rank stores its shard of every param and of
    both moments (tp halves the out-dims, ep the experts)."""
    model, shape = TRAINS[key]
    jparams = _jax_params(model)
    cfg = JaxConfig(**_cfg_kw(model), use_pallas=False)
    opt = optax.adamw(LR)
    stacked, labels = jsh.stack_graphs(_windows(model, 2))
    mesh = _jax_mesh(shape)
    with mesh:
        step = jsh.make_sharded_train_step(cfg, mesh, opt, jparams)
        new_params, _, loss = step(jparams, opt.init(jparams), stacked, labels)
    ref = params_from_jax(_np_tree(new_params))
    specs = _by_name(jsh.param_pspec(jparams, tp=shape[1], ep=shape[2]))
    sizes = dict(zip(("dp", "tp", "ep", "sp"), shape))
    for r in port[f"train_{key}"]:
        assert r["loss"] == pytest.approx(float(loss), rel=1e-5)
        assert r["cfg"] == ("masked" if shape[2] > 1 else "table")
        for k, v in r["params"].items():
            np.testing.assert_allclose(v, ref[k].numpy(), rtol=1e-4, atol=1e-4, err_msg=k)
            want = tuple(n // sizes[ax] if ax else n for n, ax in
                         zip(v.shape, tuple(specs[k]) + (None,) * (v.ndim - len(specs[k]))))
            assert r["shard_shapes"][k] == want == r["moment_shapes"][k], k


@pytest.mark.parametrize("key", sorted(TRAINS))
def test_train_step_gradients_match_jax_grad(port, key):
    """Each rank's shard gradients, as its optimizer steps them (summed
    over dp), against this rank's slice of ``jax.grad`` of the
    reference's loss: the mean edge BCE over all G windows. A dp sum of
    the ranks' means (×dp) or a reduce-scatter backward of the tp/ep
    gather (×tp, ×ep) would miss by that factor."""
    model, shape = TRAINS[key]
    jparams = _jax_params(model)
    mesh = _jax_mesh(shape)
    cfg = jsh._ep_safe_cfg(JaxConfig(**_cfg_kw(model), use_pallas=False), mesh)
    apply = jax_get_model(cfg.model)[1]
    stacked, labels = jsh.stack_graphs(_windows(model, 2))

    def loss_fn(params):
        def one(graph, lbl):
            out = apply(params, graph, cfg)
            return edge_bce_loss(out["edge_logits"], lbl, graph["edge_mask"].astype(jnp.float32), 10.0)

        return jnp.mean(jax.vmap(one)({k: jnp.asarray(v) for k, v in stacked.items()}, jnp.asarray(labels)))

    ref = params_from_jax(_np_tree(jax.grad(loss_fn)(jparams)))
    specs = _by_name(jsh.param_pspec(jparams, tp=shape[1], ep=shape[2]))
    sizes = dict(zip(("dp", "tp", "ep", "sp"), shape))
    assert max(float(np.abs(g.numpy()).max()) for g in ref.values()) > 1e-2  # not a test of zeros
    for r in port[f"train_{key}"]:
        assert r["grads"].keys() == ref.keys()
        for k, got in r["grads"].items():
            want = ref[k].numpy()
            for dim, ax in enumerate(tuple(specs[k])):
                if ax is not None:
                    want = np.split(want, sizes[ax], axis=dim)[r["coords"][ax]]
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=k)


# -- the score steps ----------------------------------------------------------------------


@pytest.mark.parametrize("key", sorted(SCORES))
def test_score_step_matches_reference(port, key):
    model, shape, n = SCORES[key]
    jparams = _jax_params(model)
    cfg = JaxConfig(**_cfg_kw(model), use_pallas=False)
    stacked, _ = jsh.stack_graphs(_windows(model, n))
    mesh = _jax_mesh(shape)
    with mesh:
        ref = np.asarray(jsh.make_sharded_score_step(cfg, mesh, jparams)(jparams, stacked))
    dp = shape[0]
    per = n // dp
    for r in port[f"score_{key}"]:
        assert r["edge_logits"].shape == (per, ref.shape[1])
        i = r["dp"]
        np.testing.assert_allclose(r["edge_logits"], ref[i * per : (i + 1) * per], rtol=1e-4, atol=1e-4)
