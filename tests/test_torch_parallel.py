"""The port's node-sharded GraphSAGE and GAT forwards, and their
gradients, against the JAX package's, on gloo ranks.

The port runs per rank in four spawned processes (one gloo group for
the module, ``torch_parallel_ranks.py``): rings of 2 (on a dp=2 × sp=2
mesh) and 4 shards. The JAX side runs its ``shard_map`` forwards on the
test process's virtual CPU devices. Both take the JAX package's params
(``convert.params_from_jax``) and the same sharded window
(``shard_graph_batch``); edge logits are compared edge for edge through
``unshard_edge_outputs``, node logits shard for shard. The port's rings
reduce each hop through the sorted-scatter wrapper (its plain version on
the CPU); the JAX side through XLA's segment sum.

Tolerance: f32 at rtol/atol 1e-4 (``tests/test_parallel.py``'s), the
gradients at atol 1e-4 against ``jax.grad`` of the single-device loss.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import __graft_entry__ as jax_entry
import torch_parallel_ranks as ranks
from alaz_tpu.config import ModelConfig as JaxConfig
from alaz_tpu.models.registry import get_model as jax_get_model
from alaz_tpu.parallel.sharded_model import make_node_sharded_gat as jax_sharded_gat
from alaz_tpu.parallel.sharded_model import make_node_sharded_graphsage as jax_sharded_graphsage
from alaz_tpu_torch.convert import params_from_jax
from alaz_tpu_torch.parallel.multislice import spawn
from alaz_tpu_torch.parallel.sharded_model import shard_graph_batch, unshard_edge_outputs

WORLD = 4
SP = {2: (2, 1, 1, 2), 4: (1, 1, 1, 4)}  # the (dp, tp, ep, sp) mesh of each ring size
# n512xe2048: a node block is whole 128-row dst blocks at 2 and 4 shards,
# so the blocked extents and the kernels' gate are live
FORWARD_WINDOW = dict(n_pods=400, n_svcs=60, n_edges=2000, seed=3)
GRAD_WINDOW = dict(n_pods=100, n_svcs=28, n_edges=500, seed=3)  # tests/test_parallel.py's
FORWARDS = [(m, sp, layout) for m in ("graphsage", "gat") for sp in (2, 4) for layout in ("coo", "blocked")]


def _cfg_kw(model: str, layout: str = "coo") -> dict:
    return dict(model=model, hidden_dim=32, num_heads=4, dtype="float32", edge_layout=layout)


@functools.lru_cache(maxsize=None)
def _jax_params(model: str, seed: int):
    cfg = JaxConfig(**_cfg_kw(model), use_pallas=False)
    return jax_get_model(model)[0](jax.random.PRNGKey(seed), cfg)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _labels(batch):
    y = (np.random.default_rng(0).random(batch.e_pad) < 0.1).astype(np.float32)
    return y, batch.edge_mask.astype(np.float32)


def _per_slot(v, perm):
    out = np.zeros(perm.shape, np.float32)
    out[perm >= 0] = v[perm[perm >= 0]]
    return out


def _cases() -> list:
    cases = []
    batch = jax_entry._example_batch(**FORWARD_WINDOW)
    for model, sp, layout in FORWARDS:
        sharded, _ = shard_graph_batch(batch, sp)
        state = params_from_jax(_np_tree(_jax_params(model, 2)))
        cases.append((f"{model}_sp{sp}_{layout}", "node_sharded",
                      dict(shape=SP[sp], cfg_kw=_cfg_kw(model, layout), state=state, sharded=sharded)))
    gbatch = jax_entry._example_batch(**GRAD_WINDOW)
    sharded, perm = shard_graph_batch(gbatch, 4)
    y, m = _labels(gbatch)
    for model in ("graphsage", "gat"):
        state = params_from_jax(_np_tree(_jax_params(model, 0)))
        cases.append((f"{model}_grads", "node_sharded",
                      dict(shape=SP[4], cfg_kw=_cfg_kw(model), state=state, sharded=sharded,
                           y=_per_slot(y, perm), m=_per_slot(m, perm))))
    return cases


@pytest.fixture(scope="module")
def port():
    """Every case on four gloo ranks, spawned once; ``port[key]`` is the
    list of the ranks' results."""
    out = spawn(ranks.run_cases, WORLD, (_cases(),), device="cpu", timeout_s=180.0)
    return {key: [r[key] for r in out] for key in out[0]}


def _blocks(results, sp: int, key: str) -> np.ndarray:
    """The ring's blocks in shard order (the ranks of the first ring)."""
    by_index = {r["index"]: r[key] for r in results[:sp]}
    return np.concatenate([by_index[i] for i in range(sp)])


@pytest.mark.parametrize("model,sp,layout", FORWARDS)
def test_node_sharded_forward_matches_reference(port, model, sp, layout):
    """Edge and node logits of the port's node-sharded forward against
    the JAX package's node-sharded forward and its single-device apply."""
    batch = jax_entry._example_batch(**FORWARD_WINDOW)
    jcfg = JaxConfig(**_cfg_kw(model, layout), use_pallas=False)
    params = _jax_params(model, 2)
    sharded, perm = shard_graph_batch(batch, sp)
    maker = jax_sharded_gat if model == "gat" else jax_sharded_graphsage
    run = maker(jcfg, Mesh(np.asarray(jax.devices()[:sp]), ("sp",)), axis="sp")
    ref_el, ref_nl = run(params, {k: jnp.asarray(v) for k, v in sharded.items()})
    res = port[f"{model}_sp{sp}_{layout}"]
    el, nl = _blocks(res, sp, "edge_logits"), _blocks(res, sp, "node_logits")
    mask = batch.edge_mask.astype(bool)
    got = unshard_edge_outputs(el, perm, batch.e_pad)
    np.testing.assert_allclose(got[mask], unshard_edge_outputs(np.asarray(ref_el), perm, batch.e_pad)[mask],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(nl, np.asarray(ref_nl), rtol=1e-4, atol=1e-4)
    assert nl.shape == (sp, batch.n_pad // sp)
    graph = {k: jnp.asarray(v) for k, v in batch.device_arrays(layout).items()}
    single = jax_get_model(model)[1](params, graph, jcfg)
    np.testing.assert_allclose(got[mask], np.asarray(single["edge_logits"])[mask], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(nl.reshape(-1), np.asarray(single["node_logits"]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("model", ["graphsage", "gat"])
def test_node_sharded_gradients_match_jax_grad(port, model):
    """Fleet-scale training: each rank's backward through the ring (its
    hops' transposes send the cotangents back around it), then the
    gradients summed over ``sp`` (``all_reduce_grads``), against
    ``jax.grad`` of the single-device loss."""
    batch = jax_entry._example_batch(**GRAD_WINDOW)
    jcfg = JaxConfig(**_cfg_kw(model), use_pallas=False)
    params = _jax_params(model, 0)
    g = {k: jnp.asarray(v) for k, v in batch.device_arrays().items()}
    y, m = (jnp.asarray(a) for a in _labels(batch))

    def ref_loss(p):
        el = jax_get_model(model)[1](p, g, jcfg)["edge_logits"]
        return ((el - y) ** 2 * m).sum() / m.sum()

    ref = params_from_jax(_np_tree(jax.grad(ref_loss)(params)))
    results = port[f"{model}_grads"]
    for r in results:  # every rank holds the summed gradients
        # the node head takes no part in the edge loss: no gradient
        assert set(r["grads"]) == {k for k in ref if not k.startswith("node_head")}
        for k, v in r["grads"].items():
            np.testing.assert_allclose(v, ref[k].numpy(), atol=1e-4, err_msg=k)
