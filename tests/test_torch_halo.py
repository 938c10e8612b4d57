"""The port's collectives, ring halo, ring attention, z-norm across
shards and GPipe against the JAX package's, on gloo ranks.

The port runs per rank in four spawned processes (one gloo group,
spawned once for the module, ``torch_parallel_ranks.py``); the JAX side
runs its ``shard_map`` runners on the test process's virtual CPU devices
(``tests/conftest.py``). The same numpy inputs go to both.

Tolerances: f32 at rtol/atol 1e-4 (``tests/test_parallel.py``'s); the
layout moves (all-to-all, ring shifts, all-gathers) and the blocked
extents exactly; the bf16 ring attention, whose inputs are rounded to
bf16 on both sides and whose logits and sums run in f32, within one bf16
ulp of the output's scale (2^-7 · max|ref|).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import torch_parallel_ranks as ranks
from alaz_tpu.models.common import znorm_edge_feats as jax_znorm
from alaz_tpu.parallel import collectives as JC
from alaz_tpu.parallel.gpipe import make_pipeline as jax_make_pipeline
from alaz_tpu.parallel.gpipe import sequential_reference as jax_sequential
from alaz_tpu.parallel.halo import make_halo_aggregate as jax_halo
from alaz_tpu.parallel.halo import partition_edges_by_dst as jax_partition
from alaz_tpu.parallel.halo import ring_attention_aggregate as jax_ring_attention
from alaz_tpu.parallel.mesh import shard_map
from alaz_tpu.parallel.sharded_model import shard_block_starts as jax_block_starts
from alaz_tpu_torch.parallel.gpipe import sequential_reference
from alaz_tpu_torch.parallel.halo import shard_graph
from alaz_tpu_torch.parallel.multislice import spawn
from alaz_tpu_torch.parallel.sharded_model import shard_block_starts

WORLD = 4
SP = {2: (2, 1, 1, 2), 4: (1, 1, 1, 4)}  # the (dp, tp, ep, sp) mesh of each ring size


def _jax_mesh(sp: int) -> Mesh:
    return Mesh(np.asarray(jax.devices()[:sp]), ("sp",))


# -- inputs ---------------------------------------------------------------------


def halo_inputs(sp: int):
    rng = np.random.default_rng(1)
    n, e, f = 512, 2048, 8
    h = rng.normal(size=(n, f)).astype(np.float32)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    return h, src, dst


def cross_inputs(sp: int = 4):
    """All edges cross shards — the pure-halo case."""
    n, f = 256, 4
    n_loc = n // sp
    h = np.arange(n * f, dtype=np.float32).reshape(n, f)
    # edge i: src in shard (i+1) % sp, dst in shard i % sp
    src = np.array([((i + 1) % sp) * n_loc for i in range(64)], dtype=np.int32)
    dst = np.array([(i % sp) * n_loc for i in range(64)], dtype=np.int32)
    return h, src, dst


def attention_inputs(sp: int):
    rng = np.random.default_rng(7)
    n, e, nh, hd = 256, 1024, 4, 8
    f = nh * hd
    kv = rng.normal(size=(n, f)).astype(np.float32)
    q_part = rng.normal(size=(n, nh)).astype(np.float32)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    e_part = rng.normal(size=(e, nh)).astype(np.float32)
    e_feat = rng.normal(size=(e, nh, hd)).astype(np.float32)
    a_k = rng.normal(size=(nh, hd)).astype(np.float32) * 0.3
    per_shard, e_budget, n_loc = jax_partition(dst, n, sp)
    srcs = np.zeros((sp, e_budget), np.int32)
    dstl = np.full((sp, e_budget), n_loc - 1, np.int32)
    mask = np.zeros((sp, e_budget), bool)
    ep_s = np.zeros((sp, e_budget, nh), np.float32)
    ef_s = np.zeros((sp, e_budget, nh, hd), np.float32)
    for s, idx in enumerate(per_shard):
        k = idx.shape[0]
        srcs[s, :k] = src[idx]
        dstl[s, :k] = dst[idx] - s * n_loc
        mask[s, :k] = True
        ep_s[s, :k] = e_part[idx]
        ef_s[s, :k] = e_feat[idx]
    arrays = (q_part.reshape(sp, n_loc, nh), kv.reshape(sp, n_loc, f), ep_s, ef_s, srcs, dstl, mask)
    return arrays, a_k


def grad_inputs(sp: int = 4):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(sp, 3, 2)).astype(np.float32)
    w = {
        "all_reduce_sum": rng.normal(size=(sp, 3, 2)).astype(np.float32),
        "all_gather": rng.normal(size=(sp, 3 * sp, 2)).astype(np.float32),
        "ring_shift": rng.normal(size=(sp, 3, 2)).astype(np.float32),
        "ring_shift_back": rng.normal(size=(sp, 3, 2)).astype(np.float32),
    }
    return x, w


def znorm_inputs(sp: int = 4):
    rng = np.random.default_rng(5)
    e_loc, f = 256, 16
    ef = rng.gamma(2.0, 1.5, size=(sp, e_loc, f)).astype(np.float32)
    mask = rng.random((sp, e_loc)) < 0.8
    mask[1, 100:] = False  # one shard mostly padding
    return ef, mask


def pipe_inputs(layers: int, m: int, d: int = 16):
    rng = np.random.default_rng(0)
    w = rng.normal(size=(layers, d, d)).astype(np.float32) * 0.3
    b = rng.normal(size=(layers, d)).astype(np.float32) * 0.1
    micro = rng.normal(size=(m, d)).astype(np.float32)
    return w, b, micro


PIPES = {  # key: (stages, layers, microbatches, gradient)
    "pipe_s4_l4": (4, 4, 8, False),
    "pipe_s4_l8": (4, 8, 8, True),
    "pipe_s2_l4": (2, 4, 4, False),
}


def _cases() -> list:
    cases = []
    for sp in (2, 4):
        h, src, dst = halo_inputs(sp)
        cases.append((f"halo_sp{sp}", "halo", dict(shape=SP[sp], **_sharded_halo(h, src, dst, sp))))
        arrays, a_k = attention_inputs(sp)
        cases.append((f"attn_sp{sp}", "ring_attention", dict(shape=SP[sp], arrays=arrays, a_k=a_k, dtype="float32")))
    h, src, dst = cross_inputs()
    cases.append(("halo_cross", "halo", dict(shape=SP[4], **_sharded_halo(h, src, dst, 4))))
    arrays, a_k = attention_inputs(4)
    cases.append(("attn_sp4_bf16", "ring_attention", dict(shape=SP[4], arrays=arrays, a_k=a_k, dtype="bfloat16")))
    x, w = grad_inputs()
    cases.append(("grads", "collective_grads", dict(shape=SP[4], x=x, w=w)))
    cases.append(("reshard", "reshard", dict(shape=SP[4], h=np.arange(32 * 16, dtype=np.float32).reshape(32, 16))))
    ef, mask = znorm_inputs()
    cases.append(("znorm", "znorm", dict(shape=SP[4], ef=ef, mask=mask)))
    for key, (stages, layers, m, grad) in PIPES.items():
        w, b, micro = pipe_inputs(layers, m)
        cases.append((key, "pipeline", dict(shape=SP[stages], w=w, b=b, micro=micro, grad=grad)))
    return cases


def _sharded_halo(h, src, dst, sp):
    hs, srcs, dstl, mask = shard_graph(h, src, dst, sp)
    return dict(h=hs, src=srcs, dst_local=dstl, mask=mask)


@pytest.fixture(scope="module")
def port():
    """Every case on four gloo ranks, spawned once; ``port[key]`` is the
    list of the ranks' results."""
    out = spawn(ranks.run_cases, WORLD, (_cases(),), device="cpu", timeout_s=180.0)
    return {key: [r[key] for r in out] for key in out[0]}


def _blocks(results, sp: int, key: str = "out") -> np.ndarray:
    """The sp ring's blocks in shard order (ranks of the first ring)."""
    by_index = {r["index"]: r[key] for r in results[: sp]}
    return np.stack([by_index[i] for i in range(sp)])


# -- halo ------------------------------------------------------------------------


def _dense_ref(h, src, dst):
    ref = np.zeros_like(h)
    np.add.at(ref, dst, h[src])
    return ref


@pytest.mark.parametrize("key,sp,inputs", [
    ("halo_sp2", 2, halo_inputs), ("halo_sp4", 4, halo_inputs), ("halo_cross", 4, cross_inputs),
])
def test_halo_matches_reference(port, key, sp, inputs):
    h, src, dst = inputs(sp)
    hs, srcs, dstl, mask = shard_graph(h, src, dst, sp)
    ref = np.asarray(jax_halo(_jax_mesh(sp), "sp")(*(jnp.asarray(a) for a in (hs, srcs, dstl, mask))))
    got = _blocks(port[key], sp)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.reshape(h.shape), _dense_ref(h, src, dst), rtol=1e-4, atol=1e-4)


def test_shard_graph_requires_divisible():
    with pytest.raises(AssertionError):
        shard_graph(np.zeros((100, 4), np.float32), np.zeros(1, np.int32), np.zeros(1, np.int32), 8)


# -- ring attention ----------------------------------------------------------------


def _jax_attention(sp, arrays, a_k, dtype):
    @partial(shard_map, mesh=_jax_mesh(sp), in_specs=(P("sp"),) * 7, out_specs=P("sp"))
    def run(qp, kvb, ep, ef, s_, dl, m):
        out = jax_ring_attention(qp[0], kvb[0], ep[0], ef[0], jnp.asarray(a_k, dtype), s_[0], dl[0], m[0], axis="sp")
        return out[None]

    cast = [jnp.asarray(a, dtype) for a in arrays[:4]] + [jnp.asarray(a) for a in arrays[4:]]
    return np.asarray(jax.jit(run)(*cast).astype(jnp.float32))


@pytest.mark.parametrize("key,sp", [("attn_sp2", 2), ("attn_sp4", 4)])
def test_ring_attention_matches_reference(port, key, sp):
    arrays, a_k = attention_inputs(sp)
    ref = _jax_attention(sp, arrays, a_k, jnp.float32)
    np.testing.assert_allclose(_blocks(port[key], sp), ref, rtol=1e-4, atol=1e-4)


def test_ring_attention_bf16_accumulates_in_f32(port):
    arrays, a_k = attention_inputs(4)
    ref = _jax_attention(4, arrays, a_k, jnp.bfloat16)
    got = _blocks(port["attn_sp4_bf16"], 4)
    assert port["attn_sp4_bf16"][0]["dtype"] == "torch.bfloat16"
    assert np.abs(got - ref).max() <= 2.0**-7 * np.abs(ref).max()


# -- the collectives and their gradients ------------------------------------------------


def _jax_loss_grad(op, x, w):
    """Value and gradient of Σ_r Σ w_r·op(x_r), each rank's term computed
    inside ``shard_map`` on 4 devices."""
    sp = x.shape[0]

    @partial(shard_map, mesh=_jax_mesh(sp), in_specs=(P("sp"), P("sp")), out_specs=(P("sp"), P("sp")))
    def per_rank(xb, wb):
        y = op(xb[0])
        return y[None], (wb[0] * y).sum()[None]

    def total(xx):
        return per_rank(xx, jnp.asarray(w))[1].sum()

    y, _ = per_rank(jnp.asarray(x), jnp.asarray(w))
    return np.asarray(y), np.asarray(jax.grad(total)(jnp.asarray(x)))


@pytest.mark.parametrize("name,op", [
    ("all_reduce_sum", lambda t: JC.all_reduce_sum(t, "sp")),
    ("all_gather", lambda t: JC.all_gather(t, "sp")),
    ("ring_shift", lambda t: JC.ring_shift(t, "sp", 1)),
    ("ring_shift_back", lambda t: JC.ring_shift(t, "sp", -1)),
])
def test_collective_gradients_match_jax_grad(port, name, op):
    """Each differentiable collective's value and backward against
    ``jax.grad`` through ``shard_map`` (psum, all_gather, ppermute)."""
    x, w = grad_inputs()
    ref_y, ref_g = _jax_loss_grad(op, x, w[name])
    res = port["grads"]
    np.testing.assert_allclose(_blocks(res, 4, name), ref_y, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_blocks(res, 4, f"{name}_grad"), ref_g, rtol=1e-5, atol=1e-5)


def test_all_to_all_reshard_is_exact(port):
    """P6: the node-sharded ↔ feature-sharded reshard pair is a real
    layout transformation, verified element-for-element."""
    d, n, f = 4, 32, 16
    h = np.arange(n * f, dtype=np.float32).reshape(n, f)
    res = port["reshard"]
    fs = _blocks(res, d, "features")  # rank d: all nodes, feature slice d
    np.testing.assert_array_equal(np.concatenate(list(fs), axis=1), h)
    np.testing.assert_array_equal(_blocks(res, d, "back").reshape(n, f), h)

    @partial(shard_map, mesh=_jax_mesh(d), in_specs=P("sp"), out_specs=P("sp"))
    def to_features(hl):
        return JC.nodes_to_features(hl, "sp")

    np.testing.assert_array_equal(fs.reshape(d * n, f // d), np.asarray(to_features(jnp.asarray(h))))


def test_znorm_over_a_group_matches_the_axis_form(port):
    """``znorm_edge_feats(axis=group)`` on each rank's shard of edges
    against the JAX package's ``axis="sp"`` form inside ``shard_map``."""
    ef, mask = znorm_inputs()

    @partial(shard_map, mesh=_jax_mesh(4), in_specs=(P("sp"), P("sp")), out_specs=P("sp"))
    def run(e, m):
        return jax_znorm(e[0], m[0], axis="sp")[None]

    ref = np.asarray(run(jnp.asarray(ef), jnp.asarray(mask)))
    np.testing.assert_allclose(_blocks(port["znorm"], 4), ref, rtol=1e-4, atol=1e-4)


def test_shard_block_starts_is_exact():
    """The shard-local blocked extents against the JAX package's, on
    shards with a live prefix and the pad fill."""
    rng = np.random.default_rng(2)
    for n_loc, e_budget, live in ((256, 1024, 700), (128, 512, 512), (256, 384, 0), (64, 256, 10)):
        dst = np.sort(rng.integers(0, n_loc, live)).astype(np.int32)
        dst_local = np.concatenate([dst, np.full(e_budget - live, n_loc - 1, np.int32)])
        mask = np.arange(e_budget) < live
        ref = jax_block_starts(jnp.asarray(dst_local), jnp.asarray(mask), n_loc)
        got = shard_block_starts(torch.as_tensor(dst_local), torch.as_tensor(mask), n_loc)
        if ref is None:
            assert got is None
            continue
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# -- GPipe -------------------------------------------------------------------------


def _fn(layer, x):
    return jnp.tanh(x @ layer["w"] + layer["b"])


@pytest.mark.parametrize("key", sorted(PIPES))
def test_pipeline_matches_reference(port, key):
    """GPipe on 4 and 2 stages, one and two layers a stage, against the
    JAX package's pipeline and the sequential loop."""
    stages, layers, m, _ = PIPES[key]
    w, b, micro = pipe_inputs(layers, m)
    params = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    ref = np.asarray(jax_make_pipeline(_fn, _jax_mesh(stages), axis="sp")(params, jnp.asarray(micro)))
    got = _blocks(port[key], stages).reshape(ref.shape)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    seq = sequential_reference(
        lambda layer, x: torch.tanh(x @ layer["w"] + layer["b"]),
        {"w": torch.as_tensor(w), "b": torch.as_tensor(b)}, torch.as_tensor(micro),
    )
    np.testing.assert_allclose(seq.numpy(), np.asarray(jax_sequential(_fn, params, jnp.asarray(micro))),
                               rtol=1e-5, atol=1e-5)


def test_pipeline_gradients_match_jax_grad(port):
    """The pipeline trains: the gradient of Σ out² through every hop and
    the output sum, into each stage's layers and the microbatches,
    against ``jax.grad`` of the sequential loop."""
    stages, layers, m, _ = PIPES["pipe_s4_l8"]
    w, b, micro = pipe_inputs(layers, m)

    def loss(p, x):
        return (jax_sequential(_fn, p, x) ** 2).sum()

    gp, gx = jax.grad(loss, argnums=(0, 1))({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(micro))
    res = port["pipe_s4_l8"]
    np.testing.assert_allclose(_blocks(res, stages, "w_grad").reshape(w.shape), np.asarray(gp["w"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_blocks(res, stages, "b_grad").reshape(b.shape), np.asarray(gp["b"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_blocks(res, stages, "micro_grad").reshape(micro.shape), np.asarray(gx),
                               rtol=1e-4, atol=1e-4)
