"""The port's training against the JAX package's, on the CPU.

Held here: the gradients of the four kernel wrappers (their
``torch.autograd.Function``s) against ``jax.vjp`` of the JAX kernels in
interpret mode; GraphSAGE's and GAT's one-step loss and gradients against
``jax.value_and_grad`` of the reference's ``edge_bce_loss(apply(...))``
(the experts' and TGN's are in their own files); params after three
AdamW steps against optax's ``adamw``; remat; the objective; and the
quality gate of ``tests/test_train.py`` on the port's own
anomaly-scenario windows (``alaz_tpu_torch.replay.scenario``), which are
held to the reference's bit for bit.

Inputs are made with numpy from a seed and handed to both packages;
params come from the reference's ``init``, carried across with
``convert.params_from_jax``. The port's wrappers take their plain
versions, because the tensors lie on the CPU.

Tolerances:
- f32: rtol/atol 1e-4, the ROADMAP's oracle.
- gathers (K1's backward ``g[dst]``) are exact: bit for bit, bf16 too.
- f32-accumulated sums rounded once to bf16 (K2's, K3's and K4's
  backward): the two sides sum in another order, so a sum near a
  rounding boundary may land one bf16 ulp apart: |Δ| ≤ 2^-7·|ref| plus
  1e-5 of the largest magnitude.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from alaz_tpu.config import ModelConfig as JaxConfig
from alaz_tpu.config import SimulationConfig as JaxSimulationConfig
from alaz_tpu.models.registry import get_model as jax_get_model
from alaz_tpu.ops import pallas_segment as jpallas
from alaz_tpu.replay.scenario import run_anomaly_scenario as jax_run_anomaly_scenario
from alaz_tpu.train import metrics as jmetrics
from alaz_tpu.train import trainstep as jtrain
from alaz_tpu.train.objective import edge_bce_loss as jax_edge_bce_loss
from alaz_tpu_torch.config import ModelConfig, SimulationConfig
from alaz_tpu_torch.convert import graph_to_torch, params_from_jax
from alaz_tpu_torch.graph.snapshot import edge_block_starts_from
from alaz_tpu_torch.models.registry import get_model
from alaz_tpu_torch.replay.scenario import run_anomaly_scenario
from alaz_tpu_torch.ops import segment_kernels as K
from alaz_tpu_torch.train import metrics, trainstep
from alaz_tpu_torch.train.objective import edge_bce_loss

N_PAD, E_PAD, N_EDGES, F = 256, 1024, 1000, 32
WINDOW = dict(n_pods=180, n_svcs=20, n_edges=1000, seed=1)
CLUSTERED = dict(WINDOW, structure="community", layout="clustered")
_DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _np(x):
    return np.asarray(x.float().detach() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


def _assert_sum_close(got, ref, dtype):
    got, ref = _np(got), _np(ref)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    else:
        scale = 1e-5 * np.abs(ref).max()
        assert (np.abs(got - ref) <= 2.0**-7 * np.abs(ref) + scale).all()


def _vjp(fwd, primals, cotangent):
    """``jax.vjp`` of ``fwd`` at ``primals``, pulled back from
    ``cotangent``, under one jit (the interpret-mode kernels compile once
    instead of running op by op)."""
    return jax.jit(lambda p, c: jax.vjp(fwd, *p)[1](c))(primals, cotangent)


def _edges(seed: int):
    """A dst-sorted edge list with a pad tail on the last node row, its
    blocked extents, unsorted src ids, weights and a cotangent over the
    node rows whose pad row is zero (under the blocked layout the port
    leaves the pad slots out of the forward, the JAX kernel does not: a
    zero cotangent on their row makes the two gradients comparable)."""
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, 200, E_PAD)).astype(np.int32)
    dst[N_EDGES:] = N_PAD - 1
    src = rng.integers(0, N_PAD, E_PAD).astype(np.int32)
    w = rng.uniform(0.1, 2.0, E_PAD).astype(np.float32)
    g_nodes = rng.normal(size=(N_PAD, F)).astype(np.float32)
    g_nodes[N_PAD - 1] = 0.0
    g_edges = rng.normal(size=(E_PAD, F)).astype(np.float32)
    bs = edge_block_starts_from(dst, N_EDGES, N_PAD)
    return rng, dst, src, w, g_nodes, g_edges, bs


# -- the four kernels' backward passes -----------------------------------------


@pytest.mark.parametrize("layout", ["coo", "blocked"])
@pytest.mark.parametrize("dtype,out_dtype", [("float32", None), ("bfloat16", None), ("bfloat16", "float32")])
def test_k1_backward_matches_vjp(dtype, out_dtype, layout):
    """K1's gradient is ``g[dst]`` in the messages' dtype (K2): exact. With
    bf16 messages summed to f32 (GAT's ``segment_sum_accurate``) the f32
    cotangent comes back bf16."""
    rng, dst, _, _, g_nodes, _, bs = _edges(1)
    msgs = rng.normal(size=(E_PAD, F)).astype(np.float32)
    jd, td = _DT[dtype]
    jo, to = (None, None) if out_dtype is None else _DT[out_dtype]
    jbs, tbs = (jnp.asarray(bs), _t(bs)) if layout == "blocked" else (None, None)
    (ref,) = _vjp(
        lambda m: jpallas.scatter_sum_sorted(m, jnp.asarray(dst), N_PAD, jo, jbs),
        (jnp.asarray(msgs).astype(jd),),
        jnp.asarray(g_nodes).astype(jo or jd),
    )
    m = _t(msgs, td).requires_grad_()
    out = K.scatter_sum_sorted(m, _t(dst), N_PAD, to, tbs)
    out.backward(_t(g_nodes, to or td))
    assert m.grad.dtype == td
    np.testing.assert_array_equal(_np(m.grad), _np(ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2_backward_matches_vjp(dtype):
    """K2's gradient is the sorted sum of ``g`` over dst (K1), in g's dtype."""
    rng, dst, _, _, _, g_edges, _ = _edges(2)
    v = rng.normal(size=(N_PAD, F)).astype(np.float32)
    jd, td = _DT[dtype]
    (ref,) = _vjp(
        lambda x: jpallas.segment_expand_sorted(x, jnp.asarray(dst), N_PAD),
        (jnp.asarray(v).astype(jd),),
        jnp.asarray(g_edges).astype(jd),
    )
    x = _t(v, td).requires_grad_()
    K.segment_expand_sorted(x, _t(dst), N_PAD).backward(_t(g_edges, td))
    assert x.grad.dtype == td
    _assert_sum_close(x.grad, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e", [1024, 1000])
def test_k3_backward_matches_vjp(dtype, e):
    """K3's gradient is the unsorted sum of ``g`` over the ids, in f32
    rounded once to g's dtype (K4 over the ids' stable sort), also for an
    edge count off the TPU kernel's 512-edge chunk."""
    n = N_PAD
    rng = np.random.default_rng(3)
    ids = rng.integers(0, n, e).astype(np.int32)
    v = rng.normal(size=(n, F)).astype(np.float32)
    g = rng.normal(size=(e, F)).astype(np.float32)
    jd, td = _DT[dtype]
    (ref,) = _vjp(
        lambda x: jpallas.gather_rows_banded(x, jnp.asarray(ids), n),
        (jnp.asarray(v).astype(jd),),
        jnp.asarray(g).astype(jd),
    )
    x = _t(v, td).requires_grad_()
    K.gather_rows_banded(x, _t(ids), n).backward(_t(g, td))
    assert x.grad.dtype == td and x.grad.shape == (n, F)
    _assert_sum_close(x.grad, ref, dtype)


def test_k3_backward_rows_off_the_block_grid():
    """A table of 200 rows (K4 writes whole 128-row blocks; the backward
    cuts the sum back to 200): against the float64 sum."""
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 200, 1000).astype(np.int32)
    g = rng.normal(size=(1000, 5)).astype(np.float32)
    x = torch.zeros((200, 5), requires_grad=True)
    K.gather_rows_banded(x, _t(ids), 200).backward(_t(g))
    ref = np.zeros((200, 5))
    np.add.at(ref, ids, g.astype(np.float64))
    assert x.grad.shape == (200, 5)
    np.testing.assert_allclose(x.grad.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layout", ["coo", "blocked"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_backward_matches_vjp(dtype, weighted, layout):
    """K4's ``dx`` (K4 with src and dst swapped, f32 products, cast to x's
    dtype) and ``dw`` (an f32 row dot) against the JAX kernel's VJP, with
    x's rows off the 128-row grid."""
    rng, dst, src, w, g_nodes, _, bs = _edges(4)
    n_x = 300
    src = (src.astype(np.int64) * n_x // N_PAD).astype(np.int32)
    x = rng.normal(size=(n_x, F)).astype(np.float32)
    jd, td = _DT[dtype]
    args = [jnp.asarray(x).astype(jd)] + ([jnp.asarray(w)] if weighted else [])

    def fwd(xx, *ww):
        return jpallas.pallas_gather_scatter_sum(
            xx, jnp.asarray(src), jnp.asarray(dst), N_PAD, ww[0] if ww else None
        )

    refs = _vjp(fwd, tuple(args), jnp.asarray(g_nodes).astype(jd))
    xt = _t(x, td).requires_grad_()
    wt = _t(w).requires_grad_() if weighted else None
    out = K.pallas_gather_scatter_sum(
        xt, _t(src), _t(dst), N_PAD, wt, _t(bs) if layout == "blocked" else None
    )
    out.backward(_t(g_nodes, td))
    assert xt.grad.dtype == td and xt.grad.shape == (n_x, F)
    _assert_sum_close(xt.grad, refs[0], dtype)
    if weighted:
        assert wt.grad.dtype == torch.float32
        np.testing.assert_allclose(_np(wt.grad), _np(refs[1]), rtol=1e-4, atol=1e-4)


def test_backward_takes_expanded_cotangents_and_counts_no_launch_on_cpu():
    """``out.sum()`` hands each backward an expanded (stride-0) cotangent;
    on CPU tensors every pass runs the plain versions and no kernel
    launches."""
    rng, dst, src, w, _, _, _ = _edges(5)
    K.reset_launch_counts()
    m = _t(rng.normal(size=(E_PAD, F)).astype(np.float32)).requires_grad_()
    v = _t(rng.normal(size=(N_PAD, F)).astype(np.float32)).requires_grad_()
    wt = _t(w).requires_grad_()
    total = (
        K.scatter_sum_sorted(m, _t(dst), N_PAD).sum()
        + K.segment_expand_sorted(v, _t(dst), N_PAD).sum()
        + K.gather_rows_banded(v, _t(src), N_PAD).sum()
        + K.pallas_gather_scatter_sum(v, _t(src), _t(dst), N_PAD, wt).sum()
    )
    total.backward()
    assert torch.equal(m.grad, torch.ones_like(m))
    deg = torch.bincount(_t(dst).long(), minlength=N_PAD) + torch.bincount(_t(src).long(), minlength=N_PAD)
    wsum = torch.zeros(N_PAD).index_add_(0, _t(src).long(), wt.detach())
    np.testing.assert_allclose(v.grad[:, 0].numpy(), (deg + wsum).numpy(), rtol=1e-5)
    assert K.launch_counts() == dict.fromkeys(K.launch_counts(), 0)


# -- one train step, per family ----------------------------------------------------


def labels_from_window(batch) -> np.ndarray:
    """Fault labels drawn from the window itself: the top tenth of the
    first edge feature among the real edges."""
    lab = np.zeros(batch.e_pad, np.float32)
    f0 = batch.edge_feats[: batch.n_edges, 0]
    lab[: batch.n_edges] = f0 > np.quantile(f0, 0.9)
    return lab


def jax_value_and_grad(jcfg, batch, label, layout="coo"):
    init, apply = jax_get_model(jcfg.model)
    params = init(jax.random.PRNGKey(0), jcfg)
    graph = {k: jnp.asarray(v) for k, v in batch.device_arrays(layout).items()}

    def loss_fn(p):
        out = apply(p, graph, jcfg)
        return jax_edge_bce_loss(out["edge_logits"], jnp.asarray(label), graph["edge_mask"].astype(jnp.float32))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return tree(params), float(loss), params_from_jax(tree(grads))


def port_loss_and_grads(np_params, cfg, batch, label, layout="coo"):
    model = get_model(cfg.model)[0](0, cfg, device="cpu")
    model.load_state_dict(params_from_jax(np_params))
    loss = trainstep.make_loss_fn(cfg)(model, graph_to_torch(batch.device_arrays(layout), "cpu"), _t(label))
    trainstep.backward(model, loss)
    return model, float(loss.detach()), {k: p.grad for k, p in model.named_parameters()}


def assert_grads_match(got: dict, ref: dict) -> None:
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("model,layout,extra", [
    ("graphsage", "coo", {}),
    ("graphsage", "blocked", {}),
    ("gat", "coo", {"src_gather": "banded"}),
])
def test_family_gradients_match(model, layout, extra):
    """One step's loss and every param's gradient, f32, the JAX side with
    its kernels in interpret mode (its custom VJPs), the port through its
    wrappers' Functions; GAT on a clustered window with the banded src
    gather (K3 and its backward)."""
    batch = jax_entry._example_batch(**(CLUSTERED if model == "gat" else WINDOW))
    label = labels_from_window(batch)
    jextra = {"src_gather": "banded-interpret"} if extra else {}
    jcfg = JaxConfig(model=model, hidden_dim=32, dtype="float32", use_pallas="interpret", edge_layout=layout, **jextra)
    np_params, ref_loss, ref_grads = jax_value_and_grad(jcfg, batch, label, layout)
    cfg = ModelConfig(model=model, hidden_dim=32, dtype="float32", edge_layout=layout, **extra)
    _, loss, grads = port_loss_and_grads(np_params, cfg, batch, label, layout)
    assert loss == pytest.approx(ref_loss, rel=1e-5)
    assert_grads_match(grads, ref_grads)


def _jax_adamw_steps(jcfg, batch, label, steps=3, lr=3e-3):
    init, _ = jax_get_model(jcfg.model)
    params = init(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    opt = jtrain._adamw(lr)
    state = opt.init(params)
    step = jtrain.make_train_step(jcfg, opt, 10.0)
    graph = {k: jnp.asarray(v) for k, v in batch.device_arrays().items()}
    losses = []
    for _ in range(steps):
        params, state, loss = step(params, state, graph, jnp.asarray(label))
        losses.append(float(loss))
    return np_params, losses, params_from_jax(jax.tree_util.tree_map(np.asarray, params))


def assert_adamw_steps_match(model: str, batch, steps: int = 3) -> None:
    """Params after ``steps`` AdamW steps of ``make_train_step`` against
    optax's adamw through the reference's ``make_train_step`` (plain
    paths on both sides: the kernels' gradients are held elsewhere; this
    holds the optimizer). f32 at rtol/atol 1e-4."""
    label = labels_from_window(batch)
    jcfg = JaxConfig(model=model, hidden_dim=32, dtype="float32", use_pallas=False)
    np_params, ref_losses, ref_params = _jax_adamw_steps(jcfg, batch, label, steps)
    cfg = ModelConfig(model=model, hidden_dim=32, dtype="float32", use_pallas=False)
    params = get_model(model)[0](0, cfg, device="cpu")
    params.load_state_dict(params_from_jax(np_params))
    opt = trainstep._adamw(params, 3e-3)
    step = trainstep.make_train_step(cfg, 10.0, "cpu")
    losses = [float(step(params, opt, batch.device_arrays(), label)) for _ in range(steps)]
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    for k, p in params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref_params[k].numpy(), rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("model", ["graphsage", "gat"])
def test_adamw_three_steps_match_optax(model):
    assert_adamw_steps_match(model, jax_entry._example_batch(**WINDOW))


def test_adamw_is_optax_adamw():
    params = get_model("graphsage")[0](0, ModelConfig(hidden_dim=8), device="cpu")
    opt = trainstep._adamw(params, 3e-3)
    (group,) = opt.param_groups
    assert len(group["params"]) == len(list(params.parameters()))
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (3e-3, (0.9, 0.999), 1e-8, 1e-4)


# -- remat and GAT's empty rows -----------------------------------------------------


@pytest.mark.parametrize("model,dtype", [("graphsage", "float32"), ("graphsage", "bfloat16"), ("gat", "bfloat16")])
def test_remat_gradients_equal_without(model, dtype):
    """``cfg.remat`` recomputes each layer in the backward: the f32
    residual carry makes the recompute round as the forward did, so the
    loss and every gradient are the same bits as without remat."""
    batch = jax_entry._example_batch(**CLUSTERED)
    label = _t(labels_from_window(batch))
    graph = graph_to_torch(batch.device_arrays(), "cpu")
    out = {}
    for remat in (False, True):
        cfg = ModelConfig(model=model, hidden_dim=32, dtype=dtype, remat=remat, src_gather="banded")
        params = get_model(model)[0](0, cfg, device="cpu")
        loss = trainstep.make_loss_fn(cfg)(params, graph, label)
        trainstep.backward(params, loss)
        out[remat] = (loss.detach(), {k: p.grad for k, p in params.named_parameters()})
    assert torch.equal(out[False][0], out[True][0])
    for k, g in out[False][1].items():
        assert torch.equal(g, out[True][1][k]), k


def test_gat_gradient_finite_on_rows_without_in_edges():
    """The pad rows and the pod rows of the window have no live in-edge
    (denominator 0): the double where keeps every gradient finite."""
    batch = jax_entry._example_batch(**WINDOW)
    assert np.bincount(batch.edge_dst[: batch.n_edges], minlength=batch.n_pad).min() == 0
    cfg = ModelConfig(model="gat", hidden_dim=32)
    params = get_model("gat")[0](0, cfg, device="cpu")
    loss = trainstep.make_loss_fn(cfg)(params, graph_to_torch(batch.device_arrays(), "cpu"), _t(labels_from_window(batch)))
    trainstep.backward(params, loss)
    for k, p in params.named_parameters():
        assert bool(torch.isfinite(p.grad).all()), k
    assert float(params.layers[0].q.w.grad.abs().max()) > 0


# -- objective, train step plumbing ---------------------------------------------------


def test_edge_bce_loss_matches_reference():
    rng = np.random.default_rng(6)
    logits = (rng.normal(size=512) * 30).astype(np.float32)  # tails where a naive log(1-σ) would overflow
    label = (rng.random(512) < 0.2).astype(np.float32)
    mask = (rng.random(512) < 0.9).astype(np.float32)
    ref = float(jax_edge_bce_loss(jnp.asarray(logits), jnp.asarray(label), jnp.asarray(mask), 10.0))
    got = float(edge_bce_loss(_t(logits), _t(label), _t(mask), 10.0))
    assert got == pytest.approx(ref, rel=1e-6)
    assert float(edge_bce_loss(_t(logits), _t(label), torch.zeros(512))) == 0.0


def test_train_step_takes_a_graph_made_under_inference_mode():
    """A graph dict moved to the device by ``make_score_fn``'s path (under
    ``inference_mode``) feeds the train step all the same: it copies the
    inference tensors autograd refuses."""
    batch = jax_entry._example_batch(**WINDOW)
    cfg = ModelConfig(hidden_dim=16)
    params = get_model("graphsage")[0](0, cfg, device="cpu")
    with torch.inference_mode():
        graph = graph_to_torch(batch.device_arrays(), "cpu")
        label = _t(labels_from_window(batch))
    opt = trainstep._adamw(params, 3e-3)
    step = trainstep.make_train_step(cfg, device="cpu")
    before = params.embed.w.detach().clone()
    loss = step(params, opt, graph, label)
    assert bool(torch.isfinite(loss)) and not torch.equal(before, params.embed.w)
    assert params.node_head[0].w.grad is not None  # zero, but present: AdamW decays it


# -- the quality gate --------------------------------------------------------------------


GATE_SIM = dict(pod_count=50, service_count=20, edge_count=40, edge_rate=200)
GATE_SCENARIO = dict(n_windows=8, fault_fraction=0.2, seed=1)


@pytest.fixture(scope="module")
def scenario():
    data = run_anomaly_scenario(SimulationConfig(**GATE_SIM), **GATE_SCENARIO)
    return data.train, data.eval


def test_gate_windows_equal_the_reference(scenario):
    """The gate's windows, made by the port, are the reference's bit for
    bit: every array the model or the metric reads, and the split."""
    ref = jax_run_anomaly_scenario(JaxSimulationConfig(**GATE_SIM), **GATE_SCENARIO)
    train, evals = scenario
    assert (len(train), len(evals)) == (len(ref.train), len(ref.eval))
    for got, want in zip(train + evals, ref.train + ref.eval):
        assert (got.n_nodes, got.n_edges, got.window_start_ms) == (want.n_nodes, want.n_edges, want.window_start_ms)
        for k in ("node_feats", "node_type", "node_mask", "edge_src", "edge_dst", "edge_type", "edge_feats",
                  "edge_mask", "edge_label", "edge_fault_kind"):
            g, w = getattr(got, k), getattr(want, k)
            assert g.dtype == w.dtype and np.array_equal(g, w), k


@pytest.mark.parametrize("model", ["graphsage", "gat"])
def test_auroc_gate(scenario, model):
    """The reference's quality gate (``tests/test_train.py``), on the port:
    trained with ``train_on_batches`` on the scenario's train windows,
    AUROC ≥ 0.9 on its held-out eval windows."""
    train, evals = scenario
    assert len(train) >= 1 and len(evals) >= 1
    cfg = ModelConfig(model=model, hidden_dim=64, num_heads=4, use_pallas=False)
    state, losses = trainstep.train_on_batches(cfg, train, epochs=25, lr=3e-3, device="cpu")
    assert losses[-1] < losses[0] and state.step == 25 * len(train)
    fn = trainstep.make_score_fn(cfg, "cpu")
    scores = [trainstep.score_batch(cfg, state.params, b, fn)["edge_logits"] for b in evals]
    a = metrics.auroc(
        np.concatenate(scores),
        np.concatenate([b.edge_label for b in evals]),
        np.concatenate([b.edge_mask for b in evals]),
    )
    assert a >= 0.9, f"AUROC {a:.3f} below gate for {model}"


def test_auroc_matches_reference_with_ties():
    rng = np.random.default_rng(8)
    scores = np.round(rng.random(2000), 2)  # many ties
    labels = (rng.random(2000) < 0.3).astype(np.float32)
    mask = rng.random(2000) < 0.8
    for m in (None, mask):
        assert metrics.auroc(scores, labels, m) == jmetrics.auroc(scores, labels, m)
    assert metrics.auroc(np.full(4, 0.5), np.array([1, 0, 1, 0])) == 0.5
    assert np.isnan(metrics.auroc(scores, np.zeros(2000)))
    kinds = rng.integers(0, 4, 2000)
    got = metrics.auroc_by_kind(scores, kinds, ("a", "b", "c", "d"), mask)
    ref = jmetrics.auroc_by_kind(scores, kinds, ("a", "b", "c", "d"), mask)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k] == ref[k] or (np.isnan(got[k]) and np.isnan(ref[k]))
