"""The sort of K3's and K4's backward (``segment_kernels.sort_by_ids``) and
the backward passes built on it, on the CPU.

Held here: the sort's plain version against numpy's stable argsort of the
encoded keys (``clamp(id, -1, n_rows) + 1``), every in-range id where
``torch.argsort(ids, stable=True)`` puts it; ``unsorted_segment_sum`` (K3's
backward) and ``gather_scatter_dx`` (K4's ``dx``) against ``jax.vjp`` of
the JAX package's ``gather_rows_banded`` and ``pallas_gather_scatter_sum``
(their Pallas kernels in interpret mode on ``JAX_PLATFORMS=cpu``); and a
two-layer GAT step with the banded src gather: each of its three K3
backwards sorts ``edge_src``, two steps give the same bits, and the
gradients hold to the reference's.
The kernel itself is held to the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances: the sort and the gathers are exact. Sums: f32 at rtol/atol
1e-4 (the ROADMAP's oracle); f32 sums rounded once to bf16 within one
bf16 ulp, |Δ| ≤ 2^-7·|ref| plus 1e-5 of the largest magnitude (the two
sides sum in another order, so a sum near a rounding boundary may land
one ulp apart).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from alaz_tpu.config import ModelConfig as JaxConfig
from alaz_tpu.ops import pallas_segment as jpallas
from alaz_tpu_torch.config import ModelConfig
from alaz_tpu_torch.convert import graph_to_torch, params_from_jax
from alaz_tpu_torch.models.registry import get_model
from alaz_tpu_torch.ops import segment_kernels as K
from alaz_tpu_torch.train import trainstep
from test_torch_train import (
    CLUSTERED,
    _DT,
    _assert_sum_close,
    _np,
    _t,
    _vjp,
    assert_grads_match,
    jax_value_and_grad,
    labels_from_window,
)

N_ROWS = 1000


def _ids(case: str, seed: int = 0) -> np.ndarray:
    """The ids of a case: ``<size>`` uniform in [0, N_ROWS), ``equal`` one
    id for all, ``negative`` and ``past`` a share of ids below 0 or at and
    past N_ROWS, ``mixed`` both, with a hub id."""
    rng = np.random.default_rng(seed)
    if case.isdigit():
        return rng.integers(0, N_ROWS, int(case)).astype(np.int32)
    ids = rng.integers(0, N_ROWS, 5000)
    if case == "equal":
        ids[:] = 17
    if case in ("negative", "mixed"):
        ids[::3] = -rng.integers(1, 2**31 - 1, ids[::3].size)
    if case in ("past", "mixed"):
        ids[1::4] = N_ROWS + rng.integers(0, 2**31 - 1 - N_ROWS, ids[1::4].size)
    if case == "mixed":
        ids[2::7] = 5
    return ids.astype(np.int32)


def _numpy_sort(ids: np.ndarray, n_rows: int):
    keys = np.clip(ids.astype(np.int64), -1, n_rows) + 1
    perm = np.argsort(keys, kind="stable")
    return (keys[perm] - 1).astype(np.int32), perm.astype(np.int32)


@pytest.mark.parametrize("payloads", [False, True])
@pytest.mark.parametrize("case", ["0", "1", "127", "4097", "100000", "equal", "negative", "past", "mixed"])
def test_sort_plain_matches_numpy_stable_argsort(case, payloads):
    """Sorted ids (clamped to [-1, N_ROWS]), the permutation (int32) and
    an int32 and an f32 payload carried into sorted order, exactly."""
    ids = _ids(case)
    rng = np.random.default_rng(1)
    pi = rng.integers(-(2**31), 2**31 - 1, ids.size).astype(np.int32)
    pf = rng.normal(size=ids.size).astype(np.float32)
    pays = (_t(pi), _t(pf)) if payloads else ()
    sorted_ids, perm, carried = K.sort_by_ids_plain(_t(ids), N_ROWS, pays)
    want_ids, want_perm = _numpy_sort(ids, N_ROWS)
    assert sorted_ids.dtype == perm.dtype == torch.int32
    np.testing.assert_array_equal(sorted_ids.numpy(), want_ids)
    np.testing.assert_array_equal(perm.numpy(), want_perm)
    assert len(carried) == len(pays)
    if payloads:
        assert carried[0].dtype == torch.int32 and carried[1].dtype == torch.float32
        np.testing.assert_array_equal(carried[0].numpy(), pi[want_perm])
        np.testing.assert_array_equal(carried[1].numpy(), pf[want_perm])


@pytest.mark.parametrize("case", ["negative", "past", "mixed", "100000"])
def test_sort_puts_every_in_range_id_where_argsort_does(case):
    """Every id in [0, N_ROWS) lands at the slot ``torch.argsort(ids,
    stable=True)`` gives it, so K4 receives the same in-range edges at the
    same positions (its tile cuts, and so its sums, stay those of a sort of
    the raw ids); the negative ids come first and the ids past the rows
    last, each in edge order."""
    ids = _t(_ids(case, seed=3))
    sorted_ids, perm, _ = K.sort_by_ids_plain(ids, N_ROWS)
    ref = torch.argsort(ids, stable=True)
    inside = (ids[ref] >= 0) & (ids[ref] < N_ROWS)
    assert torch.equal(perm[inside], ref[inside].to(torch.int32))
    assert torch.equal(sorted_ids[inside], ids[ref][inside])
    low, high = sorted_ids == -1, sorted_ids == N_ROWS
    assert torch.equal(perm[low], torch.nonzero(ids < 0).flatten().to(torch.int32))
    assert torch.equal(perm[high], torch.nonzero(ids >= N_ROWS).flatten().to(torch.int32))


def test_sort_on_cpu_runs_the_plain_version_and_launches_nothing():
    """On CPU tensors the wrapper is its plain version; no launch is
    counted, and ``launch_counts()`` keeps the four kernels' keys."""
    ids = _t(_ids("mixed"))
    w = torch.rand(ids.shape[0])
    K.reset_launch_counts()
    got = K.sort_by_ids(ids, N_ROWS, (w,))
    ref = K.sort_by_ids_plain(ids, N_ROWS, (w,))
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]) and torch.equal(got[2][0], ref[2][0])
    assert K.sort_by_ids.launches == 0
    assert K.launch_counts() == {
        "scatter_sum_sorted": 0, "segment_expand_sorted": 0,
        "gather_rows_banded": 0, "pallas_gather_scatter_sum": 0,
    }


def test_sort_kernel_wrapper_refuses_a_cpu_tensor():
    """The kernel's wrapper has no CPU path: it raises."""
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        K._sort_by_ids_cuda(_t(_ids("127")), N_ROWS, ())


# -- the backward passes on the sort --------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,e", [(128, 128), (256, 1024), (128, 1000), (384, 5000)])
def test_unsorted_segment_sum_matches_vjp(dtype, n, e):
    """K3's backward called directly, against ``jax.vjp`` of the JAX
    package's ``gather_rows_banded``: f32 at 1e-4, bf16 within one ulp; the
    ``train`` CLI's n128xe128 windows, an edge count off the TPU kernel's
    512-edge chunk and more edges than one sort tile
    (``test_torch_train.py`` holds a table off the 128-row grid)."""
    rng = np.random.default_rng(n + e)
    ids = rng.integers(0, n, e).astype(np.int32)
    v = rng.normal(size=(n, 24)).astype(np.float32)
    g = rng.normal(size=(e, 24)).astype(np.float32)
    jd, td = _DT[dtype]
    (ref,) = _vjp(
        lambda x: jpallas.gather_rows_banded(x, jnp.asarray(ids), n),
        (jnp.asarray(v).astype(jd),),
        jnp.asarray(g).astype(jd),
    )
    got = K.unsorted_segment_sum(_t(g, td), _t(ids), n)
    assert got.dtype == td and got.shape == (n, 24)
    _assert_sum_close(got, ref, dtype)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_scatter_dx_matches_vjp(dtype, weighted):
    """K4's ``dx`` (src sorted with dst and the weights carried along,
    then K4 with the roles swapped, f32) against ``jax.vjp`` of the JAX
    package's ``pallas_gather_scatter_sum`` with respect to x, x's rows
    off the 128-row grid."""
    rng = np.random.default_rng(7)
    n_dst, n_x, e, f = 256, 300, 5120, 16
    dst = np.sort(rng.integers(0, n_dst, e)).astype(np.int32)
    src = rng.integers(0, n_x, e).astype(np.int32)
    w = rng.uniform(0.1, 2.0, e).astype(np.float32)
    x = rng.normal(size=(n_x, f)).astype(np.float32)
    g = rng.normal(size=(n_dst, f)).astype(np.float32)
    jd, td = _DT[dtype]
    (ref,) = _vjp(
        lambda xx: jpallas.pallas_gather_scatter_sum(
            xx, jnp.asarray(src), jnp.asarray(dst), n_dst, jnp.asarray(w) if weighted else None
        ),
        (jnp.asarray(x).astype(jd),),
        jnp.asarray(g).astype(jd),
    )
    g32 = _t(g, td).float()
    got = K.gather_scatter_dx(g32, _t(src), _t(dst), _t(w) if weighted else None, n_x).to(td)
    assert got.shape == (n_x, f)
    _assert_sum_close(got, ref, dtype)
    xt = _t(x, td).requires_grad_()
    K.pallas_gather_scatter_sum(xt, _t(src), _t(dst), n_dst, _t(w) if weighted else None).backward(_t(g, td))
    assert torch.equal(xt.grad, got)


@pytest.fixture
def sorts(monkeypatch):
    """The ids each sort of a backward pass was given, in order (the
    wrapper's hook ``_run_sort``, counted on the CPU too)."""
    seen = []

    def run_sort(ids, n_rows, payloads=()):
        seen.append((ids, n_rows, len(payloads)))
        return K.sort_by_ids_plain(ids, n_rows, payloads)

    monkeypatch.setattr(K, "_run_sort", run_sort)
    return seen


def test_each_backward_sorts_its_own_ids(sorts):
    """K3's backward sorts its ids with no payload on every call; K4's
    ``dx`` sorts src carrying dst (and the weights, when given)."""
    rng = np.random.default_rng(8)
    ids = _t(rng.integers(0, 64, 500).astype(np.int32))
    K.unsorted_segment_sum(torch.ones(500, 4), ids, 64)
    K.unsorted_segment_sum(torch.ones(500, 4), ids, 64)
    x = torch.randn(64, 4, requires_grad=True)
    dst = _t(np.sort(rng.integers(0, 64, 500)).astype(np.int32))
    K.pallas_gather_scatter_sum(x, ids, dst, 128).backward(torch.ones(128, 4))
    w = torch.rand(500)
    K.pallas_gather_scatter_sum(x, ids, dst, 128, w).backward(torch.ones(128, 4))
    assert [(i is ids, n, p) for i, n, p in sorts] == [(True, 64, 0), (True, 64, 0), (True, 64, 1),
                                                       (True, 64, 2)]


def _gat_step(cfg, model, graph, label):
    for p in model.parameters():
        p.grad = None
    loss = trainstep.make_loss_fn(cfg)(model, graph, label)
    trainstep.backward(model, loss)
    return float(loss.detach()), {k: p.grad.clone() for k, p in model.named_parameters()}


def test_gat_step_sorts_edge_src_for_each_k3_backward(sorts):
    """A two-layer GAT step with the banded src gather (hidden 32, f32): its
    three K3 backwards (one a layer and the edge head's) each sort
    ``edge_src``; a second step gives the same bits, and the gradients
    hold to the reference's ``jax.value_and_grad`` (its kernels in
    interpret mode)."""
    batch = jax_entry._example_batch(**CLUSTERED)
    label = labels_from_window(batch)
    jcfg = JaxConfig(model="gat", hidden_dim=32, dtype="float32", use_pallas="interpret",
                     src_gather="banded-interpret")
    np_params, ref_loss, ref_grads = jax_value_and_grad(jcfg, batch, label)
    cfg = ModelConfig(model="gat", hidden_dim=32, dtype="float32", src_gather="banded")
    assert cfg.num_layers == 2
    model = get_model("gat")[0](0, cfg, device="cpu")
    model.load_state_dict(params_from_jax(np_params))
    graph = graph_to_torch(batch.device_arrays(), "cpu")
    lab = _t(label)

    K.reset_launch_counts()
    loss, grads = _gat_step(cfg, model, graph, lab)
    assert [(ids is graph["edge_src"], p) for ids, _, p in sorts] == [(True, 0)] * 3
    assert K.launch_counts() == dict.fromkeys(K.launch_counts(), 0) and K.sort_by_ids.launches == 0
    assert loss == pytest.approx(ref_loss, rel=1e-5)
    assert_grads_match(grads, ref_grads)

    _, again = _gat_step(cfg, model, graph, lab)
    assert len(sorts) == 6
    for k in grads:
        assert torch.equal(again[k], grads[k]), k
    assert _np(grads["layers.0.kv.w"]).any()
