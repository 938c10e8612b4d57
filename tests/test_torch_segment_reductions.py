"""The port's ``segment_mean``, ``segment_max`` and ``segment_softmax``
against the JAX package's (``alaz_tpu/ops/segment.py``), on the CPU.

Inputs are made with numpy from a seed and handed to both packages, in
the cases of ``tests/test_ops.py``: the masked mean and its blocked
route, empty segments, all-masked rows (the pad tail every window
carries), [E] and [E, H] logits, and the softmax's gradients, which must
stay finite on the all-masked rows. The JAX side runs XLA, or its
sorted-expand kernel in interpret mode (``use_pallas="interpret"``); the
port's wrappers take their plain versions, because the tensors lie on
the CPU. f32 throughout, held at rtol/atol 1e-4.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alaz_tpu.ops import segment as jseg
from alaz_tpu_torch.graph.snapshot import edge_block_starts_from
from alaz_tpu_torch.ops import segment as tseg

TOL = dict(rtol=1e-4, atol=1e-4)


def _coo(seed: int, n: int = 128, e: int = 512, pad: int = 64, empty_from: int = 96):
    """dst-sorted ids over the first ``empty_from`` nodes (the rest empty),
    the last ``pad`` edges the pad tail on node n-1, masked."""
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, empty_from, e - pad)).astype(np.int32)
    dst = np.concatenate([dst, np.full(pad, n - 1, np.int32)])
    mask = np.arange(e) < e - pad
    return rng, dst, mask, n


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("weighted", [False, True])
def test_segment_mean(seed, weighted):
    rng, dst, mask, n = _coo(seed)
    data = rng.normal(size=(dst.shape[0], 8)).astype(np.float32)
    w = mask.astype(np.float32) if weighted else None
    ref = jseg.segment_mean(jnp.asarray(data), jnp.asarray(dst), n,
                            weights=None if w is None else jnp.asarray(w))
    got = tseg.segment_mean(torch.from_numpy(data), torch.from_numpy(dst), n,
                            weights=None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # empty segments average to zero, not NaN
    assert np.all(got.numpy()[96:-1] == 0.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_mean_block_starts_route(seed):
    """With ``block_starts`` the three sums go through the blocked sum
    (slots past the frontier zeroed): equal to the reference's route and,
    with 0/1 weights, to the masked COO mean."""
    rng, dst, mask, n = _coo(seed)
    data = rng.normal(size=(dst.shape[0], 8)).astype(np.float32)
    w = mask.astype(np.float32)
    starts = edge_block_starts_from(dst, int(mask.sum()), n)
    ref = jseg.segment_mean(jnp.asarray(data), jnp.asarray(dst), n, weights=jnp.asarray(w),
                            block_starts=jnp.asarray(starts))
    got = tseg.segment_mean(torch.from_numpy(data), torch.from_numpy(dst), n, weights=torch.from_numpy(w),
                            block_starts=torch.from_numpy(starts))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    coo = tseg.segment_mean(torch.from_numpy(data), torch.from_numpy(dst), n, weights=torch.from_numpy(w))
    assert torch.equal(got, coo)


@pytest.mark.parametrize("shape", [(512,), (512, 4)])
def test_segment_max_empty_segments_are_neg_inf(shape):
    rng, dst, _, n = _coo(2)
    data = rng.normal(size=shape).astype(np.float32)
    ref = np.asarray(jseg.segment_max(jnp.asarray(data), jnp.asarray(dst), n))
    got = tseg.segment_max(torch.from_numpy(data), torch.from_numpy(dst), n).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(ref)) and np.isneginf(got[96:-1]).all()
    np.testing.assert_array_equal(got, ref)  # a max is exact


@pytest.mark.parametrize("up", [False, "interpret"])
@pytest.mark.parametrize("heads", [None, 4])
@pytest.mark.parametrize("with_mask", [False, True])
def test_segment_softmax(up, heads, with_mask):
    """[E] and [E, H] logits, masked or not; masked edges weigh zero and
    each present segment sums to one."""
    rng, dst, mask, n = _coo(3)
    shape = (dst.shape[0],) if heads is None else (dst.shape[0], heads)
    logits = rng.normal(size=shape).astype(np.float32)
    m = mask if with_mask else None
    ref = jseg.segment_softmax(jnp.asarray(logits), jnp.asarray(dst), n,
                               mask=None if m is None else jnp.asarray(m), use_pallas=up)
    got = tseg.segment_softmax(torch.from_numpy(logits), torch.from_numpy(dst), n,
                               mask=None if m is None else torch.from_numpy(m), use_pallas=bool(up))
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    if with_mask:
        assert np.all(got.numpy()[~mask] == 0.0)
    sums = tseg.segment_sum(got, torch.from_numpy(dst), n).numpy()
    present = np.unique(dst[mask])
    np.testing.assert_allclose(sums[present], 1.0, rtol=1e-5)


@pytest.mark.parametrize("up", [False, "interpret"])
def test_segment_softmax_all_masked_rows_have_finite_grads(up):
    """The all-masked pad segment has denominator 0: the double-where
    keeps the backward finite there, and the gradients equal
    ``jax.grad`` of the reference."""
    rng, dst, mask, n = _coo(4)
    logits = rng.normal(size=(dst.shape[0], 4)).astype(np.float32)
    wts = rng.normal(size=(dst.shape[0], 4)).astype(np.float32)

    def jloss(lg):
        a = jseg.segment_softmax(lg, jnp.asarray(dst), n, mask=jnp.asarray(mask), use_pallas=up)
        return (a * jnp.asarray(wts) * jnp.asarray(mask)[:, None]).sum()

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(logits)))
    x = torch.from_numpy(logits).requires_grad_(True)
    a = tseg.segment_softmax(x, torch.from_numpy(dst), n, mask=torch.from_numpy(mask), use_pallas=bool(up))
    (a * torch.from_numpy(wts) * torch.from_numpy(mask)[:, None]).sum().backward()
    got = x.grad.numpy()
    assert np.isfinite(got).all() and np.isfinite(ref).all()
    assert np.all(got[~mask] == 0.0)
    np.testing.assert_allclose(got, ref, **TOL)


def test_exports_match():
    import alaz_tpu.ops as jops
    import alaz_tpu_torch.ops as tops

    assert set(jops.__all__) <= set(tops.__all__)
    assert tops.segment_softmax is tseg.segment_softmax and tops.segment_mean is tseg.segment_mean
