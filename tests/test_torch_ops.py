"""The port's segment ops against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
JAX side reaches its Pallas kernels in interpret mode
(``use_pallas="interpret"``); the port's wrappers take their plain
versions, because the tensors lie on the CPU.

Tolerances:
- f32: rtol/atol 1e-4, what the JAX package holds its sharded twins to.
- bf16 sorted sums: both sides accumulate in f32 and round once to bf16,
  but in another order (one-hot matmuls against index_add_), so a sum
  that lies near a rounding boundary may land one bf16 ulp apart:
  |Δ| ≤ 2^-7·|ref| (one ulp is at most 2^-7 of the value) + 1e-6.
- the expand (a gather) is exact: bit for bit.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alaz_tpu.ops import segment as jseg
from alaz_tpu_torch.ops import segment as tseg
from alaz_tpu_torch.ops import segment_kernels as K
from alaz_tpu_torch.graph.snapshot import edge_block_starts_from

N_PAD, E_PAD, N_EDGES = 256, 1024, 1000
_DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed=0, f=32):
    """Masked messages over a dst-sorted edge list with a pad tail on
    the last node row, as the models scatter them."""
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, 200, E_PAD)).astype(np.int32)
    dst[N_EDGES:] = N_PAD - 1
    msgs = rng.normal(size=(E_PAD, f)).astype(np.float32)
    msgs[N_EDGES:] = 0.0
    bs = edge_block_starts_from(dst, N_EDGES, N_PAD)
    return msgs, dst, bs


def _to_j(a, dtype=None):
    return jnp.asarray(a) if dtype is None else jnp.asarray(a).astype(dtype)


def _to_t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


def _assert_sum_close(got, ref, dtype):
    got, ref = _np(got), _np(ref)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    else:
        assert (np.abs(got - ref) <= 2.0**-7 * np.abs(ref) + 1e-6).all()


@pytest.mark.parametrize("layout", ["coo", "blocked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sorted_sum_kernel_path_matches(dtype, layout):
    """K1 through segment_sum_sorted_dispatch, input dtype out."""
    msgs, dst, bs = _inputs(1)
    jd, td = _DT[dtype]
    blocked = layout == "blocked"
    ref = jseg.segment_sum_sorted_dispatch(
        _to_j(msgs, jd), _to_j(dst), N_PAD, "interpret",
        block_starts=_to_j(bs) if blocked else None,
    )
    got = tseg.segment_sum_sorted_dispatch(
        _to_t(msgs, td), _to_t(dst), N_PAD, True,
        block_starts=_to_t(bs) if blocked else None,
    )
    assert got.dtype == td
    _assert_sum_close(got, ref, dtype)


@pytest.mark.parametrize("layout", ["coo", "blocked"])
def test_sum_accurate_kernel_path_matches(layout):
    """K1 with out_dtype=f32: bf16 in, the f32 sum out, held at f32."""
    msgs, dst, bs = _inputs(2)
    blocked = layout == "blocked"
    ref = jseg.segment_sum_accurate(
        _to_j(msgs, jnp.bfloat16), _to_j(dst), N_PAD, "interpret",
        block_starts=_to_j(bs) if blocked else None,
    )
    got = tseg.segment_sum_accurate(
        _to_t(msgs, torch.bfloat16), _to_t(dst), N_PAD, True,
        block_starts=_to_t(bs) if blocked else None,
    )
    assert got.dtype == torch.float32
    _assert_sum_close(got, ref, "float32")


@pytest.mark.parametrize("layout", ["coo", "blocked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sorted_sum_plain_path_matches(dtype, layout):
    """Kernels off: the plain segment sum against XLA's segment_sum."""
    msgs, dst, bs = _inputs(3)
    jd, td = _DT[dtype]
    blocked = layout == "blocked"
    ref = jseg.segment_sum_sorted_dispatch(
        _to_j(msgs, jd), _to_j(dst), N_PAD, False,
        block_starts=_to_j(bs) if blocked else None,
    )
    got = tseg.segment_sum_sorted_dispatch(
        _to_t(msgs, td), _to_t(dst), N_PAD, False,
        block_starts=_to_t(bs) if blocked else None,
    )
    assert got.dtype == td
    if dtype == "float32":
        _assert_sum_close(got, ref, dtype)
    else:
        # both accumulate in bf16, in possibly different orders: a few
        # bf16 roundings of partial sums of ~5 unit-normal terms
        np.testing.assert_allclose(_np(got), _np(ref), rtol=2**-5, atol=2**-5)


def test_blocked_segment_sum_matches_and_masks_frontier():
    msgs, dst, bs = _inputs(4)
    msgs[N_EDGES:] = 7.0  # unmasked pad slots: the frontier must drop them
    ref = jseg.blocked_segment_sum(_to_j(msgs), _to_j(dst), _to_j(bs), N_PAD)
    got = tseg.blocked_segment_sum(_to_t(msgs), _to_t(dst), _to_t(bs), N_PAD)
    _assert_sum_close(got, ref, "float32")
    assert float(got[N_PAD - 1].abs().max()) == 0.0
    with pytest.raises(ValueError, match="tile-aligned"):
        tseg.blocked_segment_sum(_to_t(msgs[:1000]), _to_t(dst[:1000]), _to_t(bs), N_PAD)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_sum_blocked_equals_coo_bitwise(dtype):
    """The port's K1 gives identical real rows under both layouts."""
    msgs, dst, bs = _inputs(5)
    td = _DT[dtype][1]
    coo = K.scatter_sum_sorted(_to_t(msgs, td), _to_t(dst), N_PAD)
    blk = K.scatter_sum_sorted(_to_t(msgs, td), _to_t(dst), N_PAD, block_starts=_to_t(bs))
    assert torch.equal(coo[: N_PAD - 1], blk[: N_PAD - 1])


@pytest.mark.parametrize("up", [False, True])
def test_segment_sum_accurate_hub_fanin_bf16(up):
    """2048 bf16 ones into one hub row sum to exactly 2048 on both
    dispatch paths (a bf16 running sum would stagnate at 256), and to
    2049 with one more edge (not bf16-representable: the f32 result is
    not rounded through bf16)."""
    for e in (2048, 2049):
        ones = torch.ones((e, 128), dtype=torch.bfloat16)
        ids = torch.zeros(e, dtype=torch.int32)
        out = tseg.segment_sum_accurate(ones, ids, 128, use_pallas=up)
        assert out.dtype == torch.float32
        assert float(out[0, 0]) == float(e)
    ref = jseg.segment_sum_accurate(
        jnp.ones((2048, 128), jnp.bfloat16), jnp.zeros(2048, jnp.int32), 128, use_pallas=False
    )
    assert float(ref[0, 0]) == 2048.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("up", [False, True])
def test_expand_dst_bit_exact(dtype, up):
    """K2 through expand_dst: exact against the JAX kernel."""
    _, dst, _ = _inputs(6)
    jd, td = _DT[dtype]
    v = np.random.default_rng(6).normal(size=(N_PAD, 32)).astype(np.float32)
    ref = jseg.expand_dst(_to_j(v, jd), _to_j(dst), N_PAD, "interpret" if up else False)
    got = tseg.expand_dst(_to_t(v, td), _to_t(dst), N_PAD, up)
    assert got.dtype == td
    np.testing.assert_array_equal(_np(got), _np(ref))


def test_expand_dst_override(monkeypatch):
    _, dst, _ = _inputs(7)
    v = torch.randn(N_PAD, 8)
    for forced in ("xla", "pallas"):
        monkeypatch.setenv("ALAZ_EXPAND_DST", forced)
        assert torch.equal(tseg.expand_dst(v, _to_t(dst), N_PAD, False), v[_to_t(dst).long()])
    monkeypatch.setenv("ALAZ_EXPAND_DST", "pallsa")
    with pytest.raises(ValueError, match="ALAZ_EXPAND_DST"):
        tseg.expand_dst(v, _to_t(dst), N_PAD, True)


def test_gather_src_modes():
    v = torch.randn(16, 4)
    ids = torch.tensor([3, 1, 15], dtype=torch.int32)
    assert torch.equal(tseg.gather_src(v, ids, 16, "xla"), v[ids.long()])
    with pytest.raises(ValueError, match="src_gather mode"):
        tseg.gather_src(v, ids, 16, "bandd")
    for mode in ("banded", "banded-interpret"):
        with pytest.raises(NotImplementedError, match="banded-gather kernel"):
            tseg.gather_src(v, ids, 16, mode)


def test_kernels_enabled_predicate():
    assert tseg.kernels_enabled(True) and tseg.kernels_enabled("interpret")
    assert not tseg.kernels_enabled(False)
    with pytest.raises(ValueError, match="use_pallas"):
        tseg.kernels_enabled("cuda")


def test_wrappers_take_plain_version_only_for_cpu_tensors():
    """A CPU tensor runs the plain version and launches nothing; a tensor
    on any other device with no kernel raises instead of falling back."""
    msgs, dst, _ = _inputs(8)
    K.reset_launch_counts()
    K.scatter_sum_sorted(_to_t(msgs), _to_t(dst), N_PAD)
    K.segment_expand_sorted(_to_t(msgs), _to_t(dst), E_PAD)
    assert K.launch_counts() == {"scatter_sum_sorted": 0, "segment_expand_sorted": 0}
    meta_msgs = torch.empty((E_PAD, 32), device="meta")
    meta_dst = torch.empty(E_PAD, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        K.scatter_sum_sorted(meta_msgs, meta_dst, N_PAD)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        K.segment_expand_sorted(meta_msgs, meta_dst, E_PAD)


def test_scatter_dtype_contract():
    msgs, dst, _ = _inputs(9)
    t16 = _to_t(msgs, torch.float16)
    out = K.scatter_sum_sorted(t16, _to_t(dst), N_PAD)
    assert out.dtype == torch.float16  # computed in f32, returned in the input dtype
    ref = K.scatter_sum_sorted(_to_t(msgs, torch.float16).float(), _to_t(dst), N_PAD)
    assert torch.equal(out, ref.to(torch.float16))
    bf = K.scatter_sum_sorted(_to_t(msgs, torch.bfloat16), _to_t(dst), N_PAD, out_dtype=torch.float32)
    assert bf.dtype == torch.float32


def test_kernels_are_forward_only():
    msgs, dst, _ = _inputs(10)
    m = _to_t(msgs).requires_grad_()
    with pytest.raises(NotImplementedError, match="forward only"):
        K.scatter_sum_sorted(m, _to_t(dst), N_PAD)
    with torch.no_grad():
        K.scatter_sum_sorted(m, _to_t(dst), N_PAD)
