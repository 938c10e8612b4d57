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
- the expand and the banded src gather (row gathers) are exact: bit for
  bit.
- the fused gather-scatter (K4): both sides form each message in x's
  dtype and sum in f32 in another order: f32 within 1e-5 of max|ref|,
  bf16 within one bf16 ulp (2^-7·|ref|) plus that.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alaz_tpu.ops import pallas_segment as jpallas
from alaz_tpu.ops import segment as jseg
from alaz_tpu_torch import ops as tops
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


@pytest.mark.parametrize("mode", ["xla", "banded", "banded-interpret"])
def test_gather_src_modes(mode):
    """Every mode gives exactly v[ids] (on a CPU tensor the banded modes
    take K3's plain version); an unknown mode raises."""
    v = torch.randn(16, 4)
    ids = torch.tensor([3, 1, 15], dtype=torch.int32)
    K.reset_launch_counts()
    assert torch.equal(tseg.gather_src(v, ids, 16, mode), v[ids.long()])
    assert K.gather_rows_banded.launches == 0
    with pytest.raises(ValueError, match="src_gather mode"):
        tseg.gather_src(v, ids, 16, "bandd")


def _src_ids(case: str, e: int, n: int, seed: int) -> np.ndarray:
    """Unsorted src ids of the shapes the TPU kernel's branches take:
    each 512-edge chunk's ids inside a 3-window band ("banded"), the same
    with 10% strays anywhere in the table ("strays", inside the TPU
    kernel's 1/8 budget), or uniform over the table ("uniform", past the
    budget: the TPU kernel's plain-gather branch)."""
    rng = np.random.default_rng(seed)
    if case == "uniform":
        return rng.integers(0, n, e).astype(np.int32)
    chunk = np.arange(e) // 512
    base = (chunk * 3 * 128) % (n - 3 * 128)
    ids = base + rng.integers(0, 3 * 128, e)
    if case == "strays":
        stray = rng.random(e) < 0.1
        ids = np.where(stray, rng.integers(0, n, e), ids)
    return ids.astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case,e,f", [
    ("banded", 2048, 128),
    ("strays", 2048, 128),
    ("uniform", 2048, 128),
    ("strays", 1000, 128),  # E not a multiple of the TPU kernel's 512-edge chunk
    ("banded", 1536, 48),  # F not 128
])
def test_gather_rows_banded_bit_exact(dtype, case, e, f):
    """K3's wrapper on CPU tensors equals the JAX kernel (interpret mode)
    bit for bit, in every branch of the TPU kernel."""
    n = 1024
    ids = _src_ids(case, e, n, seed=e + f)
    jd, td = _DT[dtype]
    v = np.random.default_rng(11).normal(size=(n, f)).astype(np.float32)
    ref = jpallas.gather_rows_banded(_to_j(v, jd), _to_j(ids), n)
    got = K.gather_rows_banded(_to_t(v, td), _to_t(ids), n)
    assert got.dtype == td and got.shape == (e, f)
    np.testing.assert_array_equal(_np(got), _np(ref))


def _k4_inputs(seed: int, f: int = 32):
    msgs, dst, bs = _inputs(seed, f)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N_PAD, f)).astype(np.float32)
    src = rng.integers(0, N_PAD, E_PAD).astype(np.int32)
    w = rng.uniform(0.1, 2.0, E_PAD).astype(np.float32)
    return x, src, dst, w, bs


def _assert_k4_close(got, ref, dtype):
    got, ref = _np(got), _np(ref)
    scale = 1e-5 * np.abs(ref).max()
    if dtype == "float32":
        assert np.abs(got - ref).max() <= scale
    else:
        assert (np.abs(got - ref) <= 2.0**-7 * np.abs(ref) + scale).all()


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_scatter_sum_kernel_path_matches(dtype, weighted):
    """ops.gather_scatter_sum with kernels on (use_pallas=None) against the
    JAX kernel pallas_gather_scatter_sum (interpret mode); the blocked
    row starts give the COO rows bit for bit on every real row."""
    x, src, dst, w, bs = _k4_inputs(12)
    jd, td = _DT[dtype]
    ref = jpallas.pallas_gather_scatter_sum(
        _to_j(x, jd), _to_j(src), _to_j(dst), N_PAD, _to_j(w) if weighted else None
    )
    K.reset_launch_counts()
    tw = _to_t(w) if weighted else None
    got = tops.gather_scatter_sum(_to_t(x, td), _to_t(src), _to_t(dst), N_PAD, tw)
    assert K.launch_counts()["pallas_gather_scatter_sum"] == 0  # CPU: the plain version
    assert got.dtype == td and got.shape == (N_PAD, 32)
    _assert_k4_close(got, ref, dtype)
    blk = tops.gather_scatter_sum(
        _to_t(x, td), _to_t(src), _to_t(dst), N_PAD, tw, block_starts=_to_t(bs)
    )
    assert torch.equal(blk[: N_PAD - 1], got[: N_PAD - 1])


@pytest.mark.parametrize("layout", ["coo", "blocked"])
@pytest.mark.parametrize("weighted", [False, True])
def test_gather_scatter_sum_plain_path_matches(weighted, layout):
    """Kernels off: the plain gather and segment sum against the JAX
    package's XLA path, f32."""
    x, src, dst, w, bs = _k4_inputs(13)
    blocked = layout == "blocked"
    ref = jseg.gather_scatter_sum(
        _to_j(x), _to_j(src), _to_j(dst), N_PAD, _to_j(w) if weighted else None,
        use_pallas=False, block_starts=_to_j(bs) if blocked else None,
    )
    got = tops.gather_scatter_sum(
        _to_t(x), _to_t(src), _to_t(dst), N_PAD, _to_t(w) if weighted else None,
        use_pallas=False, block_starts=_to_t(bs) if blocked else None,
    )
    _assert_sum_close(got, ref, "float32")


def test_gather_scatter_sum_rounds_each_product_to_x_dtype():
    """In bf16 each w·x is rounded to bf16 before the f32 sum, as the JAX
    package does: 3 edges of x=1+2^-7 and w=1+2^-7 into one row sum to
    3·bf16((1+2^-7)^2) = 3·(1+2^-6), not 3·(1+2^-7)^2."""
    x = torch.full((128, 1), 1 + 2**-7).bfloat16()
    src = torch.zeros(3, dtype=torch.int32)
    dst = torch.zeros(3, dtype=torch.int32)
    w = torch.full((3,), 1 + 2**-7)
    out = K.pallas_gather_scatter_sum(x, src, dst, 128, w)
    assert float(out[0, 0]) == float(torch.tensor(3 * (1 + 2**-6)).bfloat16())


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
    t_msgs, t_dst = _to_t(msgs), _to_t(dst)
    K.scatter_sum_sorted(t_msgs, t_dst, N_PAD)
    K.segment_expand_sorted(t_msgs, t_dst, E_PAD)
    K.gather_rows_banded(t_msgs, t_dst, E_PAD)
    K.pallas_gather_scatter_sum(t_msgs, t_dst, t_dst, N_PAD)
    assert K.launch_counts() == {
        "scatter_sum_sorted": 0, "segment_expand_sorted": 0,
        "gather_rows_banded": 0, "pallas_gather_scatter_sum": 0,
    }
    meta_msgs = torch.empty((E_PAD, 32), device="meta")
    meta_dst = torch.empty(E_PAD, dtype=torch.int32, device="meta")
    for call in (
        lambda: K.scatter_sum_sorted(meta_msgs, meta_dst, N_PAD),
        lambda: K.segment_expand_sorted(meta_msgs, meta_dst, E_PAD),
        lambda: K.gather_rows_banded(meta_msgs, meta_dst, E_PAD),
        lambda: K.pallas_gather_scatter_sum(meta_msgs, meta_dst, meta_dst, N_PAD),
    ):
        with pytest.raises(ValueError, match="no kernel for device meta"):
            call()


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
    """The kernels are not forward only: each wrapper gives a gradient
    (its ``torch.autograd.Function``), for the weights of K4 too, and still
    runs under ``no_grad``. Each gradient here is a sum of ones, so it is
    exact in f32 and held bit for bit: ``msgs`` gets one per edge, ``v``
    through the gathers the count of its rows' uses, K4's ``w`` the row
    sums of ``x[src]``."""
    msgs, dst, _ = _inputs(10)
    d = _to_t(dst)
    x = _to_t(msgs[:N_PAD])
    w = torch.ones(E_PAD, requires_grad=True)
    cases = (
        ("scatter_sum_sorted", lambda t: K.scatter_sum_sorted(t, d, N_PAD), _to_t(msgs),
         lambda: torch.ones(E_PAD, 32)),
        ("segment_expand_sorted", lambda t: K.segment_expand_sorted(t, d, N_PAD), x,
         lambda: torch.bincount(d.long(), minlength=N_PAD).float()[:, None].expand(N_PAD, 32)),
        ("gather_rows_banded", lambda t: K.gather_rows_banded(t, d, N_PAD), x,
         lambda: torch.bincount(d.long(), minlength=N_PAD).float()[:, None].expand(N_PAD, 32)),
        ("pallas_gather_scatter_sum", lambda t: K.pallas_gather_scatter_sum(t, d, d, N_PAD, w), x,
         lambda: torch.bincount(d.long(), minlength=N_PAD).float()[:, None].expand(N_PAD, 32)),
    )
    for name, call, leaf, want in cases:
        t = leaf.clone().requires_grad_()
        call(t).sum().backward()
        assert torch.equal(t.grad, want()), name
        with torch.no_grad():
            out = call(t)
        assert not out.requires_grad, name
    assert torch.equal(w.grad, x[d.long()].sum(1))
