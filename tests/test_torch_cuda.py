"""The hand-written CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device. Run them on the
H100 with ``python -m pytest tests/test_torch_cuda.py -q``. The shapes
here are the awkward ones the scoring path does not reach (odd widths,
misaligned buffers, empty and hub rows, every K2 word size);
``chip_smoke.py`` covers the path's own shapes.

Tolerances: K2 and K3 bit-exact. K1 and K4 sum in f32 in another order
than the plain versions: f32 output within 1e-5 of the output's largest
magnitude; bf16 output within one bf16 ulp (≤ 2^-7·|ref|) of it. K4's
reference takes its plain version's sums in float64 (``_k4_reference``).
The backward passes: K1's (a K2 launch) bit-exact; K2's, K3's and K4's
``dx`` (a K1, K4 and K4 launch) held to the float64 sum at K1's
tolerance.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from alaz_tpu_torch.ops import segment_kernels as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _sorted_dst(n_pad, e, seed, hub=False):
    rng = np.random.default_rng(seed)
    hi = n_pad // 2  # upper half of the rows gets no edges: empty blocks
    dst = rng.integers(0, hi, e)
    if hub:
        dst[: e // 2] = 3  # one row with half of all edges
    return np.sort(dst).astype(np.int32)


def _k4_reference(x, src, dst, n_pad, w=None):
    """K4's plain version with its sums taken in float64 (on the CPU): the
    products are rounded to x's dtype as the kernel rounds them, and the
    sums are exact to far below the tolerance. The plain version's own f32
    sums are not: over the 10,000-edge hub row they stray from the exact
    sum by more than the tolerance in some draws (on the card, its atomics
    add a varying order on top), while the kernel stays close to it."""
    msgs = x.cpu()[src.cpu()]
    if w is not None:
        msgs = msgs * w.cpu().to(msgs.dtype)[:, None]
    out = torch.zeros((n_pad, x.shape[1]), dtype=torch.float64)
    return out.index_add_(0, dst.cpu(), msgs.double()).to(x.dtype)


def _assert_k1_close(got, ref):
    scale = 1e-5 * float(ref.float().abs().max())
    err = (got.float() - ref.float()).abs()
    if ref.dtype == torch.float32:
        assert float(err.max()) <= scale
    else:
        assert bool((err <= 2.0**-7 * ref.float().abs() + scale).all())


@pytest.mark.parametrize("f", [1, 3, 128, 129])
@pytest.mark.parametrize("in_dtype,out_dtype", [
    (torch.float32, None), (torch.bfloat16, None), (torch.bfloat16, torch.float32),
    (torch.float32, torch.bfloat16),
])
@pytest.mark.parametrize("hub", [False, True])
def test_scatter_sum_sorted_matches_plain(dev, f, in_dtype, out_dtype, hub):
    n_pad, e, n_edges = 512, 4096, 4000
    dst = _sorted_dst(n_pad, e, f, hub)
    dst[n_edges:] = n_pad - 1
    bs = np.searchsorted(dst[:n_edges], np.arange(0, n_pad + 1, 128)).astype(np.int32)
    msgs = torch.randn((e, f), device=dev).to(in_dtype)
    msgs[n_edges:] = 0
    d = torch.as_tensor(dst, device=dev)
    starts = torch.as_tensor(bs, device=dev)
    before = K.scatter_sum_sorted.launches
    coo = K.scatter_sum_sorted(msgs, d, n_pad, out_dtype)
    blk = K.scatter_sum_sorted(msgs, d, n_pad, out_dtype, starts)
    assert K.scatter_sum_sorted.launches == before + 2
    want = in_dtype if out_dtype is None else out_dtype
    assert coo.dtype == blk.dtype == want and coo.shape == (n_pad, f)
    _assert_k1_close(coo, K.scatter_sum_sorted_plain(msgs, d, n_pad, want))
    _assert_k1_close(blk, K.scatter_sum_sorted_plain(msgs, d, n_pad, want, starts))
    assert torch.equal(coo[: n_pad - 1], blk[: n_pad - 1])
    assert float(coo[n_pad // 2 : n_pad - 1].abs().max()) == 0.0


def test_scatter_sum_sorted_misaligned_and_deterministic(dev):
    n_pad, e, f = 256, 1000, 8
    d = torch.as_tensor(_sorted_dst(n_pad, e, 1), device=dev)
    flat = torch.randn(e * f + 1, device=dev)
    msgs = flat[1:].view(e, f)  # contiguous, 4 bytes past a 16-byte boundary
    a = K.scatter_sum_sorted(msgs, d, n_pad)
    _assert_k1_close(a, K.scatter_sum_sorted_plain(msgs, d, n_pad, torch.float32))
    assert torch.equal(a, K.scatter_sum_sorted(msgs, d, n_pad))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.int32, torch.uint8])
@pytest.mark.parametrize("f", [1, 3, 128, 129])
def test_segment_expand_sorted_bit_exact(dev, dtype, f):
    n_pad, e = 256, 3000
    d = torch.as_tensor(_sorted_dst(n_pad, e, f), device=dev)
    v = (torch.randn((n_pad, f), device=dev) * 50).to(dtype)
    before = K.segment_expand_sorted.launches
    out = K.segment_expand_sorted(v, d, n_pad)
    assert K.segment_expand_sorted.launches == before + 1
    assert torch.equal(out, K.segment_expand_sorted_plain(v, d))
    flat = torch.zeros(n_pad * f + 1, dtype=dtype, device=dev)
    flat[1:] = v.reshape(-1)
    shifted = flat[1:].view(n_pad, f)  # misaligned by one element
    assert torch.equal(K.segment_expand_sorted(shifted, d, n_pad), out)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    n_pad, e = 256, 512
    d = torch.as_tensor(_sorted_dst(n_pad, e, 2), device=dev)
    msgs = torch.randn((e, 16), device=dev)
    with pytest.raises(TypeError, match="int32"):
        K.scatter_sum_sorted(msgs, d.long(), n_pad)
    with pytest.raises(ValueError, match="contiguous"):
        K.scatter_sum_sorted(msgs.t().contiguous().t(), d, n_pad)
    with pytest.raises(ValueError, match="multiple of 128"):
        K.scatter_sum_sorted(msgs, d, 200)
    with pytest.raises(ValueError, match="entries"):
        K.scatter_sum_sorted(msgs, d, n_pad, block_starts=torch.zeros(5, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="is on cpu"):
        K.scatter_sum_sorted(msgs, d.cpu(), n_pad)
    with pytest.raises(ValueError, match="rows"):
        K.segment_expand_sorted(msgs, d, n_pad)


def test_graphsage_on_card_matches_cpu(dev):
    """The whole forward on the card (kernels) against the CPU (plain
    versions): bf16 matmuls differ between the two devices' libraries,
    so logits are held at four bf16 ulps of the largest (2^-6·max|ref|)."""
    from alaz_tpu_torch.config import ModelConfig
    from alaz_tpu_torch.convert import graph_to_torch
    from alaz_tpu_torch.models import graphsage
    from alaz_tpu_torch.replay.synth import example_batch

    cfg = ModelConfig(hidden_dim=128)
    batch = example_batch(n_pods=900, n_svcs=100, n_edges=4000, seed=0)
    model = graphsage.init(0, cfg, device="cpu")
    with torch.inference_mode():
        ref = graphsage.apply(model, graph_to_torch(batch.device_arrays(), "cpu"), cfg)
        K.reset_launch_counts()
        got = graphsage.apply(model.to(dev), graph_to_torch(batch.device_arrays(), dev), cfg)
    assert K.launch_counts() == {
        "scatter_sum_sorted": 2, "segment_expand_sorted": 1,
        "gather_rows_banded": 0, "pallas_gather_scatter_sum": 0,
    }
    for key, n in (("edge_logits", batch.n_edges), ("node_logits", batch.n_nodes)):
        r, g = ref[key][:n], got[key][:n].cpu()
        assert float((g - r).abs().max()) <= 2.0**-6 * float(r.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [4, 48, 132])
@pytest.mark.parametrize("e", [0, 1000, 4096])
def test_gather_rows_banded_bit_exact(dev, dtype, f, e):
    n_pad = 512
    ids = torch.randint(0, n_pad, (e,), dtype=torch.int32, device=dev)
    v = torch.randn((n_pad, f), device=dev).to(dtype)
    before = K.gather_rows_banded.launches
    out = K.gather_rows_banded(v, ids, n_pad)
    assert K.gather_rows_banded.launches == before + (1 if e else 0)
    assert out.shape == (e, f) and torch.equal(out, K.gather_rows_banded_plain(v, ids))
    flat = torch.zeros(n_pad * f + 1, dtype=dtype, device=dev)
    flat[1:] = v.reshape(-1)
    shifted = flat[1:].view(n_pad, f)  # rows off the 16-byte grid
    assert torch.equal(K.gather_rows_banded(shifted, ids, n_pad), out)


def test_gather_rows_banded_out_of_range_id_gives_zero_row(dev):
    v = torch.randn((256, 128), device=dev).bfloat16()
    ids = torch.tensor([5, 256, -1, 7], dtype=torch.int32, device=dev)
    out = K.gather_rows_banded(v, ids, 256)
    assert torch.equal(out[0], v[5]) and torch.equal(out[3], v[7])
    assert float(out[1:3].float().abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [4, 48, 132])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("hub", [False, True])
def test_gather_scatter_sum_matches_plain(dev, dtype, f, weighted, hub):
    """Odd widths, E off the 128 grid, empty dst blocks (the upper half of
    the rows), and a hub row of 10,000 edges, against the plain version
    summed in float64 (``_k4_reference``)."""
    n_pad, n_x = 512, 300
    e = 10_000 + 1000 if hub else 3000 - 37
    dst = _sorted_dst(n_pad, e, f)
    if hub:
        dst[:10_000] = 3
        dst = np.sort(dst)
    d = torch.as_tensor(dst, device=dev)
    bs = torch.as_tensor(np.searchsorted(dst, np.arange(0, n_pad + 1, 128)).astype(np.int32), device=dev)
    src = torch.randint(0, n_x, (e,), dtype=torch.int32, device=dev)
    x = torch.randn((n_x, f), device=dev).to(dtype)
    w = torch.rand(e, device=dev) + 0.5 if weighted else None
    before = K.pallas_gather_scatter_sum.launches
    coo = K.pallas_gather_scatter_sum(x, src, d, n_pad, w)
    blk = K.pallas_gather_scatter_sum(x, src, d, n_pad, w, bs)
    assert K.pallas_gather_scatter_sum.launches == before + 2
    assert coo.dtype == dtype and coo.shape == (n_pad, f)
    _assert_k1_close(coo.cpu(), _k4_reference(x, src, d, n_pad, w))
    assert torch.equal(coo, blk)  # no pad edges here: every row agrees
    assert float(coo[n_pad // 2 :].float().abs().max()) == 0.0


def test_gather_scatter_sum_misaligned_empty_and_rejects(dev):
    n_pad, f = 256, 8
    d = torch.as_tensor(_sorted_dst(n_pad, 1000, 4), device=dev)
    src = torch.randint(0, n_pad, (1000,), dtype=torch.int32, device=dev)
    flat = torch.randn(n_pad * f + 1, device=dev)
    x = flat[1:].view(n_pad, f)  # 4 bytes past a 16-byte boundary
    got = K.pallas_gather_scatter_sum(x, src, d, n_pad)
    _assert_k1_close(got, K.pallas_gather_scatter_sum_plain(x, src, d, n_pad))
    assert torch.equal(got, K.pallas_gather_scatter_sum(x, src, d, n_pad))  # deterministic
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    empty = K.pallas_gather_scatter_sum(x, none, none, n_pad)
    assert empty.shape == (n_pad, f) and float(empty.abs().max()) == 0.0
    with pytest.raises(ValueError, match="edge_src has"):
        K.pallas_gather_scatter_sum(x, src[:10], d, n_pad)
    with pytest.raises(ValueError, match="edge_weight has"):
        K.pallas_gather_scatter_sum(x, src, d, n_pad, torch.ones(10, device=dev))
    with pytest.raises(TypeError, match="int32"):
        K.pallas_gather_scatter_sum(x, src.long(), d, n_pad)


def test_gat_on_card_matches_cpu(dev):
    """The GAT forward on the card (K1-K3) against the CPU (plain
    versions), banded src gather on a clustered community window; logits
    held at four bf16 ulps of the largest (2^-6·max|ref|), as GraphSAGE."""
    from alaz_tpu_torch.config import ModelConfig
    from alaz_tpu_torch.convert import graph_to_torch
    from alaz_tpu_torch.models import gat
    from alaz_tpu_torch.replay.synth import example_batch

    cfg = ModelConfig(model="gat", src_gather="banded")
    batch = example_batch(n_pods=900, n_svcs=100, n_edges=4000, seed=0, structure="community", layout="clustered")
    model = gat.init(0, cfg, device="cpu")
    with torch.inference_mode():
        ref = gat.apply(model, graph_to_torch(batch.device_arrays(), "cpu"), cfg)
        K.reset_launch_counts()
        got = gat.apply(model.to(dev), graph_to_torch(batch.device_arrays(), dev), cfg)
    assert K.launch_counts() == {
        "scatter_sum_sorted": 2, "segment_expand_sorted": 3,
        "gather_rows_banded": 3, "pallas_gather_scatter_sum": 0,
    }
    for key, n in (("edge_logits", batch.n_edges), ("node_logits", batch.n_nodes)):
        r, g = ref[key][:n], got[key][:n].cpu()
        assert float((g - r).abs().max()) <= 2.0**-6 * float(r.abs().max())
    assert float(got["attn_clamp_saturation"]) == float(ref["attn_clamp_saturation"])


# -- K4's edge-balanced tiles ------------------------------------------------


def _k4_dst(case: str, tile: int, rng) -> tuple:
    """(dst sorted, n_pad) for a K4 tile case; ``tile`` is the kernel's
    live edges per tile."""
    if case == "below_one_tile":
        return np.sort(rng.integers(0, 200, tile // 3)).astype(np.int32), 256
    if case == "hub_tiles":  # one row 3.5 tiles long, begun mid-tile
        dst = np.concatenate([
            np.sort(rng.integers(0, 40, tile // 2)),
            np.full(7 * tile // 2, 40),
            np.sort(rng.integers(41, 300, tile)),
        ])
        return dst.astype(np.int32), 512
    if case == "smoke_like":  # busy rows in the first 5 of 64 blocks, ~100 edges each
        return np.sort(rng.integers(0, 640, 64_000)).astype(np.int32), 8192
    # runs of 1-40 edges; one row across the first tile end, one row
    # ending exactly on the second
    runs = rng.integers(1, 41, 3 * tile)
    dst = np.repeat(np.arange(runs.shape[0]) * 2, runs)[: 3 * tile]
    if case == "straddle":
        dst[tile - 10 : tile + 10] = dst[tile - 11] + 1
        dst[tile + 10 :] = np.maximum(dst[tile + 10 :], dst[tile - 11] + 2)
    elif case == "tile_end_on_row_end":
        dst[2 * tile :] += 1
        dst[2 * tile - 5 : 2 * tile] = dst[2 * tile - 6]
    return dst.astype(np.int32), ((int(dst[-1]) // 128) + 2) * 128


@pytest.mark.parametrize(
    "case", ["straddle", "tile_end_on_row_end", "hub_tiles", "smoke_like", "below_one_tile"]
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_scatter_tiles(dev, case, dtype):
    """K4's partition at the places it can go wrong: rows cut by a tile
    end and rows ending on one, a hub row several tiles long, a window
    whose edges sit in a few dst blocks, fewer edges than one tile. Held
    to the plain version summed in float64 (``_k4_reference``); two calls,
    and COO and blocked row starts, give the same bits; rows without edges
    are zeros."""
    tile = K.gather_scatter_tile_edges()
    rng = np.random.default_rng(7)
    dst, n_pad = _k4_dst(case, tile, rng)
    e = dst.shape[0]
    if case == "straddle":
        assert dst[tile - 1] == dst[tile]
    if case == "tile_end_on_row_end":
        assert dst[2 * tile - 1] != dst[2 * tile] and dst[2 * tile - 2] == dst[2 * tile - 1]
    n_x = 3000
    # reused rows, as in clustered windows
    src = (dst.astype(np.int64) * 7 + rng.integers(0, 20, e)) % n_x
    d = torch.as_tensor(dst, device=dev)
    s = torch.as_tensor(src.astype(np.int32), device=dev)
    bounds = np.arange(0, n_pad + 1, 128)
    bs = torch.as_tensor(np.searchsorted(dst, bounds).astype(np.int32), device=dev)
    x = torch.randn((n_x, 128), device=dev).to(dtype)
    w = torch.rand(e, device=dev) + 0.5
    got = K.pallas_gather_scatter_sum(x, s, d, n_pad, w)
    _assert_k1_close(got.cpu(), _k4_reference(x, s, d, n_pad, w))
    assert torch.equal(got, K.pallas_gather_scatter_sum(x, s, d, n_pad, w))
    assert torch.equal(got, K.pallas_gather_scatter_sum(x, s, d, n_pad, w, bs))
    empty = torch.ones(n_pad, dtype=torch.bool, device=dev)
    empty[d.long()] = False
    assert float(got[empty].float().abs().max()) == 0.0


# -- the kernels as backward passes ------------------------------------------


def _f64_sum(g, ids, n, w=None, live=None):
    """``Σ_{ids[e]=i} w[e]·g[e]`` over the live edges, in float64 on the CPU."""
    src = g.cpu().double()
    if w is not None:
        src = src * w.cpu().double()[:, None]
    if live is not None:
        src = src[:live]
        ids = ids[:live]
    return torch.zeros((n, g.shape[1]), dtype=torch.float64).index_add_(0, ids.cpu().long(), src)


def _pad_tail(dst, n_edges, n_pad):
    """Pad slots past the live edges on the last row, as the batches have
    them, and the blocked extents over the live prefix."""
    dst = dst.copy()
    dst[n_edges:] = n_pad - 1
    bs = np.searchsorted(dst[:n_edges], np.arange(0, n_pad + 1, 128)).astype(np.int32)
    return dst, bs


@pytest.mark.parametrize("f", [4, 132])
@pytest.mark.parametrize("in_dtype,out_dtype", [
    (torch.float32, None), (torch.bfloat16, None), (torch.bfloat16, torch.float32),
])
@pytest.mark.parametrize("layout", ["coo", "blocked"])
def test_scatter_sum_sorted_backward_is_one_expand(dev, f, in_dtype, out_dtype, layout):
    """K1's backward launches K2 once: ``g[dst]`` cast to the messages'
    dtype, bit for bit, pad slots past the blocked frontier included (they
    get their row's ``g``, as in the JAX package); a hub row."""
    n_pad, e, n_edges = 512, 4096, 4000
    dst, bs = _pad_tail(_sorted_dst(n_pad, e, f, hub=True), n_edges, n_pad)
    d = torch.as_tensor(dst, device=dev)
    starts = torch.as_tensor(bs, device=dev) if layout == "blocked" else None
    msgs = torch.randn((e, f), device=dev).to(in_dtype).requires_grad_()
    out = K.scatter_sum_sorted(msgs, d, n_pad, out_dtype, starts)
    g = torch.randn(out.shape, device=dev).to(out.dtype)
    K.reset_launch_counts()
    out.backward(g)
    assert K.launch_counts() == {
        "scatter_sum_sorted": 0, "segment_expand_sorted": 1,
        "gather_rows_banded": 0, "pallas_gather_scatter_sum": 0,
    }
    assert msgs.grad.dtype == in_dtype
    assert torch.equal(msgs.grad, K.segment_expand_sorted_plain(g.to(in_dtype), d))


@pytest.mark.parametrize("f", [4, 128, 129])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_expand_sorted_backward_is_one_sorted_sum(dev, f, dtype):
    """K2's backward launches K1 once: the sorted sum of ``g`` over dst in
    g's dtype, with empty rows (the upper half) and a hub row; held to the
    float64 sum at K1's tolerance."""
    n_pad, e = 512, 4096
    d = torch.as_tensor(_sorted_dst(n_pad, e, f, hub=True), device=dev)
    v = torch.randn((n_pad, f), device=dev).to(dtype).requires_grad_()
    out = K.segment_expand_sorted(v, d, n_pad)
    g = torch.randn(out.shape, device=dev).to(dtype)
    K.reset_launch_counts()
    out.backward(g)
    assert K.launch_counts()["scatter_sum_sorted"] == 1 and sum(K.launch_counts().values()) == 1
    assert v.grad.dtype == dtype
    _assert_k1_close(v.grad.cpu(), _f64_sum(g, d, n_pad).to(dtype))
    assert float(v.grad[n_pad // 2 :].float().abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,e,hub", [(512, 5000, False), (300, 5000, True), (512, 300, False), (512, 0, False)])
def test_gather_rows_banded_backward_is_one_k4(dev, dtype, n, e, hub):
    """K3's backward launches K4 once over the ids' stable sort: the
    unsorted sum of ``g`` over the ids, held to the float64 sum at K1's
    tolerance; a hub id, a table off the 128-row grid, fewer edges than one
    K4 tile, no edges. Two runs give the same bits (no atomics)."""
    ids = torch.randint(0, n, (e,), dtype=torch.int32, device=dev)
    if hub:
        ids[: e // 2] = 7
    v = torch.randn((n, 48), device=dev).to(dtype).requires_grad_()
    out = K.gather_rows_banded(v, ids, n)
    g = torch.randn(out.shape, device=dev).to(dtype)
    K.reset_launch_counts()
    out.backward(g, retain_graph=True)
    assert K.launch_counts()["pallas_gather_scatter_sum"] == 1 and sum(K.launch_counts().values()) == 1
    first, v.grad = v.grad, None
    out.backward(g)
    assert torch.equal(first, v.grad)
    assert first.dtype == dtype and first.shape == (n, 48)
    _assert_k1_close(first.cpu(), _f64_sum(g, ids, n).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("layout", ["coo", "blocked"])
@pytest.mark.parametrize("e", [300, 11_000])
def test_gather_scatter_sum_backward(dev, dtype, weighted, layout, e):
    """K4's ``dx`` launches K4 once (src and dst swapped, f32 products), held
    to the float64 sum at K1's tolerance in x's dtype; ``dw`` is the f32 row
    dot. Under the blocked layout the pad slots past the frontier took no
    part in the forward: no share of ``dx``, a zero ``dw``. A hub row of
    10,000 edges, fewer edges than one tile; two runs give the same bits."""
    n_pad, n_x, f = 512, 300, 48
    n_edges = e - 37
    dst = _sorted_dst(n_pad, e, e)
    if e > 10_000:
        dst[:10_000] = 3
        dst = np.sort(dst)
    dst, bs = _pad_tail(dst, n_edges, n_pad)
    d = torch.as_tensor(dst, device=dev)
    src = torch.randint(0, n_x, (e,), dtype=torch.int32, device=dev)
    x = torch.randn((n_x, f), device=dev).to(dtype).requires_grad_()
    w = (torch.rand(e, device=dev) + 0.5).requires_grad_() if weighted else None
    blocked = layout == "blocked"
    out = K.pallas_gather_scatter_sum(x, src, d, n_pad, w, torch.as_tensor(bs, device=dev) if blocked else None)
    g = torch.randn(out.shape, device=dev).to(dtype)
    K.reset_launch_counts()
    out.backward(g, retain_graph=True)
    assert K.launch_counts()["pallas_gather_scatter_sum"] == 1 and sum(K.launch_counts().values()) == 1
    dx, dw = x.grad, (w.grad if weighted else None)
    x.grad = None
    if weighted:
        w.grad = None
    out.backward(g)
    assert torch.equal(dx, x.grad) and (not weighted or torch.equal(dw, w.grad))
    live = n_edges if blocked else None
    g_edges = g.float()[d.long()]
    _assert_k1_close(dx.cpu(), _f64_sum(g_edges, src, n_x, w.detach() if weighted else None, live).to(dtype))
    if weighted:
        ref = (x.detach()[src.long()].float() * g_edges).sum(dim=1)
        if blocked:
            ref[n_edges:] = 0.0
        assert dw.dtype == torch.float32
        assert float((dw - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
        if blocked:
            assert float(dw[n_edges:].abs().max()) == 0.0


@pytest.mark.parametrize("model,expected", [
    ("graphsage", {"scatter_sum_sorted": 3, "segment_expand_sorted": 3,
                   "gather_rows_banded": 3, "pallas_gather_scatter_sum": 3}),
    ("gat", {"scatter_sum_sorted": 5, "segment_expand_sorted": 5,
             "gather_rows_banded": 3, "pallas_gather_scatter_sum": 3}),
])
def test_train_gradients_on_card_match_cpu(dev, model, expected):
    """One forward and backward of the train loss on the card (kernels)
    against the CPU (plain versions), both models with the banded src
    gather (K3 in each layer and the edge head): the launches of each pass
    counted (K1's backward a K2, K2's a K1, K3's a K4), every gradient finite and
    within 2^-4 of its param's largest gradient (bf16 matmuls differ
    between the devices' libraries, and an ulp apart in an activation
    carries through the backward)."""
    from alaz_tpu_torch.config import ModelConfig
    from alaz_tpu_torch.convert import graph_to_torch
    from alaz_tpu_torch.models.registry import init_params
    from alaz_tpu_torch.replay.synth import example_batch
    from alaz_tpu_torch.train.trainstep import backward, make_loss_fn

    cfg = ModelConfig(model=model, src_gather="banded")
    batch = example_batch(n_pods=900, n_svcs=100, n_edges=4000, seed=0, structure="community", layout="clustered")
    label = np.zeros(batch.e_pad, np.float32)
    label[: batch.n_edges] = batch.edge_feats[: batch.n_edges, 0] > 1.5
    grads = {}
    for where in ("cpu", dev):
        params = init_params(cfg, key=0, device=where)
        K.reset_launch_counts()
        loss = make_loss_fn(cfg)(params, graph_to_torch(batch.device_arrays(), where),
                                 torch.as_tensor(label, device=where))
        backward(params, loss)
        if where == dev:
            torch.cuda.synchronize()
            assert K.launch_counts() == expected
        grads[str(where)] = {k: p.grad.float().cpu() for k, p in params.named_parameters()}
    for k, ref in grads["cpu"].items():
        got = grads[str(dev)][k]
        assert bool(torch.isfinite(got).all()), k
        assert float((got - ref).abs().max()) <= 2.0**-4 * max(float(ref.abs().max()), 1e-30), k


# -- the streaming Service's group path on the card ---------------------------

_CARD_SIM = dict(pod_count=600, service_count=100, edge_count=400, edge_rate=20, seed=5)


def _card_serve(layout: str, batch_windows: int, duration_s: float):
    """The Service on the card over replayed traffic ingested on this
    thread before the workers start, so every closed window waits as a
    backlog: ``score_batch_windows`` > 1 groups it. f32, so group and
    serial differ only in the order of f32 sums. Returns (service, score
    map, launch counts, worker exceptions)."""
    import threading

    from alaz_tpu_torch.config import ModelConfig, RuntimeConfig, SimulationConfig
    from alaz_tpu_torch.events.intern import Interner
    from alaz_tpu_torch.models.registry import init_params
    from alaz_tpu_torch.replay.simulator import Simulator
    from alaz_tpu_torch.runtime.service import Service

    cfg = RuntimeConfig(model=ModelConfig(dtype="float32", edge_layout=layout),
                        score_batch_windows=batch_windows, edge_layout=layout)
    interner, records, raised = Interner(), [], []
    svc = Service(config=cfg, interner=interner, score_sink=records.extend,
                  model_state=init_params(cfg.model, key=0, device="cuda"),
                  score_threshold=0.0, device="cuda")
    sim = Simulator(SimulationConfig(test_duration_s=duration_s, **_CARD_SIM), interner=interner)
    for m in sim.setup():
        svc.aggregator.process_k8s(m)
    svc.aggregator.process_tcp(sim.tcp_events())
    for b in sim.iter_l7_batches():
        svc.aggregator.process_l7(b)
    svc.flush_windows()
    hook, threading.excepthook = threading.excepthook, raised.append
    K.reset_launch_counts()
    try:
        svc.start()
        svc.drain(timeout_s=120)
        svc.stop()
    finally:
        threading.excepthook = hook
    scores = {(r.window_start_ms, r.from_uid, r.to_uid, r.protocol): r.score for r in records}
    return svc, scores, K.launch_counts(), raised


@pytest.mark.parametrize("layout,batch_windows,duration_s,dispatches", [
    ("coo", 4, 3.0, 1),      # W=3, padded to 4 by repeating the last window
    ("blocked", 4, 4.0, 1),  # a blocked-layout group of 4
    ("coo", 4, 5.0, 2),      # a ragged backlog: a group of 4, then one window serially
    ("coo", 2, 6.0, 3),      # three groups of 2: the first arena's buffer comes around again
])
def test_service_group_path_matches_serial_on_card(dev, layout, batch_windows, duration_s, dispatches):
    """The group path's block-diagonal stack through K1 and K2 on the card
    against the serial path on the same windows, scores within the f32
    oracle's 1e-4. Groups staged back to back go through the two pinned
    buffers of one arena key in turn; a buffer overwritten while its copy
    to the card was in flight would give its group another window's
    scores. Each dispatch launches K1 twice (GraphSAGE's two layers) and
    K2 once (the edge head), a group as one window."""
    n_windows = int(duration_s)
    gsvc, group, glaunch, graised = _card_serve(layout, batch_windows, duration_s)
    ssvc, serial, slaunch, sraised = _card_serve(layout, 1, duration_s)
    assert graised == [] and sraised == []
    assert gsvc.scored_batches == ssvc.scored_batches == n_windows
    assert gsvc.metrics.counter("windows.closed").value == n_windows
    assert gsvc.score_dispatches == dispatches and ssvc.score_dispatches == n_windows
    assert gsvc._stage_arenas.pin
    if batch_windows == 2:
        assert (gsvc._stage_arenas.fills, gsvc._stage_arenas.reuses) == (3, 1)
    for svc, launches in ((gsvc, glaunch), (ssvc, slaunch)):
        assert launches["scatter_sum_sorted"] == 2 * svc.score_dispatches
        assert launches["segment_expand_sorted"] == svc.score_dispatches
    assert serial and set(group) == set(serial)
    keys = sorted(serial)
    np.testing.assert_allclose([group[k] for k in keys], [serial[k] for k in keys], rtol=1e-4, atol=1e-4)


def test_native_ingest_service_on_card_matches_plain(dev):
    """A small replay served on the card through native ingest (the C++ L7
    engine, ``ENGINE_BACKEND=native``, and the C++ window accumulator,
    ``use_native_ingest=True``): every closed window scored, K1 twice and
    K2 once a dispatch; each window scored again on the CPU through the
    plain versions, f32, within the f32 oracle's 1e-4."""
    import threading

    from alaz_tpu_torch.config import ModelConfig, RuntimeConfig, SimulationConfig
    from alaz_tpu_torch.events.intern import Interner
    from alaz_tpu_torch.graph.native import NativeWindowedStore
    from alaz_tpu_torch.models.registry import init_params
    from alaz_tpu_torch.replay.simulator import Simulator
    from alaz_tpu_torch.runtime.scorer import WindowScorer
    from alaz_tpu_torch.runtime.service import Service

    cfg = RuntimeConfig(model=ModelConfig(dtype="float32"), engine_backend="native")
    interner, sunk, windows, raised = Interner(), [], [], []
    svc = Service(config=cfg, interner=interner, score_sink=sunk.append,
                  model_state=init_params(cfg.model, key=0, device="cuda"),
                  score_threshold=0.0, device="cuda", use_native_ingest=True)
    assert isinstance(svc.graph_store, NativeWindowedStore)
    svc.score_observer = lambda batch, tenant, lat: windows.append(batch)
    sim = Simulator(SimulationConfig(test_duration_s=3.0, **_CARD_SIM), interner=interner)
    for m in sim.setup():
        svc.aggregator.process_k8s(m)
    svc.aggregator.process_tcp(sim.tcp_events())
    for b in sim.iter_l7_batches():
        svc.aggregator.process_l7(b)
    svc.flush_windows()
    hook, threading.excepthook = threading.excepthook, raised.append
    K.reset_launch_counts()
    try:
        svc.start()
        svc.drain(timeout_s=120)
        svc.stop()
    finally:
        threading.excepthook = hook
    assert raised == [] and svc.aggregator._native_l7 is not None
    assert svc.scored_batches == svc.metrics.counter("windows.closed").value == len(sunk) == 3
    assert K.launch_counts()["scatter_sum_sorted"] == 2 * svc.score_dispatches
    assert K.launch_counts()["segment_expand_sorted"] == svc.score_dispatches
    plain = WindowScorer(cfg.model, init_params(cfg.model, key=0, device="cpu"), device="cpu")
    for b, sb in zip(windows, sunk):
        np.testing.assert_allclose(sb.score, plain.score(b), rtol=1e-4, atol=1e-4)
