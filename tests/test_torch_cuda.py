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
tolerance. The sort of K3's and K4's backward bit-exact against its plain
version, and those two backward passes bit-exact against the
``torch.argsort`` + K4 composition the sort replaced. The GRU memory
update (``csrc/gru.cu``): masked rows and the rows past the bucket
bit-exact, live rows within ``GRU_TOL`` of its plain version.
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


def _k1_runs(dst: np.ndarray, n_pad: int, live: int) -> tuple:
    """Each row's edge run ``[s, t)`` among the first ``live`` edges."""
    bounds = np.searchsorted(dst[:live], np.arange(n_pad + 1))
    return bounds[:-1], bounds[1:]


def _k1_sequential(msgs: np.ndarray, dst: np.ndarray, n_pad: int, live: int) -> tuple:
    """K1's f32 rows as its design sums them, on the host: a run of at most
    ``L`` edges summed in edge order; a longer one cut into the ``C``-edge
    chunks of the edge axis, each summed in edge order, the chunk sums
    added in chunk order. Returns (rows, the split rows' runs)."""
    lim, chunk = K.k1_split_lengths()
    s, t = _k1_runs(dst, n_pad, live)
    out = np.zeros((n_pad, msgs.shape[1]), dtype=np.float32)
    n = t - s
    short = np.flatnonzero((n > 0) & (n <= lim))
    for k in range(int(n[short].max(initial=0))):  # the k-th edge of every run that has one
        rows = short[n[short] > k]
        out[rows] = out[rows] + msgs[s[rows] + k]
    split = [(int(a), int(b)) for a, b in zip(s, t) if b - a > lim]
    for a, b in split:
        cuts = [a, *range((a // chunk + 1) * chunk, b, chunk)]
        parts = [np.cumsum(msgs[c:min(b, (c // chunk + 1) * chunk)], axis=0, dtype=np.float32)[-1] for c in cuts]
        out[dst[a]] = np.cumsum(np.stack(parts), axis=0, dtype=np.float32)[-1]
    return out, split


def _k1_case(case: str, rng) -> tuple:
    """(dst, live edges, n_pad) of a window K1 splits rows of: ``stream``,
    the TGN cell's bucket (131,072 rows, 40,000 live edges on the 10,000
    service slots, 9,152 pad edges on the last row); ``hub``, one row of
    100,000 edges among short rows, and rows of exactly ``L`` and ``L + 1``
    edges."""
    lim, chunk = K.k1_split_lengths()
    if case == "stream":
        n_pad, live, e = 131_072, 40_000, 49_152
        dst = np.concatenate([np.sort(rng.integers(100_000, 110_000, live)), np.full(e - live, n_pad - 1)])
        return dst.astype(np.int32), live, n_pad
    n_pad = 4096
    lens = rng.integers(0, 9, n_pad)
    lens[[7, 1000, 1001, 2000, 2001]] = [lim, 100_000, lim + 1, 2 * chunk + 1, lim]
    lens[-1] = 0
    dst = np.repeat(np.arange(n_pad), lens).astype(np.int32)
    return dst, dst.shape[0], n_pad


@pytest.mark.parametrize("case", ["stream", "hub"])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_k1_splits_long_runs_bit_for_bit(dev, case, out_dtype):
    """K1 over a window with long runs, bf16 messages, F = 128: every row
    equals, bit for bit, the host's sums in K1's order (a run of at most
    ``L`` edges in edge order; a longer one by ``C``-edge chunks of the
    edge axis, the chunk sums in chunk order), rounded once; within K1's
    tolerance of the float64 sum; two calls equal; the blocked layout's
    rows equal the COO layout's (the pad row aside); one launch a call,
    one kernel launch in the device trace; ``k1_split_counts`` moves by
    exactly the long rows and their edges, each call."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(19)
    dst, live, n_pad = _k1_case(case, rng)
    e, f = dst.shape[0], 128
    msgs = torch.from_numpy(rng.standard_normal((e, f), dtype=np.float32)).to(torch.bfloat16)
    msgs[live:] = 0
    host = msgs.float().numpy()
    want, split = _k1_sequential(host, dst, n_pad, e)
    d, m = torch.as_tensor(dst, device=dev), msgs.to(dev)
    starts = torch.as_tensor(np.searchsorted(dst[:live], np.arange(0, n_pad + 1, 128)).astype(np.int32), device=dev)
    _, blk_split = _k1_sequential(host, dst, n_pad, live)
    assert split and (case == "hub" or blk_split == [])

    rows0, edges0 = K.k1_split_counts(dev)
    before = K.scatter_sum_sorted.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = K.scatter_sum_sorted(m, d, n_pad, out_dtype)
        torch.cuda.synchronize()
    kernels = [ev for ev in prof.key_averages() if "scatter_sum_sorted_kernel" in ev.key]
    assert sum(ev.count for ev in kernels) == 1
    assert K.scatter_sum_sorted.launches == before + 1
    rows1, edges1 = K.k1_split_counts(dev)
    assert (rows1 - rows0, edges1 - edges0) == (len(split), sum(b - a for a, b in split))

    assert got.dtype == out_dtype
    assert torch.equal(got.cpu(), torch.from_numpy(want).to(out_dtype))
    _assert_k1_close(got.cpu(), _f64_sum(msgs, torch.as_tensor(dst), n_pad).to(out_dtype))
    assert torch.equal(got, K.scatter_sum_sorted(m, d, n_pad, out_dtype))
    blk = K.scatter_sum_sorted(m, d, n_pad, out_dtype, starts)
    assert torch.equal(blk[: n_pad - 1], got[: n_pad - 1])
    assert float(blk[n_pad - 1].float().abs().max()) == 0.0
    rows2, edges2 = K.k1_split_counts(dev)
    assert (rows2 - rows1, edges2 - edges1) == (
        len(split) + len(blk_split), sum(b - a for a, b in split + blk_split)
    )


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


# -- the sort of K3's and K4's backward --------------------------------------


def _window_src(kind: str) -> np.ndarray:
    """The src ids of the smoke's 1M-edge windows (n131072): the uniform
    GraphSAGE window's and the clustered GAT window's."""
    from alaz_tpu_torch.replay.synth import example_batch

    extra = {} if kind == "uniform" else dict(structure="community", layout="clustered")
    return example_batch(n_pods=100_000, n_svcs=10_000, n_edges=1_048_576, seed=0, **extra).edge_src


def _sort_case(case: str, e: int, n_rows: int, rng) -> np.ndarray:
    ids = rng.integers(0, n_rows, e)
    if case == "hub":
        ids[:] = n_rows // 3
    elif case == "out_of_range":
        ids[::3] = -rng.integers(1, 2**31 - 1, ids[::3].size)
        ids[1::5] = n_rows + rng.integers(0, 2**31 - 1 - n_rows, ids[1::5].size)
    return ids.astype(np.int32)


def _assert_sort_equal(got, ref):
    assert torch.equal(got[0], ref[0]), "sorted ids"
    assert torch.equal(got[1], ref[1]), "permutation"
    assert len(got[2]) == len(ref[2])
    for a, b in zip(got[2], ref[2]):
        assert a.dtype == b.dtype and torch.equal(a, b), "payload"


@pytest.mark.parametrize("kind", ["uniform", "clustered"])
def test_sort_by_ids_on_the_windows_src_matches_plain(dev, kind):
    """The sort kernel on the 1M-edge windows' src ids (N=131,072, two
    9-bit passes), with an int32 and an f32 payload, bit for bit against
    its plain version on the card; one launch counted; two runs alike."""
    src = torch.as_tensor(_window_src(kind), device=dev)
    e = src.shape[0]
    pays = (torch.arange(e, dtype=torch.int32, device=dev).flip(0).contiguous(),
            torch.randn(e, device=dev))
    K.reset_launch_counts()
    got = K.sort_by_ids(src, 131_072, pays)
    torch.cuda.synchronize()
    assert K.sort_by_ids.launches == 1
    _assert_sort_equal(got, K.sort_by_ids_plain(src, 131_072, pays))
    _assert_sort_equal(K.sort_by_ids(src, 131_072, pays), got)


@pytest.mark.parametrize("n_rows", [128, 131_072, 2**20 + 128])
@pytest.mark.parametrize("case", ["uniform", "hub", "out_of_range"])
@pytest.mark.parametrize("size", ["1", "tile-1", "tile", "tile+1", "3tile+17"])
def test_sort_by_ids_matches_plain(dev, size, case, n_rows):
    """Bit for bit against the plain version, one launch: one id, one tile
    less one, one tile (one CTA a pass), one more, three tiles and 17; one
    hub id, ids below 0 and at or past ``n_rows``; one,
    two and three passes (n_rows 128, 131,072, 2^20 + 128). Payloads of
    both kinds ride along."""
    tile = K.sort_tile_keys()
    e = {"1": 1, "tile-1": tile - 1, "tile": tile, "tile+1": tile + 1, "3tile+17": 3 * tile + 17}[size]
    rng = np.random.default_rng(e + n_rows)
    ids = torch.as_tensor(_sort_case(case, e, n_rows, rng), device=dev)
    pays = (torch.randint(-(2**31), 2**31 - 1, (e,), dtype=torch.int32, device=dev),
            torch.randn(e, device=dev))
    K.reset_launch_counts()
    got = K.sort_by_ids(ids, n_rows, pays)
    torch.cuda.synchronize()
    assert K.sort_by_ids.launches == 1
    _assert_sort_equal(got, K.sort_by_ids_plain(ids, n_rows, pays))
    _assert_sort_equal(K.sort_by_ids(ids, n_rows), K.sort_by_ids_plain(ids, n_rows))


def test_sort_by_ids_misaligned_empty_and_rejects(dev):
    """Ids and payloads off 16-byte alignment (the bulk copy's: plain loads
    take the rest); no ids launches nothing; what the kernel does not take
    raises."""
    base = torch.randint(-5, 140, (10_001,), dtype=torch.int32, device=dev)
    wbase = torch.randn(10_001, device=dev)
    ids, w = base[1:], wbase[1:]
    assert ids.data_ptr() % 16 != 0
    _assert_sort_equal(K.sort_by_ids(ids, 128, (w,)), K.sort_by_ids_plain(ids, 128, (w,)))
    K.reset_launch_counts()
    empty = K.sort_by_ids(ids[:0], 128, (w[:0],))
    assert K.sort_by_ids.launches == 0 and empty[0].numel() == empty[1].numel() == empty[2][0].numel() == 0
    with pytest.raises(TypeError):
        K.sort_by_ids(ids.long(), 128)
    with pytest.raises(TypeError):
        K.sort_by_ids(ids, 128, (ids, ids))
    with pytest.raises(TypeError):
        K.sort_by_ids(ids, 128, (w.double(),))
    with pytest.raises(ValueError):
        K.sort_by_ids(ids, 128, (w[:-1],))
    with pytest.raises(ValueError):
        K.sort_by_ids(base[::2], 128)
    with pytest.raises(ValueError):
        K.sort_by_ids(ids, -1)
    with pytest.raises(ValueError):
        K.sort_by_ids(ids, 128, (wbase.cpu()[1:],))


def _argsort_unsorted_segment_sum(g, ids, n):
    """K3's backward as it was before the sort kernel: ``torch.argsort``,
    the gather of the sorted ids, K4."""
    perm = torch.argsort(ids, stable=True).to(torch.int32)
    dv = K._run_k4(K._kernel_dtype(g).contiguous(), perm, ids[perm], K._rows_of_blocks(n))
    return dv[:n].to(g.dtype)


def _argsort_dx(g32, src, dst, w32, n_x):
    """K4's ``dx`` as it was before the sort kernel."""
    perm = torch.argsort(src, stable=True).to(torch.int32)
    wp = None if w32 is None else w32[perm].contiguous()
    return K._run_k4(g32, dst[perm], src[perm], K._rows_of_blocks(n_x), wp)[:n_x]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,e,case", [
    (512, 5000, "uniform"), (300, 5000, "hub"), (512, 300, "uniform"), (300, 20_000, "out_of_range"),
    (131_072, 40_000, "uniform"), (128, 128, "uniform"), (131_072, 4096, "hub"),
])
def test_k3_backward_on_the_sort_is_the_argsort_composition(dev, dtype, n, e, case):
    """``unsorted_segment_sum`` on the sort kernel against the composition
    it replaced (``torch.argsort`` + K4), bit for bit, also for ids below 0
    and past the rows (they add nothing, and K4 cuts the in-range edges
    into the same tiles), at the ``train`` CLI's n128xe128 and at one sort
    tile too; one sort launch and one K4 launch a call; two calls alike."""
    rng = np.random.default_rng(n + e)
    ids = torch.as_tensor(_sort_case(case, e, n, rng), device=dev)
    g = torch.randn((e, 48), device=dev).to(dtype)
    K.reset_launch_counts()
    first = K.unsorted_segment_sum(g, ids, n)
    torch.cuda.synchronize()
    assert K.sort_by_ids.launches == 1
    assert K.launch_counts()["pallas_gather_scatter_sum"] == 1
    assert torch.equal(first, _argsort_unsorted_segment_sum(g, ids, n))
    assert torch.equal(K.unsorted_segment_sum(g, ids, n), first)
    assert K.sort_by_ids.launches == 2


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("e,case", [(300, "uniform"), (11_000, "uniform"), (11_000, "out_of_range")])
def test_k4_dx_on_the_sort_is_the_argsort_composition(dev, weighted, e, case):
    """K4's ``dx`` with dst and the weights carried through the sort
    kernel, against the composition it replaced (``torch.argsort``, three
    gathers, K4), bit for bit; src below 0 and past x's rows add nothing;
    two runs alike."""
    n_pad, n_x, f = 512, 300, 48
    rng = np.random.default_rng(e)
    d = torch.as_tensor(_sorted_dst(n_pad, e, e), device=dev)
    src = torch.as_tensor(_sort_case(case, e, n_x, rng), device=dev)
    g32 = torch.randn((n_pad, f), device=dev)
    w32 = torch.rand(e, device=dev) + 0.5 if weighted else None
    K.reset_launch_counts()
    got = K.gather_scatter_dx(g32, src, d, w32, n_x)
    torch.cuda.synchronize()
    assert K.sort_by_ids.launches == 1
    assert torch.equal(got, _argsort_dx(g32, src, d, w32, n_x))
    assert torch.equal(got, K.gather_scatter_dx(g32, src, d, w32, n_x))


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
            assert K.sort_by_ids.launches == 3  # a sort of edge_src for each K3 backward
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
    ("coo", 2, 6.0, 3),      # three groups of 2: the first staging set comes around again
])
def test_service_group_path_matches_serial_on_card(dev, layout, batch_windows, duration_s, dispatches):
    """The group path's block-diagonal stack through K1 and K2 on the card
    against the serial path on the same windows, scores within the f32
    oracle's 1e-4. Groups staged back to back go through the two pinned
    sets of their signature in turn, and serial windows through those of
    theirs; a set overwritten while its copy to the card was in flight
    would give its window or group another window's scores. Each dispatch
    launches K1 twice (GraphSAGE's two layers) and K2 once (the edge
    head), a group as one window."""
    n_windows = int(duration_s)
    gsvc, group, glaunch, graised = _card_serve(layout, batch_windows, duration_s)
    ssvc, serial, slaunch, sraised = _card_serve(layout, 1, duration_s)
    assert graised == [] and sraised == []
    assert gsvc.scored_batches == ssvc.scored_batches == n_windows
    assert gsvc.metrics.counter("windows.closed").value == n_windows
    assert gsvc.score_dispatches == dispatches and ssvc.score_dispatches == n_windows
    assert gsvc._staging_sets.pin and ssvc._staging_sets.pin
    if batch_windows == 2:
        assert (gsvc._staging_sets.fills, gsvc._staging_sets.reuses) == (3, 1)
    # one fill a serial window; a set is made once, then refilled
    made = sum(bufs is not None for bufs in ssvc._staging_sets._sets)
    assert (ssvc._staging_sets.fills, ssvc._staging_sets.reuses) == (n_windows, n_windows - made)
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


@pytest.mark.parametrize("workers,batch_windows", [(1, 1), (2, 1), (2, 4)])
def test_process_ingest_service_on_card_matches_plain(dev, workers, batch_windows):
    """A small replay served on the card over the process backend (spawned
    shard workers over shared-memory rings, each joining in C++), serially
    and as a backlog group: every closed window scored, K1 twice and K2
    once a dispatch, every row in a scored window or the ledger; each
    window scored again on the CPU through the plain versions, f32, within
    the f32 oracle's 1e-4."""
    import threading

    from alaz_tpu_torch.config import ModelConfig, RuntimeConfig, SimulationConfig
    from alaz_tpu_torch.events.intern import Interner
    from alaz_tpu_torch.models.registry import init_params
    from alaz_tpu_torch.replay.simulator import Simulator
    from alaz_tpu_torch.runtime.scorer import WindowScorer
    from alaz_tpu_torch.runtime.service import Service

    cfg = RuntimeConfig(model=ModelConfig(dtype="float32"), engine_backend="native", ingest_backend="process",
                        ingest_workers=workers, score_batch_windows=batch_windows)
    interner, sunk, windows, raised = Interner(), [], [], []
    svc = Service(config=cfg, interner=interner, score_sink=sunk.append,
                  model_state=init_params(cfg.model, key=0, device="cuda"),
                  score_threshold=0.0, device="cuda")
    svc.score_observer = lambda batch, tenant, lat: windows.append(batch)
    hook, threading.excepthook = threading.excepthook, raised.append
    pushed = 0
    try:
        assert type(svc.sharded).__name__ == "ProcessShardedIngest" and svc.sharded.wait_ready(60.0)
        sim = Simulator(SimulationConfig(test_duration_s=3.0, **_CARD_SIM), interner=interner)
        for m in sim.setup():
            svc.aggregator.process_k8s(m)
        svc.aggregator.process_tcp(sim.tcp_events())
        for b in sim.iter_l7_batches():
            svc.aggregator.process_l7(b)
            pushed += b.shape[0]
        svc.flush_windows()
        K.reset_launch_counts()
        svc.start()
        svc.drain(timeout_s=120)
    finally:
        svc.stop()
        threading.excepthook = hook
    assert raised == [] and svc.sharded.worker_restarts == 0
    assert svc.scored_batches == svc.metrics.counter("windows.closed").value == len(sunk) == 3
    if batch_windows > 1:
        assert svc.score_dispatches == 1
    assert K.launch_counts()["scatter_sum_sorted"] == 2 * svc.score_dispatches
    assert K.launch_counts()["segment_expand_sorted"] == svc.score_dispatches
    assert svc.ledger.conservation_gap(pushed, sum(b.aggregated_rows() for b in windows)) == 0
    plain = WindowScorer(cfg.model, init_params(cfg.model, key=0, device="cpu"), device="cpu")
    for b, sb in zip(windows, sunk):
        np.testing.assert_allclose(sb.score, plain.score(b), rtol=1e-4, atol=1e-4)


def test_live_service_on_card_matches_plain(dev, tmp_path):
    """The live plane on the card: pods and services from a fake API
    server through the K8s watch, an agent's frames over the unix socket
    through the native engine, request rows and scores exported to a
    local HTTP sink; every closed window scored (K1 twice and K2 once a
    dispatch), every L7 row in a window or the ledger, one anomaly row an
    edge, and each window scored again on the CPU through the plain
    versions, f32, within the f32 oracle's 1e-4."""
    import dataclasses
    import threading
    import time

    import chip_smoke
    from alaz_tpu_torch.config import BackendConfig, ModelConfig, QueueConfig, RuntimeConfig, SimulationConfig
    from alaz_tpu_torch.datastore.backend import BatchingBackend, http_transport
    from alaz_tpu_torch.events.intern import Interner
    from alaz_tpu_torch.models.registry import init_params
    from alaz_tpu_torch.replay.simulator import Simulator
    from alaz_tpu_torch.runtime.scorer import WindowScorer
    from alaz_tpu_torch.runtime.service import Service
    from alaz_tpu_torch.sources.ingest_server import IngestServer
    from alaz_tpu_torch.sources.k8s_watch import K8sWatchSource

    sim = Simulator(SimulationConfig(test_duration_s=3.0, **_CARD_SIM), interner=Interner())
    msgs = sim.setup()
    frames, tcp_rows, l7_rows = chip_smoke.agent_frames(sim, rows=2048)
    api, sink = chip_smoke.FakeApiServer(chip_smoke.api_items(msgs)), chip_smoke.BackendSink()
    # the K8s queue holds the whole LIST (KUBE_EVENTS_BUFFER_SIZE; its default, 1,000, does not)
    cfg = RuntimeConfig(model=ModelConfig(dtype="float32"), engine_backend="native",
                        queues=dataclasses.replace(QueueConfig(), kube_events=1 << 16),
                        backend=dataclasses.replace(BackendConfig(), host=sink.url))
    interner, sunk, windows, raised = Interner(), [], [], []
    backend = BatchingBackend(http_transport(sink.url), interner, cfg.backend)

    def score_sink(sb):
        sunk.append(sb)
        backend.persist_scores(sb)

    svc = Service(config=cfg, interner=interner, export_backend=backend, score_sink=score_sink,
                  model_state=init_params(cfg.model, key=0, device="cuda"), score_threshold=0.0, device="cuda")
    svc.score_observer = lambda batch, tenant, lat: windows.append(batch)
    src = K8sWatchSource(api_server=api.url)
    srv = IngestServer(svc, path=tmp_path / "live.sock")
    hook, threading.excepthook = threading.excepthook, raised.append
    try:
        svc.start()
        src.start(svc)
        want = len(msgs) + sum(1 for m in msgs if m.resource_type.value == "Pod" and m.object.image)
        deadline = time.monotonic() + 60
        while svc.k8s_queue.put_total < want and time.monotonic() < deadline:
            time.sleep(0.01)
        svc.drain(timeout_s=60)
        srv.start()
        K.reset_launch_counts()
        chip_smoke.send_frames(str(tmp_path / "live.sock"), frames[:1])  # the connections, then the requests
        while srv.records < tcp_rows and time.monotonic() < deadline:
            time.sleep(0.01)
        svc.drain(timeout_s=60)
        chip_smoke.send_frames(str(tmp_path / "live.sock"), frames[1:])
        while srv.records < tcp_rows + l7_rows and time.monotonic() < deadline:
            time.sleep(0.01)
        svc.drain(timeout_s=120)
        svc.flush_windows()
        svc.drain(timeout_s=120)
    finally:
        for stop in (srv.stop, src.stop, svc.stop, backend.stop, api.close):
            stop()
        threading.excepthook = hook
    try:
        posted = sink.snapshot()
    finally:
        sink.close()
    assert raised == [] and src.live and srv.records == tcp_rows + l7_rows and svc.k8s_queue.put_total == want
    assert svc.scored_batches == svc.metrics.counter("windows.closed").value == len(sunk) >= 3
    assert K.launch_counts()["scatter_sum_sorted"] == 2 * svc.score_dispatches
    assert K.launch_counts()["segment_expand_sorted"] == svc.score_dispatches
    assert svc.ledger.conservation_gap(l7_rows, sum(b.aggregated_rows() for b in windows)) == 0
    assert posted["anomaly_windows"] == {b.window_start_ms: b.n_edges for b in windows}
    assert posted["rows"]["/requests/"] == backend.stats()["requests"]["sent"] > 0
    plain = WindowScorer(cfg.model, init_params(cfg.model, key=0, device="cpu"), device="cpu")
    for b, sb in zip(windows, sunk):
        np.testing.assert_allclose(sb.score, plain.score(b), rtol=1e-4, atol=1e-4)


def _smi(fields: str) -> list:
    import subprocess

    out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    return [float(v) for v in out.stdout.strip().splitlines()[0].split(",")]


def test_nvml_collector_matches_nvidia_smi(dev):
    """``GpuEnvCollector`` on the card: every default leg registered under
    the JAX package's gauge names; device memory equal to nvidia-smi's
    MiB, temperature within 3 °C, SM clock and power within the two
    nvidia-smi readings taken around the gauges' ±10%."""
    from alaz_tpu_torch.runtime.gpu_env import GpuEnvCollector
    from alaz_tpu_torch.runtime.metrics import Metrics

    fields = "memory.total,temperature.gpu,clocks.sm,power.draw"
    before = _smi(fields)
    m = Metrics()
    assert GpuEnvCollector().register(m)
    snap = m.snapshot()
    after = _smi(fields)
    for leg in ("tensorcore_duty_cycle_pct", "runtime_hbm_used_bytes", "runtime_hbm_total_bytes",
                "power_draw_w", "sm_clock_mhz", "temperature_c"):
        assert f"device0.{leg}" in snap, leg
    assert int(snap["device0.runtime_hbm_total_bytes"]) // 2**20 == int(before[0])
    assert abs(snap["device0.temperature_c"] - before[1]) <= 3
    for i, leg in ((2, "sm_clock_mhz"), (3, "power_draw_w")):
        lo, hi = min(before[i], after[i]) * 0.9, max(before[i], after[i]) * 1.1
        assert lo <= snap[f"device0.{leg}"] <= hi, (leg, snap[f"device0.{leg}"], before[i], after[i])


def test_service_start_counts_the_segment_build_and_holds_the_budgets(dev):
    """A scoring Service on the card: ``start()`` is one ``segment`` build
    event (``compile.events``, ``compile.segment``, a recorder ``compile``
    event with ``duration_ms``); the windows it then scores build nothing
    and each dispatch launches K1 twice and K2 once."""
    from alaz_tpu_torch.config import ModelConfig, RuntimeConfig, SimulationConfig
    from alaz_tpu_torch.events.intern import Interner
    from alaz_tpu_torch.models.registry import init_params
    from alaz_tpu_torch.replay.simulator import Simulator
    from alaz_tpu_torch.runtime.service import Service
    from alaz_tpu_torch.sanitize.retrace import STEADY_STATE_BUDGETS, retrace_budget

    cfg = RuntimeConfig(model=ModelConfig(dtype="float32"))
    interner = Interner()
    svc = Service(config=cfg, interner=interner, model_state=init_params(cfg.model, key=0, device="cuda"),
                  device="cuda")
    sim = Simulator(SimulationConfig(test_duration_s=3.0, **_CARD_SIM), interner=interner)
    launches = {"score_apply": {"scatter_sum_sorted": 2, "segment_expand_sorted": 1}}
    svc.start()
    try:
        snap = svc.metrics.snapshot()
        assert snap["compile.events"] >= 1 and snap["compile.segment"] == 1
        (ev,) = [e for e in svc.recorder.events() if e["kind"] == "compile"]
        assert ev["fn"] == "segment" and ev["duration_ms"] >= 0.0
        with retrace_budget(STEADY_STATE_BUDGETS, launches=launches) as w:
            for m in sim.setup():
                svc.aggregator.process_k8s(m)
            svc.aggregator.process_tcp(sim.tcp_events())
            for b in sim.iter_l7_batches():
                svc.aggregator.process_l7(b)
            svc.flush_windows()
            svc.drain(timeout_s=120)
        assert w.dispatch_total == svc.score_dispatches == svc.scored_batches == 3
        after = svc.metrics.snapshot()
        assert {k: v for k, v in after.items() if k.startswith("compile.")} == {
            k: v for k, v in snap.items() if k.startswith("compile.")}
    finally:
        svc.stop()


def test_segment_softmax_on_card_routes_through_k1_and_k2(dev):
    """``segment_softmax(use_pallas=True)`` on CUDA tensors: its two
    broadcasts launch K2, its denominator K1; f32 results within 1e-5 of
    the plain versions on the CPU, finite gradients on the all-masked pad
    rows."""
    from alaz_tpu_torch.ops.segment import segment_softmax

    rng = np.random.default_rng(5)
    n, e, pad = 1024, 20_000, 500
    dst = np.concatenate([np.sort(rng.integers(0, 700, e - pad)), np.full(pad, n - 1)]).astype(np.int32)
    mask = np.arange(e) < e - pad
    logits = rng.normal(size=(e, 4)).astype(np.float32)
    ref = segment_softmax(torch.from_numpy(logits), torch.from_numpy(dst), n, torch.from_numpy(mask), True)
    x = torch.from_numpy(logits).cuda().requires_grad_(True)
    K.reset_launch_counts()
    got = segment_softmax(x, torch.from_numpy(dst).cuda(), n, torch.from_numpy(mask).cuda(), True)
    counts = K.launch_counts()
    assert (counts["scatter_sum_sorted"], counts["segment_expand_sorted"]) == (1, 2)
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-5, atol=1e-5)
    got.sum().backward()
    assert torch.isfinite(x.grad).all() and float(x.grad[~torch.from_numpy(mask).cuda()].abs().max()) == 0.0


def test_prefetcher_on_card_feeds_the_same_scores(dev):
    """``DevicePrefetcher`` on the card: the windows in order, scores
    bit-equal to the same windows through ``WindowScorer``."""
    from alaz_tpu_torch.config import ModelConfig
    from alaz_tpu_torch.models.registry import init_params
    from alaz_tpu_torch.replay.synth import example_batch
    from alaz_tpu_torch.runtime.pipeline import DevicePrefetcher
    from alaz_tpu_torch.runtime.scorer import WindowScorer
    from alaz_tpu_torch.train.trainstep import make_score_fn

    cfg = ModelConfig()
    params = init_params(cfg, key=0, device="cuda")
    wins = [example_batch(n_pods=2000, n_svcs=200, n_edges=20_000, seed=s) for s in range(4)]
    ref = WindowScorer(cfg, params, device="cuda").score_windows(wins)
    fn = make_score_fn(cfg, "cuda")
    pre = DevicePrefetcher(wins, device="cuda")
    got = []
    for b, tensors in pre:
        assert all(t.is_cuda for t in tensors.values())
        got.append(torch.sigmoid(fn(params, tensors)["edge_logits"][: b.n_edges]).cpu().numpy())
    assert pre.copies == 4
    for g, r in zip(got, ref):
        assert np.array_equal(g, r)
    # a caller that stops early stops the staging thread
    import threading

    it = iter(DevicePrefetcher(wins, device="cuda"))
    next(it)
    it.close()
    assert not any(t.name == "alaz-prefetch" for t in threading.enumerate())


def test_no_implicit_transfers_on_card(dev):
    """Under the guard a synchronizing read raises; a GraphSAGE dispatch on
    staged tensors with its readback declared explicit passes."""
    from alaz_tpu_torch.config import ModelConfig
    from alaz_tpu_torch.models.registry import init_params
    from alaz_tpu_torch.replay.synth import example_batch
    from alaz_tpu_torch.sanitize.retrace import explicit_transfer, no_implicit_transfers
    from alaz_tpu_torch.train.trainstep import make_score_fn

    cfg = ModelConfig()
    params = init_params(cfg, key=0, device="cuda")
    b = example_batch(n_pods=2000, n_svcs=200, n_edges=20_000, seed=0)
    graph = {k: torch.from_numpy(v).pin_memory().cuda(non_blocking=True) for k, v in b.device_arrays().items()}
    fn = make_score_fn(cfg, "cuda")
    fn(params, graph)  # warm
    torch.cuda.synchronize()
    with no_implicit_transfers():
        with pytest.raises(RuntimeError):
            torch.ones(4, device="cuda").sum().item()
        out = fn(params, graph)
        with explicit_transfer():
            logits = out["edge_logits"].cpu()
    assert torch.cuda.get_sync_debug_mode() == 0
    assert torch.isfinite(logits).all()


# -- the train step's feed through page-locked sets ---------------------------

_FEED_CFG = dict(model="gat", src_gather="banded")


def _train_feeds(n: int = 3) -> list:
    """``n`` labelled community windows of 300,000 edges as numpy, the
    arrays and the label the step is handed."""
    from alaz_tpu_torch.replay.synth import example_batch

    out = []
    for s in range(n):
        b = example_batch(n_pods=30_000, n_svcs=3_000, n_edges=300_000, seed=s, structure="community",
                          layout="clustered")
        label = np.zeros(b.e_pad, np.float32)
        label[: b.n_edges] = b.edge_feats[: b.n_edges, 0] > 1.5
        out.append((b.device_arrays(), label))
    return out


def _steps(feeds, feed_as=None, after=None) -> dict:
    """Three AdamW steps of the GAT train step from the same params:
    ``feed_as(i, graph, label)`` gives what step ``i`` is handed (default:
    the numpy arrays), ``after(i)`` runs as soon as the step returns.
    Each step's loss and gradients, the final params, the feed's counts."""
    from alaz_tpu_torch.config import ModelConfig
    from alaz_tpu_torch.models.registry import init_params
    from alaz_tpu_torch.train.trainstep import _adamw, make_train_step

    cfg = ModelConfig(**_FEED_CFG)
    params = init_params(cfg, key=0, device="cuda")
    opt = _adamw(params, 3e-3)
    step = make_train_step(cfg, 10.0, "cuda")
    losses, grads = [], []
    for i, (graph, label) in enumerate(feeds):
        graph, label = feed_as(i, graph, label) if feed_as else (graph, label)
        losses.append(step(params, opt, graph, label))
        if after is not None:
            after(i)
        grads.append({k: p.grad.clone() for k, p in params.named_parameters()})
    torch.cuda.synchronize()
    return {"losses": losses, "grads": grads, "params": {k: p.detach().clone() for k, p in params.named_parameters()},
            "counts": dict(step.feed_counts)}


def _on_card(i, graph, label):
    return {k: torch.as_tensor(v, device="cuda") for k, v in graph.items()}, torch.as_tensor(label, device="cuda")


def _assert_same_steps(got: dict, ref: dict) -> None:
    assert all(torch.equal(a, b) for a, b in zip(got["losses"], ref["losses"]))
    for g, r in zip(got["grads"], ref["grads"]):
        assert all(torch.equal(g[k], r[k]) for k in r)
    assert all(torch.equal(got["params"][k], ref["params"][k]) for k in ref["params"])


def test_train_step_on_numpy_runs_under_no_implicit_transfers(dev):
    """A GAT train step handed numpy runs under the guard: its host arrays
    reach the card through the page-locked sets with no synchronizing
    copy. The pageable copy the feed made before raises there."""
    from alaz_tpu_torch.config import ModelConfig
    from alaz_tpu_torch.models.registry import init_params
    from alaz_tpu_torch.sanitize.retrace import no_implicit_transfers
    from alaz_tpu_torch.train.trainstep import _adamw, make_train_step

    feeds = _train_feeds(3)
    cfg = ModelConfig(**_FEED_CFG)
    params = init_params(cfg, key=0, device="cuda")
    opt = _adamw(params, 3e-3)
    step = make_train_step(cfg, 10.0, "cuda")
    for graph, label in feeds[:2]:  # builds the kernels and both sets
        step(params, opt, graph, label)
    torch.cuda.synchronize()
    with no_implicit_transfers():
        losses = [step(params, opt, graph, label) for graph, label in feeds]
        with pytest.raises(RuntimeError):
            torch.as_tensor(feeds[0][1], device="cuda")
    torch.cuda.synchronize()
    assert step.feed_counts == {"staged": 5 * 10, "passed": 0}
    assert all(bool(torch.isfinite(x)) for x in losses)
    assert step.tracer.hists["fill"].snapshot()["count"] == 5


def test_train_step_fed_numpy_equals_fed_device_tensors(dev):
    """Three AdamW steps fed numpy (staged through the page-locked sets)
    equal, bit for bit, three steps fed the same windows as device
    tensors (passed through): losses, gradients and params."""
    feeds = _train_feeds(3)
    got = _steps(feeds)
    ref = _steps(feeds, feed_as=_on_card)
    assert got["counts"] == {"staged": 30, "passed": 0} and ref["counts"] == {"staged": 0, "passed": 30}
    _assert_same_steps(got, ref)


def test_train_step_result_holds_when_the_caller_rewrites_its_arrays(dev):
    """As the benchmark's load does: one set of arrays, refilled in place
    with each step's window and overwritten with noise the moment the step
    returns, while its copies may still be in flight. Every step trains
    on the window it was handed."""
    feeds = _train_feeds(3)
    ref = _steps(feeds, feed_as=_on_card)
    arrays = {k: v.copy() for k, v in feeds[0][0].items()}
    label = feeds[0][1].copy()
    rng = np.random.default_rng(0)

    def refill(i, graph, lbl):
        for k, v in graph.items():
            np.copyto(arrays[k], v)
        np.copyto(label, lbl)
        return arrays, label

    def scribble(i):
        for v in list(arrays.values()) + [label]:
            v[...] = rng.integers(0, 2, v.shape).astype(v.dtype)

    _assert_same_steps(_steps(feeds, feed_as=refill, after=scribble), ref)


def _parallel_on_card() -> dict:
    """One NCCL rank (world size 1, every mesh axis of size 1): the
    dp-sharded GAT score step with the banded src gather against
    ``WindowScorer``, and the node-sharded GraphSAGE forward against the
    single-device apply, each with the kernels' launches read around it."""
    from alaz_tpu_torch.config import MeshConfig, ModelConfig
    from alaz_tpu_torch.convert import graph_to_torch
    from alaz_tpu_torch.models import graphsage
    from alaz_tpu_torch.models.registry import init_params
    from alaz_tpu_torch.parallel.mesh import make_mesh
    from alaz_tpu_torch.parallel.sharded_model import make_node_sharded_graphsage, rank_shard, shard_graph_batch
    from alaz_tpu_torch.parallel.sharding import make_sharded_score_step, stack_graphs
    from alaz_tpu_torch.replay.synth import example_batch
    from alaz_tpu_torch.runtime.scorer import WindowScorer

    mesh = make_mesh(MeshConfig())
    cfg = ModelConfig(model="gat", src_gather="banded")
    params = init_params(cfg, key=0)
    batches = [example_batch(n_pods=3000, n_svcs=300, n_edges=20_000, seed=s, structure="community",
                             layout="clustered") for s in range(2)]
    stacked, _ = stack_graphs(batches)
    score = make_sharded_score_step(cfg, mesh, params)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    logits = score(params, stacked)
    torch.cuda.synchronize()
    score_launches = K.launch_counts()
    scorer = WindowScorer(cfg, params)
    equal = [bool(torch.equal(torch.sigmoid(row[: b.n_edges]).cpu(), torch.as_tensor(scorer.score(b))))
             for b, row in zip(batches, logits)]

    sage_cfg = ModelConfig()
    sage = init_params(sage_cfg, key=0)
    b = batches[0]
    sharded, perm = shard_graph_batch(b, 1)
    run = make_node_sharded_graphsage(sage_cfg, mesh)
    with torch.inference_mode():
        K.reset_launch_counts()
        el, nl = run(sage, rank_shard(sharded, 0))
        torch.cuda.synchronize()
        sage_launches = K.launch_counts()
        ref = graphsage.apply(sage, graph_to_torch(b.device_arrays()), sage_cfg)
    valid = perm[0] >= 0
    got = el[0][torch.as_tensor(valid, device="cuda")].float().cpu()
    want = ref["edge_logits"][torch.as_tensor(perm[0][valid], device="cuda")].float().cpu()
    return {
        "score_launches": score_launches, "equal": equal,
        "sage_launches": sage_launches,
        "edge_err": float((got - want).abs().max()), "edge_scale": float(want.abs().max()),
        "node_err": float((nl[0].cpu() - ref["node_logits"].cpu()).abs().max()),
        "node_scale": float(ref["node_logits"].abs().max()),
    }


def test_parallel_steps_on_card_launch_the_kernels(dev):
    """``alaz_tpu_torch.parallel`` on one NCCL rank: the dp-sharded GAT
    score step launches K1 2 / K2 3 / K3 3 a window and scores what
    ``WindowScorer`` scores, bit for bit; the node-sharded GraphSAGE
    forward at one shard launches K1 (1 hop + 1) a layer and holds to the
    single-device apply within 2^-5 of the largest logit (it sums its
    remote and edge-feature messages apart in f32)."""
    from alaz_tpu_torch.parallel.multislice import spawn

    out = spawn(_parallel_on_card, 1, timeout_s=300.0)[0]
    assert out["score_launches"] == {"scatter_sum_sorted": 4, "segment_expand_sorted": 6,
                                     "gather_rows_banded": 6, "pallas_gather_scatter_sum": 0}
    assert out["equal"] == [True, True]
    assert out["sage_launches"] == {"scatter_sum_sorted": 4, "segment_expand_sorted": 0,
                                    "gather_rows_banded": 0, "pallas_gather_scatter_sum": 0}
    assert out["edge_err"] <= 2.0**-5 * out["edge_scale"]
    assert out["node_err"] <= 2.0**-5 * out["node_scale"]


# -- the GRU memory update (csrc/gru.cu) -----------------------------------

# The kernel and its plain version differ only in the order in which each
# product's f32 sum is taken. That can land a gate's bf16 rounding one ulp
# apart (at most 2^-8 below 1); m' = (1 - z) n + z m with |n|, |m| <= 1
# then moves by at most 2^-8 * |n - m| <= 2^-7 through z and two ulps of n
# (its own rounding and r's): 2^-6 in all.
GRU_TOL = 2.0**-6


def _gru_layers(h: int, dev, seed: int) -> list:
    from alaz_tpu_torch.models.common import Dense

    gen = torch.Generator().manual_seed(seed)
    layers = []
    for _ in range(3):
        d = Dense(2 * h, h)
        d.reset_parameters(gen)
        with torch.no_grad():
            d.b.copy_(torch.randn(h, generator=gen) * 0.5)
        layers.append(d.to(dev))
    return layers


def _gru_inputs(h: int, n_pad: int, n_mem: int, dev, seed: int) -> tuple:
    gen = torch.Generator(device=dev).manual_seed(seed)
    memory = torch.rand((n_mem, h), generator=gen, device=dev) * 2 - 1  # a memory stays in [-1, 1]
    node_h = torch.randn((n_pad, h), generator=gen, device=dev).bfloat16()
    mask = torch.rand(n_pad, generator=gen, device=dev) > 0.16
    return memory, node_h, mask


@pytest.mark.parametrize("h,n_pad,n_mem", [
    (128, 131_072, 131_072),  # the TGN cell's bucket
    (128, 131_059, 131_200),  # a ragged last tile, a memory longer than the bucket
    (64, 1_003, 1_500),
    (32, 37, 37),
    (32, 0, 20),  # no bucket: the tail alone
])
def test_gru_update_matches_plain(dev, h, n_pad, n_mem):
    """One launch a call; masked rows and the rows past the bucket as they
    were, bit for bit; live rows within ``GRU_TOL`` of the plain version;
    two calls alike."""
    from alaz_tpu_torch.ops import gru_kernels as G

    layers = _gru_layers(h, dev, h + n_pad)
    memory, node_h, mask = _gru_inputs(h, n_pad, n_mem, dev, n_pad + 1)
    with torch.inference_mode():
        launches = G.gru_update.launches
        got = G.gru_update(*layers, memory, node_h, mask)
        torch.cuda.synchronize()
        assert G.gru_update.launches == launches + 1
        again = G.gru_update(*layers, memory, node_h, mask)
        ref = G.gru_update_plain(*layers, memory, node_h, mask, torch.bfloat16)
    assert got.shape == (n_mem, h) and got.dtype == torch.float32
    assert torch.equal(got, again)
    assert torch.equal(got[n_pad:], memory[n_pad:])
    assert torch.equal(got[:n_pad][~mask], memory[:n_pad][~mask])
    live = (got[:n_pad][mask] - ref[:n_pad][mask]).abs()
    assert live.numel() == 0 or float(live.max()) <= GRU_TOL


def test_tgn_update_takes_the_kernel_only_outside_autograd(dev):
    """``tgn.update`` launches the GRU kernel under ``inference_mode`` and
    ``no_grad``, and runs the plain version, launching nothing, where
    autograd records (the kernel has no backward) or the compute dtype is
    f32; the two agree within ``GRU_TOL``."""
    from alaz_tpu_torch.config import ModelConfig
    from alaz_tpu_torch.models import tgn
    from alaz_tpu_torch.ops import gru_kernels as G

    cfg = ModelConfig(model="tgn")
    model = tgn.init(0, cfg, device=dev)
    memory, node_h, mask = _gru_inputs(cfg.hidden_dim, 4_096, 4_096, dev, 7)
    graph = {"node_mask": mask}
    n0 = G.gru_update.launches
    under_grad = tgn.update(model, graph, memory, node_h, cfg)
    assert under_grad.requires_grad and G.gru_update.launches == n0
    with torch.inference_mode():
        kernel = tgn.update(model, graph, memory, node_h, cfg)
    with torch.no_grad():
        tgn.update(model, graph, memory, node_h, cfg)
        f32_cfg = ModelConfig(model="tgn", dtype="float32")
        tgn.update(model, graph, memory, node_h.float(), f32_cfg)
    assert G.gru_update.launches == n0 + 2
    assert float((kernel - under_grad.detach()).abs().max()) <= GRU_TOL


def test_gru_update_refuses_what_the_kernel_does_not_take(dev):
    from alaz_tpu_torch.ops import gru_kernels as G

    layers = _gru_layers(32, dev, 0)
    memory, node_h, mask = _gru_inputs(32, 64, 64, dev, 0)
    with torch.inference_mode():
        with pytest.raises(TypeError):
            G.gru_update(*layers, memory, node_h.float(), mask)
        with pytest.raises(TypeError):
            G.gru_update(*layers, memory.double(), node_h, mask)
        with pytest.raises(ValueError):
            G.gru_update(*layers, memory[:32], node_h, mask)  # memory shorter than the bucket
        with pytest.raises(ValueError):
            G.gru_update(*layers, memory.t().contiguous().t(), node_h, mask)  # not contiguous
        wide = _gru_layers(48, dev, 0)
        m48, h48, k48 = _gru_inputs(48, 64, 64, dev, 0)
        with pytest.raises(ValueError):
            G.gru_update(*wide, m48, h48, k48)
        m64, h64, k64 = _gru_inputs(64, 64, 64, dev, 0)
        with pytest.raises(ValueError):
            G.gru_update(*layers, m64, h64, k64)  # layers of another width


def test_gru_activations_equal_torch_on_every_bf16_input(dev):
    """The kernel's sigmoid (``rcp.approx(1 + __expf(-x))``) and tanh
    (``tanh.approx``), rounded to bf16, give ``torch.sigmoid``'s and
    ``torch.tanh``'s bits on every bf16 input but NaN: the gates' inputs
    are bf16 values, so the kernel's activations are the plain version's."""
    from alaz_tpu_torch.ops import gru_kernels as G

    x = torch.arange(-(2**15), 2**15, dtype=torch.int32, device=dev).to(torch.int16).view(torch.bfloat16)
    got = G.gru_activations(x)
    keep = ~torch.isnan(x)
    with torch.inference_mode():
        want = torch.stack([torch.sigmoid(x), torch.tanh(x)])
    for k in range(2):
        assert torch.equal(got[k][keep].view(torch.int16), want[k][keep].view(torch.int16))
    assert bool(torch.isnan(got[:, ~keep]).all())
