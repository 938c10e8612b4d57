"""Ring halo exchange: message passing over node-sharded graphs (SP/CP).

For graphs too big for one card (BASELINE.json config 5: 100k-pod
fleets), the node axis is sharded across the ``sp`` mesh axis. Local
edges (grouped by destination shard) may have *remote* sources — the
halo. Instead of gathering all remote rows (memory blow-up), node-feature
shards rotate around the ring and each rank folds in the messages whose
source lives in the block it currently holds — the graph analog of ring
attention: D steps, one neighbor send/receive between steps, peak memory
one block (SURVEY §2.3 P4; blockwise aggregation caps memory like
blockwise attention).

The ring functions run per rank: each rank calls them on its own shard,
with ``axis`` the process group of the ``sp`` axis
(``mesh.axis_group``). The block is shifted D-1 times: the shift after
the last hop would hand on a block no hop reads.

Layout contract (prepared by ``shard_graph``):
- nodes are partitioned contiguously: shard d owns slots [d·n_loc, (d+1)·n_loc)
- each shard holds the edges whose **dst** is local, dst-sorted, padded to
  a common per-shard edge budget
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from alaz_tpu_torch.graph.snapshot import EDGE_BLOCK_ROWS
from alaz_tpu_torch.ops.segment import ATTENTION_LOGIT_CLAMP, segment_sum_sorted_dispatch
from alaz_tpu_torch.parallel.collectives import axis_index, axis_size, ring_shift
from alaz_tpu_torch.parallel.mesh import axis_group


def _hop_segment_sum(data, edge_dst_local, n_loc, block_starts, use_pallas):
    """The per-hop local reduce every ring aggregator shares: the sorted
    sum, through the sorted-scatter wrapper (K1 on a CUDA tensor) when
    ``use_pallas`` asks and the shard's node block is whole 128-row dst
    blocks, else the plain segment sum; ``block_starts`` (shard-local
    blocked extents, sharded_model.shard_block_starts) routes it through
    the blocked layout. Valid because each shard's edges are dst-sorted
    with the pads (dst n_loc-1) last, and bit-exact against the plain sum
    in f32 up to the order of the sum, since every hop's messages are
    already sel-masked to zero on non-live edges."""
    if n_loc % EDGE_BLOCK_ROWS:
        use_pallas = False
    return segment_sum_sorted_dispatch(data, edge_dst_local, n_loc, use_pallas, block_starts=block_starts)


def _ring_owner(edge_src, n_loc, axis):
    d = axis_size(axis)
    return d, axis_index(axis), edge_src // n_loc, edge_src % n_loc


def ring_gather_scatter(
    h_local: torch.Tensor,  # [n_loc, F] this shard's node states
    edge_src: torch.Tensor,  # [e_loc] GLOBAL src ids of local-dst edges
    edge_dst_local: torch.Tensor,  # [e_loc] LOCAL dst ids (dst - my_offset)
    edge_mask: torch.Tensor,  # [e_loc]
    axis=None,
    block_starts: torch.Tensor | None = None,
    use_pallas: bool | str = True,
) -> torch.Tensor:
    """out[d_local] = Σ_{e: dst=d} h[src[e]] with h sharded over ``axis``.

    Every rank of ``axis`` calls it on its shard. D ring steps; at step k
    this rank holds the block owned by (my_idx - k) mod D and processes
    the edges whose src falls in it. ``block_starts`` (shard-local blocked
    extents, sharded_model.shard_block_starts) routes each hop's reduce
    through the blocked layout's path.
    """
    n_loc = h_local.shape[0]
    d, my_idx, src_owner, src_local = _ring_owner(edge_src, n_loc, axis)
    acc = torch.zeros_like(h_local)
    blk = h_local
    for k in range(d):
        owner = (my_idx - k + d) % d
        sel = (src_owner == owner) & edge_mask
        msgs = blk[src_local] * sel[:, None].to(blk.dtype)
        acc = acc + _hop_segment_sum(msgs, edge_dst_local, n_loc, block_starts, use_pallas)
        if k + 1 < d:
            blk = ring_shift(blk, axis, shift=1)
    return acc


def ring_gather_edges(
    h_local: torch.Tensor,  # [n_loc, F] this shard's node states
    edge_src: torch.Tensor,  # [e_loc] GLOBAL src ids of local-dst edges
    edge_mask: torch.Tensor,  # [e_loc]
    axis=None,
) -> torch.Tensor:
    """Per-edge ``h[src[e]]`` with h sharded over ``axis`` — the ring
    counterpart of a cross-shard gather: node blocks rotate and each rank
    fills in the rows whose src lives in the block it currently holds (D
    steps, peak memory one block). Used by the node-sharded edge head,
    where every edge needs its (possibly remote) source state, not an
    aggregate."""
    n_loc = h_local.shape[0]
    d, my_idx, src_owner, src_local = _ring_owner(edge_src, n_loc, axis)
    out = torch.zeros((edge_src.shape[0],) + tuple(h_local.shape[1:]), dtype=h_local.dtype,
                      device=h_local.device)
    blk = h_local
    for k in range(d):
        owner = (my_idx - k + d) % d
        sel = (src_owner == owner) & edge_mask
        out = torch.where(sel[:, None], blk[src_local], out)
        if k + 1 < d:
            blk = ring_shift(blk, axis, shift=1)
    return out


def ring_attention_aggregate(
    q_part: torch.Tensor,  # [n_loc, nh] dst-side logit partials (local)
    kv_local: torch.Tensor,  # [n_loc, nh*hd] kv projections (the rotating block)
    e_part: torch.Tensor,  # [e_loc, nh] edge-feature logit partials (local edges)
    e_feat: torch.Tensor,  # [e_loc, nh, hd] edge-feature messages (local edges)
    a_k: torch.Tensor,  # [nh, hd] src-side attention vector
    edge_src: torch.Tensor,  # [e_loc] GLOBAL src ids of local-dst edges
    edge_dst_local: torch.Tensor,  # [e_loc] LOCAL dst ids
    edge_mask: torch.Tensor,  # [e_loc]
    axis=None,
    logit_clamp: float = ATTENTION_LOGIT_CLAMP,
    block_starts: torch.Tensor | None = None,
    use_pallas: bool | str = True,
) -> torch.Tensor:
    """**Ring attention for graphs**: the fused GAT softmax-aggregate
    (models/gat.py layer_fn) over a node-sharded graph. Per ring hop this
    rank holds one remote kv block and folds in the edges whose src lives
    there: logits = leaky_relu(q_part[dst] + a_k·kv[src] + e_part) clamped
    to ±logit_clamp, then the exp-weighted messages AND the exp column
    accumulate in one segment sum; the per-node division happens once
    after the ring. The fixed clamp is what removes classic ring
    attention's running-max recurrence — every hop's exp is already safe
    in f32, so numerator/denominator are plain ring-accumulated sums
    (SURVEY §2.3 P4; the blockwise-normalizer trick of blockwise/ring
    attention, degenerate because the max is a constant).

    Every rank of ``axis`` calls it on its shard. Returns [n_loc, nh*hd]
    normalized attention aggregates for the local nodes.

    Src ownership is derived as ``edge_src // n_loc``: node shards MUST
    be uniform and contiguous (shard k owns global ids [k·n_loc,
    (k+1)·n_loc)), exactly what ``shard_graph_batch`` / ``shard_graph``
    produce. A non-uniform layout would silently route edges to the wrong
    hop — repartition through those helpers first.
    """
    n_loc = kv_local.shape[0]
    nh, hd = a_k.shape
    out_dtype = kv_local.dtype
    d, my_idx, src_owner, src_local = _ring_owner(edge_src, n_loc, axis)
    # dst side is shard-local: one local gather, hoisted out of the ring.
    # Logits and both ring accumulators run f32 regardless of input
    # dtype — the same f32-denominator rule as segment_sum_accurate: a
    # bf16 running sum stagnates at hub fan-in ~256, and here the sum
    # also spans D hops.
    q_e = q_part[edge_dst_local].float()  # [e_loc, nh]
    e_part32 = e_part.float()
    a_k32 = a_k.float()
    acc = torch.zeros((n_loc, nh * hd + nh), dtype=torch.float32, device=kv_local.device)
    blk = kv_local
    for k in range(d):
        owner = (my_idx - k + d) % d
        sel = (src_owner == owner) & edge_mask
        kv_src = blk[src_local].reshape(-1, nh, hd)
        k_src = torch.einsum("ehd,hd->eh", kv_src.float(), a_k32)
        logits = F.leaky_relu(q_e + k_src + e_part32, 0.2)
        logits = torch.clamp(logits, -logit_clamp, logit_clamp)
        w = torch.where(sel[:, None], torch.exp(logits), 0.0)  # [e_loc, nh] f32
        msgs = ((kv_src + e_feat).float() * w[:, :, None]).reshape(-1, nh * hd)
        fused = torch.cat([msgs, w], dim=1)
        acc = acc + _hop_segment_sum(fused, edge_dst_local, n_loc, block_starts, use_pallas)
        if k + 1 < d:
            blk = ring_shift(blk, axis, shift=1)
    num = acc[:, : nh * hd].reshape(n_loc, nh, hd)
    den = acc[:, nh * hd :]  # [n_loc, nh]
    nonempty = den > 0.0
    return (
        torch.where(
            nonempty[:, :, None],
            num / torch.where(nonempty, den, 1.0)[:, :, None],
            0.0,
        )
        .reshape(n_loc, nh * hd)
        .to(out_dtype)
    )


def partition_edges_by_dst(
    edge_dst: np.ndarray,
    n_nodes: int,
    n_shards: int,
    edge_mask: np.ndarray | None = None,
) -> tuple[list[np.ndarray], int, int]:
    """The shared shard-layout core: contiguous node ownership, per-shard
    dst-sorted edge index lists, common 128-rounded edge budget. Returns
    (per-shard global edge indices in dst order, e_budget, n_loc). Both
    ``shard_graph`` and ``sharded_model.shard_graph_batch`` build on this
    so the ring kernels see one layout contract."""
    assert n_nodes % n_shards == 0, "pad node count to a multiple of n_shards"
    n_loc = n_nodes // n_shards
    owner = edge_dst // n_loc
    keep = np.ones(edge_dst.shape[0], bool) if edge_mask is None else edge_mask.astype(bool)
    per_shard = []
    e_budget = 0
    for s in range(n_shards):
        sel = np.flatnonzero((owner == s) & keep)
        sel = sel[np.argsort(edge_dst[sel], kind="stable")]
        per_shard.append(sel)
        e_budget = max(e_budget, sel.shape[0])
    e_budget = max(128, ((e_budget + 127) // 128) * 128)
    return per_shard, e_budget, n_loc


def shard_graph(
    node_feats: np.ndarray,
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    n_shards: int,
):
    """Partition a COO graph for the halo layer.

    Returns per-shard stacked arrays (leading axis = shard):
    ``h [D, n_loc, F]``, ``src [D, e_loc]`` (global ids), ``dst_local
    [D, e_loc]``, ``mask [D, e_loc]``. Nodes must already be padded to a
    multiple of ``n_shards``; per-shard edge budget is the max shard edge
    count rounded up to 128."""
    n = node_feats.shape[0]
    per_shard, e_budget, n_loc = partition_edges_by_dst(edge_dst, n, n_shards)

    h = node_feats.reshape(n_shards, n_loc, -1)
    src = np.zeros((n_shards, e_budget), dtype=np.int32)
    dst_local = np.full((n_shards, e_budget), n_loc - 1, dtype=np.int32)
    mask = np.zeros((n_shards, e_budget), dtype=bool)
    for s, idx in enumerate(per_shard):
        k = idx.shape[0]
        src[s, :k] = edge_src[idx]
        dst_local[s, :k] = edge_dst[idx] - s * n_loc
        mask[s, :k] = True
    return h, src, dst_local, mask


def make_halo_aggregate(mesh, axis: str = "sp"):
    """The node-sharded aggregation of one rank: this rank's blocks of
    ``shard_graph``'s stacked arrays in (leading axis of size 1, as
    ``shard_map`` hands them), this rank's block of the sums out
    (``[1, n_loc, F]``). The shard axis maps onto the mesh's ``axis``;
    each hop's reduce is K1 on a CUDA tensor, over the shard's live edges
    only (``sharded_model.shard_block_starts``: the pads past them all
    sit on the last dst row)."""
    from alaz_tpu_torch.parallel.sharded_model import shard_block_starts

    group = axis_group(mesh, axis)

    def run(h, src, dst_local, mask):
        bs = shard_block_starts(dst_local[0], mask[0], h.shape[1])
        out = ring_gather_scatter(h[0], src[0], dst_local[0], mask[0], axis=group, block_starts=bs)
        return out[None]

    return run
