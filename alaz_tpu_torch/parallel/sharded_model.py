"""Node-sharded model forwards (GraphSAGE + GAT) — the config-5 serving
path (BASELINE.json: 100k-pod multi-cluster graphs sharded across the
cards of a host or a cluster).

For graphs too big for one card, the node axis is partitioned over the
``sp`` mesh axis and every rank runs the forward on its own shard:
message aggregation crosses shards via the ring halo exchange
(halo.ring_gather_scatter — the graph analog of ring attention), the
edge head's remote source states arrive via the per-edge ring gather
(halo.ring_gather_edges), and everything else is shard-local dense math.
SURVEY §7 hard part (d): cross-shard neighbor halos without blowing
interconnect latency — D-1 neighbor hops per layer, peak extra memory one
node block. Each hop's local reduce, and the edge-feature scatter, is the
sorted-scatter wrapper (K1 on a CUDA tensor).

Numerically equivalent to the single-device ``graphsage.apply`` (same
params): validated edge-for-edge against the JAX package's node-sharded
forwards in tests/test_torch_parallel.py via the permutation
``shard_graph_batch`` returns.

Training through these forwards: params are replicated over ``sp``, and
a rank's loss covers only its shard's edges, so the gradient one rank's
backward leaves on a parameter is that rank's share. The gradient of the
whole graph's loss is their sum over ``sp``: call
``all_reduce_grads(params, mesh)`` after the backward (what JAX's
transpose of a replicated ``shard_map`` input does).
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from alaz_tpu_torch.config import ModelConfig
from alaz_tpu_torch.graph.snapshot import EDGE_BLOCK_ROWS, GraphBatch
from alaz_tpu_torch.models.common import (
    compute_dtype,
    dense,
    gelu,
    layernorm,
    masked_degree,
    mlp,
    scatter_messages,
    znorm_edge_feats,
)
from alaz_tpu_torch.parallel.collectives import all_reduce_sum
from alaz_tpu_torch.parallel.halo import (
    partition_edges_by_dst,
    ring_attention_aggregate,
    ring_gather_edges,
    ring_gather_scatter,
)
from alaz_tpu_torch.parallel.mesh import axis_group


# The shard-local array set a node-sharded forward consumes (what
# shard_graph_batch emits), in wire order.
SHARDED_GRAPH_KEYS = (
    "node_feats",
    "node_type",
    "node_mask",
    "edge_src",
    "edge_dst_local",
    "edge_type",
    "edge_feats",
    "edge_mask",
)


def node_sharded_specs(axis: str = "sp") -> tuple[tuple, tuple]:
    """The (in_specs, out_specs) contract BOTH node-sharded makers run
    under, as tuples of axis names per dim: params replicated (``()``),
    every graph array sharded on its leading S axis, both logit outputs
    sharded the same way (the JAX package's ``shard_map`` specs)."""
    in_specs = ((), {k: (axis,) for k in SHARDED_GRAPH_KEYS})
    out_specs = ((axis,), (axis,))
    return in_specs, out_specs


def shard_graph_batch(batch: GraphBatch, n_shards: int) -> tuple[dict, np.ndarray]:
    """Partition one GraphBatch for the node-sharded forward.

    Nodes split contiguously (n_pad must divide by n_shards — bucket
    sizes are powers of two, so any pow2 shard count works); each shard
    receives the edges whose dst is local, dst-sorted, padded to a common
    per-shard budget. Returns (stacked shard arrays, perm) where
    ``perm[s, i]`` is the global edge index in slot i of shard s (-1 =
    padding) so callers can scatter per-edge outputs back to batch order.
    """
    n, e = batch.n_pad, batch.e_pad
    per_shard, e_budget, n_loc = partition_edges_by_dst(
        batch.edge_dst, n, n_shards, edge_mask=batch.edge_mask
    )

    def alloc(shape, dtype, fill=0):
        return np.full(shape, fill, dtype=dtype)

    out = {
        "node_feats": batch.node_feats.reshape(n_shards, n_loc, -1),
        "node_type": batch.node_type.reshape(n_shards, n_loc),
        "node_mask": batch.node_mask.reshape(n_shards, n_loc),
        "edge_src": alloc((n_shards, e_budget), np.int32),
        "edge_dst_local": alloc((n_shards, e_budget), np.int32, n_loc - 1),
        "edge_type": alloc((n_shards, e_budget), np.int32),
        "edge_feats": alloc(
            (n_shards, e_budget, batch.edge_feats.shape[1]), np.float32
        ),
        "edge_mask": alloc((n_shards, e_budget), bool),
    }
    perm = np.full((n_shards, e_budget), -1, dtype=np.int64)
    for s, idx in enumerate(per_shard):  # already dst-sorted by the core
        k = idx.shape[0]
        out["edge_src"][s, :k] = batch.edge_src[idx]
        out["edge_dst_local"][s, :k] = batch.edge_dst[idx] - s * n_loc
        out["edge_type"][s, :k] = batch.edge_type[idx]
        out["edge_feats"][s, :k] = batch.edge_feats[idx]
        out["edge_mask"][s, :k] = True
        perm[s, :k] = idx
    return out, perm


def rank_shard(sharded: dict, index: int, device=None) -> dict:
    """Shard ``index`` of ``shard_graph_batch``'s stacked arrays as
    tensors on ``device`` (default ``cuda``), each with a leading axis of
    size 1: the block ``shard_map`` would hand that rank."""
    from alaz_tpu_torch.convert import graph_to_torch

    return graph_to_torch({k: np.ascontiguousarray(v[index : index + 1]) for k, v in sharded.items()}, device)


def shard_block_starts(
    dst_local: torch.Tensor, edge_mask: torch.Tensor, n_loc: int
) -> torch.Tensor | None:
    """Shard-local twin of graph/snapshot.edge_block_starts_from: the
    per-128-dst-row extents over this shard's live edge prefix, derived
    on the device (the host wire format — SHARDED_GRAPH_KEYS — is
    unchanged).

    Valid because ``edge_dst_local`` is globally sorted: the live prefix
    is dst-sorted by partition_edges_by_dst and the pad fill (n_loc - 1)
    is >= every live value. Interior extents from searchsorted therefore
    agree with the host definition; only the final sentinel would land
    at e_budget instead of n_live (pads share dst n_loc - 1), so the
    minimum clamps every entry to the live-edge frontier. Requires
    n_loc % EDGE_BLOCK_ROWS == 0 — callers gate (n_loc can be 64 at the
    smallest bucket over 4 shards; e_budget is always 128-rounded)."""
    if n_loc % EDGE_BLOCK_ROWS != 0:
        return None
    n_live = edge_mask.to(torch.int32).sum().to(torch.int32)
    bounds = torch.arange(0, n_loc + 1, EDGE_BLOCK_ROWS, dtype=torch.int32, device=dst_local.device)
    starts = torch.searchsorted(dst_local.to(torch.int32).contiguous(), bounds, out_int32=True)
    return torch.minimum(starts, n_live)


def _sharded_heads(params, h, ef, src, dst_local, edge_mask, dtype, axis):
    """The split edge head + node head over one node shard (shared by
    both node-sharded forwards so the serving paths cannot drift):
    models/common.edge_head's re-association, with the remote src states
    arriving via the per-edge ring gather."""
    w1 = params.edge_head[0].w.to(dtype)
    hdim = h.shape[-1]
    u = h @ w1[:hdim]
    v = h @ w1[hdim : 2 * hdim]
    u_e = ring_gather_edges(u.float(), src, edge_mask, axis=axis)
    z = (
        u_e.to(dtype)
        + v[dst_local]
        + ef @ w1[2 * hdim :]
        + params.edge_head[0].b.to(dtype)
    )
    edge_logits = mlp(list(params.edge_head)[1:], gelu(z))[:, 0]
    node_logits = mlp(params.node_head, h)[:, 0]
    return edge_logits.float()[None], node_logits.float()[None]


def _maybe_znorm_sharded(ef_raw, edge_mask, cfg, axis, dtype):
    """Shard-side twin of models/common.py maybe_znorm_graph: the
    fleet-baseline z-stats are a GLOBAL per-window reduction, summed over
    the node shards so sharded forwards match the single-device apply
    (parity tests)."""
    if cfg.edge_feat_znorm and ef_raw.shape[1] < cfg.edge_feat_dim_in:
        ef_raw = znorm_edge_feats(ef_raw, edge_mask, axis=axis)
    return ef_raw.to(dtype)


def _shard_inputs(g, cfg, group):
    """The per-forward invariants of one shard: compute dtype, masks, ids,
    the widened edge features, n_loc, the kernel switch (K1 needs whole
    128-row dst blocks) and the blocked extents. The extents are derived
    under the blocked layout, and under COO too when K1 runs: a shard's
    pad slots all sit on its last dst row, and K1, which walks a row with
    one warp, would walk them all (a shard with few live edges of a
    window whose edges are skewed to other shards has nearly an edge
    budget of pads); clamped to the live frontier, it stops before them.
    Bit-exact either way: the pads' messages are masked to zero."""
    dtype = compute_dtype(cfg)
    node_mask = g["node_mask"][0].float()
    edge_mask = g["edge_mask"][0]
    src, dst_local = g["edge_src"][0], g["edge_dst_local"][0]
    ef = _maybe_znorm_sharded(g["edge_feats"][0], edge_mask, cfg, group, dtype)
    n_loc = g["node_feats"].shape[1]
    use_k = cfg.use_pallas if n_loc % EDGE_BLOCK_ROWS == 0 else False
    bs = shard_block_starts(dst_local, edge_mask, n_loc) if cfg.edge_layout == "blocked" or use_k else None
    return dtype, node_mask, edge_mask, src, dst_local, ef, n_loc, bs, use_k


def make_node_sharded_graphsage(
    cfg: ModelConfig, mesh, axis: str = "sp"
) -> Callable:
    """The node-sharded forward of one rank: (params, this rank's shard)
    → (edge_logits [1, e_budget], node_logits [1, n_loc]). Params (a
    ``GraphSAGE`` module) are replicated over ``axis``; the shard is
    ``rank_shard`` of ``shard_graph_batch``'s arrays."""
    group = axis_group(mesh, axis)

    def run(params, g):
        dtype, node_mask, edge_mask, src, dst_local, ef, n_loc, bs, use_k = _shard_inputs(g, cfg, group)

        # f32 residual stream, mirroring the single-device forward
        # (models/graphsage.py): matmuls in the compute dtype, carry and
        # LN/GELU in f32 so bf16 sharded serving stays parity-exact
        h = dense(params.embed, g["node_feats"][0].to(dtype))
        h = h.float() * node_mask[:, None]

        # degree is layer-invariant: one [E] scatter per forward (the
        # same hoist the single-device models carry)
        deg = masked_degree(edge_mask, dst_local, n_loc, torch.float32)

        for layer in params.layers:
            # remote part: Σ_{dst local} (h W_msg)[src] via the ring
            hw = dense(layer["msg"], h.to(dtype))
            ring_agg = ring_gather_scatter(
                hw.float(), src, dst_local, edge_mask, axis=group,
                block_starts=bs, use_pallas=use_k,
            )
            # local part: edge-feature messages scatter shard-locally,
            # through the sorted-scatter kernel when the shard shapes
            # qualify (edges are 128-padded by construction; node blocks
            # need whole 128-row dst blocks)
            ef_msgs = dense(layer["edge_proj"], ef).float()
            ef_agg, _ = scatter_messages(
                ef_msgs, dst_local, edge_mask, n_loc, use_k, deg=deg, block_starts=bs,
            )
            agg = (ring_agg + ef_agg) / torch.clamp(deg, min=1.0)[:, None]
            h_new = dense(layer["self"], h.to(dtype)) + dense(layer["neigh"], agg.to(dtype))
            h_new = gelu(layernorm(layer["ln"], h_new.float()))
            h = (h + h_new) * node_mask[:, None]

        return _sharded_heads(params, h.to(dtype), ef, src, dst_local, edge_mask, dtype, group)

    return run


def make_node_sharded_gat(
    cfg: ModelConfig, mesh, axis: str = "sp"
) -> Callable:
    """The node-sharded GAT forward of one rank (BASELINE config 3 at
    fleet scale): same signature as ``make_node_sharded_graphsage``.
    Attention crosses shards via ``halo.ring_attention_aggregate`` — the
    fused softmax-aggregate accumulates numerator and denominator over
    the ring hops, so cross-shard normalization needs no extra collective
    beyond the same hops the sum aggregation pays. Numerically equivalent
    to the single-device ``gat.apply`` (same params)."""
    nh = cfg.num_heads
    hd = cfg.hidden_dim // nh
    group = axis_group(mesh, axis)

    def run(params, g):
        dtype, node_mask, edge_mask, src, dst_local, ef, n_loc, bs, use_k = _shard_inputs(g, cfg, group)

        # f32 residual stream, mirroring models/gat.py
        h = dense(params.embed, g["node_feats"][0].to(dtype))
        h = h.float() * node_mask[:, None]

        for layer in params.layers:
            attn = layer.attn.to(dtype)  # [nh, 3hd]
            a_q, a_k, a_e = attn[:, :hd], attn[:, hd : 2 * hd], attn[:, 2 * hd :]
            hc = h.to(dtype)
            q = dense(layer.q, hc).reshape(n_loc, nh, hd)
            kv = dense(layer.kv, hc)  # [n_loc, nh*hd] — the ring block
            e_feat = dense(layer.edge_proj, ef).reshape(-1, nh, hd)
            q_part = torch.einsum("nhd,hd->nh", q, a_q)  # [n_loc, nh]
            e_part = torch.einsum("ehd,hd->eh", e_feat, a_e)  # [e_loc, nh]
            agg = ring_attention_aggregate(
                q_part, kv, e_part, e_feat, a_k,
                src, dst_local, edge_mask, axis=group, block_starts=bs, use_pallas=use_k,
            )
            h_new = dense(layer.out, agg.to(dtype))
            h = (h + gelu(layernorm(layer.ln, h_new.float()))) * node_mask[:, None]

        return _sharded_heads(params, h.to(dtype), ef, src, dst_local, edge_mask, dtype, group)

    return run


def all_reduce_grads(params: torch.nn.Module, mesh, axis: str = "sp") -> None:
    """Sum every parameter's gradient over ``axis`` in place: after a
    backward through a node-sharded forward, each rank holds the gradient
    of its own shard's loss terms, and the whole graph's gradient is
    their sum (params are replicated over the axis). A parameter no
    rank's loss reached keeps ``grad`` None."""
    group = axis_group(mesh, axis)
    for p in params.parameters():
        if p.grad is not None:
            p.grad.copy_(all_reduce_sum(p.grad, group))


def unshard_edge_outputs(
    sharded: Any, perm: np.ndarray, n_edges: int
) -> np.ndarray:
    """[S, e_budget] per-edge outputs → batch edge order using the perm
    from shard_graph_batch (padding slots dropped)."""
    flat = np.asarray(sharded).reshape(-1)
    perm_flat = perm.reshape(-1)
    out = np.zeros(n_edges, flat.dtype)
    valid = perm_flat >= 0
    out[perm_flat[valid]] = flat[valid]
    return out
