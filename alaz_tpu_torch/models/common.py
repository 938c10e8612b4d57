"""Shared model building blocks.

Parameters live in small ``nn.Module``s whose layout is the JAX
package's: a dense layer holds ``w`` as ``[in, out]`` and ``b``, a layer
norm ``g`` and ``b``. So a JAX param tree maps onto a module's state dict
leaf for leaf, with no transposition (``convert.py``). The functions
below keep the JAX package's numerics: weights cast to the input dtype,
population-variance layer norm, tanh-approximate GELU.
"""

from __future__ import annotations

from typing import Iterable

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from alaz_tpu_torch.config import ModelConfig
from alaz_tpu_torch.ops.segment import (
    expand_dst,
    gather_src,
    segment_sum,
    segment_sum_sorted_dispatch,
)


class Dense(nn.Module):
    """``x @ w + b`` with ``w`` stored ``[in, out]``."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(in_dim, out_dim))
        self.b = nn.Parameter(torch.zeros(out_dim))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """He-normal weights, zero bias (the JAX package's dense_init)."""
        in_dim = self.w.shape[0]
        self.w.copy_(torch.randn(self.w.shape, generator=generator) * (2.0 / in_dim) ** 0.5)
        self.b.zero_()


class LayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(dim))
        self.b = nn.Parameter(torch.zeros(dim))


def dense(params: Dense, x: torch.Tensor) -> torch.Tensor:
    return x @ params.w.to(x.dtype) + params.b.to(x.dtype)


def layernorm(params: LayerNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + eps)
    return y * params.g.to(x.dtype) + params.b.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp(params: Iterable[Dense], x: torch.Tensor) -> torch.Tensor:
    layers = list(params)
    for i, layer in enumerate(layers):
        x = dense(layer, x)
        if i + 1 < len(layers):
            x = gelu(x)
    return x


def remat_layer(layer_fn, layer, h):
    """``layer_fn(layer, h)`` rematerialized (``cfg.remat``): its
    activations are dropped after the forward and recomputed in the
    backward, trading compute for activation memory. The gradients equal
    those without remat when the recompute rounds as the forward did (the
    models' f32 residual carry)."""
    return torch.utils.checkpoint.checkpoint(layer_fn, layer, h, use_reentrant=False)


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# leading edge-feature columns that carry window STATS (count, mean/max
# latency, 5xx/4xx rates, tls share, request rate); the z-norm
# augmentation scores exactly these
EDGE_STAT_COLS = 7


def znorm_edge_feats(
    ef: torch.Tensor,
    edge_mask: torch.Tensor,
    eps: float = 1e-8,
    clip: float = 8.0,
) -> torch.Tensor:
    """[..., E, F] → [..., E, F + EDGE_STAT_COLS]: append per-window
    z-scores of the stat columns, each edge measured against its window's
    fleet baseline (a leading axis holds stacked windows, each normed on
    its own, as ``jax.vmap`` of the single-window form would). Stats
    accumulate in f32 whatever the feature dtype; z of padded edges is
    forced to 0."""
    m = edge_mask.float()[..., None]
    stats = ef[..., :EDGE_STAT_COLS].float()
    cnt = m.sum(-2, keepdim=True)
    s1 = (stats * m).sum(-2, keepdim=True)
    s2 = (stats * stats * m).sum(-2, keepdim=True)
    cnt = torch.clamp(cnt, min=1.0)
    mean = s1 / cnt
    var = torch.clamp(s2 / cnt - mean * mean, min=0.0)
    z = (stats - mean) * torch.rsqrt(var + eps)
    z = torch.clamp(z, -clip, clip) * m
    return torch.cat([ef, z.to(ef.dtype)], dim=-1)


def group_graph(stacked: dict, cfg: ModelConfig) -> dict:
    """W windows of one bucket, stacked on a leading axis (``[W, ...]``
    tensors of ``GraphBatch.device_arrays``), as ONE block-diagonal graph
    whose forward gives each window what its own forward gives: node ids
    of window w are offset by w·n_pad, so every window's dst order stays
    sorted across the stack and each kernel runs once for the group. The
    window-global operations keep per-window semantics: the edge-stat
    z-norm runs here per window (the model then sees the widened features
    and skips its own), the blocked extents of window w are offset by
    w·E_pad (window w's pad edges, masked, fall in its last dst block, as
    COO's sorted runs hold them), and ``windows`` ([W]) tells the model
    how many windows the edge axis holds (GAT's saturation gauge is per
    window)."""
    w, n_pad = stacked["node_feats"].shape[:2]
    e_pad = stacked["edge_src"].shape[1]
    dev = stacked["edge_src"].device
    windows = torch.arange(w, device=dev, dtype=torch.int32)
    out = {"windows": windows}
    for k, v in stacked.items():
        if k in ("edge_src", "edge_dst"):
            out[k] = (v + (windows * n_pad)[:, None]).reshape(-1)
        elif k == "edge_block_starts":
            starts = v + (windows * e_pad)[:, None]
            out[k] = torch.cat([starts[:, :-1].reshape(-1), starts[-1, -1:]])
        elif k == "edge_feats" and cfg.edge_feat_znorm:
            out[k] = znorm_edge_feats(v, stacked["edge_mask"]).reshape(w * e_pad, -1)
        else:
            out[k] = v.reshape(w * v.shape[1], *v.shape[2:])
    return out


def maybe_znorm_graph(graph: dict, cfg: ModelConfig) -> dict:
    """Model-entry hook: ``graph`` with augmented edge_feats when
    cfg.edge_feat_znorm (idempotent: skips if the width already matches
    edge_feat_dim_in)."""
    if not cfg.edge_feat_znorm:
        return graph
    if graph["edge_feats"].shape[1] >= cfg.edge_feat_dim_in:
        return graph
    return dict(graph, edge_feats=znorm_edge_feats(graph["edge_feats"], graph["edge_mask"]))


def graph_block_starts(graph: dict, cfg: ModelConfig) -> torch.Tensor | None:
    """The blocked layout's per-128-dst extents for this batch, or None
    under COO. A blocked config over a batch that never shipped extents
    raises instead of silently scoring the COO path."""
    if cfg.edge_layout != "blocked":
        return None
    bs = graph.get("edge_block_starts")
    if bs is None:
        raise ValueError(
            "edge_layout='blocked' but the graph carries no "
            "edge_block_starts — ship batches via "
            "GraphBatch.device_arrays(edge_layout='blocked')"
        )
    return bs


def scatter_messages(
    msgs: torch.Tensor,
    edge_dst: torch.Tensor,
    edge_mask: torch.Tensor,
    num_nodes: int,
    use_pallas: bool | str,
    deg: torch.Tensor | None = None,
    block_starts: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked message scatter → (sum [N,H], degree [N]), dispatched like
    ``segment_sum_sorted_dispatch``. Models pass the window's shipped
    degree; direct callers get ``masked_degree``."""
    m = msgs * edge_mask[:, None].to(msgs.dtype)
    agg = segment_sum_sorted_dispatch(
        m, edge_dst, num_nodes, use_pallas, block_starts=block_starts
    )
    if deg is None:
        deg = masked_degree(edge_mask, edge_dst, num_nodes, msgs.dtype)
    return agg, deg


def masked_degree(edge_mask, edge_dst, num_nodes: int, dtype) -> torch.Tensor:
    """deg[d] = Σ_{e: dst[e]=d} mask[e]."""
    return segment_sum(edge_mask.to(dtype), edge_dst, num_nodes)


def graph_degree(graph: dict, dtype, num_nodes: int) -> torch.Tensor:
    """The per-forward in-degree: the host-shipped window invariant
    (``GraphBatch.device_arrays`` ``node_deg``) when the batch carries it,
    else the in-graph segment sum."""
    deg = graph.get("node_deg")
    if deg is not None:
        return deg.to(dtype)
    return masked_degree(graph["edge_mask"], graph["edge_dst"], num_nodes, dtype)


def edge_head(
    params: nn.ModuleList, h, graph, dtype, use_pallas: bool | str = False,
    src_gather_mode: str = "xla",
) -> torch.Tensor:
    """Per-edge anomaly logit from [h_src, h_dst, edge_feats], in the
    split form of ``mlp(params, concat([h[src], h[dst], ef]))``: the first
    layer's weight rows split into (src, dst, ef) blocks, the node-side
    products run on [N, H] node states before the per-edge gathers, and
    the dst-side expand rides the sorted-expand kernel."""
    w1 = params[0].w.to(dtype)
    hdim = h.shape[-1]
    u = h @ w1[:hdim]  # [N, H'] src-side projection
    v = h @ w1[hdim : 2 * hdim]  # [N, H'] dst-side projection
    efp = graph["edge_feats"].to(dtype) @ w1[2 * hdim :]
    v_e = expand_dst(v, graph["edge_dst"], h.shape[0], use_pallas)
    u_e = gather_src(u, graph["edge_src"], h.shape[0], src_gather_mode)
    z = u_e + v_e + efp + params[0].b.to(dtype)
    return mlp(list(params)[1:], gelu(z))[:, 0]
