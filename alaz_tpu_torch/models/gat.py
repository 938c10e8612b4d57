"""GAT with typed attention: the JAX package's ``models/gat.py``
(BASELINE.json config 3, 10k-pod mixed HTTP/gRPC/Postgres/Kafka edges).

Multi-head additive attention over incoming edges; the logits are
conditioned on source, destination and edge features, which carry the
protocol one-hot, so no per-edge type embedding is gathered. The
per-destination softmax is fused with the aggregation: exp-weighted
messages and the exp column go through one f32 segment sum (K1) and are
normalized per node. Per layer the dst-side logit partial rides the
sorted expand (K2) and the one src-side row gather is ``gather_src``
(K3 under ``src_gather="banded"``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from alaz_tpu_torch.config import ModelConfig
from alaz_tpu_torch.device import resolve_device
from alaz_tpu_torch.models.common import (
    Dense,
    LayerNorm,
    compute_dtype,
    dense,
    edge_head,
    gelu,
    graph_block_starts,
    layernorm,
    maybe_znorm_graph,
    mlp,
    remat_layer,
)
from alaz_tpu_torch.ops.segment import (
    ATTENTION_LOGIT_CLAMP,
    expand_dst,
    gather_src,
    segment_sum_accurate,
)


class GATLayer(nn.Module):
    """One attention layer: ``q``, ``kv``, ``edge_proj``, ``out``, ``ln``
    and the raw ``attn`` parameter ``[num_heads, 3·head_dim]`` (the
    q, kv and edge blocks of each head's attention vector)."""

    def __init__(self, h: int, nh: int, ef: int):
        super().__init__()
        self.q = Dense(h, h)
        self.kv = Dense(h, h)
        self.edge_proj = Dense(ef, h)
        self.attn = nn.Parameter(torch.empty(nh, 3 * (h // nh)))
        self.out = Dense(h, h)
        self.ln = LayerNorm(h)


class GAT(nn.Module):
    """The params of ``apply``, laid out as the JAX param tree: ``embed``,
    ``edge_head[0..1]``, ``node_head[0..1]``, ``layers[l].{q, kv,
    edge_proj, attn, out, ln}``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        h, nh = cfg.hidden_dim, cfg.num_heads
        if h % nh:
            raise ValueError(f"num_heads={nh} must divide hidden_dim={h}")
        self.cfg = cfg
        ef = cfg.edge_feat_dim_in
        self.embed = Dense(cfg.node_feature_dim, h)
        self.edge_head = nn.ModuleList([Dense(2 * h + ef, h), Dense(h, 1)])
        self.node_head = nn.ModuleList([Dense(h, h), Dense(h, 1)])
        self.layers = nn.ModuleList(GATLayer(h, nh, ef) for _ in range(cfg.num_layers))

    def forward(self, graph: dict) -> dict:
        return apply(self, graph, self.cfg)


def init(key, cfg: ModelConfig, device=None) -> GAT:
    """Random params from ``key`` (a ``torch.Generator`` or an int seed),
    drawn on the CPU so a seed gives the same params on every device:
    He-normal dense weights, zero biases, ``attn`` normal ×0.05."""
    gen = key if isinstance(key, torch.Generator) else torch.Generator().manual_seed(int(key))
    dev = resolve_device(device)
    model = GAT(cfg)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Dense):
                m.reset_parameters(gen)
            elif isinstance(m, GATLayer):
                m.attn.copy_(torch.randn(m.attn.shape, generator=gen) * 0.05)
    return model.to(dev)


def apply(params: GAT, graph: dict, cfg: ModelConfig) -> dict:
    """Forward pass over a graph of tensors (``convert.graph_to_torch``).
    Returns ``node_h``, ``edge_logits``, ``node_logits`` and
    ``attn_clamp_saturation``: the largest, over layers, fraction of live
    attention logits at or past the ±30 clamp; over a stacked group
    (``common.group_graph``) one such fraction a window, ``[W]``."""
    dtype = compute_dtype(cfg)
    graph = maybe_znorm_graph(graph, cfg)
    n = graph["node_feats"].shape[0]
    nh = cfg.num_heads
    hd = cfg.hidden_dim // nh
    node_mask = graph["node_mask"].float()[:, None]
    edge_mask = graph["edge_mask"]
    src, dst = graph["edge_src"], graph["edge_dst"]

    # the residual stream rides in f32; matmuls stay in the compute dtype
    h = dense(params.embed, graph["node_feats"].to(dtype)).float() * node_mask
    ef = graph["edge_feats"].to(dtype)
    block_starts = graph_block_starts(graph, cfg)
    n_windows = graph["windows"].shape[0] if "windows" in graph else None
    live = edge_mask.float().sum() if n_windows is None else edge_mask.float().reshape(n_windows, -1).sum(1)

    def layer_fn(layer, h32):
        hc = h32.to(dtype)
        # logit = a·[q_dst, kv_src, e_feat], re-associated into per-node and
        # per-edge partial dot products: the dst-side partial rides the
        # sorted expand, only the src side stays a row gather
        attn = layer.attn.to(dtype)
        a_q, a_k, a_e = attn[:, :hd], attn[:, hd : 2 * hd], attn[:, 2 * hd :]
        q = dense(layer.q, hc).reshape(n, nh, hd)
        kv = dense(layer.kv, hc).reshape(n, nh, hd)
        e_feat = dense(layer.edge_proj, ef).reshape(-1, nh, hd)

        # einsum returns [N, nh] with strides (1, N); the expand kernel
        # takes contiguous rows
        q_part = torch.einsum("nhd,hd->nh", q, a_q).contiguous()  # [N, nh]
        e_part = torch.einsum("ehd,hd->eh", e_feat, a_e)  # [E, nh]
        kv_src = gather_src(kv.reshape(n, nh * hd), src, n, cfg.src_gather).reshape(-1, nh, hd)
        k_src = torch.einsum("ehd,hd->eh", kv_src, a_k)
        logits = (expand_dst(q_part, dst, n, cfg.use_pallas) + k_src + e_part).float()
        logits = F.leaky_relu(logits, 0.2)

        # saturation gauge: the fraction of live logits at or past the
        # clamp, which the fixed clamp (in place of a per-segment max)
        # would otherwise hide
        hit = (logits.abs() >= ATTENTION_LOGIT_CLAMP) & edge_mask[:, None]
        if n_windows is None:
            sat = hit.float().sum() / torch.clamp(live * nh, min=1.0)
        else:  # a stacked group (common.group_graph): one fraction a window
            hits = hit.float().sum(1).reshape(n_windows, -1).sum(1)
            sat = hits / torch.clamp(live * nh, min=1.0)
        logits = torch.clamp(logits, -ATTENTION_LOGIT_CLAMP, ATTENTION_LOGIT_CLAMP)
        w = torch.where(edge_mask[:, None], torch.exp(logits), 0.0)  # [E, nh] f32
        msgs = ((kv_src + e_feat) * w[:, :, None].to(dtype)).reshape(-1, nh * hd)
        # one f32-accumulated segment sum over messages and exp column
        fused = torch.cat([msgs, w.to(msgs.dtype)], dim=1)
        agg_all = segment_sum_accurate(fused, dst, n, cfg.use_pallas, block_starts=block_starts)
        num = agg_all[:, : nh * hd].reshape(n, nh, hd)
        denom = agg_all[:, nh * hd :]  # [N, nh]
        # double where: rows with no live in-edge have denom 0; the inner
        # where keeps the division, and so its backward, off that 0
        nonempty = denom > 0.0
        agg = torch.where(
            nonempty[:, :, None],
            num / torch.where(nonempty, denom, 1.0)[:, :, None],
            0.0,
        ).reshape(n, nh * hd)
        h_new = dense(layer.out, agg.to(dtype))
        return (h32 + gelu(layernorm(layer.ln, h_new.float()))) * node_mask, sat

    sats = []
    for layer in params.layers:
        h, sat = remat_layer(layer_fn, layer, h) if cfg.remat else layer_fn(layer, h)
        sats.append(sat)
    h = h.to(dtype)

    edge_logits = edge_head(params.edge_head, h, graph, dtype, cfg.use_pallas, cfg.src_gather)
    node_logits = mlp(params.node_head, h)[:, 0]
    return {
        "node_h": h,
        "edge_logits": edge_logits.float(),
        "node_logits": node_logits.float(),
        "attn_clamp_saturation": torch.stack(sats).amax(0),
    }
