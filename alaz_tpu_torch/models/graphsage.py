"""GraphSAGE anomaly scorer, the flagship model.

Mean-aggregator GraphSAGE with edge-feature-conditioned messages:

    m_e   = W_msg·h[src_e] + W_ef·e_e
    agg_d = Σ_{e:dst=d} m_e / deg_d          (sorted-scatter kernel)
    h'_d  = GELU(LN(W_self·h_d + W_neigh·agg_d)) + h_d

plus per-edge and per-node anomaly heads. Matmuls run in the compute
dtype (bf16 by default), the residual stream and the scatter's
accumulation in f32 -- the JAX package's ``models/graphsage.py``. With
``cfg.remat`` each layer is recomputed in the backward instead of keeping
its activations (``torch.utils.checkpoint``).
"""

from __future__ import annotations

import torch
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
    graph_degree,
    layernorm,
    maybe_znorm_graph,
    mlp,
    remat_layer,
    scatter_messages,
)
from alaz_tpu_torch.ops.segment import gather_src


class GraphSAGE(nn.Module):
    """The params of ``apply``, laid out as the JAX param tree: ``embed``,
    ``edge_head[0..1]``, ``node_head[0..1]``, ``layers[l].{msg,
    edge_proj, self, neigh, ln}``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_dim
        ef = cfg.edge_feat_dim_in
        self.embed = Dense(cfg.node_feature_dim, h)
        self.edge_head = nn.ModuleList([Dense(2 * h + ef, h), Dense(h, 1)])
        self.node_head = nn.ModuleList([Dense(h, h), Dense(h, 1)])
        self.layers = nn.ModuleList(
            nn.ModuleDict(
                {
                    "msg": Dense(h, h),
                    "edge_proj": Dense(ef, h),
                    "self": Dense(h, h),
                    "neigh": Dense(h, h),
                    "ln": LayerNorm(h),
                }
            )
            for _ in range(cfg.num_layers)
        )

    def forward(self, graph: dict, h_bias: torch.Tensor | None = None) -> dict:
        return apply(self, graph, self.cfg, h_bias)


def init(key, cfg: ModelConfig, device=None) -> GraphSAGE:
    """Random params from ``key`` (a ``torch.Generator`` or an int seed),
    drawn on the CPU so a seed gives the same params on every device."""
    gen = key if isinstance(key, torch.Generator) else torch.Generator().manual_seed(int(key))
    dev = resolve_device(device)
    model = GraphSAGE(cfg)
    for m in model.modules():
        if isinstance(m, Dense):
            m.reset_parameters(gen)
    return model.to(dev)


def apply(params: GraphSAGE, graph: dict, cfg: ModelConfig, h_bias=None) -> dict:
    """Forward pass over a graph of tensors (``convert.graph_to_torch``).
    ``h_bias`` ([N, H], optional) is added to the embedded node state
    before message passing."""
    dtype = compute_dtype(cfg)
    graph = maybe_znorm_graph(graph, cfg)
    n = graph["node_feats"].shape[0]
    node_mask = graph["node_mask"].float()[:, None]
    edge_mask = graph["edge_mask"]

    h = dense(params.embed, graph["node_feats"].to(dtype))
    if h_bias is not None:
        h = h + h_bias.to(dtype)
    # the residual stream rides in f32; matmuls stay in the compute dtype.
    # An f32 carry also keeps remat exact: the recomputed layer rounds as
    # the saved one did
    h = h.float() * node_mask

    ef = graph["edge_feats"].to(dtype)
    deg = graph_degree(graph, torch.float32, n)
    block_starts = graph_block_starts(graph, cfg)

    def layer_fn(layer, h32):
        hc = h32.to(dtype)
        # dense-before-gather: (h @ W)[src] == h[src] @ W over N rows, not E
        msgs = gather_src(dense(layer["msg"], hc), graph["edge_src"], n, cfg.src_gather) + dense(
            layer["edge_proj"], ef
        )
        agg, _ = scatter_messages(
            msgs, graph["edge_dst"], edge_mask, n, cfg.use_pallas, deg=deg,
            block_starts=block_starts,
        )
        agg = agg / torch.clamp(deg, min=1.0)[:, None]  # bf16 / f32 → f32
        h_new = dense(layer["self"], hc) + dense(layer["neigh"], agg.to(dtype))
        h_new = gelu(layernorm(layer["ln"], h_new.float()))
        return (h32 + h_new) * node_mask

    for layer in params.layers:
        h = remat_layer(layer_fn, layer, h) if cfg.remat else layer_fn(layer, h)
    h = h.to(dtype)

    edge_logits = edge_head(params.edge_head, h, graph, dtype, cfg.use_pallas, cfg.src_gather)
    node_logits = mlp(params.node_head, h)[:, 0]
    return {
        "node_h": h,
        "edge_logits": edge_logits.float(),
        "node_logits": node_logits.float(),
    }
