"""Edge-type expert model: per-protocol expert message transforms, the
JAX package's ``models/experts.py``. Each L7 protocol ``t`` has its own
message weight ``W_t``:

    m_e = h[src_e] @ W_{type_e} + b_{type_e}

computed in one of two equivalent forms selected by
``ModelConfig.expert_dispatch``:

- ``"table"`` (default): per-expert node tables ``u_t = h @ W_t`` (T
  N-row matmuls), then one row gather from the stacked ``[T·N, H]``
  table at ``type·n + src``;
- ``"masked"``: ``Σ_t 1[type_e = t] · (h[src_e] @ W_t + b_t)``, T E-row
  matmuls over ``gather_src`` (K3 under ``src_gather="banded"``).

Unlike GraphSAGE, the degree and the residual stream stay in the compute
dtype, as in the JAX package.
"""

from __future__ import annotations

import contextlib

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
    graph_degree,
    layernorm,
    maybe_znorm_graph,
    mlp,
    scatter_messages,
)
from alaz_tpu_torch.ops.segment import gather_src

EXPERT_DISPATCH = ("table", "masked")


class ExpertLayer(nn.ModuleDict):
    """One layer: the stacked experts ``expert_w [T, H, H]`` and
    ``expert_b [T, H]``, and ``edge_proj``, ``self``, ``neigh``, ``ln``."""

    def __init__(self, h: int, t: int, ef: int):
        super().__init__(
            {"edge_proj": Dense(ef, h), "self": Dense(h, h), "neigh": Dense(h, h), "ln": LayerNorm(h)}
        )
        self.expert_w = nn.Parameter(torch.empty(t, h, h))
        self.expert_b = nn.Parameter(torch.zeros(t, h))


class Experts(nn.Module):
    """The params of ``apply``, laid out as the JAX param tree: ``embed``,
    ``edge_head[0..1]``, ``node_head[0..1]``, ``layers[l].{expert_w,
    expert_b, edge_proj, self, neigh, ln}``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        h, ef = cfg.hidden_dim, cfg.edge_feat_dim_in
        self.embed = Dense(cfg.node_feature_dim, h)
        self.edge_head = nn.ModuleList([Dense(2 * h + ef, h), Dense(h, 1)])
        self.node_head = nn.ModuleList([Dense(h, h), Dense(h, 1)])
        self.layers = nn.ModuleList(
            ExpertLayer(h, cfg.num_edge_types, ef) for _ in range(cfg.num_layers)
        )

    def forward(self, graph: dict) -> dict:
        return apply(self, graph, self.cfg)


def init(key, cfg: ModelConfig, device=None) -> Experts:
    """Random params from ``key`` (a ``torch.Generator`` or an int seed),
    drawn on the CPU so a seed gives the same params on every device:
    He-normal dense weights and experts, zero biases."""
    gen = key if isinstance(key, torch.Generator) else torch.Generator().manual_seed(int(key))
    dev = resolve_device(device)
    model = Experts(cfg)
    scale = (2.0 / cfg.hidden_dim) ** 0.5
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Dense):
                m.reset_parameters(gen)
            elif isinstance(m, ExpertLayer):
                m.expert_w.copy_(torch.randn(m.expert_w.shape, generator=gen) * scale)
    return model.to(dev)


def _expert_messages_masked(layer: ExpertLayer, h_src, edge_type, dtype) -> torch.Tensor:
    """Masked sum over experts: T matmuls over the [E, H] src rows."""
    out = torch.zeros_like(h_src)
    for ti in range(layer.expert_w.shape[0]):
        w = layer.expert_w[ti].to(dtype)
        b = layer.expert_b[ti].to(dtype)
        mask = (edge_type == ti).to(dtype)[:, None]
        out = out + mask * (h_src @ w + b)
    return out


def _expert_messages_table(layer: ExpertLayer, h, edge_src, edge_type, dtype) -> torch.Tensor:
    """Dense before gather: ``u_t = h @ W_t + b_t`` over N rows for every
    expert, then one row gather from the stacked [T·N, H] table at
    ``type·n + src``. Codes outside [0, T) get zero messages, as in the
    masked form: the index is clipped, then the row masked."""
    t, n = layer.expert_w.shape[0], h.shape[0]
    w = layer.expert_w.to(dtype)  # [T, H, H]
    b = layer.expert_b.to(dtype)  # [T, H]
    u = torch.einsum("nh,thk->tnk", h, w) + b[:, None, :]
    flat = u.reshape(t * n, h.shape[1])
    idx = edge_type * n + edge_src
    valid = ((edge_type >= 0) & (edge_type < t)).to(dtype)[:, None]
    return flat[torch.clamp(idx, 0, t * n - 1)] * valid


def apply(params: Experts, graph: dict, cfg: ModelConfig, around_dispatch=contextlib.nullcontext) -> dict:
    """Forward pass over a graph of tensors (``convert.graph_to_torch``).
    An unknown ``cfg.expert_dispatch`` raises: a typo must not run the
    other form under this one's name. ``around_dispatch()`` is entered
    around each layer's expert dispatch alone (the Service's span and
    device clock); it changes no number."""
    dtype = compute_dtype(cfg)
    graph = maybe_znorm_graph(graph, cfg)
    n = graph["node_feats"].shape[0]
    node_mask = graph["node_mask"].to(dtype)[:, None]
    edge_mask = graph["edge_mask"]

    h = dense(params.embed, graph["node_feats"].to(dtype)) * node_mask
    ef = graph["edge_feats"].to(dtype)
    deg = graph_degree(graph, dtype, n)

    if cfg.expert_dispatch not in EXPERT_DISPATCH:
        raise ValueError(
            f"expert_dispatch {cfg.expert_dispatch!r}; expected 'table' or 'masked'"
        )
    for layer in params.layers:
        with around_dispatch():
            if cfg.expert_dispatch == "table":
                msgs = _expert_messages_table(layer, h, graph["edge_src"], graph["edge_type"], dtype)
            else:
                msgs = _expert_messages_masked(
                    layer, gather_src(h, graph["edge_src"], n, cfg.src_gather), graph["edge_type"], dtype
                )
        msgs = msgs + dense(layer["edge_proj"], ef)
        agg, _ = scatter_messages(msgs, graph["edge_dst"], edge_mask, n, cfg.use_pallas, deg=deg)
        agg = agg / torch.clamp(deg, min=1.0)[:, None]
        h_new = dense(layer["self"], h) + dense(layer["neigh"], agg.to(dtype))
        h_new = gelu(layernorm(layer["ln"], h_new))
        h = (h + h_new) * node_mask

    edge_logits = edge_head(params.edge_head, h, graph, dtype, cfg.use_pallas, cfg.src_gather)
    node_logits = mlp(params.node_head, h)[:, 0]
    return {
        "node_h": h,
        "edge_logits": edge_logits.float(),
        "node_logits": node_logits.float(),
    }
