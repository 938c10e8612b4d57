"""Temporal GNN over 1 s windows: the JAX package's ``models/tgn.py``
(BASELINE.json config 4, latency-spike forecasting).

A per-node memory (node slots are stable across windows) conditions each
window's snapshot encoding and is updated by a GRU cell:

    h_t = GraphSAGE(x_t ; h_bias = W_m·m_{t-1})
    m_t = GRU(m_{t-1}, h_t)        (active nodes only)

Scores are read from ``h_t``. The memory is an ``[M, H]`` f32 tensor;
when a window's node bucket outgrows M it is zero-extended to the bucket,
so a streaming caller can size it once and let it grow. Every step is
functional (no in-place update), so the memory threads through an
unrolled sequence with its gradient.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from alaz_tpu_torch.config import ModelConfig
from alaz_tpu_torch.device import resolve_device
from alaz_tpu_torch.models import graphsage
from alaz_tpu_torch.models.common import Dense, compute_dtype, dense


class TGN(nn.Module):
    """The params of ``step``, laid out as the JAX param tree: ``encoder``
    (a GraphSAGE), ``mem_in``, ``gru_r``, ``gru_z``, ``gru_n``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_dim
        self.encoder = graphsage.GraphSAGE(cfg)
        self.mem_in = Dense(h, h)
        self.gru_r = Dense(2 * h, h)
        self.gru_z = Dense(2 * h, h)
        self.gru_n = Dense(2 * h, h)

    def forward(self, graph: dict) -> dict:
        return apply(self, graph, self.cfg)


def init(key, cfg: ModelConfig, device=None) -> TGN:
    """Random params from ``key`` (a ``torch.Generator`` or an int seed),
    drawn on the CPU: He-normal dense weights, zero biases, except the
    update gate's bias at -2, which leans the gate toward the fresh
    encoding at init (z ≈ 0.12) so stale memory does not dominate early
    training."""
    gen = key if isinstance(key, torch.Generator) else torch.Generator().manual_seed(int(key))
    dev = resolve_device(device)
    model = TGN(cfg)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Dense):
                m.reset_parameters(gen)
        model.gru_z.b.sub_(2.0)
    return model.to(dev)


def init_memory(cfg: ModelConfig, max_nodes: int, device=None) -> torch.Tensor:
    return torch.zeros((max_nodes, cfg.hidden_dim), dtype=torch.float32, device=resolve_device(device))


def apply(params: TGN, graph: dict, cfg: ModelConfig) -> dict:
    """Memoryless single-window forward (cold-start memory). Streaming
    callers thread the memory through ``step`` (``WindowScorer`` does),
    and training unrolls ``step`` (``train_tgn_unrolled``): through this
    path the GRU gets no gradient, since the updated memory is dropped."""
    nodes = graph["node_feats"]
    memory = init_memory(cfg, nodes.shape[0], device=nodes.device)
    out, _ = step(params, graph, memory, cfg)
    return out


def step(params: TGN, graph: dict, memory: torch.Tensor, cfg: ModelConfig) -> tuple:
    """One window: encode the snapshot conditioned on the memory, emit its
    scores, and return ``(outputs, memory)`` with the memory updated on
    active nodes (zero-extended first if the node bucket grew)."""
    dtype = compute_dtype(cfg)
    n_pad = graph["node_feats"].shape[0]
    if memory.shape[0] < n_pad:
        memory = F.pad(memory, (0, 0, 0, n_pad - memory.shape[0]))
    m_prev = memory[:n_pad]

    out = graphsage.apply(
        params.encoder, graph, cfg, h_bias=dense(params.mem_in, m_prev.to(dtype))
    )
    h = out["node_h"].float()

    # GRU memory update for active nodes
    hz = torch.cat([m_prev.to(dtype), h.to(dtype)], dim=-1)
    r = torch.sigmoid(dense(params.gru_r, hz)).float()
    z = torch.sigmoid(dense(params.gru_z, hz)).float()
    hn = torch.cat([(r * m_prev).to(dtype), h.to(dtype)], dim=-1)
    n_t = torch.tanh(dense(params.gru_n, hn)).float()
    m_new = (1 - z) * n_t + z * m_prev

    m_next = torch.where(graph["node_mask"][:, None], m_new, m_prev)
    if memory.shape[0] > n_pad:
        m_next = torch.cat([m_next, memory[n_pad:]])
    return out, m_next


@functools.lru_cache(maxsize=None)
def make_step_fn(cfg: ModelConfig):
    """``step`` closed over a ModelConfig, one per config (ModelConfig is
    a frozen dataclass, so equal configs share it): the streaming
    callers' entry point."""

    def tgn_step(params, graph, memory):
        return step(params, graph, memory, cfg)

    return tgn_step
