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

import contextlib
import functools

import torch
import torch.nn.functional as F
from torch import nn

from alaz_tpu_torch.config import ModelConfig
from alaz_tpu_torch.device import resolve_device
from alaz_tpu_torch.models import graphsage
from alaz_tpu_torch.models.common import Dense, compute_dtype, dense
from alaz_tpu_torch.ops import gru_kernels
from alaz_tpu_torch.ops.segment import kernels_enabled
from alaz_tpu_torch.sanitize.retrace import dispatch


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


def encode(params: TGN, graph: dict, memory: torch.Tensor, cfg: ModelConfig) -> tuple:
    """The window's outputs from its snapshot conditioned on the memory:
    ``(outputs, memory)``, the memory zero-extended first if the node
    bucket outgrew it."""
    dtype = compute_dtype(cfg)
    n_pad = graph["node_feats"].shape[0]
    if memory.shape[0] < n_pad:
        memory = F.pad(memory, (0, 0, 0, n_pad - memory.shape[0]))
    m_prev = memory[:n_pad]
    out = graphsage.apply(
        params.encoder, graph, cfg, h_bias=dense(params.mem_in, m_prev.to(dtype))
    )
    return out, memory


def update(params: TGN, graph: dict, memory: torch.Tensor, node_h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The GRU memory update: ``m_t`` on the window's active nodes from
    ``m_{t-1}`` (``memory``, at least the node bucket's rows, as ``encode``
    returns it) and the window's node states ``node_h``; every other row
    as it was. One kernel (``ops/gru_kernels.py gru_update``) where the
    config asks for the kernels, the tensors are on a card, the compute
    dtype is bf16 and no gradient is being recorded (the kernel has no
    backward); else the plain version."""
    dtype = compute_dtype(cfg)
    mask = graph["node_mask"]
    if (kernels_enabled(cfg.use_pallas) and memory.is_cuda and dtype == torch.bfloat16
            and not torch.is_grad_enabled()):
        return gru_kernels.gru_update(params.gru_r, params.gru_z, params.gru_n, memory, node_h, mask)
    return gru_kernels.gru_update_plain(params.gru_r, params.gru_z, params.gru_n, memory, node_h, mask, dtype)


def step(params: TGN, graph: dict, memory: torch.Tensor, cfg: ModelConfig) -> tuple:
    """One window: encode the snapshot conditioned on the memory, emit its
    scores, and return ``(outputs, memory)`` with the memory updated on
    active nodes (zero-extended first if the node bucket grew)."""
    out, memory = encode(params, graph, memory, cfg)
    return out, update(params, graph, memory, out["node_h"], cfg)


@functools.lru_cache(maxsize=None)
def make_step_fn(cfg: ModelConfig):
    """``step`` closed over a ModelConfig, one per config (ModelConfig is
    a frozen dataclass, so equal configs share it): the streaming
    callers' entry point. ``around_update`` is entered around the memory
    update alone (the Service's span and device clock)."""

    def tgn_step(params, graph, memory, around_update=contextlib.nullcontext):
        with dispatch("tgn_step", graph):
            out, memory = encode(params, graph, memory, cfg)
            with around_update():
                memory = update(params, graph, memory, out["node_h"], cfg)
            return out, memory

    return tgn_step
