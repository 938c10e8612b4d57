"""Train and score steps over GraphBatches: the JAX package's
``train/trainstep.py``.

The optimizer is ``torch.optim.AdamW`` with optax's ``adamw`` defaults
and its weight decay, 1e-4, set explicitly (torch's default is 1e-2).
optax decays every leaf, biases and layer-norm gains included, so there
is one parameter group. Params stay f32 master weights; the models cast
them to the compute dtype in the forward. Gradients flow through the
hand-written kernels (``ops/segment_kernels.py``), whose backward passes
are kernels too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, List

import numpy as np
import torch

from alaz_tpu_torch.config import ModelConfig
from alaz_tpu_torch.convert import graph_to_torch
from alaz_tpu_torch.device import resolve_device
from alaz_tpu_torch.graph.snapshot import GraphBatch
from alaz_tpu_torch.models import tgn
from alaz_tpu_torch.models.registry import get_model
from alaz_tpu_torch.train.objective import edge_bce_loss


@dataclass
class TrainState:
    params: torch.nn.Module
    opt_state: torch.optim.Optimizer  # AdamW: its moments and step counts
    step: int = 0


def _adamw(params: torch.nn.Module, lr: float, weight_decay: float = 1e-4) -> torch.optim.AdamW:
    """``optax.adamw(lr, weight_decay=1e-4)``: betas (0.9, 0.999), eps 1e-8
    after the bias-corrected square root, decoupled decay on every
    parameter."""
    return torch.optim.AdamW(
        params.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay
    )


def _autograd_tensor(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when it was made under ``inference_mode``
    (``make_score_fn``), which autograd refuses to save."""
    return t.clone() if t.is_inference() else t


def _train_graph(graph: dict, dev: torch.device) -> dict:
    return {k: _autograd_tensor(v) for k, v in graph_to_torch(graph, dev).items()}


def backward(params: torch.nn.Module, loss: torch.Tensor) -> None:
    """``loss.backward()``, then a zero gradient for every param the loss
    does not reach (the node head, under the edge loss): optax's adamw
    updates every leaf, decay included, and torch's skips a param with
    no gradient."""
    loss.backward()
    for p in params.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def make_loss_fn(cfg: ModelConfig, pos_weight: float = 10.0) -> Callable:
    """``loss_fn(params, graph, edge_label) -> loss``: the masked,
    positive-weighted edge BCE of one forward, on the graph's device."""
    _, apply = get_model(cfg.model)

    def loss_fn(params, graph: dict, edge_label: torch.Tensor) -> torch.Tensor:
        out = apply(params, graph, cfg)
        return edge_bce_loss(out["edge_logits"], edge_label, graph["edge_mask"].float(), pos_weight)

    return loss_fn


def make_train_step(cfg: ModelConfig, pos_weight: float = 10.0, device=None) -> Callable:
    """``train_step(params, optimizer, graph, edge_label) -> loss``: one
    forward, backward and optimizer step on ``device`` (default ``cuda``).
    ``graph`` may hold numpy arrays or tensors. The gradients stay in the
    params' ``.grad`` until the next step; the loss comes back as a
    detached tensor on the device, so the step does not wait for it."""
    loss_fn = make_loss_fn(cfg, pos_weight)
    dev = resolve_device(device)

    def train_step(params, optimizer, graph: dict, edge_label) -> torch.Tensor:
        g = _train_graph(graph, dev)
        label = _autograd_tensor(torch.as_tensor(edge_label, device=dev))
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, g, label)
        backward(params, loss)
        optimizer.step()
        return loss.detach()

    return train_step


def train_on_batches(
    cfg: ModelConfig,
    batches: Iterable[GraphBatch],
    epochs: int = 5,
    lr: float = 3e-3,
    pos_weight: float = 10.0,
    seed: int = 0,
    device=None,
) -> tuple:
    """Train fresh params (from ``seed``) on the windows, ``epochs`` passes
    in order, one step a window → ``(TrainState, losses)``. The windows
    move to the device once, in the config's edge layout."""
    dev = resolve_device(device)
    init, _ = get_model(cfg.model)
    params = init(seed, cfg, device=dev)
    optimizer = _adamw(params, lr)
    step_fn = make_train_step(cfg, pos_weight, dev)
    data = [
        (graph_to_torch(b.device_arrays(cfg.edge_layout), dev), torch.as_tensor(b.edge_label, device=dev))
        for b in batches
    ]
    losses: List[float] = []
    for _ in range(epochs):
        for graph, label in data:
            losses.append(float(step_fn(params, optimizer, graph, label)))
    return TrainState(params=params, opt_state=optimizer, step=len(losses)), losses


def _pad_graph_field(name: str, v, n_t: int, e_t: int):
    """Zero/mask-pad one device-array field up to target buckets. Padding
    edges point at the last node slot (keeps the dst-sorted invariant)
    with mask 0, so they contribute nothing."""
    v = np.asarray(v)
    if name.startswith("node_"):
        pad = n_t - v.shape[0]
        widths = ((0, pad),) + ((0, 0),) * (v.ndim - 1)
        return np.pad(v, widths)
    pad = e_t - v.shape[0]
    if pad == 0:
        return v
    if name in ("edge_src", "edge_dst"):
        return np.pad(v, (0, pad), constant_values=n_t - 1)
    widths = ((0, pad),) + ((0, 0),) * (v.ndim - 1)
    return np.pad(v, widths)


def prep_sequences(batches, label_attr: str = "edge_label", device=None) -> list:
    """One window sequence (a list of GraphBatch) or several (a list of
    lists) as ``[(graphs, labels), ...]`` on ``device``, every window
    padded up to the largest bucket present (the unroll takes one shape)."""
    dev = resolve_device(device)
    seq_input = list(batches)
    if not seq_input:
        raise ValueError("no training windows")
    sequences = (
        [list(s) for s in seq_input] if isinstance(seq_input[0], (list, tuple)) else [seq_input]
    )
    all_b = [b for s in sequences for b in s]
    n_t = max(b.n_pad for b in all_b)
    e_t = max(b.e_pad for b in all_b)

    def prep(batch_list):
        graphs = [
            graph_to_torch(
                {k: _pad_graph_field(k, v, n_t, e_t) for k, v in b.device_arrays().items()}, dev
            )
            for b in batch_list
        ]
        labels = [
            torch.as_tensor(np.pad(getattr(b, label_attr), (0, e_t - b.e_pad)), device=dev)
            for b in batch_list
        ]
        return graphs, labels

    return [prep(s) for s in sequences]


def unrolled_loss(params, prepped: list, memory0: torch.Tensor, cfg: ModelConfig,
                  pos_weight: float = 10.0) -> torch.Tensor:
    """The TGN objective over whole window sequences: ``tgn.step`` unrolled
    through each sequence from ``memory0``, the memory threaded from window
    to window without a detach (so the GRU and memory params get
    gradient), the loss averaged over each sequence's windows, then over
    the sequences."""
    total = 0.0
    for graphs, labels in prepped:
        mem = memory0
        seq_total = 0.0
        for g, lbl in zip(graphs, labels):
            out, mem = tgn.step(params, g, mem, cfg)
            seq_total = seq_total + edge_bce_loss(
                out["edge_logits"], lbl, g["edge_mask"].float(), pos_weight
            )
        total = total + seq_total / len(graphs)
    return total / len(prepped)


def train_tgn_unrolled(
    cfg: ModelConfig,
    batches: Iterable,
    epochs: int = 5,
    lr: float = 3e-3,
    pos_weight: float = 10.0,
    seed: int = 0,
    label_attr: str = "edge_label",
    device=None,
) -> tuple:
    """Temporal training for TGN: one optimizer step per epoch over the
    unrolled sequences (``unrolled_loss``). ``batches`` is one window
    sequence or several, each unrolled from fresh memory; forecast
    training (``label_attr="edge_label_next"``) should use several fault
    draws, or the model memorizes which edges ramp. Returns
    ``(TrainState, losses)``."""
    dev = resolve_device(device)
    prepped = prep_sequences(batches, label_attr, dev)
    params = tgn.init(seed, cfg, device=dev)
    optimizer = _adamw(params, lr)
    n_t = prepped[0][0][0]["node_feats"].shape[0]
    memory0 = tgn.init_memory(cfg, max(cfg.tgn_max_nodes, n_t), device=dev)
    losses: List[float] = []
    for _ in range(epochs):
        optimizer.zero_grad(set_to_none=True)
        loss = unrolled_loss(params, prepped, memory0, cfg, pos_weight)
        backward(params, loss)
        optimizer.step()
        losses.append(float(loss.detach()))
    return TrainState(params=params, opt_state=optimizer, step=len(losses)), losses


def make_score_fn(cfg: ModelConfig, device=None) -> Callable:
    """Inference fn ``(params, graph) -> outputs`` on ``device`` (default
    ``cuda``). ``graph`` may hold numpy arrays or tensors; they are moved
    to the device. Runs under ``torch.inference_mode``: its outputs, and
    tensors it made, cannot feed a backward (``make_train_step`` copies
    such inputs)."""
    _, apply = get_model(cfg.model)
    dev = resolve_device(device)

    def score_apply(params, graph: dict) -> dict:
        with torch.inference_mode():
            return apply(params, graph_to_torch(graph, dev), cfg)

    return score_apply


def score_batch(
    cfg: ModelConfig, params, batch: GraphBatch, score_fn: Callable | None = None, device=None
) -> dict:
    """Score one window; outputs come back as numpy (``node_h`` widened
    to f32, since numpy has no bf16; a scalar output such as GAT's
    ``attn_clamp_saturation`` as a numpy scalar). The batch ships in the
    config's edge layout."""
    if score_fn is None:
        score_fn = make_score_fn(cfg, device)
    out = score_fn(params, batch.device_arrays(cfg.edge_layout))
    return {k: v.float().cpu().numpy()[()] for k, v in out.items()}
