"""Scoring functions: the score half of the JAX package's
``train/trainstep.py``. Training comes with a later slice."""

from __future__ import annotations

from typing import Callable

import torch

from alaz_tpu_torch.config import ModelConfig
from alaz_tpu_torch.convert import graph_to_torch
from alaz_tpu_torch.device import resolve_device
from alaz_tpu_torch.graph.snapshot import GraphBatch
from alaz_tpu_torch.models.registry import get_model


def make_score_fn(cfg: ModelConfig, device=None) -> Callable:
    """Inference fn ``(params, graph) -> outputs`` on ``device`` (default
    ``cuda``). ``graph`` may hold numpy arrays or tensors; they are moved
    to the device. Runs under ``torch.inference_mode``."""
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
