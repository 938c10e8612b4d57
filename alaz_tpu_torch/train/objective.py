"""Losses. Fault detection is per-edge binary classification with heavy
class imbalance: BCE with the positive class weighted up, masked to real
(non-padding) edges. The JAX package's ``train/objective.py``."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-element ``-y·log σ(x) - (1-y)·log σ(-x)``, through log-sigmoid
    so a large |x| neither overflows nor loses the tail (optax's form)."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def edge_bce_loss(
    edge_logits: torch.Tensor,
    edge_label: torch.Tensor,
    edge_mask: torch.Tensor,
    pos_weight: float = 10.0,
) -> torch.Tensor:
    per_edge = sigmoid_binary_cross_entropy(edge_logits, edge_label)
    weight = torch.where(edge_label > 0.5, pos_weight, 1.0) * edge_mask
    return (per_edge * weight).sum() / torch.clamp(weight.sum(), min=1.0)
