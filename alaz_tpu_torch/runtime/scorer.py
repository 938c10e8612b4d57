"""The serial window scorer: the core of the JAX package's service
scorer loop (``runtime/service.py`` ``score_one`` and ``record_window``).

A closed window moves to the device, runs through the model, and its
real edges get one sigmoid each. The backlog group path, the score
plane, spans, tenancy and the rest of the service plane come with later
slices.
"""

from __future__ import annotations

from typing import Iterable, List

import numpy as np
import torch

from alaz_tpu_torch.config import ModelConfig
from alaz_tpu_torch.device import resolve_device
from alaz_tpu_torch.graph.snapshot import GraphBatch
from alaz_tpu_torch.train.trainstep import make_score_fn


class WindowScorer:
    """Scores windows one at a time with ``params`` (a model module,
    moved to ``device``; default ``cuda``)."""

    def __init__(self, cfg: ModelConfig, params: torch.nn.Module, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = params.to(self.device)
        self._score_fn = make_score_fn(cfg, self.device)
        self.scored_batches = 0
        self.scored_edges = 0

    def score(self, batch: GraphBatch) -> np.ndarray:
        """Per-edge anomaly scores of the window's real edges, f32
        ``[n_edges]``."""
        out = self._score_fn(self.params, batch.device_arrays(self.cfg.edge_layout))
        n = batch.n_edges
        scores = torch.sigmoid(out["edge_logits"][:n]).cpu().numpy()
        self.scored_batches += 1
        self.scored_edges += n
        return scores

    def score_windows(self, batches: Iterable[GraphBatch]) -> List[np.ndarray]:
        return [self.score(b) for b in batches]
