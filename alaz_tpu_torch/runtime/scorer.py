"""The serial window scorer: the core of the JAX package's service
scorer loop (``runtime/service.py`` ``score_one`` and ``record_window``).

A closed window moves to the device, runs through the model, and its
real edges get one sigmoid each. Under ``model="tgn"`` the scorer owns
the temporal node memory, as the service does: presized to
``cfg.tgn_max_nodes``, threaded through ``tgn.step`` window by window,
zero-extended when a bucket outgrows it. The backlog group path, the
score plane, spans, tenancy and the rest of the service plane come with
later slices.
"""

from __future__ import annotations

from typing import Iterable, List

import numpy as np
import torch

from alaz_tpu_torch.config import ModelConfig
from alaz_tpu_torch.convert import graph_to_torch
from alaz_tpu_torch.device import resolve_device
from alaz_tpu_torch.graph.snapshot import GraphBatch
from alaz_tpu_torch.models import tgn
from alaz_tpu_torch.train.trainstep import make_score_fn


class WindowScorer:
    """Scores windows one at a time with ``params`` (a model module,
    moved to ``device``; default ``cuda``)."""

    def __init__(self, cfg: ModelConfig, params: torch.nn.Module, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = params.to(self.device)
        self.memory = None  # the temporal model's node memory (tgn only)
        if cfg.model == "tgn":
            self.memory = tgn.init_memory(cfg, cfg.tgn_max_nodes, device=self.device)
            self._tgn_step = tgn.make_step_fn(cfg)
            self._score_fn = self._tgn_score
        else:
            self._score_fn = make_score_fn(cfg, self.device)
        self.scored_batches = 0
        self.scored_edges = 0

    def _tgn_score(self, params, graph: dict) -> dict:
        with torch.inference_mode():
            out, self.memory = self._tgn_step(params, graph_to_torch(graph, self.device), self.memory)
        return out

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
