"""Eval metrics: AUROC by the rank statistic (Mann-Whitney U), on the
host in numpy. A copy of the JAX package's ``train/metrics.py``; the
BASELINE.json quality gate is AUROC ≥ 0.9 on injected-fault graphs."""

from __future__ import annotations

import numpy as np


def auroc(scores: np.ndarray, labels: np.ndarray, mask: np.ndarray | None = None) -> float:
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels) > 0.5
    if mask is not None:
        keep = np.asarray(mask, dtype=bool)
        scores, labels = scores[keep], labels[keep]
    n_pos = int(labels.sum())
    n_neg = labels.shape[0] - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="stable")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, scores.shape[0] + 1)
    # midranks for ties
    sorted_scores = scores[order]
    i = 0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        if j > i:
            ranks[order[i : j + 1]] = (i + j + 2) / 2.0
        i = j + 1
    u = ranks[labels].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def auroc_by_kind(
    scores: np.ndarray,
    kind_labels: np.ndarray,
    kind_names: tuple,
    mask: np.ndarray | None = None,
) -> dict:
    """Per-failure-class AUROC: each kind k scored one-vs-clean (edges of
    other fault kinds excluded, so classes do not dilute each other).
    ``kind_labels``: 0 = clean, else 1 + the index into ``kind_names``.
    NaN for kinds absent from the eval set."""
    scores = np.asarray(scores, dtype=np.float64)
    kinds = np.asarray(kind_labels)
    keep = np.ones(scores.shape[0], bool) if mask is None else np.asarray(mask, bool)
    out = {}
    for i, name in enumerate(kind_names):
        sel = keep & ((kinds == 0) | (kinds == i + 1))
        out[name] = auroc(scores[sel], (kinds[sel] == i + 1).astype(np.float32))
    return out
