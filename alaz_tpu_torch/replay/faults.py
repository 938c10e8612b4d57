"""Fault injection for anomaly-detection evaluation.

The reference README's failure taxonomy (README.md:51-57 — the classes
Alaz's SaaS surfaces) is the label space:

- ``latency_spike`` — an edge's latencies multiply by ~10
- ``error_burst``   — a large fraction of an edge's responses go 5xx
- ``zombie``        — a service stops answering (requests marked failed,
  traffic collapses)

Faults are injected on *request rows* (post-aggregator, pre-window) for a
chosen set of edges over a window span; the oracle then labels aggregated
GraphBatch edges by (src_uid, dst_uid) membership, which is the ground
truth AUROC is computed against (BASELINE.json ≥0.9 gate).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Set, Tuple

import numpy as np

LATENCY_SPIKE = "latency_spike"
ERROR_BURST = "error_burst"
ZOMBIE = "zombie"

FAULT_KINDS = (LATENCY_SPIKE, ERROR_BURST, ZOMBIE)

# a ramped latency fault COUNTS as a spike once its multiplier crosses
# this (the labels flip here; below it the drift is a leading indicator
# the forecaster is allowed to see)
SPIKE_THRESHOLD = 4.0


@dataclass
class FaultPlan:
    """Which (from_uid, to_uid) edges are faulty, with what, and when.

    ``ramps`` makes a latency fault develop gradually instead of
    stepping: pair -> (onset_ms, span_ms, full_mult), multiplier ramping
    1 → full_mult linearly over [onset, onset+span]. Rows are labeled
    faulty only once the multiplier crosses SPIKE_THRESHOLD — the
    sub-threshold drift is the leading indicator that makes
    next-window forecasting (BASELINE config 4) a learnable task
    rather than clairvoyance."""

    # (from_uid_id, to_uid_id) -> fault kind
    edges: Dict[Tuple[int, int], str] = field(default_factory=dict)
    start_ms: int = 0
    end_ms: int = 1 << 62
    # (from_uid_id, to_uid_id) -> (onset_ms, span_ms, full_mult)
    ramps: Dict[Tuple[int, int], Tuple[int, int, float]] = field(default_factory=dict)

    def active(self, window_start_ms: int) -> bool:
        return self.start_ms <= window_start_ms < self.end_ms

    @property
    def edge_set(self) -> Set[Tuple[int, int]]:
        return set(self.edges)

    def ramp_multiplier(self, pair: Tuple[int, int], t_ms) -> np.ndarray:
        """Vectorized over t_ms; 1.0 outside the ramp's support."""
        onset, span, full = self.ramps[pair]
        u = np.clip((np.asarray(t_ms, np.float64) - onset) / max(span, 1), 0.0, 1.0)
        return 1.0 + (full - 1.0) * u


def make_ramp_plan(
    rng: np.random.Generator,
    edge_uid_pairs: List[Tuple[int, int]],
    fault_fraction: float = 0.15,
    onset_lo_ms: int = 0,
    onset_hi_ms: int = 1,
    span_ms: int = 4000,
    full_mult: float = 12.0,
) -> FaultPlan:
    """Latency faults that RAMP: each picked edge drifts 1x → full_mult
    over ``span_ms`` starting at a random onset in [onset_lo, onset_hi).
    The forecast scenario trains models to call the spike BEFORE the
    threshold crossing (replay/scenario.py run_forecast_scenario)."""
    n_faulty = max(1, int(len(edge_uid_pairs) * fault_fraction))
    pick = rng.choice(len(edge_uid_pairs), size=n_faulty, replace=False)
    plan = FaultPlan()
    for i in pick:
        pair = edge_uid_pairs[int(i)]
        plan.edges[pair] = LATENCY_SPIKE
        plan.ramps[pair] = (
            int(rng.integers(onset_lo_ms, max(onset_hi_ms, onset_lo_ms + 1))),
            int(span_ms),
            float(full_mult),
        )
    return plan


def make_plan(
    rng: np.random.Generator,
    edge_uid_pairs: List[Tuple[int, int]],
    fault_fraction: float = 0.15,
    kinds: tuple = FAULT_KINDS,
    start_ms: int = 0,
    end_ms: int = 1 << 62,
) -> FaultPlan:
    n_faulty = max(1, int(len(edge_uid_pairs) * fault_fraction))
    pick = rng.choice(len(edge_uid_pairs), size=n_faulty, replace=False)
    plan = FaultPlan(start_ms=start_ms, end_ms=end_ms)
    for i in pick:
        plan.edges[edge_uid_pairs[int(i)]] = kinds[int(rng.integers(0, len(kinds)))]
    return plan


def inject(rows: np.ndarray, plan: FaultPlan, rng: np.random.Generator) -> np.ndarray:
    """Mutate REQUEST_DTYPE rows in place per the plan; returns per-row
    0/1 labels (ground truth at request granularity)."""
    labels = np.zeros(rows.shape[0], dtype=np.float32)
    if not plan.edges:
        return labels
    if rows.shape[0] == 0:
        return labels
    active = plan.active(int(rows["start_time_ms"].min()))
    if not active:
        return labels
    pair = rows["from_uid"].astype(np.int64) << 32 | rows["to_uid"].astype(np.int64)
    for (fu, tu), kind in plan.edges.items():
        mask = pair == (np.int64(fu) << 32 | np.int64(tu))
        if not mask.any():
            continue
        idx = np.flatnonzero(mask)
        if (fu, tu) in plan.ramps:
            # ramped latency: per-row multiplier from the row's own time;
            # rows count as faulty only past the spike threshold
            m = plan.ramp_multiplier((fu, tu), rows["start_time_ms"][idx])
            rows["latency_ns"][idx] = (
                rows["latency_ns"][idx].astype(np.float64)
                * m * rng.uniform(0.9, 1.1, idx.shape[0])
            ).astype(np.uint64)
            labels[idx] = (m >= SPIKE_THRESHOLD).astype(np.float32)
            continue
        labels[mask] = 1.0
        if kind == LATENCY_SPIKE:
            rows["latency_ns"][idx] = (
                rows["latency_ns"][idx].astype(np.float64)
                * rng.uniform(8.0, 15.0, idx.shape[0])
            ).astype(np.uint64)
        elif kind == ERROR_BURST:
            hit = idx[rng.random(idx.shape[0]) < 0.8]
            rows["status_code"][hit] = 500
        elif kind == ZOMBIE:
            # service stops answering: requests fail, most traffic vanishes
            rows["completed"][idx] = False
            rows["status_code"][idx] = 0
    return labels


def drop_zombie_rows(rows: np.ndarray, labels: np.ndarray, plan: FaultPlan, rng: np.random.Generator, keep_frac: float = 0.1):
    """Zombie edges lose most of their traffic; apply after inject()."""
    if not plan.edges:
        return rows, labels
    pair = rows["from_uid"].astype(np.int64) << 32 | rows["to_uid"].astype(np.int64)
    drop = np.zeros(rows.shape[0], dtype=bool)
    for (fu, tu), kind in plan.edges.items():
        if kind != ZOMBIE:
            continue
        mask = pair == (np.int64(fu) << 32 | np.int64(tu))
        drop |= mask & (rng.random(rows.shape[0]) > keep_frac)
    return rows[~drop], labels[~drop]


def _pack_pairs(fu: np.ndarray, tu: np.ndarray) -> np.ndarray:
    return fu.astype(np.int64) << 32 | tu.astype(np.int64)


def label_batch_kinds(batch, plan: FaultPlan, kind_names: tuple = FAULT_KINDS) -> np.ndarray:
    """Per-edge fault KIND labels: 0 = clean, else 1 + index into
    ``kind_names``. Lets evaluation break AUROC out per failure class —
    a model that only catches error bursts must not hide behind a
    blended number. Plan kinds outside ``kind_names`` stay 0 here (the
    binary oracle still labels them faulty); vectorized with one np.isin
    pass per kind like label_batch_edges."""
    kinds = np.zeros(batch.e_pad, dtype=np.int32)
    if batch.node_uids is None or not plan.active(batch.window_start_ms) or not plan.edges:
        return kinds
    uids = batch.node_uids
    edge_keys = _pack_pairs(uids[batch.edge_src], uids[batch.edge_dst])
    spiking = set(_spiking_keys(plan, int(batch.window_end_ms)).tolist())
    for i, name in enumerate(kind_names):
        keys = np.array(
            [
                k
                for (fu, tu), kd in plan.edges.items()
                if kd == name and (k := int(fu) << 32 | int(tu)) in spiking
            ],
            dtype=np.int64,
        )
        if keys.size == 0:
            continue
        hit = np.isin(edge_keys, keys)
        hit[batch.n_edges :] = False
        kinds[hit] = i + 1
    return kinds


def _spiking_keys(plan: FaultPlan, at_ms: int) -> np.ndarray:
    """Packed keys of plan edges that count as FAULTY at ``at_ms``:
    non-ramped edges always (while the plan is active), ramped edges only
    once their multiplier has crossed SPIKE_THRESHOLD."""
    keys = []
    for (fu, tu) in plan.edges:
        if (fu, tu) in plan.ramps:
            if float(plan.ramp_multiplier((fu, tu), at_ms)) < SPIKE_THRESHOLD:
                continue
        keys.append(int(fu) << 32 | int(tu))
    return np.array(keys, dtype=np.int64)


def label_batch_edges(batch, plan: FaultPlan, at_ms: int | None = None) -> np.ndarray:
    """Oracle labels for an aggregated GraphBatch: edge is faulty iff its
    (src_uid, dst_uid) is in the plan and the window overlaps the span —
    for RAMPED edges, iff the multiplier has crossed SPIKE_THRESHOLD by
    ``at_ms`` (default: the window's END, the end-of-window state).
    Passing a future ``at_ms`` (e.g. next window's end) yields the
    forecast target: what this edge's label WILL be. Vectorized via the
    same packed int64 pair key inject() matches on."""
    labels = np.zeros(batch.e_pad, dtype=np.float32)
    if batch.node_uids is None or not plan.active(batch.window_start_ms) or not plan.edges:
        return labels
    t = int(at_ms) if at_ms is not None else int(batch.window_end_ms)
    plan_keys = _spiking_keys(plan, t)
    if plan_keys.size == 0:
        return labels
    uids = batch.node_uids
    edge_keys = _pack_pairs(uids[batch.edge_src], uids[batch.edge_dst])
    hit = np.isin(edge_keys, plan_keys)
    hit[batch.n_edges :] = False
    labels[hit] = 1.0
    return labels
