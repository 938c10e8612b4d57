"""Score-plane observability (ISSUE 13): streaming score-distribution
sketches, drift detection, and top-K anomaly attribution.

PR 9 explained the pipeline's latency and PR 10 opened the device black
box, but the system's *product* — the anomaly scores — was still
unobserved: nothing watched score distributions in production, noticed a
model/topology change moving them, or could answer "why did node X score
0.97". This module is the third leg of the observability plane:

- **Streaming distribution sketches.** Every scored window's edge scores
  fold into a per-model mergeable sketch: the lock-striped
  :class:`~alaz_tpu.obs.histogram.Histogram` ladder remapped to [0,1]
  score space (:data:`SCORE_BOUNDS` — factor-2 log-odds rungs, fine at
  BOTH tails, where anomaly mass lives). One ``searchsorted`` +
  ``bincount`` per window buckets the whole vector; the same count
  vector then feeds the sketch (``Histogram.add_counts``) AND the drift
  compare, so the two can never disagree about what the window looked
  like. Per-window summary gauges (mean/p99/max score, scored-node
  count) ride next to the sketch on ``/metrics`` and ``/scores``.

- **Drift detection** (:class:`DriftDetector`). A rolling reference —
  the trailing K windows' bucket counts — is compared against each new
  window via PSI and L∞-on-CDF, with hysteresis on both edges (enter
  needs ``hysteresis`` consecutive over-threshold windows, exit needs
  the same run under HALF the threshold — a window hovering at the
  line cannot flap the state). Deploy-rollout-shaped node-table churn
  (a large fraction of the previous window's ACTIVE uids vanishing)
  **rebaselines** instead of alarming: the reference resets and refills
  before comparisons resume. The reference is trailing, so a sustained
  regime change pages for ~K windows and then becomes the new baseline
  (page-then-adapt). Flips and rebaselines land in the FlightRecorder
  and on the ``scores.drift_state`` gauge.

- **Top-K anomaly attribution.** Per window, the K highest-scoring
  nodes (node score = max over its in-edge scores — the dst-major
  aggregates assembly already produced) are kept in a bounded ledger
  with their feature z-scores against the window's ACTIVE-node
  population and their top contributing in-edges (src, protocol,
  score, request count, error rate). Bounded by construction — K nodes
  × E edges × W windows, never a per-node metric series — served at
  ``/scores/top`` and attached to scenario drift-gate failures.

Cost discipline (the ≤2 % ``score_plane_overhead_pct`` bench bound):
every observation is one vectorized pass per **window**, never per-row
Python; the only lock is the plane's own, once per window.

:func:`feature_scores` is the deterministic feature-space scorer the
scenario drift gates and the bench A/B share: a fixed logistic read of
the aggregated edge stats (error rates dominant, latency and volume
secondary), so scores move iff the windowed stats move — no trained
model needed to prove the drift machinery end to end on CPU.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Deque, List, Optional

import numpy as np

from alaz_tpu_torch.obs.histogram import Histogram

# ---------------------------------------------------------------------------
# The score-space ladder: the Histogram contract (fixed shared bounds →
# merge is vector addition) remapped to [0,1]. Factor-2 rungs from 1e-4
# up to 0.4096, a 0.5 midpoint, then the mirror approaching 1 — log-odds
# resolution at both tails, where "almost surely fine" and "almost
# surely anomalous" mass concentrates. 28 bounds + overflow.
# ---------------------------------------------------------------------------

_TAIL = tuple(1e-4 * (2.0**i) for i in range(13))  # 1e-4 .. 0.4096
SCORE_BOUNDS = (
    _TAIL + (0.5,) + tuple(round(1.0 - b, 10) for b in reversed(_TAIL)) + (1.0,)
)
N_SCORE_BUCKETS = len(SCORE_BOUNDS) + 1

_BOUNDS_F8 = np.asarray(SCORE_BOUNDS, dtype=np.float64)

# Bucketing is the plane's hottest op (once per edge score per window),
# and np.searchsorted pays ~17ns/element of generic binary-search
# overhead. The ladder is FIXED, so bucket lookup is a uniform
# quantization table instead: cell = floor(score * 65536), bucket =
# table[cell] — one multiply, one cast, one gather. Cells that contain
# a ladder rung (or neighbor one — the float32 multiply can land a
# value one cell over at a cell edge) are marked ambiguous and fall
# back to exact searchsorted for just those elements, so the result is
# bit-identical to bisect_left for EVERY input (the parity test sweeps
# the rungs and their float neighborhoods).
_CELL_BITS = 16
_N_CELLS = 1 << _CELL_BITS


def _build_cell_tables():
    edges = np.arange(_N_CELLS + 1, dtype=np.float64) / _N_CELLS
    lo = np.searchsorted(_BOUNDS_F8, edges[:-1], side="left")
    hi = np.searchsorted(
        _BOUNDS_F8, np.nextafter(edges[1:], -1.0), side="left"
    )
    amb = lo != hi
    amb = amb | np.roll(amb, 1) | np.roll(amb, -1)
    return lo.astype(np.intp), amb


_CELL_TABLE, _CELL_AMBIGUOUS = _build_cell_tables()


def score_bucket_counts(scores: np.ndarray) -> np.ndarray:
    """One window's scores → per-bucket counts on the score ladder;
    exactly ``bisect_left(SCORE_BOUNDS, v)`` per value (what
    ``Histogram.observe`` computes) for v in the score domain [0, 1],
    via the quantization table above. Out-of-domain values clamp into
    the end buckets — score space is closed, the overflow bucket of the
    generic Histogram ladder is dead weight here."""
    if scores.size == 0:
        return np.zeros(N_SCORE_BUCKETS, dtype=np.intp)
    q = np.clip((scores * _N_CELLS).astype(np.intp), 0, _N_CELLS - 1)
    idx = _CELL_TABLE[q]
    amb = _CELL_AMBIGUOUS[q]
    if amb.any():
        idx[amb] = np.searchsorted(
            _BOUNDS_F8, scores[amb].astype(np.float64), side="left"
        )
    return np.bincount(idx, minlength=N_SCORE_BUCKETS)


# ---------------------------------------------------------------------------
# Distribution distance: PSI + L∞-on-CDF over the shared ladder.
# ---------------------------------------------------------------------------


def psi(
    ref_counts: np.ndarray, cur_counts: np.ndarray, floor: float = 5e-3
) -> float:
    """Population stability index between two count vectors on the same
    ladder. Proportions are FLOORED (the standard PSI smoothing), not
    epsilon-added: a tiny epsilon lets a 2% sliver of mass opposite an
    empty bucket contribute ``0.02·ln(0.02/1e-7) ≈ 0.25`` — a full
    alarm threshold of phantom drift from one straggler bucket, exactly
    the noise small service-map windows (tens of edges) produce. With
    the floor, an absent-vs-2% bucket costs ~0.03 and real regime
    shifts (half the mass moving rungs) still score ≥1."""
    ref = np.asarray(ref_counts, dtype=np.float64)
    cur = np.asarray(cur_counts, dtype=np.float64)
    rt, ct = ref.sum(), cur.sum()
    if rt <= 0 or ct <= 0:
        return 0.0
    p = np.maximum(ref / rt, floor)
    q = np.maximum(cur / ct, floor)
    return float(np.sum((q - p) * np.log(q / p)))


def cdf_linf(ref_counts: np.ndarray, cur_counts: np.ndarray) -> float:
    """L∞ distance between the two empirical CDFs on the shared ladder
    (the Kolmogorov–Smirnov statistic at bucket resolution): catches a
    mass SHIFT that PSI's per-bucket terms understate when the mass
    slides across many adjacent rungs."""
    ref = np.asarray(ref_counts, dtype=np.float64)
    cur = np.asarray(cur_counts, dtype=np.float64)
    rt, ct = ref.sum(), cur.sum()
    if rt <= 0 or ct <= 0:
        return 0.0
    return float(np.abs(np.cumsum(ref) / rt - np.cumsum(cur) / ct).max())


STABLE, DRIFTED = 0, 1


class DriftDetector:
    """Rolling-reference drift state machine (see module docstring).

    NOT internally locked: the owning :class:`ScorePlane` serializes
    every call under its plane lock (one update per window)."""

    def __init__(
        self,
        window: int = 8,
        enter_psi: float = 0.25,
        enter_ks: float = 0.2,
        hysteresis: int = 2,
        min_ref: Optional[int] = None,
        exit_frac: float = 0.5,
    ):
        self.window = max(1, int(window))
        self.enter_psi = float(enter_psi)
        self.enter_ks = float(enter_ks)
        self.hysteresis = max(1, int(hysteresis))
        # windows the reference must hold before comparisons start (a
        # fresh or just-rebaselined plane accumulates, never judges)
        self.min_ref = self.window if min_ref is None else max(1, int(min_ref))
        self.exit_frac = float(exit_frac)
        self._ref: Deque[np.ndarray] = deque(maxlen=self.window)
        self.state = STABLE
        self.flips = 0  # stable→drifted transitions
        self.rebaselines = 0
        self.compared = 0
        self.last_psi = 0.0
        self.last_ks = 0.0
        self._over = 0  # consecutive over-threshold windows
        self._under = 0  # consecutive under-exit windows

    @property
    def reference_windows(self) -> int:
        return len(self._ref)

    def rebaseline(self) -> None:
        """Reset the reference (deploy-rollout-shaped churn): the new
        regime accumulates ``min_ref`` windows before judging resumes,
        and the state returns to stable with clean hysteresis counters."""
        self._ref.clear()
        self.rebaselines += 1
        self.state = STABLE
        self._over = self._under = 0

    def update(self, counts: np.ndarray) -> dict:
        """Fold one window in; returns {psi, ks, state, flipped,
        compared} where ``flipped`` is None / "drifted" / "stable"."""
        flipped = None
        compared = False
        if len(self._ref) >= self.min_ref:
            ref = np.sum(np.stack(list(self._ref)), axis=0)
            self.last_psi = psi(ref, counts)
            self.last_ks = cdf_linf(ref, counts)
            self.compared += 1
            compared = True
            over = self.last_psi > self.enter_psi or self.last_ks > self.enter_ks
            under = (
                self.last_psi < self.enter_psi * self.exit_frac
                and self.last_ks < self.enter_ks * self.exit_frac
            )
            if self.state == STABLE:
                self._over = self._over + 1 if over else 0
                if self._over >= self.hysteresis:
                    self.state = DRIFTED
                    self.flips += 1
                    flipped = "drifted"
                    self._over = 0
            else:
                self._under = self._under + 1 if under else 0
                if self._under >= self.hysteresis:
                    self.state = STABLE
                    flipped = "stable"
                    self._under = 0
        self._ref.append(np.asarray(counts, dtype=np.int64))
        return {
            "psi": self.last_psi,
            "ks": self.last_ks,
            "state": self.state,
            "flipped": flipped,
            "compared": compared,
        }


# ---------------------------------------------------------------------------
# Attribution vocabulary: the node-feature stat columns `_assemble`
# writes (graph/builder.py), named so a /scores/top reader doesn't need
# the builder source open to know what z=+38 on `in_count` means.
# ---------------------------------------------------------------------------

NODE_STAT_COLS = {
    "out_count": 4,
    "in_count": 5,
    "out_err_rate": 6,
    "in_err_rate": 7,
    "out_latency": 8,
    "in_latency": 9,
    "out_degree": 10,
    "in_degree": 11,
}


def feature_logits(edge_feats: np.ndarray) -> np.ndarray:
    """The fixed feature-space read in LOGIT form, vectorized over any
    leading shape — the ONE definition of the deterministic scorer's
    weights. :func:`feature_scores` is its sigmoid; the tenancy replay
    harness (replay/tenants.py) drives the service scorer loop with
    this directly, so the per-tenant planes see EXACTLY the
    feature_scores distribution by construction."""
    ef = np.asarray(edge_feats)
    return (
        6.0 * ef[..., 3]  # 5xx/error rate
        + 3.0 * ef[..., 4]  # 4xx rate
        + 2.0 * ef[..., 1]  # log mean latency (scaled /20 by assembly)
        + 0.5 * ef[..., 0]  # log1p request count
        - 4.0
    ).astype(np.float32)


def feature_scores(batch) -> np.ndarray:
    """The deterministic feature-space scorer the scenario drift gates
    and the bench A/B share: a FIXED logistic read of the aggregated
    edge features (5xx rate dominant, 4xx and latency secondary, volume
    mild) — a pure function of the windowed stats, so the score
    distribution moves iff the stats move, with no trained model (and no
    accelerator) in the loop. NOT a detection model: the real models
    score the service, this scores the *plane*."""
    z = feature_logits(batch.edge_feats[: batch.n_edges])
    return (1.0 / (1.0 + np.exp(-z))).astype(np.float32)


class ScorePlane:
    """The score-plane accountant for one scorer (see module docstring).

    ``metrics``: a runtime ``Metrics`` registry — the per-model sketch
    registers sparse as ``scores.dist.<model>`` (absent from the scrape
    until the first scored window), the summary/drift gauges and the
    ``scores.*`` counters register eagerly. ``enabled=False`` registers
    NOTHING and short-circuits every observe at the first branch (the
    SCORE_TRACE_ENABLED kill switch + the absent-not-zero discipline: a
    killed plane must be absent from the scrape, not render
    ``scores.drift_state 0`` as if it were watching).

    ``resolve``: optional uid→string resolver (the service passes
    ``interner.lookup``) so the attribution ledger carries names, not
    interned ids. One scorer thread writes; ``/scores`` handlers read —
    all mutable state sits under the plane lock, once per window.
    """

    def __init__(
        self,
        metrics=None,
        recorder=None,
        enabled: bool = True,
        model: str = "default",
        drift_windows: int = 8,
        top_k: int = 10,
        top_edges: int = 3,
        ledger_windows: int = 32,
        enter_psi: float = 0.25,
        enter_ks: float = 0.2,
        hysteresis: int = 2,
        min_ref: Optional[int] = None,
        rebaseline_frac: float = 0.25,
        resolve: Optional[Callable[[int], str]] = None,
        metric_suffix: str = "",
    ):
        self.enabled = bool(enabled)
        self.metrics = metrics if self.enabled else None
        self.recorder = recorder
        self.model = str(model) or "default"
        # tenancy: a per-tenant plane registers every series
        # under its own ``.t<k>`` suffix so K planes on one registry
        # never share a gauge/counter instance (same-name registration
        # returns the existing object — K unsuffixed planes would
        # silently sum their counters and last-write their gauges). ""
        # keeps the single-tenant names bit-for-bit.
        self._suffix = str(metric_suffix)
        self.top_k = max(0, int(top_k))
        self.top_edges = max(1, int(top_edges))
        self.rebaseline_frac = float(rebaseline_frac)
        self.resolve = resolve
        self._lock = threading.Lock()
        self._drift = DriftDetector(  # guarded-by: self._lock
            window=drift_windows,
            enter_psi=enter_psi,
            enter_ks=enter_ks,
            hysteresis=hysteresis,
            min_ref=min_ref,
        )
        # bounded attribution ring: K nodes × top_edges in-edges per
        # entry, last `ledger_windows` windows — never a per-node series
        self._ledger: Deque[dict] = deque(  # guarded-by: self._lock
            maxlen=max(1, int(ledger_windows))
        )
        self._prev_uids: Optional[np.ndarray] = None  # guarded-by: self._lock
        self.windows = 0  # guarded-by: self._lock
        self._last: dict = {}  # last-window summary  # guarded-by: self._lock
        if self.metrics is not None:
            # sparse: the sketch is absent from /metrics and snapshot
            # until the first scored window (the empty-series rule)
            self.hist = self.metrics.histogram(
                f"scores.dist.{self.model}{self._suffix}",
                sparse=True,
                bounds=SCORE_BOUNDS,
            )
            self._c_windows = self.metrics.counter(f"scores.windows{self._suffix}")
            self._c_drift = self.metrics.counter(
                f"scores.drift_events{self._suffix}"
            )
            self._c_rebase = self.metrics.counter(
                f"scores.rebaselines{self._suffix}"
            )
            # set-style gauges (no callbacks): the registry never calls
            # back into the plane, so no lock-order edge toward the
            # plane lock can form (the device plane's ABBA lesson)
            self._g_mean = self.metrics.gauge(f"scores.window_mean{self._suffix}")
            self._g_p99 = self.metrics.gauge(f"scores.window_p99{self._suffix}")
            self._g_max = self.metrics.gauge(f"scores.window_max{self._suffix}")
            self._g_nodes = self.metrics.gauge(
                f"scores.scored_nodes{self._suffix}"
            )
            self._g_state = self.metrics.gauge(f"scores.drift_state{self._suffix}")
            self._g_psi = self.metrics.gauge(f"scores.drift_psi{self._suffix}")
            self._g_ks = self.metrics.gauge(f"scores.drift_ks{self._suffix}")
        else:
            self.hist = Histogram(
                f"scores.dist.{self.model}{self._suffix}", bounds=SCORE_BOUNDS
            )
            self._c_windows = self._c_drift = self._c_rebase = None
            self._g_mean = self._g_p99 = self._g_max = None
            self._g_nodes = self._g_state = self._g_psi = self._g_ks = None

    # -- per-window observe (the scorer thread's one call) -------------------

    def observe_window(self, batch, scores: np.ndarray) -> None:
        """Fold one scored window in: sketch + summary + drift compare +
        attribution. ``scores`` are the window's REAL-edge scores in
        [0,1] (the sigmoid the export leg also reads), length
        ``batch.n_edges``."""
        if not self.enabled:
            return
        scores = np.asarray(scores)
        n = int(scores.shape[0])
        # cost discipline: everything below is O(E) vectorized with no
        # sort — counts via one searchsorted+bincount, the summary p99
        # straight from those counts (sketch resolution — np.quantile's
        # per-window sort was the plane's single biggest cost), active
        # nodes via degree bincounts instead of unique's sort
        counts = score_bucket_counts(scores)
        vsum = float(scores.sum(dtype=np.float64))
        if n:
            mean = vsum / n
            p99 = self.hist._percentile_from(counts, n, 0.99)
            mx = float(scores.max())
        else:
            mean = p99 = mx = 0.0
        # active nodes = endpoints touched by this window's edges: the
        # NodeTable is cumulative across windows, so churn/attribution
        # must read the window's live population, not the table
        if n:
            deg = np.bincount(batch.edge_src[:n], minlength=batch.n_pad)
            deg += np.bincount(batch.edge_dst[:n], minlength=batch.n_pad)
            active = np.flatnonzero(deg)
        else:
            active = np.empty(0, dtype=np.int64)
        if batch.node_uids is not None and active.size:
            # slot↔uid is bijective in the NodeTable, so the gather of
            # unique slots is already a unique uid set — no sort needed
            uids = batch.node_uids[active]
        else:
            uids = active
        entry = self._attribution(batch, scores, active) if self.top_k else None

        with self._lock:
            self.windows += 1
            rebased = False
            churn = 0.0
            if self._prev_uids is not None and self._prev_uids.size and uids.size:
                # disappearance, not addition: a rollout REPLACES nodes
                # (old uids vanish → rebaseline); a hot key / dns storm
                # ADDS nodes while the old ones keep talking (→ the
                # distribution compare stays armed and may page)
                churn = 1.0 - float(
                    np.isin(self._prev_uids, uids, assume_unique=True).mean()
                )
                if churn >= self.rebaseline_frac:
                    self._drift.rebaseline()
                    rebased = True
            if uids.size:
                # an EMPTY window (traffic gap) must not become the
                # churn baseline: a rollout separated from the old
                # regime by one idle window would then never compare
                # old-vs-new uids and would page as drift instead of
                # rebaselining (review-caught; regression-tested)
                self._prev_uids = uids
            d = self._drift.update(counts)
            if entry is not None:
                self._ledger.append(entry)
            self._last = {
                "window_start_ms": int(batch.window_start_ms),
                "scored_edges": n,
                "scored_nodes": int(active.size),
                "mean": round(mean, 4),
                "p99": round(p99, 4),
                "max": round(mx, 4),
            }

        # sketch + metric/recorder feeds run OUTSIDE the plane lock (the
        # histogram has its own stripe locks, the recorder its ring lock)
        self.hist.add_counts(counts.tolist(), vsum)
        if self.metrics is not None:
            self._c_windows.inc()
            self._g_mean.set(mean)
            self._g_p99.set(p99)
            self._g_max.set(mx)
            self._g_nodes.set(float(active.size))
            self._g_state.set(float(d["state"]))
            self._g_psi.set(d["psi"])
            self._g_ks.set(d["ks"])
            if rebased:
                self._c_rebase.inc()
            if d["flipped"] == "drifted":
                self._c_drift.inc()
        if self.recorder is not None:
            if rebased:
                self.recorder.record(
                    "score_rebaseline",
                    window_start_ms=int(batch.window_start_ms),
                    churn=round(churn, 4),
                )
            if d["flipped"] is not None:
                self.recorder.record(
                    "score_drift",
                    window_start_ms=int(batch.window_start_ms),
                    state=("drifted" if d["state"] == DRIFTED else "stable"),
                    psi=round(d["psi"], 4),
                    ks=round(d["ks"], 4),
                )

    # ONE bookkeeper for the drift events: the detector's own counters
    # (a plane-side copy incremented next to them would desynchronize
    # the moment any path touches the detector directly)

    @property
    def drift_events(self) -> int:
        """Stable→drifted flips observed (the scenario-gate count)."""
        with self._lock:
            return self._drift.flips

    @property
    def rebaselines(self) -> int:
        with self._lock:
            return self._drift.rebaselines

    # -- attribution ---------------------------------------------------------

    def _node_name(self, batch, slot: int):
        if batch.node_uids is None:
            return int(slot)
        uid = int(batch.node_uids[slot])
        if self.resolve is not None:
            try:
                return self.resolve(uid)
            except Exception:
                return uid
        return uid

    def _attribution(self, batch, scores: np.ndarray, active: np.ndarray) -> dict:
        """One window's top-K ledger entry: K highest-scoring nodes
        (node score = max in-edge score over the dst-major aggregates),
        feature z-scores vs the window's ACTIVE population, top
        contributing in-edges. Bounded: K × top_edges, whatever the
        fan-in (the 500k hot-key test pins this)."""
        n = int(scores.shape[0])
        entry = {
            "window_start_ms": int(batch.window_start_ms),
            "scored_edges": n,
            "scored_nodes": int(active.size),
            "nodes": [],
        }
        if n == 0 or active.size == 0:
            return entry
        e_dst = batch.edge_dst[:n]
        # node score = max over in-edge scores. The builder emits edges
        # DST-MAJOR sorted, so each node's in-edges are one contiguous
        # run: per-dst maxes are a single O(E) reduceat and a node's run
        # is two binary searches — no per-node full-array masks, no
        # ufunc.at. Hand-built unsorted batches take the general path.
        d = np.diff(e_dst)
        if not np.any(d < 0):
            starts = np.concatenate(([0], np.flatnonzero(d > 0) + 1))
            uniq_dst = e_dst[starts]
            dst_max = np.maximum.reduceat(scores, starts)
            ends = np.concatenate((starts[1:], [n]))
        else:
            node_score = np.zeros(batch.n_pad, dtype=np.float64)
            np.maximum.at(node_score, e_dst, scores)
            uniq_dst = np.flatnonzero(node_score > 0.0)
            dst_max = node_score[uniq_dst]
            starts = ends = None
        k = min(self.top_k, int(uniq_dst.size))
        sel_k = np.argpartition(dst_max, -k)[-k:]
        sel_k = sel_k[np.argsort(-dst_max[sel_k], kind="stable")]
        feats = batch.node_feats[active]
        mu = feats.mean(axis=0)
        sd = feats.std(axis=0)
        sd = np.where(sd > 1e-9, sd, 1.0)
        from alaz_tpu_torch.events.schema import _PROTOCOL_NAMES as proto_names

        nodes: List[dict] = []
        for j in sel_k:
            slot = int(uniq_dst[j])
            s = float(dst_max[j])
            if s <= 0.0:
                continue  # a node with no scored in-edge explains nothing
            z = np.round((batch.node_feats[slot] - mu) / sd, 2)
            if starts is not None:
                idx = np.arange(starts[j], ends[j])
            else:
                idx = np.flatnonzero(e_dst == slot)
            if idx.size > self.top_edges:
                sel = idx[np.argpartition(scores[idx], -self.top_edges)[-self.top_edges:]]
            else:
                sel = idx
            sel = sel[np.argsort(-scores[sel], kind="stable")]
            edges = [
                {
                    "src": self._node_name(batch, int(batch.edge_src[i])),
                    "proto": proto_names[int(batch.edge_type[i]) % len(proto_names)],
                    "score": round(float(scores[i]), 4),
                    "requests": int(round(float(np.expm1(batch.edge_feats[i, 0])))),
                    "err_rate": round(float(batch.edge_feats[i, 3]), 4),
                }
                for i in sel
            ]
            nodes.append(
                {
                    "uid": self._node_name(batch, int(slot)),
                    "score": round(s, 4),
                    "in_edges_seen": int(idx.size),
                    "z": {
                        name: float(z[col])
                        for name, col in NODE_STAT_COLS.items()
                    },
                    "top_in_edges": edges,
                }
            )
        entry["nodes"] = nodes
        return entry

    # -- read side (the /scores surfaces) ------------------------------------

    def snapshot(self) -> dict:
        """The ``/scores`` payload: sketch percentiles, last-window
        summary, drift state — bounded, no per-node data (that is
        ``top_snapshot``'s job)."""
        with self._lock:
            out = {
                "model": self.model,
                "windows": self.windows,
                "last_window": dict(self._last),
                "drift": {
                    "state": "drifted" if self._drift.state == DRIFTED else "stable",
                    "psi": round(self._drift.last_psi, 4),
                    "ks": round(self._drift.last_ks, 4),
                    # the detector's own counters — read directly here
                    # (the public properties re-take the plane lock)
                    "events": self._drift.flips,
                    "rebaselines": self._drift.rebaselines,
                    "reference_windows": self._drift.reference_windows,
                    "compared": self._drift.compared,
                },
            }
        snap = self.hist.snapshot()  # stripe locks, outside the plane lock
        out["dist"] = {
            "count": snap["count"],
            "p50": round(snap["p50"], 4),
            "p95": round(snap["p95"], 4),
            "p99": round(snap["p99"], 4),
        }
        return out

    def top_snapshot(self, windows: int = 1) -> List[dict]:
        """The ``/scores/top`` payload: the newest ``windows`` ledger
        entries, newest first. Bounded by the ring size however large
        the ask."""
        w = max(0, int(windows))
        with self._lock:
            entries = list(self._ledger)[-w:] if w else []
        return list(reversed(entries))
