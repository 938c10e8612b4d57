"""Device-side observability plane (ISSUE 11): per-bucket score
telemetry, staging decomposition, occupancy/padding accounting, and the
always-on compile event plane.

PR 9 gave the host plane per-stage attribution, but the two
device-facing span stages stayed single opaque numbers: ``stage`` mixed
host array prep with the host→device transfer, and ``score`` summed
every shape bucket into one histogram. Every ROADMAP north-star item
(Pallas fused-aggregation kernels, mixed-precision scoring arms,
multi-tenant continuous batching) needs its win attributed *per kernel,
per bucket* before it can be claimed — FeatGraph and the GNN-aggregation
architecture studies (PAPERS.md) both show accelerator aggregation cost
is dominated by layout/occupancy effects invisible without that
resolution. This module opens the box:

- :class:`DeviceTelemetry` — the staging/scoring accountant:

  * ``stage`` decomposes into **arena** (host array prep / arena fill)
    vs **transfer** (``jnp.asarray`` dispatch) histograms
    (``latency.stage_arena_s`` / ``latency.stage_transfer_s``) plus a
    cumulative ``device.transfer_bytes`` ledger;
  * ``score`` feeds a **per-bucket** labeled histogram
    (``latency.score_s.<bucket>``, bucket = ``n<N_pad>xe<E_pad>``) next
    to the span plane's aggregate, so a regression in ONE bucket can't
    hide inside the fleet p99;
  * **occupancy accounting at staging time**: every staged window
    observes ``rows / bucket capacity`` into ``device.occupancy.<bucket>``
    and accumulates real vs padded edge slots — the
    ``device.pad_waste_pct`` gauge is the TPU-native efficiency number
    the bucketed-CSR/Pallas work will be judged by.

- :class:`CompileEventPlane` — sanitize's ``CompileWatcher`` promoted
  from test fixture to production hookup: XLA compile events (traced-fn
  name, shape bucket, duration) count into ``compile.*`` metrics and
  land in the :class:`~alaz_tpu.obs.recorder.FlightRecorder`, so a
  steady-state retrace shows up on ``/metrics`` and in crash dumps
  instead of only under ``make sanitize``. The scorer thread tags the
  current bucket through a thread-local context, which is exact because
  XLA compiles synchronously on the dispatching thread.

Cost discipline (the ≤2 % bench bound): every observation here is per
**window × dispatch**, never per row or per edge; per-bucket series are
created lazily on first observation and registered *sparse* — a bucket
with zero observations is omitted from ``/metrics`` and the snapshot,
never rendered as an empty series.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Optional

from alaz_tpu_torch.obs.histogram import Histogram


def bucket_key(batch) -> str:
    """The bucket label a GraphBatch scores under: its padded (node,
    edge) capacities — exactly the pair that keys the jit cache, so one
    label == one compiled program shape. Delegates to
    ``GraphBatch.bucket_key`` (graph/snapshot.py), the one definition."""
    return batch.bucket_key


def pad_waste_pct_from(real_slots: int, pad_slots: int) -> float:
    """THE pad-waste definition: percentage of edge slots that are pad,
    not data; 0.0 on empty (vacuously efficient, never NaN). Every
    surface that publishes pad waste — the device gauge, the builder's
    host-side counters (bench), the chaos harness — computes through
    here, so the formula cannot drift between `/stats` and the bench."""
    total = real_slots + pad_slots
    return 100.0 * pad_slots / total if total else 0.0


def batch_pad_waste_pct(batches) -> float:
    """Padding waste over a set of emitted batches (the chaos-harness
    form of :func:`pad_waste_pct_from`)."""
    real = sum(int(b.n_edges) for b in batches)
    slots = sum(int(b.e_pad) for b in batches)
    return pad_waste_pct_from(real, slots - real)


def blocked_pad_waste_pct_from(real_slots: int, block_slots: int) -> float:
    """The blocked layout's waste through the SAME definition: under
    ``EDGE_LAYOUT=blocked`` the aggregation paths process the per-block
    tile slots (graph/snapshot.blocked_edge_slots_from), not the bucket
    rung, so waste = the tile slots that aren't real edges. Feeding
    :func:`pad_waste_pct_from` keeps the two layouts' numbers directly
    comparable — same formula, different slot denominator (ISSUE 20)."""
    return pad_waste_pct_from(real_slots, max(block_slots - real_slots, 0))


# occupancy is a LINEAR 0..1 ratio, not a latency: on the default 2x
# geometric ladder a 55% and a 100% window land in the same bucket and
# interpolation can report >100%. A 5%-step linear ladder gives
# percentiles within 5 points and caps at exactly 1.0 — occupancy
# histograms merge only with like-bounded peers (the Histogram merge
# contract), which per-bucket series never need to violate.
OCCUPANCY_BOUNDS = tuple(round(0.05 * i, 2) for i in range(1, 21))


class _BucketStats:
    """Per-bucket telemetry cell: score latency + occupancy histograms
    and exact staged/scored counters. ``block_fill_hist`` is created
    lazily on the first BLOCKED window (the batch shipped extents) —
    a COO-only deployment never registers the series (sparse, absent
    not zero)."""

    __slots__ = ("score_hist", "occupancy_hist", "block_fill_hist",
                 "staged", "scored")

    def __init__(self, score_hist: Histogram, occupancy_hist: Histogram):
        self.score_hist = score_hist
        self.occupancy_hist = occupancy_hist
        self.block_fill_hist: Optional[Histogram] = None
        self.staged = 0  # windows staged (occupancy observations)
        self.scored = 0  # windows scored (score_hist observations)


class DeviceTelemetry:
    """Staging/scoring accountant for one scorer (see module docstring).

    ``metrics``: a runtime ``Metrics`` registry — per-bucket histograms
    register sparse as ``latency.score_s.<bucket>`` /
    ``device.occupancy.<bucket>``; the decomposition histograms and the
    ``device.*`` gauges register eagerly. ``metrics=None`` (tests,
    host-only pipelines) keeps private histograms.

    ``enabled=False`` short-circuits every observe at the first branch —
    the DEVICE_TRACE_ENABLED kill switch.
    """

    def __init__(self, metrics=None, recorder=None, enabled: bool = True):
        self.enabled = enabled
        self.metrics = metrics
        self.recorder = recorder
        self._lock = threading.Lock()
        self._buckets: Dict[str, _BucketStats] = {}  # guarded-by: self._lock
        # exact cumulative accounting (edge slots, not rows-of-bytes):
        # pad_waste_pct = padded / (staged + padded) — the gauges read
        # these, so a scrape mid-window is off by at most one window
        self.staged_windows = 0  # guarded-by: self._lock
        self.staged_edges = 0  # real (masked-in) edge slots  # guarded-by: self._lock
        self.padded_edge_slots = 0  # pad tail slots  # guarded-by: self._lock
        self.transfer_bytes = 0  # host→device bytes dispatched  # guarded-by: self._lock
        # blocked-layout twin ledger: real edges vs the tile
        # slots the blocked reduce touches, accumulated only for windows
        # that shipped extents — a COO deployment leaves both at 0
        self.blocked_staged_edges = 0  # guarded-by: self._lock
        self.blocked_edge_slots = 0  # tile slots  # guarded-by: self._lock
        if metrics is not None and enabled:
            self.arena_hist = metrics.histogram("latency.stage_arena_s")
            self.transfer_hist = metrics.histogram("latency.stage_transfer_s")
            metrics.gauge("device.transfer_bytes", lambda: self.transfer_bytes)
            metrics.gauge("device.staged_windows", lambda: self.staged_windows)
            metrics.gauge("device.staged_edges", lambda: self.staged_edges)
            metrics.gauge(
                "device.padded_edge_slots", lambda: self.padded_edge_slots
            )
            metrics.gauge("device.pad_waste_pct", lambda: self.pad_waste_pct)
            metrics.gauge("device.block_fill_pct", lambda: self.block_fill_pct)
        else:
            # disabled (or registry-less): keep private histograms and
            # register NOTHING — a killed plane must be absent from the
            # scrape, not render pad_waste_pct=0 as if collection were
            # live and clean (the same absent-not-zero discipline the
            # sparse per-bucket series follow)
            self.arena_hist = Histogram("latency.stage_arena_s")
            self.transfer_hist = Histogram("latency.stage_transfer_s")
            if not enabled:
                self.metrics = None  # per-bucket registration off too

    # -- bucket registry -----------------------------------------------------

    def _bucket(self, key: str) -> _BucketStats:
        # LOCK ORDER: the histogram registration below takes the Metrics
        # registry lock, and the registry holds ITS lock while reading
        # the device.pad_waste_pct gauge — so registration must happen
        # with the device lock RELEASED or a /metrics scrape racing a
        # first-bucket staging deadlocks ABBA (caught in review;
        # regression-tested). Double-checked: racers both build, one
        # wins the insert; the histograms are registry-shared either way.
        with self._lock:
            b = self._buckets.get(key)
        if b is not None:
            return b
        if self.metrics is not None:
            # sparse: a registered-but-never-observed bucket is OMITTED
            # from snapshot/exposition (the empty-series
            # discipline, next to the gauge-error rule), never
            # rendered as a zero/NaN series
            nb = _BucketStats(
                self.metrics.histogram(f"latency.score_s.{key}", sparse=True),
                self.metrics.histogram(
                    f"device.occupancy.{key}", sparse=True,
                    bounds=OCCUPANCY_BOUNDS,
                ),
            )
        else:
            nb = _BucketStats(
                Histogram(f"latency.score_s.{key}"),
                Histogram(f"device.occupancy.{key}", bounds=OCCUPANCY_BOUNDS),
            )
        with self._lock:
            return self._buckets.setdefault(key, nb)

    def _block_fill_hist(self, key: str, b: _BucketStats) -> Histogram:
        # same ABBA discipline as _bucket: the registry registration
        # runs with the device lock RELEASED; double-checked, racers
        # both build and one wins (the histogram is registry-shared
        # under a Metrics registry either way)
        with self._lock:
            h = b.block_fill_hist
        if h is not None:
            return h
        if self.metrics is not None:
            nh = self.metrics.histogram(
                f"device.block_fill.{key}", sparse=True,
                bounds=OCCUPANCY_BOUNDS,
            )
        else:
            nh = Histogram(f"device.block_fill.{key}", bounds=OCCUPANCY_BOUNDS)
        with self._lock:
            if b.block_fill_hist is None:
                b.block_fill_hist = nh
            return b.block_fill_hist

    # -- staging side --------------------------------------------------------

    def observe_staged(self, batch) -> None:
        """One window entered the staging path: occupancy (rows vs
        bucket capacity) + the pad-waste ledger. Called once per REAL
        window — group-padding duplicates are not re-counted. A window
        that shipped blocked extents additionally feeds the block-fill
        ledger and its per-bucket histogram (the blocked layout's
        occupancy twin)."""
        if not self.enabled:
            return
        key = bucket_key(batch)
        e_pad = int(batch.e_pad)
        n_edges = int(batch.n_edges)
        b = self._bucket(key)
        b.occupancy_hist.observe(float(batch.edge_occupancy))
        block_slots = 0
        if getattr(batch, "edge_block_starts", None) is not None:
            block_slots = int(batch.blocked_edge_slots)
            if block_slots > 0:
                # fill ratio over the slots the blocked reduce touches
                # (real <= slots by construction, so the 0..1 linear
                # occupancy ladder applies unchanged)
                self._block_fill_hist(key, b).observe(n_edges / block_slots)
        with self._lock:
            b.staged += 1
            self.staged_windows += 1
            self.staged_edges += n_edges
            self.padded_edge_slots += e_pad - n_edges
            if block_slots > 0:
                self.blocked_staged_edges += n_edges
                self.blocked_edge_slots += block_slots

    def observe_transfer(
        self, n_bytes: int, arena_s: float, transfer_s: float
    ) -> None:
        """One staging dispatch (a serial window or a whole vmapped
        group): the arena/prep vs host→device split, plus bytes."""
        if not self.enabled:
            return
        self.arena_hist.observe(arena_s)
        self.transfer_hist.observe(transfer_s)
        with self._lock:
            self.transfer_bytes += int(n_bytes)

    # -- scoring side --------------------------------------------------------

    def observe_score(self, batch, dur_s: float) -> None:
        """One window's device step time, attributed to its bucket.
        Group members share the group dispatch duration — the same
        critical-path semantics the span plane's ``score`` stage uses."""
        if not self.enabled:
            return
        b = self._bucket(bucket_key(batch))
        b.score_hist.observe(dur_s)
        with self._lock:
            b.scored += 1

    # -- read side -----------------------------------------------------------

    @property
    def pad_waste_pct(self) -> float:
        # LOCKLESS read: this property backs a registered gauge, and the
        # Metrics registry reads gauges while holding its own lock —
        # taking the device lock here closes the ABBA cycle _bucket()
        # avoids (see the lock-order note there). Two GIL-atomic int
        # reads; a scrape racing a staging is off by at most one window.
        staged = self.staged_edges  # alazlint: disable=ALZ010 -- intentionally racy gauge read; locking here would ABBA-deadlock against the Metrics registry lock (see _bucket)
        padded = self.padded_edge_slots  # alazlint: disable=ALZ010 -- same intentionally racy read as the line above
        return pad_waste_pct_from(staged, padded)

    @property
    def block_fill_pct(self) -> float:
        # LOCKLESS for the same ABBA reason as pad_waste_pct (this backs
        # a registered gauge); 0.0 until the first blocked window —
        # mirrors pad_waste_pct's never-NaN empty reading
        real = self.blocked_staged_edges  # alazlint: disable=ALZ010 -- intentionally racy gauge read, see pad_waste_pct
        slots = self.blocked_edge_slots  # alazlint: disable=ALZ010 -- same intentionally racy read as the line above
        if not slots:
            return 0.0
        return 100.0 - blocked_pad_waste_pct_from(real, slots)

    def snapshot(self) -> dict:
        """The ``/stats`` per-bucket breakdown (next to the span plane's
        ``stage_latency``): occupancy + score percentiles per bucket,
        the stage decomposition, and the pad-waste ledger."""
        with self._lock:
            buckets = dict(self._buckets)
            out = {
                "pad_waste_pct": round(
                    pad_waste_pct_from(
                        self.staged_edges, self.padded_edge_slots
                    ),
                    3,
                ),
                "staged_windows": self.staged_windows,
                "staged_edges": self.staged_edges,
                "padded_edge_slots": self.padded_edge_slots,
                "transfer_bytes": self.transfer_bytes,
            }
            if self.blocked_edge_slots:
                # blocked ledger rides /stats only once a blocked window
                # staged (the sparse absent-not-zero discipline)
                out["block_fill_pct"] = round(
                    100.0
                    - blocked_pad_waste_pct_from(
                        self.blocked_staged_edges, self.blocked_edge_slots
                    ),
                    3,
                )
                out["blocked_edge_slots"] = self.blocked_edge_slots
        # histogram walks take the stripe locks — outside the plane lock
        arena, transfer = self.arena_hist.snapshot(), self.transfer_hist.snapshot()
        out["stage_split_ms"] = {
            "arena": {
                "count": arena["count"],
                "p50_ms": round(arena["p50"] * 1e3, 4),
                "p99_ms": round(arena["p99"] * 1e3, 4),
            },
            "transfer": {
                "count": transfer["count"],
                "p50_ms": round(transfer["p50"] * 1e3, 4),
                "p99_ms": round(transfer["p99"] * 1e3, 4),
            },
        }
        per_bucket = {}
        for key, b in sorted(buckets.items()):
            score = b.score_hist.snapshot()
            occ = b.occupancy_hist.snapshot()
            per_bucket[key] = {
                "staged": b.staged,
                "scored": b.scored,
                "score_p50_ms": round(score["p50"] * 1e3, 4),
                "score_p95_ms": round(score["p95"] * 1e3, 4),
                "score_p99_ms": round(score["p99"] * 1e3, 4),
                "occupancy_p50_pct": round(occ["p50"] * 100.0, 2),
                "occupancy_p99_pct": round(occ["p99"] * 100.0, 2),
            }
            if b.block_fill_hist is not None:
                fill = b.block_fill_hist.snapshot()
                per_bucket[key]["block_fill_p50_pct"] = round(
                    fill["p50"] * 100.0, 2
                )
        out["buckets"] = per_bucket
        return out


def _metric_safe(name: str) -> str:
    """Traced-fn names can carry non-identifier characters
    (``<lambda>``); the closed metric registry and the Prometheus
    exposition both need a clean token."""
    import re

    return re.sub(r"[^0-9A-Za-z_]", "_", name)


class CompileEventPlane:
    """Always-on XLA compile capture (see module docstring).

    ``start()`` opens a :class:`~alaz_tpu.sanitize.retrace.CompileWatcher`
    for the plane's lifetime (the service owns one per process-resident
    scorer; jax's ``log_compiles`` flag is saved/restored on stop). Each
    "Compiling <fn>" event counts into ``compile.events`` and
    ``compile.<fn>``; each "Finished XLA compilation" event carries the
    duration and lands in the flight recorder with the bucket the scorer
    thread declared via :meth:`bucket`.

    The steady-state contract this makes operational: after warmup,
    ``compile.<entry point>`` counters FREEZE — any later increment on
    a dashboard is a serving-path retrace (shape outside the bucket set,
    fresh jit wrapper, Python-type flip; see alazsan/ALZ006), caught in
    production instead of only under ``make sanitize``.
    """

    def __init__(self, metrics=None, recorder=None, enabled: bool = True):
        self.enabled = enabled
        self.metrics = metrics
        self.recorder = recorder
        self.events = 0  # "Compiling" count — guarded-by: self._lock
        self.by_fn: Dict[str, int] = {}  # guarded-by: self._lock
        self._lock = threading.Lock()
        self._tls = threading.local()  # current bucket, scorer-thread-set
        self._watcher = None
        if metrics is not None:
            self._c_events = metrics.counter("compile.events")
        else:
            self._c_events = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "CompileEventPlane":
        if not self.enabled or self._watcher is not None:
            return self
        from alaz_tpu_torch.sanitize.retrace import CompileWatcher

        self._watcher = CompileWatcher(on_event=self._on_event)
        self._watcher.__enter__()
        return self

    def stop(self) -> None:
        if self._watcher is not None:
            self._watcher.__exit__()
            self._watcher = None

    # -- bucket attribution --------------------------------------------------

    @contextmanager
    def bucket(self, key: Optional[str]):
        """Tag compiles fired inside the block with ``key`` — exact
        because XLA compiles synchronously on the dispatching thread."""
        prev = getattr(self._tls, "bucket", None)
        self._tls.bucket = key
        try:
            yield
        finally:
            self._tls.bucket = prev

    # -- capture sink --------------------------------------------------------

    def _on_event(self, kind: str, name: str, secs: Optional[float]) -> None:
        bucket = getattr(self._tls, "bucket", None)
        if kind == "compiling":
            with self._lock:
                self.events += 1
                self.by_fn[name] = self.by_fn.get(name, 0) + 1
            if self._c_events is not None:
                self._c_events.inc()
            if self.metrics is not None:
                self.metrics.counter(f"compile.{_metric_safe(name)}").inc()
        elif kind == "finished" and self.recorder is not None:
            # one recorder event per compile, on the message that knows
            # the duration; a steady-state retrace therefore rides every
            # crash dump and /recorder pull with its cost attached
            self.recorder.record(
                "compile",
                fn=name,
                bucket=bucket,
                duration_ms=round(secs * 1e3, 3) if secs is not None else None,
            )

    # -- read side -----------------------------------------------------------

    def count(self, name: str) -> int:
        with self._lock:
            return self.by_fn.get(name, 0)

    def snapshot(self) -> dict:
        with self._lock:
            return {"events": self.events, "by_fn": dict(self.by_fn)}
