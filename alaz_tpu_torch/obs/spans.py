"""Window-lifecycle span tracing (ISSUE 9 tentpole).

Answers "where did window W spend its 0.6 s between first row and
exported score" — the attribution every next perf tentpole (process-mode
ingest, Pallas fused aggregation, multi-tenant isolation) is gated on.
Each emitted window carries one span: named per-stage durations through
the full lifecycle,

    first-row-seen ──────────────► close begins          = ``scatter``
    per-shard close pop+aggregate                        = ``shard_close``
    cross-shard recombine / grouped reduction            = ``merge``
    feature assembly + pad/bucket                        = ``assemble``
    degree-cap sampling decision + selection (cap>0)     = ``sample``
    host→device: arrays/arena/transfer dispatch          = ``stage``
    device compute (blocked on)                          = ``score``
    score export ack (annotate + sink)                   = ``export``

Cost discipline (the ≤2 % rows/s bench bound): tracer calls happen per
**window × stage** (plus one ``first_row`` per chunk×window at the
persist mouth), never per row; each call is a dict write under one
short tracer lock; the lock-striped histograms are fed once per window
at completion, not per observation. ``enabled=False`` short-circuits
every method at the first branch.

The live-span map is bounded (``max_live``, LRU-evicted with a counter):
a window that never completes — scoring disabled mid-run, a shed window
queue — costs an eviction tick, not a leak.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, Optional

from alaz_tpu_torch.obs.histogram import Histogram

# ordered as the lifecycle runs; the e2e gate asserts every emitted
# window's span covers all of these. ``sample`` is always timed — with
# no degree cap it measures the cap *decision* (one branch), so the
# stage is nonzero in every pipeline and the completeness gate needs no
# cap-conditional carve-out.
STAGES = (
    "scatter",
    "shard_close",
    "merge",
    "assemble",
    "sample",
    "stage",
    "score",
    "export",
)

# the host-plane prefix: what a pipeline with no scorer behind it (bench
# ingest, the chaos harness — ``complete_at_emit=True``) can complete
HOST_STAGES = STAGES[:5]


class WindowSpan:
    __slots__ = ("window_start_ms", "t_first", "stages")

    def __init__(self, window_start_ms: int, t_first: float):
        self.window_start_ms = int(window_start_ms)
        self.t_first = t_first  # monotonic first-row-seen
        self.stages: Dict[str, float] = {}

    def missing(self, expected=STAGES) -> tuple:
        return tuple(s for s in expected if s not in self.stages)


class SpanTracer:
    """Per-window span registry + per-stage latency histograms.

    ``metrics``: a runtime ``Metrics`` registry — histograms register as
    ``latency.<stage>_s`` with counters ``trace.windows`` /
    ``trace.evicted`` and gauge ``trace.live``; with ``metrics=None``
    (bench A/B, chaos harness) the tracer keeps private histograms in
    ``self.hists``.

    ``complete_at_emit``: pipelines with no scorer behind them (bench
    ingest, the chaos harness) complete spans when the window emits;
    the service keeps spans open through score + export instead.
    """

    def __init__(
        self,
        metrics=None,
        recorder=None,
        enabled: bool = True,
        max_live: int = 4096,
        complete_at_emit: bool = False,
    ):
        self.enabled = enabled
        self.recorder = recorder
        self.complete_at_emit = complete_at_emit
        self.max_live = max(16, int(max_live))
        self._lock = threading.Lock()
        self._live: "OrderedDict[int, WindowSpan]" = OrderedDict()  # guarded-by: self._lock
        self.completed = 0  # guarded-by: self._lock
        self.evicted = 0  # guarded-by: self._lock
        if metrics is not None:
            self.hists = {
                s: metrics.histogram(f"latency.{s}_s") for s in STAGES
            }
            self._c_windows = metrics.counter("trace.windows")
            self._c_evicted = metrics.counter("trace.evicted")
            metrics.gauge("trace.live", lambda: self.live_count)
        else:
            self.hists = {s: Histogram(f"latency.{s}_s") for s in STAGES}
            self._c_windows = None
            self._c_evicted = None

    # -- lifecycle marks -----------------------------------------------------

    def _get_or_create_locked(self, w: int, now: float) -> WindowSpan:
        # contract: every caller holds self._lock (the `_locked` suffix);
        # the lint only models `with` blocks, hence the disables
        span = self._live.get(w)  # alazlint: disable=ALZ010 -- caller holds self._lock (_locked contract)
        if span is not None:
            # touch = recency: without this the eviction is FIFO and an
            # actively-observed straggler (the oldest window, mid-score)
            # is evicted FIRST while idle newer spans survive
            self._live.move_to_end(w)  # alazlint: disable=ALZ010 -- caller holds self._lock (_locked contract)
        else:
            if len(self._live) >= self.max_live:  # alazlint: disable=ALZ010 -- caller holds self._lock (_locked contract)
                self._live.popitem(last=False)  # alazlint: disable=ALZ010 -- caller holds self._lock (_locked contract)
                self.evicted += 1  # alazlint: disable=ALZ010 -- caller holds self._lock (_locked contract)
                if self._c_evicted is not None:
                    self._c_evicted.inc()
            span = WindowSpan(w, now)
            self._live[w] = span  # alazlint: disable=ALZ010 -- caller holds self._lock (_locked contract)
        return span

    def first_row(self, window_start_ms: int, t: Optional[float] = None) -> None:
        """First row of the window seen at the persist mouth; idempotent
        (only the first call sets the span's origin). ``t`` lets a
        cross-process pipeline (alaz_tpu/shm, ISSUE 15) backdate the
        origin to the shard worker's own CLOCK_MONOTONIC stamp — the
        clock is system-wide, so the residency math still closes."""
        if not self.enabled:
            return
        w = int(window_start_ms)
        now = time.perf_counter() if t is None else float(t)
        with self._lock:
            self._get_or_create_locked(w, now)

    def close_start(self, window_start_ms: int, t: Optional[float] = None) -> None:
        """The close wave reached this window: the elapsed time since
        first_row becomes the ``scatter`` stage (open-window residency —
        ingest, queueing, watermark wait). First caller wins; the other
        shards' close pops are covered by ``shard_close``. ``t`` as in
        :meth:`first_row` — the process backend stamps close time on the
        worker's clock."""
        if not self.enabled:
            return
        w = int(window_start_ms)
        now = time.perf_counter() if t is None else float(t)
        with self._lock:
            span = self._get_or_create_locked(w, now)
            if "scatter" not in span.stages:
                span.stages["scatter"] = now - span.t_first

    def observe(self, window_start_ms: int, stage: str, dur_s: float) -> None:
        """Record a stage duration on the window's span. Re-observation
        keeps the max — per-shard parallel closes all report, and the
        span carries the critical-path one."""
        if not self.enabled:
            return
        w = int(window_start_ms)
        with self._lock:
            span = self._get_or_create_locked(w, time.perf_counter())
            if stage not in span.stages or dur_s > span.stages[stage]:
                span.stages[stage] = dur_s

    def emit(self, window_start_ms: int) -> None:
        """The window's GraphBatch left the host plane. Completes the
        span when nothing downstream (scorer/export) will."""
        if self.enabled and self.complete_at_emit:
            self.complete(window_start_ms)

    def complete(self, window_start_ms: int) -> Optional[WindowSpan]:
        """Finalize: feed every stage duration into its histogram (one
        sample per window per stage), push the span event to the flight
        recorder, drop the live entry."""
        if not self.enabled:
            return None
        w = int(window_start_ms)
        with self._lock:
            span = self._live.pop(w, None)
            if span is None:
                return None
            self.completed += 1
        # histogram/recorder feeds run OUTSIDE the tracer lock: the
        # stripes have their own locks and the recorder its own ring lock
        for stage, dur in span.stages.items():
            h = self.hists.get(stage)
            if h is not None:
                h.observe(dur)
        if self._c_windows is not None:
            self._c_windows.inc()
        if self.recorder is not None:
            self.recorder.record(
                "window_span",
                window_start_ms=w,
                stages={s: round(d * 1e3, 4) for s, d in span.stages.items()},
            )
        return span

    def discard(self, window_start_ms: int) -> None:
        """Drop a live span without completing it (shed window)."""
        if not self.enabled:
            return
        with self._lock:
            self._live.pop(int(window_start_ms), None)

    # -- read side -----------------------------------------------------------

    @property
    def expected_stages(self) -> tuple:
        """The stages a complete span must carry in THIS pipeline: the
        host prefix when spans complete at emit (no scorer behind the
        tracer), the full lifecycle otherwise."""
        return HOST_STAGES if self.complete_at_emit else STAGES

    @property
    def live_count(self) -> int:
        with self._lock:
            return len(self._live)

    def stage_snapshot(self) -> dict:
        """{stage: {count, p50_ms, p95_ms, p99_ms}} — the /stats and
        bench ``stage_latency`` payload."""
        out = {}
        for s in STAGES:
            h = self.hists[s]
            snap = h.snapshot()
            out[s] = {
                "count": snap["count"],
                "p50_ms": round(snap["p50"] * 1e3, 4),
                "p95_ms": round(snap["p95"] * 1e3, 4),
                "p99_ms": round(snap["p99"] * 1e3, 4),
            }
        return out
