"""Window-lifecycle span tracing: the JAX package's ``obs/spans.py``,
with the port's span helper beside it.

Answers "where did window W spend its 0.6 s between first row and
exported score". Each emitted window carries one span: named per-stage
durations through the full lifecycle,

    first-row-seen ──────────────► close begins          = ``scatter``
    per-shard close pop+aggregate                        = ``shard_close``
    cross-shard recombine / grouped reduction            = ``merge``
    feature assembly + pad/bucket                        = ``assemble``
    degree-cap sampling decision + selection (cap>0)     = ``sample``
    host→device: arrays/arena/transfer dispatch          = ``stage``
    device compute (blocked on)                          = ``score``
    score export ack (annotate + sink)                   = ``export``

The port times the scorer's work through ``SpanTracer.span`` and adds
stages of its own (``PORT_STAGES``), nested as they run:

    score    ⊃ dispatch (the score fn's call, until it returns; in a
                stacked group it runs at staging, outside ``score``)
             ⊃ wait     (the blocking read of the edge logits)
    record   ⊃ plane    (the sigmoid and the score plane's pass)
             ⊃ export
    handoff  ⊃ gauges   (the closing thread's window enqueue and its
                         src-locality gauges; no window's span)
    take                (the scorer's wait for its next window)
    feed     ⊃ fill     (the train step's host arrays into a
                         page-locked set, on a card)
    forward, backward, optim          (the rest of the train step)
    memory                            (TGN's memory update, inside
                                       dispatch; no window's span)
    experts                           (each layer's expert dispatch,
                                       inside dispatch; no window's span)

``memory`` and ``experts`` are models' own stages (``MODEL_STAGES``):
their series register only in a tracer that ``add_stage`` gives them,
the Service's under ``model="tgn"`` and ``model="experts"``, so every
other Service's names stay the JAX service's.

A span times its stage on the host (``perf_counter`` wall seconds into
``latency.<stage>_s``, a histogram for every stage of both tuples; the
thread's CPU seconds into the counter ``cpu.<stage>_s``, in
``SpanTracer.cpu``, registered like the histograms or, without a
registry, private to the tracer), records its parent stage (the span open around it
on the same thread) in the window's ``window_span`` event, and, only
while a ``torch.profiler`` session records in the process, opens the
profiler range ``alaz.<stage>`` around its body: the range lands in the
trace on the profiler's clock, on its thread, beside the card's
activity. The ranges are the profiler's CPU-op kind, not its user
annotations, so the trace gives them no copy on the device timeline.

Cost discipline (the ≤2 % rows/s bench bound): tracer calls happen per
**window × stage** (plus one ``first_row`` per chunk×window at the
persist mouth), never per row; each call is a dict write under one
short tracer lock; the lock-striped histograms are fed once per window
at completion, not per observation. ``enabled=False`` short-circuits
every method at the first branch; a span then reads the wall clock
alone (its callers account busy time from it).

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

# the port's own stages (module docstring): sub-stages of the scorer's
# window work, and windowless work. Apart from STAGES, so the e2e
# gate's span-completeness contract stays the lifecycle's.
PORT_STAGES = (
    "take",
    "dispatch",
    "wait",
    "record",
    "plane",
    "handoff",
    "gauges",
    "feed",
    "fill",
    "forward",
    "backward",
    "optim",
)

# the stages ``SpanTracer.span`` times: each counts its thread CPU
# seconds into ``cpu.<stage>_s``
SPAN_STAGES = ("stage", "score", "export") + PORT_STAGES

# stages only some models run (module docstring): ``SpanTracer.add_stage``
# registers one where its model runs
MODEL_STAGES = ("memory", "experts")

# this thread's open spans' stages, innermost last
_LOCAL = threading.local()

# (torch.autograd.profiler, torch._C._profiler), imported at the first
# span: the process pool's workers import obs/ without torch
_TORCH_PROFILER = []


def _profiler_modules() -> list:
    if not _TORCH_PROFILER:
        import torch._C._profiler
        import torch.autograd.profiler

        _TORCH_PROFILER[:] = [torch.autograd.profiler, torch._C._profiler]
    return _TORCH_PROFILER


class _Seconds:
    """A private tracer's CPU-seconds counter (the registry counter's
    ``inc`` and ``value``), without the runtime package and its torch."""

    __slots__ = ("value", "_lock")

    def __init__(self) -> None:
        self.value = 0.0  # guarded-by: self._lock
        self._lock = threading.Lock()

    def inc(self, n: float) -> None:
        with self._lock:
            self.value += n


class WindowSpan:
    __slots__ = ("window_start_ms", "t_first", "stages", "parents")

    def __init__(self, window_start_ms: int, t_first: float):
        self.window_start_ms = int(window_start_ms)
        self.t_first = t_first  # monotonic first-row-seen
        self.stages: Dict[str, float] = {}
        # stage -> the stage whose span was open around it
        self.parents: Dict[str, str] = {}

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
        self._metrics = metrics
        if metrics is not None:
            self.hists = {
                s: metrics.histogram(f"latency.{s}_s") for s in STAGES + PORT_STAGES
            }
            self.cpu = {s: metrics.counter(f"cpu.{s}_s") for s in SPAN_STAGES}
            self._c_windows = metrics.counter("trace.windows")
            self._c_evicted = metrics.counter("trace.evicted")
            metrics.gauge("trace.live", lambda: self.live_count)
        else:
            self.hists = {s: Histogram(f"latency.{s}_s") for s in STAGES + PORT_STAGES}
            self.cpu = {s: _Seconds() for s in SPAN_STAGES}
            self._c_windows = None
            self._c_evicted = None

    def add_stage(self, stage: str) -> None:
        """Register one of ``MODEL_STAGES``: its ``latency.<stage>_s``
        histogram and ``cpu.<stage>_s`` counter, as ``__init__`` does the
        others'."""
        if self._metrics is not None:
            self.hists[stage] = self._metrics.histogram(f"latency.{stage}_s")
            self.cpu[stage] = self._metrics.counter(f"cpu.{stage}_s")
        else:
            self.hists[stage] = Histogram(f"latency.{stage}_s")
            self.cpu[stage] = _Seconds()

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

    def observe(
        self, window_start_ms: int, stage: str, dur_s: float, parent: Optional[str] = None
    ) -> None:
        """Record a stage duration on the window's span, and the stage it
        ran inside (``parent``) if any. Re-observation keeps the max —
        per-shard parallel closes all report, and the span carries the
        critical-path one."""
        if not self.enabled:
            return
        w = int(window_start_ms)
        with self._lock:
            span = self._get_or_create_locked(w, time.perf_counter())
            if stage not in span.stages or dur_s > span.stages[stage]:
                span.stages[stage] = dur_s
            if parent is not None:
                span.parents[stage] = parent

    def span(self, stage: str, window=None) -> "_Span":
        """``with tracer.span(stage, window) as sp:`` times its body as
        ``stage`` (module docstring); ``sp.wall_s`` holds the wall
        seconds after the body. ``window``: the window id whose span
        takes the stage, or a stacked group's ``[(tracer, window id),
        ...]``; with None the stage belongs to no window's lifecycle and
        its histogram takes the time at once — so a hand-off that runs
        after its window was scored never reopens that window's span. A
        body that raises is not observed."""
        return _Span(self, stage, window)

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
                parents=dict(span.parents),
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
        """{stage: {count, p50_ms, p95_ms, p99_ms}} over the lifecycle's
        and the port's stages — the /stats and bench ``stage_latency``
        payload."""
        out = {}
        for s in STAGES + PORT_STAGES + tuple(m for m in MODEL_STAGES if m in self.hists):
            h = self.hists[s]
            snap = h.snapshot()
            out[s] = {
                "count": snap["count"],
                "p50_ms": round(snap["p50"] * 1e3, 4),
                "p95_ms": round(snap["p95"] * 1e3, 4),
                "p99_ms": round(snap["p99"] * 1e3, 4),
            }
        return out


class _Span:
    """One timed stage (``SpanTracer.span``)."""

    __slots__ = ("tracer", "stage", "window", "parent", "t0", "c0", "wall_s", "dropped", "_range")

    def __init__(self, tracer: SpanTracer, stage: str, window):
        self.tracer = tracer
        self.stage = stage
        self.window = window
        self.parent: Optional[str] = None
        self.wall_s = 0.0
        self.dropped = False
        self._range = None

    def drop(self) -> None:
        """Observe nothing for this span (a poll that took no window). A
        profiler range already open stays in the trace."""
        self.dropped = True

    def __enter__(self) -> "_Span":
        if self.tracer.enabled:
            stack = getattr(_LOCAL, "stack", None)
            if stack is None:
                stack = _LOCAL.stack = []
            if stack:
                self.parent = stack[-1]
            stack.append(self.stage)
            autograd_profiler, profiler = _profiler_modules()
            if autograd_profiler._is_profiler_enabled:
                self._range = profiler._RecordFunctionFast("alaz." + self.stage)
                self._range.__enter__()
            # the CPU clock is read inside the wall clock's interval: on
            # a fine thread clock a span's CPU seconds never exceed its
            # wall seconds (a clock that ticks reads whole ticks)
            self.t0 = time.perf_counter()
            self.c0 = time.thread_time()
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        tr = self.tracer
        if not tr.enabled:
            self.wall_s = time.perf_counter() - self.t0
            return
        cpu_s = time.thread_time() - self.c0
        self.wall_s = time.perf_counter() - self.t0
        if self._range is not None:
            self._range.__exit__(None, None, None)
        _LOCAL.stack.pop()
        if exc_type is not None or self.dropped:
            return
        tr.cpu[self.stage].inc(cpu_s)
        if self.window is None:
            tr.hists[self.stage].observe(self.wall_s)
        elif isinstance(self.window, list):
            for owner, w in self.window:
                owner.observe(w, self.stage, self.wall_s, self.parent)
        else:
            tr.observe(self.window, self.stage, self.wall_s, self.parent)
