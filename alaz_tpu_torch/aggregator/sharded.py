"""Sharded multi-worker host ingest (ISSUE 5 tentpole).

PR 1 vectorized ``process_l7`` to ~1M rows/s single-threaded; the
remaining gap to the host plane's per-stage capability is serialization,
not work — numpy releases the GIL on every big op, so N shard workers
running the SAME vectorized path on disjoint shards overlap most of the
wall clock (the FeatGraph / arxiv 2310.12184 shape: keep per-partition
aggregation data-parallel, push the irregular grouping kernel into the
tuned native backend — here ``alz_group_edges``).

Topology (every arrow a bounded queue or a locked hand-off):

    submit (any thread) → hash-partition by connection key (pid, fd)
        → [N worker queues] → shard workers, each running a PRIVATE
          ``Aggregator`` (socket lines, h2 state, stmt caches, path
          caches are per-connection state, and a connection always lands
          on the same worker) over the SHARED thread-safe ``Interner`` /
          ``ClusterInfo``, persisting REQUEST rows into a per-worker
          ``ShardPartialStore`` (window-bucketed raw rows)
        → close waves: when every worker's watermark passes a window,
          the merge thread broadcasts a close request; EACH WORKER then
          aggregates its own shard's window rows into one uid-keyed
          ``EdgePartial`` (one grouped reduction, on the worker thread —
          the expensive stage stays data-parallel)
        → merge thread: recombines the N partials per window with ONE
          more grouped reduction (sum/max per edge key) and assembles
          the ``GraphBatch`` through the shared ``GraphBuilder`` (slot
          assignment happens only here, so it is identical to the
          single-thread path's). With N == 1 there is nothing to
          recombine: the worker deposits its raw rows and the merge
          stage runs ``GraphBuilder.build`` verbatim — the pool adds
          queue hops, not work.

Determinism contract (tests/test_sharded_ingest.py): for the same input
rows, the merged ``GraphBatch`` is identical to the single-thread
``WindowedGraphStore`` output — same edges, features and counts — up to
two documented degrees of freedom: interner id NUMBERING (workers intern
concurrently, so the ids assigned to the same strings can differ between
runs; compare through the strings) and per-uid endpoint-type ties (a uid
seen with two different types keeps whichever its first-mapped row
carried). Feature equality is exact because every reduction input is an
integer-valued float64 (per-window latency sums stay below 2^53 ns).

Lock order (ARCHITECTURE §3g; alazsan-stressed in tests/test_sanitize.py):
worker threads take a store lock OR the progress condition, never both
at once; the merge path takes ``_merge_lock`` → worker-queue locks
(close broadcast) → the progress condition (ack wait) → store locks
(take_ready) → downstream emit locks — one direction only, a DAG by
construction. The supervision plane (ISSUE 6) adds ``_restart_lock`` →
``_wm_cond`` (restart bookkeeping) and keeps re-drives/queue puts
OUTSIDE the progress condition, so no reverse edge appears.

Self-healing (ISSUE 6, ARCHITECTURE §3j): worker threads run under a
supervisor shell — a crash (a chaos-injected ``WorkerCrash`` or an
escaped bug) marks the worker dead and wakes the merge plane, which
restarts the thread against the SAME queue/store/aggregator (none of
that state is thread-affine) and, when a close wave was in flight,
re-drives the close to the restarted worker so ``_await_wave`` can
never wedge on an ack that will not come. Rows in flight on the dying
thread are attributed to the shared :class:`DropLedger` (cause
``dropped``); scatter backpressure past ``shed_block_s`` sheds to the
ledger (cause ``shed``) instead of blocking the producer forever; late
stragglers keep their ``late`` attribution. Conservation — pushed ==
emitted + ledger total — is the chaos suite's checkable invariant.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Union

import numpy as np

from alaz_tpu_torch.aggregator.cluster import ClusterInfo
from alaz_tpu_torch.aggregator.engine import Aggregator, AggregatorStats, _conn_keys
from alaz_tpu_torch.config import RuntimeConfig
from alaz_tpu_torch.datastore.interface import BaseDataStore, DataStore
from alaz_tpu_torch.events.intern import Interner
from alaz_tpu_torch.events.k8s import K8sResourceMessage
from alaz_tpu_torch.graph.builder import (
    EdgePartial,
    GraphBuilder,
    NodeTable,
    partial_from_rows,
)
from alaz_tpu_torch.graph.snapshot import GraphBatch
from alaz_tpu_torch.logging import get_logger
from alaz_tpu_torch.obs.recorder import FlightRecorder
from alaz_tpu_torch.obs.spans import SpanTracer
from alaz_tpu_torch.utils.ledger import DropLedger
from alaz_tpu_torch.utils.queues import BatchQueue, QueueClosed

log = get_logger("alaz_tpu.sharded")


class WorkerCrash(BaseException):
    """A worker thread's injected death (see alaz_tpu/chaos/injectors).

    BaseException-derived so the per-item ``except Exception`` net that
    keeps a shard alive through bad batches cannot absorb it — the
    thread must actually die for the supervisor path to be real."""

_W_FLOOR = -(2**62)  # "no window closed yet" sentinel (below any real id)


class _QItem:
    """One worker-queue element. ``__len__`` is the EVENT count so
    BatchQueue's events-denominated capacity stays truthful (a bare tuple
    would count its arity)."""

    __slots__ = ("kind", "payload", "now_ns")

    def __init__(self, kind: str, payload, now_ns):
        self.kind = kind
        self.payload = payload
        self.now_ns = now_ns

    def __len__(self) -> int:
        p = self.payload
        if type(p) is tuple and len(p) == 2:  # (chunk, shard row index)
            p = p[1]
        shape = getattr(p, "shape", None)
        return int(shape[0]) if shape else 1


def _shard_rows(payload) -> np.ndarray:
    """Materialize a scattered slice: the scatter ships ``(chunk, idx)``
    so the record gather runs on the worker thread, not the submitter."""
    if type(payload) is tuple:
        chunk, idx = payload
        return chunk[idx]
    return payload


class ShardPartialStore(BaseDataStore):
    """One shard worker's DataStore sink: buckets persisted REQUEST rows
    into time windows (raw — bucketing is one cheap copy, exactly what
    the serial store pays) and, on a close request, aggregates each
    closed window's rows into a uid-keyed :class:`EdgePartial` **on the
    worker thread** — the grouped reduction is the expensive stage and
    runs in parallel across shards, outside any lock.

    Single-producer: exactly one worker thread calls persist_requests and
    close_upto; ``_local_nodes`` (the private grouping table) is
    worker-thread-only and never locked. The lock covers the window map,
    the ready shelf and the counters, which the merge thread also
    touches."""

    def __init__(
        self,
        window_ms: int,
        label_fn=None,
        aggregate: bool = True,
        ledger: Optional[DropLedger] = None,
        tracer: Optional[SpanTracer] = None,
    ):
        self.window_ms = int(window_ms)
        self.label_fn = label_fn
        # shared span tracer: first-row marks + per-shard
        # close timings; per window×stage, never per row
        self.tracer = tracer
        # False (the N==1 pool): deposit raw rows; the merge stage then
        # runs the serial GraphBuilder.build verbatim — no partial pass
        self.aggregate = aggregate
        # shared pipeline-wide loss accounting (late stragglers land here
        # in addition to the store-local counter)
        self.ledger = ledger
        self._local_nodes = NodeTable()  # worker-thread-only grouping aid
        self._pending: Dict[int, List[np.ndarray]] = {}  # guarded-by: self._lock
        # closed-and-aggregated windows awaiting the merge thread:
        # window id → EdgePartial (aggregate=True) | raw row array
        self._ready: Dict[int, Union[EdgePartial, np.ndarray]] = {}  # guarded-by: self._lock
        self._watermark: Optional[int] = None  # guarded-by: self._lock
        self._closed_upto = _W_FLOOR  # guarded-by: self._lock
        self.request_count = 0  # guarded-by: self._lock
        self.late_dropped = 0  # guarded-by: self._lock
        self.last_persist_monotonic: Optional[float] = None  # guarded-by: self._lock
        self._lock = threading.Lock()

    # -- DataStore surface (the worker's Aggregator persists here) ---------

    def persist_requests(self, batch: np.ndarray) -> None:
        with self._lock:
            self.last_persist_monotonic = time.monotonic()
            n = int(batch.shape[0])
            self.request_count += n
            if n == 0:
                return
            wids = batch["start_time_ms"] // self.window_ms
            wmin, wmax = int(wids.min()), int(wids.max())
            if wmin == wmax:
                # dominant steady-state shape: whole chunk in one window.
                # Copy — the rows are retained across calls and the
                # caller may reuse its buffer (the serial store's rule).
                present: Union[np.ndarray, List[int]] = [wmin]
            elif wmax - wmin < (1 << 20):
                present = np.flatnonzero(np.bincount(wids - wmin)) + wmin
            else:  # degenerate timestamps: don't size a bincount by span
                present = np.unique(wids)
            for w in present:
                w = int(w)
                if w <= self._closed_upto:
                    # stragglers for an already-closed window (the
                    # aggregator retry path, or chaos-delayed delivery):
                    # drop, never re-emit
                    k = n if wmin == wmax else int((wids == w).sum())
                    self.late_dropped += k
                    if self.ledger is not None:
                        self.ledger.add("late", k)
                    continue
                rows = batch.copy() if wmin == wmax else batch[wids == w]
                self._pending.setdefault(w, []).append(rows)
                # span origin (idempotent — first shard to see the
                # window wins; lock order: store lock → tracer lock)
                if self.tracer is not None:
                    self.tracer.first_row(w * self.window_ms)
                if self._watermark is None or w > self._watermark:
                    self._watermark = w

    # -- worker-side close ---------------------------------------------------

    def close_upto(self, upto: Optional[int]) -> None:
        """Pop every pending window ≤ ``upto`` (None = all), aggregate it
        on the calling (worker) thread, shelve the result for the merge
        thread, and seal the horizon so later rows drop as late.

        Windows the sealed horizon ALREADY passed (``seal_upto`` ran
        while this store still held their rows — only reachable through
        a crash/restart interleave) are late-dropped here instead of
        shelved: re-emitting a merged window would corrupt every
        downstream consumer, losing attributed rows merely degrades."""
        with self._lock:
            if upto is None:
                upto = max(self._pending, default=self._closed_upto)
                if self._watermark is not None:
                    upto = max(upto, self._watermark)
            floor = self._closed_upto
            popped = {w: ps for w, ps in self._pending.items() if w <= upto}
            for w in popped:
                del self._pending[w]
            stale_rows = 0
            for w in [w for w in popped if w <= floor]:
                stale_rows += sum(int(p.shape[0]) for p in popped.pop(w))
            if stale_rows:
                self.late_dropped += stale_rows
            if upto > self._closed_upto:
                self._closed_upto = upto
        if stale_rows and self.ledger is not None:
            self.ledger.add("late", stale_rows, reason="sealed_horizon")
        # the grouped reduction runs OUTSIDE the lock: it is the heavy
        # stage, and it must overlap across worker threads
        done: List[tuple] = []
        tr = self.tracer
        for w, parts in sorted(popped.items()):
            ws_ms = w * self.window_ms
            if tr is not None:
                # the close wave reached this window: residency since
                # first_row becomes `scatter` (first shard to close wins)
                tr.close_start(ws_ms)
            tc0 = time.perf_counter()
            rows = np.concatenate(parts) if len(parts) > 1 else parts[0]
            if self.aggregate:
                labels = self.label_fn(rows) if self.label_fn is not None else None
                done.append((w, partial_from_rows(rows, self._local_nodes, labels)))
            else:
                done.append((w, rows))
            if tr is not None:
                # per-shard parallel closes all report; the span keeps
                # the max — the critical-path shard
                tr.observe(ws_ms, "shard_close", time.perf_counter() - tc0)
        if done:
            with self._lock:
                for w, item in done:
                    self._ready[w] = item

    # -- merge-side surface --------------------------------------------------

    @property
    def watermark(self) -> Optional[int]:
        with self._lock:
            return self._watermark

    def take_ready(self, upto: Optional[int]) -> Dict[int, Union[EdgePartial, np.ndarray]]:
        """Remove and return shelved windows ≤ ``upto`` (None = all)."""
        with self._lock:
            if upto is None:
                done = dict(self._ready)
                self._ready.clear()
            else:
                done = {w: p for w, p in self._ready.items() if w <= upto}
                for w in done:
                    del self._ready[w]
            return done

    def seal_upto(self, upto: int) -> None:
        """Advance the never-reopen floor (applied globally after a merge
        so EVERY store agrees on the merged horizon, even stores that had
        no rows for those windows)."""
        with self._lock:
            if upto > self._closed_upto:
                self._closed_upto = upto


class ShardedIngest:
    """N-worker sharded ingest pipeline with close-wave merging.

    Duck-types the ``Aggregator`` ingestion surface (``process_l7`` /
    ``process_tcp`` / ``process_proc`` / ``process_k8s`` / ``gc`` /
    ``reap_zombies`` / ``flush_retries``) and the windowed-store surface
    (``flush`` / ``late_dropped`` / ``last_persist_monotonic`` /
    ``on_batch``), so `runtime.service.Service` can swap it in for the
    serial pair. Ingestion calls are asynchronous: they partition by
    connection key and enqueue; closed windows emit on the merge thread.

    ``tee`` (optional) is an extra DataStore every worker's emitted
    REQUEST rows fan out to (the export-backend leg). It is called from
    N worker threads concurrently and must be thread-safe — the batching
    export backend (queue-fronted) is; bespoke sinks must lock.
    """

    def __init__(
        self,
        n_workers: int,
        interner: Optional[Interner] = None,
        config: Optional[RuntimeConfig] = None,
        cluster: Optional[ClusterInfo] = None,
        window_s: float = 1.0,
        on_batch: Optional[Callable[[GraphBatch], None]] = None,
        label_fn=None,
        renumber: bool = False,
        tee: Optional[DataStore] = None,
        queue_events: int = 1 << 18,
        autostart: bool = True,
        ledger: Optional[DropLedger] = None,
        fault_hook: Optional[Callable[[int, str], None]] = None,
        shed_block_s: float = 5.0,
        degree_cap: int = 0,
        sample_seed: int = 0,
        tracer: Optional[SpanTracer] = None,
        recorder: Optional[FlightRecorder] = None,
    ):
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        self.n = int(n_workers)
        # unified loss accounting: every row this pipeline
        # loses lands in exactly one ledger cause — the conservation
        # invariant the chaos suite checks
        self.ledger = ledger if ledger is not None else DropLedger()
        # span plane: ON by default. A standalone pipeline
        # (bench, chaos harness) gets a private tracer whose spans
        # complete at emit; the service passes its metrics-registered
        # tracer, which stays open through score/export.
        if tracer is None:
            tracer = SpanTracer(complete_at_emit=True, recorder=recorder)
        self.tracer = tracer
        # flight recorder: worker crashes/restarts and every
        # ledger decision become structured ring events; a dying worker
        # dumps the tail to the log automatically
        self.recorder = recorder
        if recorder is not None and self.ledger.recorder is None:
            self.ledger.recorder = recorder
        # chaos seam: called as fault_hook(worker_idx, kind) at item
        # boundaries on the worker thread; may raise WorkerCrash or stall
        self.fault_hook = fault_hook  # lockless-ok: attach-once chaos seam (wiring or harness, before traffic flows); workers null-check an atomic reference read
        # scatter backpressure bound: a producer blocks at most this long
        # on a backlogged shard queue before the rows shed to the ledger
        # (a stalled/dead worker must not wedge the submitting thread)
        self.shed_block_s = float(shed_block_s)
        self.interner = interner if interner is not None else Interner()
        self.config = config if config is not None else RuntimeConfig()
        self.cluster = (
            cluster if cluster is not None else ClusterInfo(self.interner)
        )
        self.window_s = window_s
        self.window_ms = int(window_s * 1000)
        self.on_batch = on_batch
        # in-class appends happen inside the close-wave merge region;
        # main reads .batches only after stop()/join (happens-before)
        self.batches: List[GraphBatch] = []  # guarded-by: self._merge_lock
        # the cap applies HERE, at the merge-stage assembly, never in the
        # per-shard partials: each worker sees only its shard's slice of
        # a dst's fan-in, so capping early would make the sample depend
        # on worker count — the merge sees the whole window, and the
        # priority hash (seed, window, uids) makes N∈{1..} select
        # identically
        self.builder = GraphBuilder(
            window_s=window_s, renumber=renumber,
            degree_cap=degree_cap, sample_seed=sample_seed,
            ledger=self.ledger, tracer=self.tracer,
        )
        self.label_fn = label_fn
        self.tee = tee

        self.stores = [
            ShardPartialStore(
                self.window_ms,
                # N == 1: the close wave deposits raw rows and the merge
                # stage IS GraphBuilder.build — label_fn then applies at
                # build time exactly like the serial store
                label_fn=label_fn if self.n > 1 else None,
                aggregate=self.n > 1,
                ledger=self.ledger,
                tracer=self.tracer,
            )
            for _ in range(self.n)
        ]
        self.workers = [
            Aggregator(
                self._worker_sink(self.stores[i]),
                interner=self.interner,
                config=self.config,
                cluster=self.cluster,
                # semantic drops (filtered) join the SHARED ledger so the
                # pipeline's conservation reads delivered == emitted +
                # ledger.total with no per-worker side channel
                ledger=self.ledger,
                recorder=recorder,
            )
            for i in range(self.n)
        ]
        # engine backend: when the config (or the A/B
        # override) asks for the native L7 engine, dlopen + layout-check
        # it at pool construction — the first traffic batch must not pay
        # the load, and a missing .so warns HERE, not mid-traffic
        if self.workers[0]._use_native_engine():
            loaded = all(
                w._native_l7_engine() is not None for w in self.workers
            )
            log.info(
                f"sharded ingest L7 engine backend: native "
                f"(loaded={loaded}, workers={self.n})"
            )
        self._queues = [
            BatchQueue(queue_events, f"shard{i}") for i in range(self.n)
        ]

        # progress plane: per-worker processed watermark, close-wave acks
        # and the merged horizon, all published under one condition
        self._wm_cond = threading.Condition()
        self._worker_wm: List[Optional[int]] = [None] * self.n  # guarded-by: self._wm_cond
        # scatters mid-flight: rows handed to process_l7 but not yet on
        # every worker queue. While nonzero the idle-watermark close rule
        # is suppressed — closing on "idle" workers whose slice of the
        # current chunk hasn't landed yet would late-drop it.
        self._inflight = 0  # guarded-by: self._wm_cond
        # wave id → set of worker indices that acked. A SET, not a
        # count: a restarted worker sees both the original close item
        # (queued behind its backlog) and the re-driven one — counting
        # it twice would let a wave complete before some OTHER worker
        # closed its shard, and the merge would seal rows that store
        # still holds (the seed-0 duplicate-emission bug).
        self._wave_acks: Dict[int, set] = {}  # guarded-by: self._wm_cond
        self._wave_seq = 0  # guarded-by: self._wm_cond
        self._merged_upto = _W_FLOOR  # guarded-by: self._wm_cond
        # serializes whole close waves (merge thread vs flush callers)
        self._merge_lock = threading.Lock()
        self.merge_s = 0.0  # merge-stage wall time (recombine+assemble)  # guarded-by: self._merge_lock
        self.windows_merged = 0  # guarded-by: self._merge_lock

        # supervision plane: per-worker thread handles so a
        # dead worker can be restarted in place; _worker_dead is the
        # dying thread's wake signal to anyone blocked on the condition
        self._restart_lock = threading.Lock()
        self._worker_threads: List[Optional[threading.Thread]] = []  # guarded-by: self._restart_lock
        self._merge_thread: Optional[threading.Thread] = None  # guarded-by: self._restart_lock
        self._worker_dead = [False] * self.n  # guarded-by: self._wm_cond
        self._worker_restarts = 0  # guarded-by: self._restart_lock
        # per-worker restart generation: close-wave re-drives key off
        # "was worker i restarted since this wave began", NOT "did MY
        # _supervise call do the restart" — the merger's supervision
        # heartbeat races the wave-waiter's, and whoever loses that race
        # must still re-drive (the original close died with the thread)
        self._worker_gen = [0] * self.n  # guarded-by: self._restart_lock
        self._last_wave_monotonic = time.monotonic()  # merge liveness gauge  # lockless-ok: written inside the merge lock's bounded-acquire region (which the lockset walk models); the sanction covers the racy float READ — it IS the last_wave_age_s freshness gauge. Every site is a plain float store/read, never a container mutation, so GIL-atomicity holds

        self._stop = threading.Event()
        if autostart:
            self.start()

    def _worker_sink(self, store: ShardPartialStore) -> DataStore:
        if self.tee is None:
            return store
        from alaz_tpu_torch.runtime.service import FanoutDataStore

        return FanoutDataStore([store, self.tee])

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        with self._restart_lock:
            if self._worker_threads or self._merge_thread is not None:
                return
            self._stop.clear()
            for i in range(self.n):
                t = threading.Thread(
                    target=self._worker_main, args=(i,), name=f"alaz-shard{i}",
                    daemon=True,
                )
                t.start()
                self._worker_threads.append(t)
            t = threading.Thread(
                target=self._merger_loop, name="alaz-shard-merge", daemon=True
            )
            t.start()
            self._merge_thread = t

    def stop(self) -> None:
        self._stop.set()  # BEFORE the snapshot: _supervise refuses
        # restarts once set, so no thread can appear after we collect
        for q in self._queues:
            q.close()
        with self._wm_cond:
            self._wm_cond.notify_all()
        with self._restart_lock:
            threads = [t for t in self._worker_threads if t is not None]
            if self._merge_thread is not None:
                threads.append(self._merge_thread)
            self._worker_threads = []
            self._merge_thread = None
        for t in threads:
            t.join(timeout=5)

    def close(self) -> None:
        self.stop()

    # -- supervision ----------------------------------------------

    @property
    def worker_restarts(self) -> int:
        with self._restart_lock:
            return self._worker_restarts

    @property
    def last_wave_age_s(self) -> float:
        """Seconds since the last close wave completed its merge — the
        gauge that makes a stalled merge thread visible."""
        return time.monotonic() - self._last_wave_monotonic

    def _worker_main(self, i: int) -> None:
        """Supervisor shell around the worker loop: any escape — a chaos
        WorkerCrash or a real bug — marks the worker dead and wakes the
        merge plane (which restarts it) instead of leaving every future
        wave to wedge on a silent missing ack."""
        try:
            self._worker_loop(i)
            return  # clean shutdown path (stop/close)
        except WorkerCrash:
            log.warning(f"shard{i} worker killed (injected crash)")
            reason = "injected_crash"
        except BaseException as exc:
            log.error(f"shard{i} worker died: {exc!r}")
            reason = repr(exc)
        if self.recorder is not None:
            # the crash trail ships WITH the crash: the event lands in
            # the ring and the ring's tail lands in the log, so a chaos
            # failure (or a real one) reads as a story, not a bare mark.
            # Best-effort: a recorder/logging failure here must never
            # swallow the dead-mark below — that would permanently
            # disable supervision of this worker (no restart, every
            # future close wave timing out)
            try:
                self.recorder.record("worker_crash", worker=i, reason=reason)
                self.recorder.crash_dump(log, f"shard{i} worker died: {reason}")
            except Exception as exc:
                log.error(f"flight-recorder crash dump failed: {exc!r}")
        with self._wm_cond:
            self._worker_dead[i] = True
            self._wm_cond.notify_all()

    def _supervise(self) -> List[int]:
        """Restart every worker whose thread died; returns the restarted
        indices so a waiting close wave can re-drive its close request.
        The restarted thread resumes the SAME queue, store and private
        aggregator — none of that state died with the thread — so the
        shard's backlog (including any queued close items) drains in
        order exactly as if the worker had merely stalled."""
        restarted: List[int] = []
        if self._stop.is_set():
            return restarted
        with self._restart_lock:
            if not self._worker_threads:
                return restarted  # never started / already stopped
            for i in range(self.n):
                t = self._worker_threads[i]
                if t is None or t.is_alive():
                    continue
                self._worker_restarts += 1
                self._worker_gen[i] += 1
                with self._wm_cond:
                    self._worker_dead[i] = False
                nt = threading.Thread(
                    target=self._worker_main, args=(i,),
                    name=f"alaz-shard{i}r{self._worker_restarts}", daemon=True,
                )
                self._worker_threads[i] = nt
                nt.start()
                restarted.append(i)
                if self.recorder is not None:
                    self.recorder.record(
                        "worker_restart", worker=i,
                        restart=self._worker_restarts,
                    )
                log.warning(
                    f"shard{i} worker restarted "
                    f"(restart #{self._worker_restarts})"
                )
        return restarted

    def _gen_snapshot(self) -> List[int]:
        with self._restart_lock:
            return list(self._worker_gen)

    # -- ingestion surface (Aggregator duck type) ----------------------------

    def process_l7(self, events: np.ndarray, now_ns: Optional[int] = None) -> None:
        """Partition an L7 batch by connection key and enqueue per-shard
        slices. Asynchronous: returns before processing (the serial
        Aggregator returns the emitted rows; callers needing per-batch
        edge counts read the aggregated ``stats`` instead)."""
        self._scatter("l7", events, now_ns)

    def process_tcp(self, events: np.ndarray, now_ns: Optional[int] = None) -> None:
        self._scatter("tcp", events, now_ns)

    def process_proc(self, events: np.ndarray) -> None:
        # proc exit tears down per-pid state on EVERY worker that may own
        # one of the pid's connections — (pid, fd) sharding splits a
        # pid's fds across workers, so the event broadcasts
        self._broadcast("proc", events)

    def process_k8s(self, msg: K8sResourceMessage) -> None:
        # cluster state is shared (thread-safe _IpTable) — fold once,
        # from the caller's thread, exactly like the serial engine
        self.cluster.handle_msg(msg)
        if self.tee is not None:
            self.tee.persist_resource(msg.resource_type, msg.event_type, msg.object)

    def gc(self, now_ns: Optional[int] = None) -> None:
        """Housekeeping broadcast: each worker gc's its own aggregator ON
        its own thread, so socket-line/h2 state is never mutated from the
        housekeeping thread while a worker joins against it."""
        self._broadcast("gc", now_ns)

    def reap_zombies(self) -> None:
        self._broadcast("reap", None)

    def flush_retries(self, now_ns: int):
        """Timer-driven retry flush, broadcast to the owning workers.
        Returns None (retried rows surface through ``stats`` and the
        merged windows, not a return value — the serial path's contract
        of returning the rows cannot survive the queue hop)."""
        self._broadcast("retries", now_ns)
        return None

    def _put_or_shed(self, i: int, item: _QItem) -> None:
        """Bounded-backpressure enqueue: block at most ``shed_block_s``
        on a backlogged shard queue, then SHED the rows to the ledger —
        a stalled or dead worker must cost data (attributed), never
        wedge the submitting thread (the drop-not-block contract, one
        hop deeper). A queue closed by a racing stop() drops the item's
        rows too — ATTRIBUTED (alazflow ALZ043 found the old bare
        ``except QueueClosed: pass`` losing them untracked): per-item
        here, so shards that enqueued before the close keep their exact
        counts and only the rows that truly never landed are ledgered."""
        try:
            if self._queues[i].put(item, timeout=self.shed_block_s):
                return
        except QueueClosed:
            self.ledger.add("dropped", len(item), reason="closed")
            return
        n = len(item)
        self.ledger.add("shed", n, reason=f"shard{i}_backlog")
        log.warning(f"shard{i} backlogged past {self.shed_block_s}s; shed {n} rows")

    def _scatter(self, kind: str, events: np.ndarray, now_ns) -> None:
        with self._wm_cond:
            self._inflight += 1
        try:
            if self.n == 1:
                self._put_or_shed(0, _QItem(kind, events, now_ns))
                return
            shard = (
                _conn_keys(events["pid"], events["fd"]) % np.uint64(self.n)
            ).astype(np.int64)
            for i in range(self.n):
                idx = np.flatnonzero(shard == i)
                if idx.shape[0]:
                    # ship (chunk, index) and let the WORKER extract its
                    # slice: the 320-byte-record gather is a real copy,
                    # and doing it here would serialize N copies on the
                    # submitting thread
                    self._put_or_shed(i, _QItem(kind, (events, idx), now_ns))
        finally:
            with self._wm_cond:
                self._inflight -= 1
                self._wm_cond.notify_all()

    def _broadcast(self, kind: str, payload) -> None:
        """Control-plane broadcast (close/gc/proc/...): must DELIVER, so
        it retries a full queue instead of shedding — but a queue stays
        full forever only when its worker died, so each retry round
        supervises (restarts dead workers) to unwedge itself."""
        for i, q in enumerate(self._queues):
            item = _QItem(kind, payload, None)
            try:
                while not q.put(item, timeout=0.5):
                    if self._stop.is_set():
                        return
                    self._supervise()
            except QueueClosed:
                pass

    # -- worker / merger loops -----------------------------------------------

    def _worker_loop(self, i: int) -> None:
        q = self._queues[i]
        agg = self.workers[i]
        store = self.stores[i]
        last_wm: Optional[int] = None
        while True:
            item = q.get(timeout=0.1)
            if item is None:
                if self._stop.is_set() or q.closed:
                    return
                continue
            kind, payload, now_ns = item.kind, item.payload, item.now_ns
            try:
                if self.fault_hook is not None:
                    # chaos seam: fires at the item boundary (all-or-
                    # nothing row accounting), may raise WorkerCrash
                    self.fault_hook(i, kind)
                if kind == "l7":
                    agg.process_l7(_shard_rows(payload), now_ns=now_ns)
                elif kind == "tcp":
                    agg.process_tcp(_shard_rows(payload), now_ns=now_ns)
                elif kind == "close":
                    wave, upto = payload
                    try:
                        store.close_upto(upto)
                    finally:
                        # the ack must flow even if aggregation raised —
                        # a silent miss would strand the wave until stop.
                        # Membership-guarded: a straggler ack for a wave
                        # that already completed (or timed out) must not
                        # resurrect its entry. Per-worker set: a
                        # restarted worker acking both the original and
                        # the re-driven close counts ONCE.
                        with self._wm_cond:
                            if wave in self._wave_acks:
                                self._wave_acks[wave].add(i)
                            self._wm_cond.notify_all()
                elif kind == "proc":
                    agg.process_proc(payload)
                elif kind == "retries":
                    agg.flush_retries(
                        payload if payload is not None else time.time_ns()
                    )
                elif kind == "gc":
                    agg.gc(payload)
                elif kind == "reap":
                    agg.reap_zombies()
            except WorkerCrash:
                # the thread dies with this item in flight: attribute its
                # rows before going (conservation survives the crash),
                # then let the supervisor shell take over. ONLY L7 rows
                # carry weight in the conservation books (the process
                # backend's kill-settle rule, process_pool.py): a TCP
                # establish never becomes a REQUEST row, so ledgering a
                # crashed tcp item counts rows no numerator pushed —
                # the per-tenant gate reads that as a negative gap. The
                # row-visible consequence of the lost socket state is
                # ledgered downstream as filtered/no_socket.
                if kind == "l7":
                    self.ledger.add("dropped", len(item), reason="worker_crash")
                raise
            except Exception as exc:  # keep the shard alive; mirror service workers
                # the failed batch's rows reach neither emit nor retry —
                # attribute them (alazflow ALZ043) so conservation holds
                # through a poison batch, not just through injected
                # crashes. Attribution errs toward overcounting when the
                # engine emitted part of the batch before raising; a
                # negative gap is the loud failure mode, not a silent one.
                # L7-only, same contract as the crash path above.
                if kind == "l7":
                    self.ledger.add("dropped", len(item), reason="batch_error")
                log.warning(f"shard{i} {kind} batch failed: {exc}")
            finally:
                q.task_done()
            if kind in ("l7", "retries"):
                wm = store.watermark
                if wm is not None and wm != last_wm:
                    last_wm = wm
                    with self._wm_cond:
                        self._worker_wm[i] = wm
                        self._wm_cond.notify_all()

    def _closable_locked(self) -> Optional[int]:
        """Highest window id safe to close, or None. Caller holds
        ``_wm_cond``. Workers with QUEUED work constrain the close (their
        backlog may hold older windows): min over their processed
        watermarks, the serial close rule taken shard-wise. Workers that
        are idle (everything delivered is processed) do NOT hold the
        horizon back — a shard whose connections simply went quiet must
        not stall emission forever — so with every worker idle the rule
        degenerates to max(watermark) - 1, exactly the serial store's.
        Idle-based closes are suppressed while a scatter is mid-flight
        (``_inflight``): an "idle" worker whose slice of the current
        chunk hasn't been enqueued yet isn't idle, it's early. Rows a
        quiet shard receives later for a closed window drop as late —
        the same fate the serial path gives rows behind the watermark."""
        busy: List[int] = []
        idle: List[int] = []
        for i in range(self.n):
            wm = self._worker_wm[i]  # alazlint: disable=ALZ010 -- both callers hold self._wm_cond (documented caller-holds-lock helper; the lint pass is intra-function)
            if self._queues[i].unfinished:
                if wm is None:
                    return None  # a worker with queued work hasn't started
                busy.append(wm)
            elif wm is not None:
                idle.append(wm)
        if busy:
            return min(busy) - 1
        if idle and not self._inflight:  # alazlint: disable=ALZ010 -- caller holds self._wm_cond, see above
            return max(idle) - 1
        return None

    def _merger_loop(self) -> None:
        while not self._stop.is_set():
            with self._wm_cond:
                closable = self._closable_locked()
                if closable is None or closable <= self._merged_upto:
                    self._wm_cond.wait(0.2)
                    closable = self._closable_locked()
                ready = closable is not None and closable > self._merged_upto
            if self._stop.is_set():
                return
            # supervision heartbeat: a worker that died outside any wave
            # (mid-l7) would otherwise pin _closable_locked to None via
            # its stale watermark + growing backlog, stalling every
            # window silently — restart it here, wave or no wave
            self._supervise()
            if ready:
                # bounded even on the merge thread: _await_wave self-
                # heals dead workers, so the bound only trips on a
                # pathological stall — in which case the merger must
                # come back to supervise rather than wedge forever
                self._run_close_wave(closable, timeout_s=60.0)

    def _run_close_wave(
        self, upto: Optional[int], timeout_s: Optional[float] = None
    ) -> bool:
        """One full close wave: broadcast the close request, wait for
        every worker's ack (each has aggregated its shard by then),
        recombine + assemble + emit in window order. Serialized under
        ``_merge_lock`` (merge thread vs flush callers), so emission
        order is globally window-ascending. With ``timeout_s`` the whole
        wave — including the wait for a concurrent wave's lock — is
        bounded: on expiry it returns False with shelved windows intact
        (the next wave merges them); True once the merge ran."""
        deadline = (
            None if timeout_s is None else time.monotonic() + timeout_s
        )
        if timeout_s is None:
            self._merge_lock.acquire()  # alazlint: disable=ALZ012,ALZ042 -- paired with the finally below; the timeout branch needs acquire(timeout=...) and `with` can't express it. Unbounded only when the CALLER passed timeout_s=None, an explicit opt-in (every entry-surface caller passes a budget)
        elif not self._merge_lock.acquire(timeout=timeout_s):  # alazlint: disable=ALZ012 -- bounded acquire (a stalled merge must not wedge flush); released in the finally
            log.error(
                f"close wave: merge lock not free within {timeout_s}s "
                "(stalled merge?); giving up this wave"
            )
            return False
        try:
            # restart-generation baseline BEFORE the broadcast: a worker
            # restarted between here and the ack wait shows as a gen
            # bump, and _await_wave re-drives its close regardless of
            # WHICH thread's supervision performed the restart
            gen0 = self._gen_snapshot()
            wave = self._start_wave()
            self._broadcast("close", (wave, upto))
            remaining = (
                None if deadline is None
                else max(deadline - time.monotonic(), 0.05)
            )
            if not self._await_wave(wave, upto, remaining, gen0):
                return False  # stopped or timed out mid-wave
            t0 = time.perf_counter()
            taken = [s.take_ready(upto) for s in self.stores]
            windows = sorted(set().union(*[set(t) for t in taken]))
            if windows:
                horizon = windows[-1]
                for s in self.stores:
                    s.seal_upto(horizon)
            for w in windows:
                parts = [t[w] for t in taken if w in t]
                if self.n == 1:
                    # single shard: the serial builder path verbatim
                    rows = parts[0]
                    labels = (
                        self.label_fn(rows) if self.label_fn is not None else None
                    )
                    batch = self.builder.build(
                        rows,
                        window_start_ms=w * self.window_ms,
                        window_end_ms=(w + 1) * self.window_ms,
                        edge_label=labels,
                    )
                else:
                    batch = self.builder.build_from_partials(
                        parts,
                        window_start_ms=w * self.window_ms,
                        window_end_ms=(w + 1) * self.window_ms,
                    )
                if self.on_batch is not None:
                    self.on_batch(batch)
                else:
                    self.batches.append(batch)
                # completes the span here when no scorer follows
                # (complete_at_emit); the service's tracer keeps it open
                self.tracer.emit(w * self.window_ms)
            self.merge_s += time.perf_counter() - t0
            self.windows_merged += len(windows)
            self._last_wave_monotonic = time.monotonic()
        finally:
            self._merge_lock.release()
        # advance the merged horizon to the WAVE's target even when no
        # window had rows — otherwise an empty wave never moves it and
        # the merger loop re-broadcasts the same close at full spin
        target = upto
        if windows and (target is None or windows[-1] > target):
            target = windows[-1]
        if target is not None:
            with self._wm_cond:
                if target > self._merged_upto:
                    self._merged_upto = target
        return True

    def _start_wave(self) -> int:
        with self._wm_cond:
            self._wave_seq += 1
            wave = self._wave_seq
            self._wave_acks[wave] = set()
            return wave

    def _await_wave(
        self,
        wave: int,
        upto: Optional[int],
        timeout_s: Optional[float],
        gen0: List[int],
    ) -> bool:
        """Wait for every worker's close ack, self-healing as it waits:
        a worker that died can never ack, so each poll round restarts
        dead workers and RE-DRIVES the close to any worker whose restart
        GENERATION moved past the wave-start baseline ``gen0`` without
        an ack — whichever thread's supervision actually performed the
        restart (the merger heartbeat races this waiter; keying off "my
        _supervise restarted it" loses that race and strands the wave).
        The original close item died with the crashed thread or sits
        behind a backlog the restarted thread drains first — a duplicate
        close is idempotent: the store pops nothing new and the
        straggler ack is a per-worker set entry. Returns False when
        stopped or when ``timeout_s`` expires first."""
        deadline = (
            None if timeout_s is None else time.monotonic() + timeout_s
        )
        seen_gen = list(gen0)
        while True:
            with self._wm_cond:
                if len(self._wave_acks.get(wave, ())) >= self.n:
                    del self._wave_acks[wave]
                    return True
                if self._stop.is_set():
                    self._wave_acks.pop(wave, None)
                    return False
                self._wm_cond.wait(0.2)
                if len(self._wave_acks.get(wave, ())) >= self.n:
                    del self._wave_acks[wave]
                    return True
                acked = set(self._wave_acks.get(wave, ()))
            if deadline is not None and time.monotonic() > deadline:
                with self._wm_cond:
                    self._wave_acks.pop(wave, None)
                log.error(
                    f"close wave {wave} timed out awaiting worker acks"
                )
                return False
            # outside the condition (lock order: never queue-put under
            # _wm_cond): restart the dead, re-drive restarted non-ackers
            self._supervise()
            cur = self._gen_snapshot()
            for i in range(self.n):
                if cur[i] != seen_gen[i] and i not in acked:
                    if self._redrive_close(i, wave, upto, deadline):
                        seen_gen[i] = cur[i]
                    # on failure seen_gen stays: the next poll round
                    # retries the re-drive (gen still differs)

    def _redrive_close(
        self, i: int, wave: int, upto: Optional[int], deadline: Optional[float]
    ) -> bool:
        """Bounded, self-healing re-drive: each retry round supervises
        (the restarted worker may have crashed AGAIN with its queue at
        capacity — without a restart nothing ever drains it) and the
        wave's own deadline caps the whole attempt, so the merge thread
        can degrade to a timed-out wave but never wedge here."""
        item = _QItem("close", (wave, upto), None)
        while not self._stop.is_set():
            if deadline is not None and time.monotonic() > deadline:
                return False
            try:
                if self._queues[i].put(item, timeout=0.5):
                    return True
            except QueueClosed:
                return False
            self._supervise()
        return False

    # -- windowed-store surface ---------------------------------------------

    def flush(self, timeout_s: float = 30.0) -> bool:
        """Close and merge every open window. The close requests queue
        BEHIND all previously submitted batches, so no pre-drain is
        needed — the wave ack means each worker has processed everything
        that was in flight when flush was called (the serial store's
        watermark-inclusive ``flush()`` semantics).

        BOUNDED (ISSUE 6): returns within ~``timeout_s`` even with a
        worker killed or stalled mid-wave — dead workers restart and the
        close re-drives; a stall longer than the budget yields False
        with all state intact (call again to finish). The regression
        gate: flush/drain may degrade to False, never to a hang."""
        return self._run_close_wave(None, timeout_s=timeout_s)

    def drain(self, timeout_s: float = 10.0) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.unfinished == 0:
                return True
            time.sleep(0.002)
        return False

    @property
    def unfinished(self) -> int:
        return sum(q.unfinished for q in self._queues)

    @property
    def pending_retries(self) -> int:
        return sum(a.pending_retries for a in self.workers)

    @property
    def request_count(self) -> int:
        return sum(s.request_count for s in self.stores)

    @property
    def late_dropped(self) -> int:
        return sum(s.late_dropped for s in self.stores)

    @property
    def last_persist_monotonic(self) -> Optional[float]:
        stamps = [
            s.last_persist_monotonic
            for s in self.stores
            if s.last_persist_monotonic is not None
        ]
        return max(stamps) if stamps else None

    @property
    def stats(self) -> AggregatorStats:
        """Aggregated engine stats across the shard workers (a snapshot —
        the summed object is fresh per read, not shared state)."""
        total = AggregatorStats()
        for a in self.workers:
            for k, v in a.stats.as_dict().items():
                setattr(total, k, getattr(total, k) + v)
        return total
