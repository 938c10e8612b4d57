"""The shard worker process (ISSUE 15): one spawn target per shard.

Runs the SAME private per-shard loop the thread backend runs —
``Aggregator`` → ``ShardPartialStore`` over this shard's slice of the
connection-key partition — but in its own interpreter, out of the
parent's GIL entirely. Everything thread mode shared is replaced:

- the shared Interner → a PRIVATE per-process Interner; closed windows
  ship uid-LOCAL ``EdgePartial`` frames plus a delta string table, and
  the parent folds + remaps at merge (the id-exchange);
- the shared ClusterInfo → a private one, fed the same k8s control
  messages by ring broadcast (cross-process state is rings + deltas
  only — the alazrace process-role contract);
- the shared DropLedger → a private ledger whose per-cause totals
  mirror into the request ring's STATS block on every add, so the books
  survive a SIGKILL and the parent can prove exact conservation through
  the kill;
- the shared SpanTracer → a local span clock; first-row/close stamps
  ride the window frames (CLOCK_MONOTONIC is system-wide) and feed the
  parent's tracer, so the window lifecycle stays fully attributed.

Single-threaded by construction: the worker owns both ring cursors, its
stats block, and every object it builds — no locks are shared across
the spawn boundary, and none are needed inside it.
"""

from __future__ import annotations

import pickle
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from alaz_tpu_torch.events.schema import (
    L7_EVENT_DTYPE,
    PROC_EVENT_DTYPE,
    TCP_EVENT_DTYPE,
)
from alaz_tpu_torch.logging import get_logger
from alaz_tpu_torch.shm import codec, ring as shm_ring
from alaz_tpu_torch.shm.ring import (
    AGG_STAT_FIELDS,
    K_ACK,
    K_CLOSE,
    K_GC,
    K_K8S,
    K_L7,
    K_PROC,
    K_REAP,
    K_RETRIES,
    K_SEAL,
    K_STOP,
    K_TCP,
    K_WINDOW,
    RingClosed,
    RingConsumer,
    RingProducer,
    S_DONE_RECORDS,
    S_HEARTBEAT,
    S_LAST_PERSIST,
    S_LATE_DROPPED,
    S_LEDGER,
    S_PENDING_RETRIES,
    S_REQUEST_COUNT,
    S_WATERMARK,
    S_AGG_STATS,
    ShmRing,
    W_FLOOR,
)
from alaz_tpu_torch.utils.ledger import DropLedger

log = get_logger("alaz_tpu.shm.worker")


@dataclass
class WorkerSpec:
    """Everything a spawned shard worker needs — picklable by contract
    (spawn pickles the Process args; a non-picklable ``label_fn`` is
    refused at pool construction, not at first traffic)."""

    shard_index: int
    n_shards: int
    req_ring: str  # shm segment names — the only shared state
    resp_ring: str
    window_ms: int
    resp_start_cursor: int = 0
    label_fn: Optional[object] = None
    config: Optional[object] = None  # RuntimeConfig (dataclass, picklable)
    generation: int = 0


class _ShmLedger(DropLedger):
    """DropLedger whose per-cause totals mirror into the request ring's
    STATS block — the crash-surviving half of the books. Totals CONTINUE
    across respawns (the base offsets are the predecessor's mirror), and
    the mirror flush is DEFERRED to record boundaries, AFTER the ring
    commit: a kill mid-record then replays the record with its buffered
    adds discarded (no double-attribution), and a kill between commit
    and flush shifts at most one record's causes into the parent's
    ``dropped`` residual — conservation stays exact either way."""

    def __init__(self, stats_ring: ShmRing):
        super().__init__()
        self._ring = stats_ring
        self._base = stats_ring.ledger_mirror()
        self._dirty: set = set()

    def add(self, cause, n, reason=None):
        super().add(cause, n, reason=reason)
        if n > 0:
            self._dirty.add(cause)

    def flush_mirror(self) -> None:
        for cause in self._dirty:
            idx = self.CAUSES.index(cause)
            self._ring.set_stat_u64(
                S_LEDGER + 8 * idx, self._base[cause] + self.count(cause)
            )
        self._dirty.clear()


class _SpanClock:  # role-private: built and mutated only inside one single-threaded shard worker process; nothing parent-side ever holds a reference
    """SpanTracer duck type for the worker side of the span plane: keeps
    the per-window first-row / close-start stamps and the shard-close
    duration; the stamps ride the window frames back to the parent's
    real tracer. CLOCK_MONOTONIC (= time.perf_counter here) is
    system-wide on the deployment target, so the parent can subtract."""

    def __init__(self):
        self.first: dict = {}
        self.close: dict = {}
        self.dur: dict = {}

    def first_row(self, ws_ms: int) -> None:
        if ws_ms not in self.first:
            self.first[ws_ms] = time.perf_counter()

    def close_start(self, ws_ms: int) -> None:
        if ws_ms not in self.close:
            self.close[ws_ms] = time.perf_counter()

    def observe(self, ws_ms: int, stage: str, dur_s: float) -> None:
        if stage == "shard_close":
            prev = self.dur.get(ws_ms, 0.0)
            if dur_s > prev:
                self.dur[ws_ms] = dur_s

    def pop(self, ws_ms: int):
        """(first_row_t, close_start_t, close_dur_s) for a shipped
        window; entries drop once shipped (bounded state)."""
        t0 = self.first.pop(ws_ms, 0.0)
        tc = self.close.pop(ws_ms, t0)
        return t0, tc, self.dur.pop(ws_ms, 0.0)

    def prune_upto(self, ws_ms_limit: int) -> None:
        """Drop stamps for windows the close horizon passed WITHOUT
        shipping (late-dropped stragglers, sealed windows): pop() never
        runs for those, and a long-lived worker must not accumulate one
        dict entry per late window forever."""
        for d in (self.first, self.close, self.dur):
            for w in [w for w in d if w <= ws_ms_limit]:
                del d[w]


def shard_worker_main(spec: WorkerSpec) -> None:
    """Spawn target: attach the rings and run the shard loop until the
    parent closes the request ring or sends K_STOP."""
    from alaz_tpu_torch.aggregator.cluster import ClusterInfo
    from alaz_tpu_torch.aggregator.engine import Aggregator
    from alaz_tpu_torch.aggregator.sharded import ShardPartialStore
    from alaz_tpu_torch.config import RuntimeConfig
    from alaz_tpu_torch.events.intern import Interner

    req = ShmRing(name=spec.req_ring)
    resp = ShmRing(name=spec.resp_ring)
    consumer = RingConsumer(req)  # resumes at the persisted tail
    producer = RingProducer(resp, start_cursor=spec.resp_start_cursor)

    interner = Interner()
    cluster = ClusterInfo(interner)
    ledger = _ShmLedger(req)
    clock = _SpanClock()
    store = ShardPartialStore(
        spec.window_ms,
        label_fn=spec.label_fn,
        aggregate=True,  # partials always: raw rows carry local uids
        ledger=ledger,
        tracer=clock,
    )
    config = spec.config if spec.config is not None else RuntimeConfig()
    agg = Aggregator(
        store, interner=interner, config=config, cluster=cluster,
        ledger=ledger,
    )
    shipped_strings = 0  # interner rows already sent as deltas
    done = req.stat_u64(S_DONE_RECORDS)  # continue the predecessor's count
    heartbeat = req.stat_u64(S_HEARTBEAT)
    # a fresh process has a fresh (empty) store: announce "no watermark"
    # so the parent's close rule waits for real progress, not the dead
    # predecessor's horizon
    req.set_stat_i64(S_WATERMARK, W_FLOOR)
    # engine backend (ISSUE 16): ENGINE_BACKEND=native reaches this
    # spawned process through RuntimeConfig.engine_backend's env-reading
    # default (or the parent's explicit config). dlopen + layout-check
    # the .so BEFORE the readiness handshake so the first traffic batch
    # never pays the load inside a caller's measured window.
    if agg._use_native_engine():
        eng = agg._native_l7_engine()
        log.info(
            f"shm shard{spec.shard_index} L7 engine backend: native "
            f"(loaded={eng is not None})"
        )
    # readiness handshake: generation+1 (never 0) says THIS generation's
    # loop is about to poll — wait_ready() pins pool spawn cost outside
    # a caller's measured window (the bench's steady-state contract)
    req.set_stat_u64(shm_ring.S_READY_GEN, spec.generation + 1)

    def _ship_windows(taken: dict) -> None:
        nonlocal shipped_strings
        for w in sorted(taken):
            partial = taken[w]
            cur = len(interner)
            delta = (
                interner.strings_since(shipped_strings)
                if cur > shipped_strings
                else []
            )
            t0, tc, dur = clock.pop(w * spec.window_ms)
            payload = codec.encode_window(
                w, partial, shipped_strings, delta, t0, tc, dur
            )
            shipped_strings = cur
            _put_resp(K_WINDOW, payload, rows=partial.rows)

    def _put_resp(kind: int, payload: bytes, rows: int = 0) -> None:
        # must-deliver with a liveness escape: a response ring can only
        # stay full while the parent stopped draining — which means the
        # parent is gone or stopping, and the request ring's close latch
        # is the signal to give up
        while not producer.put(kind, payload, rows=rows, timeout=0.5):
            if req.closed:
                raise RingClosed(req.name)

    def _sync_stats() -> None:
        req.set_stat_i64(
            S_WATERMARK,
            W_FLOOR if store.watermark is None else int(store.watermark),
        )
        req.set_stat_u64(S_REQUEST_COUNT, store.request_count)
        req.set_stat_u64(S_LATE_DROPPED, store.late_dropped)
        req.set_stat_u64(S_PENDING_RETRIES, agg.pending_retries)
        lp = store.last_persist_monotonic
        req.set_stat_f64(S_LAST_PERSIST, 0.0 if lp is None else float(lp))
        for i, f in enumerate(AGG_STAT_FIELDS):
            req.set_stat_u64(S_AGG_STATS + 8 * i, getattr(agg.stats, f))

    log.info(
        f"shm shard{spec.shard_index} worker up "
        f"(gen {spec.generation}, ring {spec.req_ring})"
    )
    while True:
        # zero-copy view; the slots stay reserved until commit() below,
        # so a SIGKILL mid-record REPLAYS it against the respawn's fresh
        # state instead of losing it
        rec = consumer.get_view(timeout=0.05)
        if rec is None:
            if req.closed:
                break
            continue
        heartbeat += 1
        req.set_stat_u64(S_HEARTBEAT, heartbeat)
        kind = rec.kind
        try:
            if kind == K_L7:
                agg.process_l7(
                    codec.decode_events(rec.payload, L7_EVENT_DTYPE),
                    now_ns=rec.now_ns,
                )
            elif kind == K_TCP:
                agg.process_tcp(
                    codec.decode_events(rec.payload, TCP_EVENT_DTYPE),
                    now_ns=rec.now_ns,
                )
            elif kind == K_CLOSE:
                wave, upto = codec.decode_close(rec.payload)
                try:
                    store.close_upto(upto)
                    _ship_windows(store.take_ready(upto))
                    if upto is not None:
                        # stamps for windows the horizon passed without
                        # shipping (late stragglers) would otherwise
                        # leak one entry per window forever
                        clock.prune_upto(upto * spec.window_ms)
                finally:
                    # the ack must flow even if aggregation raised — a
                    # silent miss would strand the wave until timeout
                    # (same contract as the thread worker's finally)
                    _put_resp(K_ACK, codec.encode_close(wave, upto))
            elif kind == K_PROC:
                agg.process_proc(
                    codec.decode_events(rec.payload, PROC_EVENT_DTYPE)
                )
            elif kind == K_K8S:
                agg.process_k8s(pickle.loads(bytes(rec.payload)))
            elif kind == K_RETRIES:
                agg.flush_retries(
                    rec.now_ns if rec.now_ns is not None else time.time_ns()
                )
            elif kind == K_GC:
                agg.gc(rec.now_ns)
            elif kind == K_REAP:
                agg.reap_zombies()
            elif kind == K_SEAL:
                store.seal_upto(codec.SEAL_FRAME.unpack_from(rec.payload)[0])
            elif kind == K_STOP:
                break
        except RingClosed:
            consumer.commit()
            break
        except Exception as exc:  # keep the shard alive; mirror the thread worker
            # a poison batch's rows reach neither emit nor retry —
            # attribute them so conservation holds through it
            if kind in (K_L7, K_TCP):
                ledger.add("dropped", rec.rows, reason="batch_error")
            log.warning(
                f"shm shard{spec.shard_index} "
                f"{shm_ring.KIND_NAMES.get(kind, kind)} record failed: {exc}"
            )
        # ORDER IS THE CRASH CONTRACT: commit (consume point) first,
        # mirror flush second — a kill between the two shifts this one
        # record's causes into the parent's `dropped` residual, never
        # loses or double-counts a row
        consumer.commit()
        ledger.flush_mirror()
        done += 1
        req.set_stat_u64(S_DONE_RECORDS, done)
        if kind in (K_L7, K_TCP, K_RETRIES, K_CLOSE, K_SEAL):
            _sync_stats()
    ledger.flush_mirror()
    _sync_stats()
    req.detach()
    resp.detach()
    log.info(f"shm shard{spec.shard_index} worker exiting cleanly")
