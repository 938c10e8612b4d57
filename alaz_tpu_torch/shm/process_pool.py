"""Process-mode ``ShardedIngest`` backend (ISSUE 15 tentpole).

``ProcessShardedIngest`` duck-types the thread backend's whole surface —
the ``Aggregator`` ingestion side (``process_l7`` / ``process_tcp`` /
``process_proc`` / ``process_k8s`` / ``gc`` / ``reap_zombies`` /
``flush_retries``) and the windowed-store side (``flush`` / ``drain`` /
``stats`` / the supervision gauges) — so ``runtime.service.Service`` and
the chaos/bench harnesses swap it in behind
``RuntimeConfig.ingest_backend = "process"`` with no caller changes.

Same scatter/close-wave/merge skeleton as ``aggregator/sharded.py``,
with every thread-mode sharing point replaced by an explicit exchange:

    submit (any thread) → hash-partition by connection key
        → [N request rings] → shard worker PROCESSES (spawn), each
          running the private Aggregator → ShardPartialStore loop with
          a PER-PROCESS Interner/ClusterInfo/DropLedger — out of the
          parent's GIL entirely
        → close waves: broadcast K_CLOSE; each worker aggregates its
          shard ON ITS OWN CORE and ships uid-LOCAL EdgePartial frames
          + an interner delta table through its response ring, then acks
        → merge thread: folds deltas into the SHARED Interner, remaps
          uids through the per-worker exchange table, recombines with
          ``GraphBuilder.build_from_partials`` — bit-identical to serial
          and to thread mode (the PR 5 equivalence property, extended).

Conservation through a SIGKILL (the chaos process-kill gate): the
parent logs every row it scatters per worker; the ring tail says exactly
which records the dead worker fully processed (commit-after-process —
a record mid-flight at the kill REPLAYS to the respawn, see ring.py);
the worker's ledger mirror in the STATS block says which consumed rows
it attributed; received partials say which it emitted. The residual —
rows pending in the dead store — is attributed ``dropped/shm<i>_kill``
at respawn, so ``pushed == emitted + ledger.total`` stays EXACT through
the kill.

Lock order (one direction, alazsan-stressed): ``_merge_lock`` →
``_io_lock`` (response drains / respawn) → ``_state_lock`` (acks,
stash, horizon) → per-ring producer locks → ledger/tracer leaf locks.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import signal
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np

from alaz_tpu_torch.aggregator.cluster import ClusterInfo
from alaz_tpu_torch.aggregator.engine import AggregatorStats, _conn_keys
from alaz_tpu_torch.aggregator.sharded import WorkerCrash, _W_FLOOR
from alaz_tpu_torch.config import RuntimeConfig
from alaz_tpu_torch.datastore.interface import DataStore
from alaz_tpu_torch.events.intern import Interner
from alaz_tpu_torch.events.k8s import K8sResourceMessage
from alaz_tpu_torch.graph.builder import GraphBuilder
from alaz_tpu_torch.graph.snapshot import GraphBatch
from alaz_tpu_torch.logging import get_logger
from alaz_tpu_torch.obs.recorder import FlightRecorder
from alaz_tpu_torch.obs.spans import SpanTracer
from alaz_tpu_torch.shm import codec
from alaz_tpu_torch.shm.ring import (
    DEFAULT_RING_SLOTS,
    DEFAULT_SLOT_BYTES,
    KIND_NAMES,
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
    S_LAST_PERSIST,
    S_LATE_DROPPED,
    S_PENDING_RETRIES,
    S_REQUEST_COUNT,
    S_WATERMARK,
    ShmRing,
    W_FLOOR,
)
from alaz_tpu_torch.shm.worker import WorkerSpec, shard_worker_main
from alaz_tpu_torch.utils.ledger import DropLedger

log = get_logger("alaz_tpu.shm.pool")

_KIND_BY_NAME = {"l7": K_L7, "tcp": K_TCP}


class _WorkerHandle:
    """Parent-side books for one shard worker process. Mutated under the
    pool's ``_io_lock`` (drain/respawn) except the producer cursor and
    row log, which the per-ring ``put_lock`` serializes."""

    def __init__(self, index: int, req: ShmRing, resp: ShmRing):
        self.index = index
        self.req = req
        self.resp = resp
        self.producer = RingProducer(req)
        self.put_lock = threading.Lock()
        self.consumer = RingConsumer(resp, start_cursor=0)
        self.proc: Optional[multiprocessing.process.BaseProcess] = None
        self.generation = 0  # lockless-ok: monotonic int bumped only under the pool's _io_lock; racy reads (wave re-drive baseline, ring gauges) tolerate one-poll staleness
        self.spawned_at = 0.0  # monotonic; crash-loop detection
        self.fast_deaths = 0  # consecutive deaths within 1s of spawn
        self.respawn_after = 0.0  # backoff gate (io thread)
        # record/row books (the kill-conservation + backlog inputs):
        # EVERY produced record logs (end_cursor, l7_rows) so the
        # parent can reconstruct both the consumed-record count (the
        # done-counter reconciliation at settle) and the consumed L7
        # rows (the conservation equation)
        self.row_log: deque = deque()  # (end_cursor, l7_rows) unconsumed  # guarded-by: self.put_lock
        self.rows_consumed = 0  # pruned L7-row total (io thread)
        self.records_consumed = 0  # pruned record count (io thread)
        self.rows_in_partials = 0  # WINDOW frames received (io thread)
        self.mirror_folded: Dict[str, int] = {
            c: 0 for c in DropLedger.CAUSES
        }
        self.rows_lost_attributed = 0
        self.produced_records = 0  # guarded-by: self.put_lock
        # id-exchange table: worker-local interner id -> shared id
        self.remap = np.zeros(1024, dtype=np.int32)
        self.remap_size = 0

    # -- id exchange --------------------------------------------------------

    def fold_delta(
        self, base: int, strings: List[str], interner: Interner
    ) -> None:
        """Fold one delta-table ship into the shared interner and extend
        the remap. Ships arrive in ring order, so bases are contiguous;
        a gap means a protocol bug and must be loud."""
        if base != self.remap_size:
            raise RuntimeError(
                f"shm shard{self.index}: interner delta base {base} != "
                f"remap size {self.remap_size} (gen {self.generation})"
            )
        if not strings:
            return
        ids = interner.intern_many(strings)
        need = base + len(strings)
        if need > self.remap.shape[0]:
            grown = np.zeros(max(need, 2 * self.remap.shape[0]), np.int32)
            grown[: self.remap_size] = self.remap[: self.remap_size]
            self.remap = grown
        self.remap[base:need] = ids
        self.remap_size = need

    def remap_uids(self, local_ids: np.ndarray) -> np.ndarray:
        if local_ids.shape[0] and int(local_ids.max()) >= self.remap_size:
            raise RuntimeError(
                f"shm shard{self.index}: partial references local id "
                f"{int(local_ids.max())} beyond exchanged table "
                f"{self.remap_size}"
            )
        return self.remap[local_ids]

    # -- consumption accounting --------------------------------------------

    def prune_consumed(self) -> None:
        """Advance the consumed books past every record the worker has
        fully processed (ring tail passed it — commit-after-process)."""
        tail = self.req.tail
        with self.put_lock:
            while self.row_log and self.row_log[0][0] <= tail:
                self.rows_consumed += self.row_log.popleft()[1]
                self.records_consumed += 1


class ProcessShardedIngest:
    """N shard worker PROCESSES over shared-memory rings with close-wave
    merging — the out-of-GIL backend for the sharded host plane.

    Differences from the thread backend a caller can observe:
    ``tee`` is refused (an export sink would see worker-LOCAL interner
    ids — resolve-at-export would ship wrong strings; route exports off
    the merged batches instead); ``label_fn`` must be picklable (it
    crosses the spawn boundary); and cluster topology must arrive
    through :meth:`process_k8s` — a pre-populated ``cluster=`` argument
    is PARENT-side state (export naming, degree-cap uid parity) that
    never crosses into the workers, whose private ClusterInfos only see
    the ring broadcast. Everything else — ordering, conservation,
    bit-identical output — is contract-equal and property-tested
    against serial and thread mode.
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
        autostart: bool = True,
        ledger: Optional[DropLedger] = None,
        fault_hook: Optional[Callable[[int, str], None]] = None,
        shed_block_s: float = 5.0,
        degree_cap: int = 0,
        sample_seed: int = 0,
        tracer: Optional[SpanTracer] = None,
        recorder: Optional[FlightRecorder] = None,
        slot_bytes: Optional[int] = None,
        ring_slots: Optional[int] = None,
    ):
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        if tee is not None:
            raise ValueError(
                "ingest_backend=process does not support a tee datastore: "
                "worker REQUEST rows carry process-local interner ids the "
                "export sink cannot resolve (use the thread backend for "
                "the export tee, or export from merged batches)"
            )
        if label_fn is not None:
            try:
                pickle.dumps(label_fn)
            except Exception as exc:
                raise ValueError(
                    "ingest_backend=process requires a picklable label_fn "
                    f"(it crosses the spawn boundary): {exc}"
                ) from exc
        self.n = int(n_workers)
        self.ledger = ledger if ledger is not None else DropLedger()
        if tracer is None:
            tracer = SpanTracer(complete_at_emit=True, recorder=recorder)
        self.tracer = tracer
        self.recorder = recorder
        if recorder is not None and self.ledger.recorder is None:
            self.ledger.recorder = recorder
        self.fault_hook = fault_hook  # lockless-ok: attach-once chaos seam (wiring/harness, before traffic); callers null-check an atomic reference read
        self.shed_block_s = float(shed_block_s)
        self.interner = interner if interner is not None else Interner()
        self.config = config if config is not None else RuntimeConfig()
        self.cluster = (
            cluster if cluster is not None else ClusterInfo(self.interner)
        )
        self.window_s = window_s
        self.window_ms = int(window_s * 1000)
        self.on_batch = on_batch
        self.label_fn = label_fn
        # in-class appends happen inside the close-wave merge region;
        # main reads .batches only after stop()/join (happens-before)
        self.batches: List[GraphBatch] = []  # guarded-by: self._merge_lock
        # slot geometry: config knobs unless the caller overrides
        if slot_bytes is None:
            slot_bytes = getattr(
                self.config, "shm_slot_bytes", DEFAULT_SLOT_BYTES
            )
        if ring_slots is None:
            ring_slots = getattr(
                self.config, "shm_ring_slots", DEFAULT_RING_SLOTS
            )
        self.slot_bytes = int(slot_bytes)
        self.ring_slots = int(ring_slots)
        # the cap applies at the merge-stage assembly over SHARED-id
        # uids — the same placement (and the same N-invariance argument)
        # as the thread backend
        self.builder = GraphBuilder(
            window_s=window_s, renumber=renumber,
            degree_cap=degree_cap, sample_seed=sample_seed,
            ledger=self.ledger, tracer=self.tracer,
        )
        self._ctx = multiprocessing.get_context("spawn")
        self.workers: List[_WorkerHandle] = []
        for i in range(self.n):
            req = ShmRing(
                slot_bytes=self.slot_bytes, n_slots=self.ring_slots,
                create=True,
            )
            resp = ShmRing(
                slot_bytes=self.slot_bytes, n_slots=self.ring_slots,
                create=True,
            )
            self.workers.append(_WorkerHandle(i, req, resp))

        # wave / stash / horizon plane
        self._state_lock = threading.Lock()
        self._wave_acks: Dict[int, set] = {}  # guarded-by: self._state_lock
        self._wave_seq = 0  # guarded-by: self._state_lock
        self._stash: Dict[int, List[tuple]] = {}  # window -> [(shard, partial)]  # guarded-by: self._state_lock
        self._inflight = 0  # guarded-by: self._state_lock
        self._merged_upto = _W_FLOOR  # guarded-by: self._state_lock
        self._worker_restarts = 0  # guarded-by: self._state_lock
        # response-ring consumption + respawn are single-flight
        self._io_lock = threading.Lock()
        # whole close waves serialize (merge thread vs flush callers)
        self._merge_lock = threading.Lock()
        self.merge_s = 0.0  # guarded-by: self._merge_lock
        self.windows_merged = 0  # guarded-by: self._merge_lock
        self._last_wave_monotonic = time.monotonic()  # lockless-ok: written inside the merge lock's bounded-acquire region (which the lockset walk models since ISSUE 19); the sanction covers the racy float READ — it IS the last_wave_age_s freshness gauge. Every site is a plain float store/read, never a container mutation, so GIL-atomicity holds

        self._stop = threading.Event()
        self._merge_thread: Optional[threading.Thread] = None  # guarded-by: self._state_lock
        # final-books snapshot: stop() settles every mirror into this
        # dict BEFORE unlinking the segments, so post-stop reads of
        # stats/request_count (the chaos gates do this) stay valid
        self._final: Optional[dict] = None  # lockless-ok: written once by the one thread that wins the stop latch, read after stop returns
        if autostart:
            self.start()

    # -- lifecycle -----------------------------------------------------------

    def _spawn(self, h: _WorkerHandle) -> None:
        spec = WorkerSpec(
            shard_index=h.index,
            n_shards=self.n,
            req_ring=h.req.name,
            resp_ring=h.resp.name,
            window_ms=self.window_ms,
            resp_start_cursor=h.consumer.cursor,
            label_fn=self.label_fn,
            config=self.config,
            generation=h.generation,
        )
        p = self._ctx.Process(
            target=shard_worker_main, args=(spec,),
            name=f"alaz-shmshard{h.index}g{h.generation}", daemon=True,
        )
        p.start()
        h.proc = p
        h.spawned_at = time.monotonic()

    def start(self) -> None:
        with self._state_lock:
            if self._merge_thread is not None:
                return
            self._stop.clear()
            t = threading.Thread(
                target=self._merger_loop, name="alaz-shm-merge", daemon=True
            )
            self._merge_thread = t
        with self._io_lock:  # process handles move only under the io lock
            for h in self.workers:
                if h.proc is None:
                    self._spawn(h)
        t.start()

    def stop(self) -> None:
        if self._stop.is_set() and self._final is not None:
            return  # idempotent (close() then __del__)
        self._stop.set()
        with self._state_lock:
            t = self._merge_thread
            self._merge_thread = None
        if t is not None:
            t.join(timeout=10)
        for h in self.workers:
            # stop record first (wakes a blocked poll with intent), THEN
            # the close latch (after the latch, puts raise RingClosed)
            try:
                with h.put_lock:
                    h.producer.try_put(K_STOP, b"")
            except (RingClosed, ValueError):
                pass
            h.req.close_ring()
        deadline = time.monotonic() + 5.0
        with self._io_lock:  # merge thread is down: uncontended, held for order
            for h in self.workers:
                p = h.proc
                if p is None:
                    continue
                p.join(timeout=max(0.1, deadline - time.monotonic()))
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=2.0)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=2.0)
                h.proc = None
        # settle the books BEFORE the segments go away: drain straggler
        # responses, fold every ledger mirror (conservation gates read
        # the pipeline ledger after stop), snapshot the gauge surfaces
        with self._io_lock:
            for h in self.workers:
                try:
                    self._drain_shard(h)
                    self._fold_mirror(h)
                    h.prune_consumed()
                except Exception as exc:
                    log.warning(f"shm shard{h.index} final drain failed: {exc}")
            total = AggregatorStats()
            final = {
                "request_count": 0, "late_dropped": 0,
                "pending_retries": 0, "last_persist": None,
            }
            for h in self.workers:
                for k, v in h.req.agg_stats_mirror().items():
                    setattr(total, k, getattr(total, k) + int(v))
                final["request_count"] += h.req.stat_u64(S_REQUEST_COUNT)
                final["late_dropped"] += h.req.stat_u64(S_LATE_DROPPED)
                final["pending_retries"] += h.req.stat_u64(S_PENDING_RETRIES)
                lp = h.req.stat_f64(S_LAST_PERSIST)
                if lp > 0.0 and (
                    final["last_persist"] is None or lp > final["last_persist"]
                ):
                    final["last_persist"] = lp
            final["stats"] = total
            for h in self.workers:
                for r in (h.req, h.resp):
                    r.detach()
                    r.unlink()
            self._final = final

    def close(self) -> None:
        self.stop()

    def wait_ready(self, timeout_s: float = 30.0) -> bool:
        """Block until every CURRENT-generation worker's loop is up
        (spawn + re-import is ~0.5-1 s per process). Optional — the
        rings buffer traffic submitted earlier just fine — but callers
        measuring steady-state throughput (bench) call this so pool
        construction cost stays outside their window, exactly where the
        thread backend's thread-start cost already sits."""
        from alaz_tpu_torch.shm.ring import S_READY_GEN

        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if all(
                h.req.stat_u64(S_READY_GEN) >= h.generation + 1
                for h in self.workers
            ):
                return True
            if self._stop.is_set():
                return False
            time.sleep(0.005)
        return False

    def __del__(self):  # best-effort: never leak /dev/shm segments
        try:
            if not self._stop.is_set():
                self.stop()
        except Exception:
            pass

    # -- supervision (ISSUE 6 contract, process edition) ---------------------

    @property
    def worker_restarts(self) -> int:
        with self._state_lock:
            return self._worker_restarts

    @property
    def last_wave_age_s(self) -> float:
        return time.monotonic() - self._last_wave_monotonic

    def _kill_shard(self, i: int, why: str) -> None:
        """The chaos seam's effect: SIGKILL the shard process — the
        hardest death (no atexit, no flush, books frozen mid-flight)."""
        h = self.workers[i]
        with self._io_lock:
            p = h.proc
            if p is None or not p.is_alive() or p.pid is None:
                return
            pid = p.pid
            if self.recorder is not None:
                self.recorder.record(
                    "worker_kill", worker=i, pid=pid, reason=why
                )
            log.warning(f"shm shard{i} (pid {pid}) SIGKILL: {why}")
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass

    def _supervise(self) -> List[int]:
        """Detect dead shard processes, settle their books exactly, and
        respawn them against the SAME rings (the request backlog — rows
        the dead worker never copied out — drains into the replacement
        in order). Returns the respawned indices so a waiting close wave
        can re-drive its close."""
        restarted: List[int] = []
        if self._stop.is_set():
            return restarted
        for h in self.workers:
            with self._io_lock:
                p = h.proc
                if p is None or p.is_alive():
                    continue
                now = time.monotonic()
                if now < h.respawn_after:
                    continue  # backoff: a crash-looping spawn must not storm
                self._settle_dead_shard(h)
                # exponential backoff on instant deaths (a worker that
                # cannot survive startup — import error, bad spec —
                # would otherwise respawn at poll frequency forever)
                if now - h.spawned_at < 1.0:
                    h.fast_deaths += 1
                    h.respawn_after = now + min(
                        2.0, 0.05 * (2 ** min(h.fast_deaths, 6))
                    )
                    if h.fast_deaths == 3:
                        log.error(
                            f"shm shard{h.index} died instantly 3× — the "
                            "spawn target cannot start. Common cause: the "
                            "owning script lacks an `if __name__ == "
                            "'__main__':` guard (spawn re-imports __main__"
                            "); also check the worker log for import "
                            "errors. Backing off respawns."
                        )
                else:
                    h.fast_deaths = 0
                h.generation += 1
                self._spawn(h)
            with self._state_lock:
                self._worker_restarts += 1
                restarts = self._worker_restarts
            restarted.append(h.index)
            if self.recorder is not None:
                self.recorder.record(
                    "worker_restart", worker=h.index, restart=restarts,
                    process=True,
                )
            log.warning(
                f"shm shard{h.index} worker respawned "
                f"(gen {h.generation}, restart #{restarts})"
            )
            # horizon alignment: the replacement starts with a fresh
            # store; the seal queues BEHIND the request backlog, so
            # backlog rows for already-merged windows still ship and
            # attribute as late at the merge (conserved, never silent).
            # BEST-EFFORT (plain bounded put, no supervision retry): a
            # _put_control here would recurse back into _supervise on a
            # full ring of a crash-looping worker; a missed seal is
            # safe — the merge itself late-drops anything below the
            # horizon (the ≤ merged_upto guard)
            with self._state_lock:
                horizon = self._merged_upto
            if horizon > _W_FLOOR:
                try:
                    with h.put_lock:
                        if h.producer.put(
                            K_SEAL, codec.SEAL_FRAME.pack(horizon),
                            timeout=0.2,
                        ):
                            h.produced_records += 1
                            h.row_log.append((h.producer.cursor, 0))
                except RingClosed:
                    pass
        return restarted

    def _settle_dead_shard(self, h: _WorkerHandle) -> None:
        """Settle a dead worker's books (caller holds ``_io_lock``):
        drain every committed response, fold the ledger mirror, then
        attribute the residual — rows the worker consumed but neither
        shipped in a partial nor ledgered — as ``dropped``. The exact
        equation the chaos process-kill gate checks."""
        exitcode = None if h.proc is None else h.proc.exitcode
        self._drain_shard(h)  # partials/acks committed before death
        self._fold_mirror(h)
        h.prune_consumed()
        # done-counter reconciliation: a kill between the dead worker's
        # ring commit and its S_DONE_RECORDS write would otherwise
        # desync produced-vs-done by one FOREVER (phantom backlog —
        # unfinished never 0, drain() never settles). The parent's
        # pruned record count is the authoritative consumed count; the
        # respawn continues from it.
        h.req.set_stat_u64(S_DONE_RECORDS, h.records_consumed)
        mirror = sum(h.mirror_folded.values())
        lost = (
            h.rows_consumed
            - h.rows_in_partials
            - mirror
            - h.rows_lost_attributed
        )
        if lost > 0:
            self.ledger.add("dropped", lost, reason=f"shm{h.index}_kill")
            h.rows_lost_attributed += lost
        elif lost < 0:
            # negative = double counting somewhere — loud, never silent
            log.error(
                f"shm shard{h.index}: kill accounting gap {lost} "
                f"(consumed={h.rows_consumed} partials={h.rows_in_partials} "
                f"mirror={mirror})"
            )
        if self.recorder is not None:
            self.recorder.record(
                "worker_crash", worker=h.index, reason=f"exit={exitcode}",
                rows_lost=max(0, lost), process=True,
            )
        log.warning(
            f"shm shard{h.index} worker died (exit {exitcode}); "
            f"{max(0, lost)} in-flight rows attributed dropped"
        )
        # the replacement brings a fresh interner: reset the exchange
        h.remap_size = 0

    # -- ingestion surface (Aggregator duck type) ----------------------------

    def process_l7(self, events: np.ndarray, now_ns: Optional[int] = None) -> None:
        self._scatter("l7", events, now_ns)

    def process_tcp(self, events: np.ndarray, now_ns: Optional[int] = None) -> None:
        self._scatter("tcp", events, now_ns)

    def process_proc(self, events: np.ndarray) -> None:
        # (pid, fd) sharding splits a pid's fds across workers: broadcast
        payload = codec.encode_events(events)
        for h in self.workers:
            self._put_control(h, K_PROC, payload)

    def process_k8s(self, msg: K8sResourceMessage) -> None:
        # fold into the PARENT cluster first — the shared interner gets
        # uid strings in the same deterministic order as the serial
        # path (degree-cap priorities are uid-pure; parity depends on
        # this) — then broadcast so every worker's private cluster can
        # attribute its shard's traffic
        self.cluster.handle_msg(msg)
        payload = pickle.dumps(msg)
        for h in self.workers:
            self._put_control(h, K_K8S, payload)

    def gc(self, now_ns: Optional[int] = None) -> None:
        for h in self.workers:
            self._put_control(h, K_GC, b"", now_ns=now_ns)

    def reap_zombies(self) -> None:
        for h in self.workers:
            self._put_control(h, K_REAP, b"")

    def flush_retries(self, now_ns: int):
        for h in self.workers:
            self._put_control(h, K_RETRIES, b"", now_ns=now_ns)
        return None

    def _fault(self, i: int, kind: str) -> None:
        """Chaos seam, process edition: the hook runs parent-side at
        item boundaries; a WorkerCrash verdict becomes a SIGKILL of the
        shard process — mid-wave when the item is a close."""
        hook = self.fault_hook
        if hook is None:
            return
        try:
            hook(i, kind)
        except WorkerCrash as exc:
            self._kill_shard(i, str(exc))

    def _scatter(self, kind: str, events: np.ndarray, now_ns) -> None:
        with self._state_lock:
            self._inflight += 1
        try:
            if self.n == 1:
                self._put_rows(0, kind, events, None, now_ns)
                return
            shard = (
                _conn_keys(events["pid"], events["fd"]) % np.uint64(self.n)
            ).astype(np.int64)
            for i in range(self.n):
                idx = np.flatnonzero(shard == i)
                if idx.shape[0]:
                    self._put_rows(i, kind, events, idx, now_ns)
        finally:
            with self._state_lock:
                self._inflight -= 1

    def _put_rows(self, i: int, kind: str, events, idx, now_ns) -> None:
        """Bounded-backpressure row put: gather the shard slice straight
        into the ring (one copy — the scatter thread's rate is the
        pipeline ceiling) and block at most ``shed_block_s`` on a
        backlogged ring, then SHED to the ledger (ring-full is the
        queue-full of this backend)."""
        self._fault(i, kind)
        h = self.workers[i]
        n = int(events.shape[0] if idx is None else idx.shape[0])
        try:
            with h.put_lock:
                ok = h.producer.put_rows(
                    _KIND_BY_NAME[kind], events, idx, now_ns=now_ns,
                    timeout=self.shed_block_s,
                )
                if ok:
                    h.produced_records += 1
                    # ONLY L7 rows carry weight in the kill-conservation
                    # books: the equation is pushed-L7 == emitted +
                    # ledger, and a TCP event never becomes a REQUEST
                    # row or a partial — row-weighting it would
                    # attribute the worker's entire lifetime TCP intake
                    # as "dropped" at the first kill
                    h.row_log.append(
                        (h.producer.cursor, n if kind == "l7" else 0)
                    )
                    return
        except RingClosed:
            # per-event attribution, like the thread backend's
            # _put_or_shed (the kill-settle equation above is the only
            # place TCP must stay out — lifetime vs in-flight)
            self.ledger.add("dropped", n, reason="closed")
            return
        self.ledger.add("shed", n, reason=f"shard{i}_backlog")
        log.warning(
            f"shm shard{i} ring backlogged past {self.shed_block_s}s; "
            f"shed {n} rows"
        )

    def _put_control(
        self, h: _WorkerHandle, kind: int, payload, now_ns=None,
        deadline_s: float = 60.0,
    ) -> bool:
        """Control-plane put: retries a full ring with supervision
        between rounds (a ring stays full forever only when its worker
        died), but BOUNDED — a worker that cannot start at all (the
        crash-loop path) must cost a dropped control record and a loud
        log, never a wedged k8s/housekeeping/merge thread. Every control
        kind tolerates loss: closes re-drive by generation, seals are
        belt-and-braces under the merge's own horizon guard, gc/reap/
        retries are periodic, and a k8s fold for a worker that never
        runs folds nothing either way."""
        deadline = time.monotonic() + deadline_s
        while not self._stop.is_set():
            try:
                with h.put_lock:
                    ok = h.producer.put(kind, payload, now_ns=now_ns, timeout=0.5)
                    if ok:
                        h.produced_records += 1
                        h.row_log.append((h.producer.cursor, 0))
                        return True
            except RingClosed:
                return False
            if time.monotonic() > deadline:
                log.error(
                    f"shm shard{h.index}: control record "
                    f"{KIND_NAMES.get(kind, kind)} undeliverable for "
                    f"{deadline_s:.0f}s (worker unstartable?); dropping it"
                )
                return False
            self._supervise()
        return False

    # -- response drain / merge plane ----------------------------------------

    def _drain_shard(self, h: _WorkerHandle) -> None:
        """Drain one response ring (caller holds ``_io_lock``). Folds
        interner deltas, remaps partials into shared-id space, stamps
        the span plane, records acks. View+commit: decode_window copies
        the columns it keeps, so the frame itself never needs a
        materializing pass."""
        while True:
            rec = h.consumer.try_get_view()
            if rec is None:
                return
            try:
                self._consume_response(h, rec)
            finally:
                h.consumer.commit()

    def _consume_response(self, h: _WorkerHandle, rec) -> None:
        if rec.kind == K_WINDOW:
            (
                w, partial, base, strings, t_first, t_close, dur,
            ) = codec.decode_window(rec.payload)
            h.fold_delta(base, strings, self.interner)
            partial.from_uid = h.remap_uids(partial.from_uid)
            partial.to_uid = h.remap_uids(partial.to_uid)
            h.rows_in_partials += partial.rows
            ws_ms = w * self.window_ms
            tr = self.tracer
            if tr is not None:
                tr.first_row(ws_ms, t=t_first if t_first > 0 else None)
                tr.close_start(ws_ms, t=t_close if t_close > 0 else None)
                tr.observe(ws_ms, "shard_close", dur)
            with self._state_lock:
                self._stash.setdefault(w, []).append((h.index, partial))
        elif rec.kind == K_ACK:
            wave, _ = codec.decode_close(rec.payload)
            with self._state_lock:
                if wave in self._wave_acks:
                    self._wave_acks[wave].add(h.index)

    def _drain_responses(self) -> None:
        with self._io_lock:
            for h in self.workers:
                self._drain_shard(h)
                self._fold_mirror(h)
                h.prune_consumed()

    def _fold_mirror(self, h: _WorkerHandle) -> None:
        """Fold the worker's crash-surviving ledger mirror into the
        pipeline ledger (delta since last fold, per cause) — one
        bookkeeper for the conservation equation, parent side."""
        mirror = h.req.ledger_mirror()
        for cause, cur in mirror.items():
            delta = cur - h.mirror_folded[cause]
            if delta > 0:
                self.ledger.add(cause, delta, reason=f"shm{h.index}")
                h.mirror_folded[cause] = cur

    def _closable(self) -> Optional[int]:
        """Highest window id safe to close — the thread backend's rule,
        read through the STATS blocks: min over busy workers' processed
        watermarks; all-idle degenerates to max(wm) - 1, suppressed
        while a scatter is mid-flight."""
        with self._state_lock:
            inflight = self._inflight
        busy: List[int] = []
        idle: List[int] = []
        for h in self.workers:
            wm = h.req.stat_i64(S_WATERMARK)
            with h.put_lock:
                produced = h.produced_records
            backlog = produced - h.req.stat_u64(S_DONE_RECORDS)
            if backlog > 0:
                if wm == W_FLOOR:
                    return None  # queued work on a worker with no progress
                busy.append(wm)
            elif wm != W_FLOOR:
                idle.append(wm)
        if busy:
            return min(busy) - 1
        if idle and not inflight:
            return max(idle) - 1
        return None

    def _merger_loop(self) -> None:
        while not self._stop.is_set():
            self._drain_responses()
            self._supervise()
            closable = self._closable()
            with self._state_lock:
                ready = closable is not None and closable > self._merged_upto
            if self._stop.is_set():
                return
            if ready:
                self._run_close_wave(closable, timeout_s=60.0)
            else:
                time.sleep(0.02)

    def _start_wave(self) -> int:
        with self._state_lock:
            self._wave_seq += 1
            wave = self._wave_seq
            self._wave_acks[wave] = set()
            return wave

    def _run_close_wave(
        self, upto: Optional[int], timeout_s: Optional[float] = None
    ) -> bool:
        deadline = (
            None if timeout_s is None else time.monotonic() + timeout_s
        )
        if timeout_s is None:
            self._merge_lock.acquire()  # alazlint: disable=ALZ012,ALZ042 -- paired with the finally below; timeout branch needs acquire(timeout=) which `with` can't express. Unbounded only on explicit caller opt-in (every entry-surface caller passes a budget)
        elif not self._merge_lock.acquire(timeout=timeout_s):  # alazlint: disable=ALZ012 -- bounded acquire (a stalled merge must not wedge flush); released in the finally
            log.error(
                f"shm close wave: merge lock not free within {timeout_s}s; "
                "giving up this wave"
            )
            return False
        windows: List[int] = []
        try:
            gen0 = [h.generation for h in self.workers]
            wave = self._start_wave()
            close_payload = codec.encode_close(wave, upto)
            for h in self.workers:
                self._fault(h.index, "close")
                self._put_control(h, K_CLOSE, close_payload)
            remaining = (
                None if deadline is None
                else max(deadline - time.monotonic(), 0.05)
            )
            if not self._await_wave(wave, upto, remaining, gen0):
                return False
            self._drain_responses()  # every acked worker's windows are in
            t0 = time.perf_counter()
            with self._state_lock:
                windows = sorted(
                    w for w in self._stash if upto is None or w <= upto
                )
                taken = {w: self._stash.pop(w) for w in windows}
                merged_upto = self._merged_upto
            for w in windows:
                parts = [p for _, p in sorted(taken[w], key=lambda t: t[0])]
                ws_ms = w * self.window_ms
                if w <= merged_upto:
                    # a respawned worker's backlog re-shipped a window
                    # the horizon already passed: re-emitting would
                    # corrupt every downstream consumer — attribute and
                    # drop (the seal-horizon contract, parent side)
                    late_rows = sum(p.rows for p in parts)
                    self.ledger.add(
                        "late", late_rows, reason="sealed_horizon"
                    )
                    self.tracer.discard(ws_ms)
                    continue
                batch = self.builder.build_from_partials(
                    parts,
                    window_start_ms=ws_ms,
                    window_end_ms=(w + 1) * self.window_ms,
                )
                if self.on_batch is not None:
                    self.on_batch(batch)
                else:
                    self.batches.append(batch)
                self.tracer.emit(ws_ms)
            self.merge_s += time.perf_counter() - t0
            self.windows_merged += len(windows)
            self._last_wave_monotonic = time.monotonic()
        finally:
            self._merge_lock.release()
        target = upto
        if windows and (target is None or windows[-1] > target):
            target = windows[-1]
        if target is not None:
            seal = False
            with self._state_lock:
                if target > self._merged_upto:
                    self._merged_upto = target
                    seal = True
            if seal:
                payload = codec.SEAL_FRAME.pack(target)
                for h in self.workers:
                    self._put_control(h, K_SEAL, payload)
        return True

    def _await_wave(
        self,
        wave: int,
        upto: Optional[int],
        timeout_s: Optional[float],
        gen0: List[int],
    ) -> bool:
        """Wait for every worker's ack, draining and self-healing as it
        waits: a worker that died can never ack, so each round
        supervises (respawn) and RE-DRIVES the close to any worker whose
        generation moved past the wave-start baseline without an ack
        (its close record died in the old process's copy-out, or sits
        behind the backlog the replacement drains first — a duplicate
        close is idempotent, the straggler ack a set entry)."""
        deadline = (
            None if timeout_s is None else time.monotonic() + timeout_s
        )
        seen_gen = list(gen0)
        close_payload = codec.encode_close(wave, upto)
        while True:
            self._drain_responses()
            with self._state_lock:
                acked = set(self._wave_acks.get(wave, ()))
                if len(acked) >= self.n:
                    del self._wave_acks[wave]
                    return True
            if self._stop.is_set():
                with self._state_lock:
                    self._wave_acks.pop(wave, None)
                return False
            if deadline is not None and time.monotonic() > deadline:
                with self._state_lock:
                    self._wave_acks.pop(wave, None)
                log.error(
                    f"shm close wave {wave} timed out awaiting worker acks"
                )
                return False
            self._supervise()
            for h in self.workers:
                if h.generation != seen_gen[h.index] and h.index not in acked:
                    self._put_control(h, K_CLOSE, close_payload)
                    seen_gen[h.index] = h.generation
            time.sleep(0.002)

    # -- windowed-store surface ---------------------------------------------

    def flush(self, timeout_s: float = 30.0) -> bool:
        """Close and merge every open window; close requests queue
        BEHIND all scattered rows (ring FIFO), so the wave ack means
        each worker processed everything in flight. Bounded: a kill
        mid-wave respawns + re-drives; a stall past the budget yields
        False with all state intact."""
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
        if self._final is not None:
            return 0
        total = 0
        for h in self.workers:
            with h.put_lock:
                produced = h.produced_records
            total += max(0, produced - h.req.stat_u64(S_DONE_RECORDS))
        return total

    @property
    def pending_retries(self) -> int:
        if self._final is not None:
            return self._final["pending_retries"]
        return sum(
            h.req.stat_u64(S_PENDING_RETRIES) for h in self.workers
        )

    @property
    def request_count(self) -> int:
        if self._final is not None:
            return self._final["request_count"]
        return sum(h.req.stat_u64(S_REQUEST_COUNT) for h in self.workers)

    @property
    def late_dropped(self) -> int:
        if self._final is not None:
            return self._final["late_dropped"]
        return sum(h.req.stat_u64(S_LATE_DROPPED) for h in self.workers)

    @property
    def last_persist_monotonic(self) -> Optional[float]:
        if self._final is not None:
            return self._final["last_persist"]
        stamps = [
            h.req.stat_f64(S_LAST_PERSIST)
            for h in self.workers
            if h.req.stat_f64(S_LAST_PERSIST) > 0.0
        ]
        return max(stamps) if stamps else None

    @property
    def stats(self) -> AggregatorStats:
        """Aggregated engine stats across the shard worker processes —
        read from the crash-surviving STATS mirrors (a snapshot; the
        summed object is fresh per read; stop() freezes the final one)."""
        if self._final is not None:
            return self._final["stats"]
        total = AggregatorStats()
        for h in self.workers:
            for k, v in h.req.agg_stats_mirror().items():
                setattr(total, k, getattr(total, k) + int(v))
        return total

    def shm_req_pending(self) -> int:
        """Request-side committed-but-unconsumed slots, summed — the
        scrape-path gauge read. Lock-free on purpose: cursor-hint reads
        only, no put_lock traffic on the scatter path per scrape."""
        if self._final is not None:
            return 0
        return sum(h.req.pending_slots for h in self.workers)

    def shm_resp_pending(self) -> int:
        if self._final is not None:
            return 0
        return sum(h.resp.pending_slots for h in self.workers)

    def ring_stats(self) -> dict:
        """Per-worker ring occupancy/backlog gauges (obs plane)."""
        if self._final is not None:
            return {}
        out = {}
        for h in self.workers:
            with h.put_lock:
                produced = h.produced_records
            out[str(h.index)] = {
                "req_pending_slots": h.req.pending_slots,
                "resp_pending_slots": h.resp.pending_slots,
                "ring_slots": h.req.n_slots,
                "backlog_records": max(
                    0, produced - h.req.stat_u64(S_DONE_RECORDS)
                ),
                "generation": h.generation,
            }
        return out
