"""The aggregator engine — the aggregator/data.go join core (G9), columnar.

Responsibilities, mapped to the reference:

- ``process_tcp``  : TCP state events → socket-line opens/closes
  (processTcpConnect, data.go:404-476) + optional AliveConnection emits.
- ``process_l7``   : L7 event batches → attributed ``REQUEST_DTYPE`` edges
  (processL7 → per-protocol handlers, data.go:1364-1383,1208-1272) with
  socket-line fallback join for events without embedded addresses
  (findRelatedSocket, data.go:1407-1429) and a bounded retry queue for
  events that raced their TCP state (signal-and-requeue, data.go:404-437;
  attemptLimit 3 / 20ms, data.go:105-110).
- ``process_proc`` : proc exit → socket-line teardown (zombie reaper analog,
  data.go:192-219).
- ``process_k8s``  : informer messages → cluster IP maps + datastore
  forwarding (processk8s, data.go:239-263; persist.go).

Everything hot is vectorized over the batch; per-event Python happens only
for low-rate protocols (SQL/Mongo/Kafka/AMQP payload parsing) and is
amortized by unique-payload grouping.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

import numpy as np

from alaz_tpu_torch.aggregator.cluster import ClusterInfo
from alaz_tpu_torch.aggregator.dns import ReverseDnsCache
from alaz_tpu_torch.aggregator.h2 import Http2Assembler
from alaz_tpu_torch.aggregator.sockline import SockInfo, SocketLineStore
from alaz_tpu_torch.config import RuntimeConfig
from alaz_tpu_torch.datastore.dto import (
    ALIVE_CONNECTION_DTYPE,
    EP_OUTBOUND,
    EP_POD,
    KAFKA_CONSUME,
    KAFKA_EVENT_DTYPE,
    KAFKA_PUBLISH,
    REQUEST_DTYPE,
    reverse_direction,
)
from alaz_tpu_torch.datastore.interface import DataStore
from alaz_tpu_torch.events.intern import Interner
from alaz_tpu_torch.events.k8s import K8sResourceMessage
from alaz_tpu_torch.events.schema import (
    PROC_EVENT_DTYPE,
    AmqpMethod,
    Http2Method,
    L7Protocol,
    MongoMethod,
    ProcEventType,
    RedisMethod,
    TcpEventType,
)
from alaz_tpu_torch.logging import get_logger
from alaz_tpu_torch.protocols import http as http_proto
from alaz_tpu_torch.protocols import kafka as kafka_proto
from alaz_tpu_torch.protocols import mongo as mongo_proto
from alaz_tpu_torch.protocols import mysql as mysql_proto
from alaz_tpu_torch.protocols import postgres as postgres_proto
from alaz_tpu_torch.utils.ratelimit import TokenBucket, admit_batch

log = get_logger("alaz_tpu.aggregator")

RETRY_ATTEMPT_LIMIT = 3  # data.go:109 attemptLimit
RETRY_INTERVAL_NS = 20_000_000  # data.go:108 retryInterval (20ms)

_PATH_CACHE_MAX = 65536  # per-protocol parsed-path cache bound (cleared in gc)

# A/B toggle for the native L7 engine body, mirroring
# builder.set_native_grouping: None follows RuntimeConfig.engine_backend,
# True/False force the native/python join stage regardless of config.
_native_engine_override: Optional[bool] = None


def set_native_engine(enabled: Optional[bool]) -> None:
    """Force the L7 engine backend: True = native (alz_process_l7),
    False = python (numpy join stage), None = follow
    ``RuntimeConfig.engine_backend``. Parity tests and the bench A/B flip
    both backends through this one switch, like ``set_native_grouping``
    does for the grouping stage."""
    global _native_engine_override
    _native_engine_override = enabled


# sentinel: the join/fill stage ran (side effects: requeue/ledger/stats
# done) but every row dropped — distinct from None, which means the stage
# did NOT run and the caller may fall back without double-counting
_EMPTY_BATCH = ()


def _conn_keys(pid: np.ndarray, fd: np.ndarray) -> np.ndarray:
    """(pid, fd) → mixed u64 grouping key (collision odds are 2^-64-ish;
    used only to group rows that share a socket line)."""
    with np.errstate(over="ignore"):
        return (pid.astype(np.uint64) << np.uint64(32)) ^ (
            fd * np.uint64(0x9E3779B97F4A7C15)
        )


class ConnStmtCache(dict):
    """Prepared-statement cache keyed ``(pid, fd, stmt-id)`` with a
    per-connection index, so teardown on TCP CLOSED / proc EXIT costs
    O(statements on that connection), not O(whole cache): the previous
    scan walked every cached statement per closed-pair batch, which at a
    65k-entry cache made every connection churn a full-cache sweep.

    Only the mutation surface the engine and protocol parsers actually
    use is indexed (``[]=``, ``pop``, ``del``, the drop_* teardowns) —
    other dict mutators are unsupported."""

    def __init__(self) -> None:
        super().__init__()
        self._by_conn: dict[tuple[int, int], set] = {}
        self._fds_of_pid: dict[int, set] = {}

    def __setitem__(self, key, value) -> None:
        if key not in self:
            conn = (key[0], key[1])
            self._by_conn.setdefault(conn, set()).add(key)
            self._fds_of_pid.setdefault(key[0], set()).add(key[1])
        super().__setitem__(key, value)

    def _unindex(self, key) -> None:
        conn = (key[0], key[1])
        keys = self._by_conn.get(conn)
        if keys is None:
            return
        keys.discard(key)
        if not keys:
            del self._by_conn[conn]
            fds = self._fds_of_pid.get(key[0])
            if fds is not None:
                fds.discard(key[1])
                if not fds:
                    del self._fds_of_pid[key[0]]

    def __delitem__(self, key) -> None:
        super().__delitem__(key)
        self._unindex(key)

    _MISSING = object()

    def pop(self, key, default=_MISSING):
        if default is self._MISSING:
            value = super().pop(key)
        else:
            if key not in self:
                return default
            value = super().pop(key)
        self._unindex(key)
        return value

    def clear(self) -> None:
        super().clear()
        self._by_conn.clear()
        self._fds_of_pid.clear()

    def _unsupported(self, *_a, **_k):
        raise NotImplementedError(
            "ConnStmtCache indexes only []=, del, pop and the drop_* "
            "teardowns; this mutator would silently desync the "
            "connection index"
        )

    update = setdefault = popitem = __ior__ = _unsupported

    def drop_conn(self, pid: int, fd: int) -> int:
        """Delete every statement cached for one (pid, fd)."""
        keys = self._by_conn.pop((pid, fd), None)
        if not keys:
            return 0
        for k in keys:
            super().__delitem__(k)
        fds = self._fds_of_pid.get(pid)
        if fds is not None:
            fds.discard(fd)
            if not fds:
                del self._fds_of_pid[pid]
        return len(keys)

    def drop_pid(self, pid: int) -> int:
        """Delete every statement cached for any fd of one pid."""
        n = 0
        for fd in list(self._fds_of_pid.get(pid, ())):
            n += self.drop_conn(pid, fd)
        return n


class AggregatorStats:
    def __init__(self) -> None:
        self.l7_in = 0
        self.l7_joined = 0
        self.l7_dropped_no_socket = 0
        self.l7_dropped_not_pod = 0
        self.l7_requeued = 0
        # single-writer stream counters: each is incremented by exactly
        # one worker (tcp/proc/k8s consume loops); readers are /stats
        # gauges where an off-by-one-batch read is fine
        self.tcp_in = 0  # lockless-ok: single-writer GIL-atomic int counter (tcp worker); racy reads are stats gauges
        self.proc_in = 0  # lockless-ok: single-writer GIL-atomic int counter (proc worker); racy reads are stats gauges
        self.k8s_in = 0  # lockless-ok: single-writer GIL-atomic int counter (k8s fold thread); racy reads are stats gauges
        self.edges_out = 0
        self.kafka_out = 0
        self.l7_rate_limited = 0

    def as_dict(self) -> dict:
        return dict(self.__dict__)


class Aggregator:
    def __init__(
        self,
        ds: DataStore,
        interner: Optional[Interner] = None,
        config: Optional[RuntimeConfig] = None,
        cluster: Optional[ClusterInfo] = None,
        proc_root: str | None = None,
        ledger=None,
        recorder=None,
    ):
        self.ds = ds
        # optional flight recorder (alaz_tpu/obs): rare
        # structural events — zombie-reap sweeps tearing down join
        # state — become ring events a post-incident dump replays.
        # Per-sweep, never per row.
        self.recorder = recorder
        # unified loss accounting: the join/attribution stage's
        # semantic drops (no socket after retries, non-pod source, rate
        # limit) land in the shared ledger's `filtered` cause, so
        # pushed == emitted + ledger.total holds with no side-channel
        # "semantic" term. A private ledger when the caller has none —
        # the stats counters remain the per-reason observability surface.
        if ledger is None:
            from alaz_tpu_torch.utils.ledger import DropLedger

            ledger = DropLedger()
        self.ledger = ledger
        self.interner = interner if interner is not None else Interner()
        self.config = config if config is not None else RuntimeConfig()
        # where tracked pids live: /proc by default, /host/proc when the
        # service runs containerized with the host procfs mounted. All
        # liveness probes go through this root, never the service's own
        # pid namespace (see reap_zombies). Derives from config unless a
        # caller overrides it directly (tests).
        self.proc_root = (
            proc_root if proc_root is not None else self.config.proc_root
        )
        self.cluster = cluster if cluster is not None else ClusterInfo(self.interner)
        self.socket_lines = SocketLineStore()
        self.h2 = Http2Assembler()
        self.stats = AggregatorStats()
        self.live_pids: set[int] = set()
        # prepared-statement caches (pgStmts / mySqlStmts analogs),
        # conn-indexed so teardown never scans the whole cache
        self.pg_stmts: ConnStmtCache = ConnStmtCache()
        self.mysql_stmts: ConnStmtCache = ConnStmtCache()
        # retry queue of (l7 rows, attempts, not_before_ns)
        self._retries: deque[tuple[np.ndarray, int, int]] = deque()  # guarded-by: self._l7_lock
        # L7 processing is single-logical-threaded, but the housekeeping
        # ticker also fires flush_retries (ADVICE: retries must not wait
        # for the next L7 batch); reentrant because process_l7 flushes too
        self._l7_lock = threading.RLock()
        # payload-hash → interned path id, per protocol (cross-batch cache)
        self._path_cache: dict[int, dict[int, int]] = {}
        self.reverse_dns = ReverseDnsCache()
        # per-pid rate limiting (100/s burst 1000, data.go:339-353) — the
        # reference applies it on the trace path; gated off by default
        self.rate_limit: tuple[float, float] | None = None
        self._pid_buckets: dict[int, TokenBucket] = {}  # guarded-by: self._l7_lock
        # native L7 engine: per-aggregator handle, owns the
        # socket-line snapshot cache. Resolved lazily on the first batch
        # so set_native_engine flips after construction still take effect;
        # _native_l7_failed latches the miss so an absent .so logs once.
        self._native_l7 = None  # guarded-by: self._l7_lock
        self._native_l7_failed = False  # guarded-by: self._l7_lock

    def backfill_from_proc(
        self,
        pids: list[int] | None = None,
        proc_root: str | None = None,
        now_ns: int | None = None,
    ) -> int:
        """Cold-start: seed socket lines for connections that predate this
        agent from /proc/<pid>/fd + /proc/<pid>/net/tcp
        (sock_num_line.go:223-269,352-429). Returns lines created. Called
        once at startup so V1-joined L7 events on long-lived connections
        attribute immediately instead of dropping until fresh TCP events
        arrive."""
        from alaz_tpu_torch.aggregator.procfs import backfill_socket_lines

        proc_root = proc_root if proc_root is not None else self.proc_root
        now_ns = now_ns if now_ns is not None else time.time_ns()
        created = backfill_socket_lines(
            self.socket_lines, pids=pids, proc_root=proc_root, now_ns=now_ns
        )
        if created:
            log.info(f"cold-start backfill: {created} socket lines from {proc_root}")
        return created

    # ------------------------------------------------------------------
    # TCP events
    # ------------------------------------------------------------------

    def process_tcp(self, events: np.ndarray, now_ns: int | None = None) -> None:
        """Fold a TCP_EVENT_DTYPE batch into socket lines."""
        self.stats.tcp_in += events.shape[0]
        interesting = (events["type"] == TcpEventType.ESTABLISHED) | (
            events["type"] == TcpEventType.CLOSED
        )
        events = events[interesting]  # alazlint: disable=ALZ040 -- TCP state events are control plane, not request rows; conservation counts L7 rows only and non-ESTABLISHED/CLOSED types carry no join state
        if events.shape[0] == 0:
            return
        _, starts, inverse = np.unique(
            _conn_keys(events["pid"], events["fd"]), return_index=True, return_inverse=True
        )
        alive_rows = []
        closed_pairs: set[tuple[int, int]] = set()
        for g, start in enumerate(starts):
            rows = events[inverse == g]  # alazlint: disable=ALZ040 -- per-connection grouping: every group is visited, no event leaves the loop unprocessed
            pid = int(rows["pid"][0])
            fd = int(rows["fd"][0])
            line = self.socket_lines.get_or_create(pid, fd)
            self.live_pids.add(pid)  # alazlint: disable=ALZ051 -- idempotent element op: liveness set tolerates ingest/reap interleaving; add/discard are single container ops, never check-then-act
            for r in rows:
                if r["type"] == TcpEventType.ESTABLISHED:
                    line.add_value(
                        int(r["timestamp_ns"]),
                        SockInfo(
                            pid=pid,
                            fd=fd,
                            saddr=int(r["saddr"]),
                            sport=int(r["sport"]),
                            daddr=int(r["daddr"]),
                            dport=int(r["dport"]),
                        ),
                    )
                    alive_rows.append(r)
                else:
                    line.add_value(int(r["timestamp_ns"]), None)
                    closed_pairs.add((pid, fd))
        if closed_pairs:
            self._teardown_conns(closed_pairs)
        if self.config.send_alive_tcp_connections and alive_rows:
            self._persist_alive(np.array(alive_rows, dtype=events.dtype))

    def _teardown_conns(self, closed_pairs: set[tuple[int, int]]) -> None:
        """Per-connection state teardown on TCP CLOSED: h2 parsers and
        prepared-statement caches must not survive a (pid, fd) reuse
        (reference deletes both on close, data.go:363-380,496-500). Runs
        on the TCP worker; the stmt caches are mutated by the L7 worker
        under _l7_lock, so take it here too."""
        for pid, fd in closed_pairs:
            self.h2.remove_conn(pid, fd)
        with self._l7_lock:
            for pid, fd in closed_pairs:
                self.pg_stmts.drop_conn(pid, fd)
                self.mysql_stmts.drop_conn(pid, fd)

    def _persist_alive(self, rows: np.ndarray) -> None:
        out = np.zeros(rows.shape[0], dtype=ALIVE_CONNECTION_DTYPE)
        out["check_time_ms"] = rows["timestamp_ns"] // 1_000_000
        out["from_ip"] = rows["saddr"]
        out["from_port"] = rows["sport"]
        out["to_ip"] = rows["daddr"]
        out["to_port"] = rows["dport"]
        ft, fu = self.cluster.attribute(rows["saddr"])
        tt, tu = self.cluster.attribute(rows["daddr"])
        out["from_type"], out["from_uid"] = ft, fu
        out["to_type"], out["to_uid"] = tt, tu
        self.ds.persist_alive_connections(out)

    def reap_zombies(self, kill_fn=None) -> list[int]:
        """Tear down the state of processes that died without an EXIT
        event — the 2-minute zombie reaper (data.go:192-219). The
        default probe is existence of ``<proc_root>/<pid>``, NOT
        ``kill(pid, 0)``: tracked pids come from agents on the node and
        are host pids, while this service may run in a container with
        its own pid namespace — kill() would consult the wrong process
        table and reap every live pid. ``kill_fn`` is injectable for
        tests and for callers that really do share a pid namespace."""
        import os as os_mod

        if kill_fn is None:
            root = self.proc_root
            if not os_mod.path.isdir(root):
                # an unmounted/typoed proc root would read as "every pid
                # is dead" and tear down ALL join state each sweep — a
                # destructive misconfiguration that must be loud, not a
                # silent purge
                log.error(
                    f"zombie reaper: proc root {root!r} does not exist; "
                    "skipping sweep (check PROC_ROOT / the procfs mount)"
                )
                return []

            def kill_fn(pid, _sig, _root=root):
                if not os_mod.path.isdir(os_mod.path.join(_root, str(pid))):
                    raise ProcessLookupError(pid)

        dead: list[int] = []
        for pid in list(self.live_pids):
            try:
                kill_fn(pid, 0)
            except ProcessLookupError:
                dead.append(pid)
            except PermissionError:
                pass  # exists but owned elsewhere: alive
            except OSError:
                pass
        if dead:
            ev = np.zeros(len(dead), dtype=PROC_EVENT_DTYPE)
            ev["pid"] = dead
            ev["type"] = ProcEventType.EXIT
            self.process_proc(ev)
            if self.recorder is not None:
                # a reap tears down join state for every dead pid — the
                # kind of rare structural event a flight-recorder dump
                # needs to explain "why did attribution drop at t"
                self.recorder.record(
                    "zombie_reap", pids=len(dead),
                    live_pids=len(self.live_pids),
                )
        return dead

    # ------------------------------------------------------------------
    # Proc events
    # ------------------------------------------------------------------

    def process_proc(self, events: np.ndarray) -> None:
        self.stats.proc_in += events.shape[0]
        for r in events:
            pid = int(r["pid"])
            if r["type"] == ProcEventType.EXIT:
                self.live_pids.discard(pid)  # alazlint: disable=ALZ051 -- idempotent element op: liveness set tolerates ingest/reap interleaving; add/discard are single container ops, never check-then-act
                self.socket_lines.remove_pid(pid)
                self.h2.remove_pid(pid)
                with self._l7_lock:  # stmt caches belong to the L7 worker
                    self.pg_stmts.drop_pid(pid)
                    self.mysql_stmts.drop_pid(pid)
                    # a reused pid must start with a fresh burst
                    # allowance. Under the same lock as the L7 worker's
                    # bucket inserts (alazrace ALZ050: this pop used to
                    # ride bare on dict-op GIL atomicity while
                    # _apply_rate_limit inserted concurrently)
                    self._pid_buckets.pop(pid, None)
            elif r["type"] == ProcEventType.EXEC:
                self.live_pids.add(pid)  # alazlint: disable=ALZ051 -- idempotent element op: liveness set tolerates ingest/reap interleaving; add/discard are single container ops, never check-then-act

    # ------------------------------------------------------------------
    # K8s events
    # ------------------------------------------------------------------

    def process_k8s(self, msg: K8sResourceMessage) -> None:
        self.stats.k8s_in += 1
        self.cluster.handle_msg(msg)
        self.ds.persist_resource(msg.resource_type, msg.event_type, msg.object)

    # ------------------------------------------------------------------
    # L7 events
    # ------------------------------------------------------------------

    def process_l7(self, events: np.ndarray, now_ns: int | None = None) -> np.ndarray:
        """Join + attribute an L7_EVENT_DTYPE batch. Returns the emitted
        REQUEST_DTYPE rows (also persisted to the datastore)."""
        now_ns = now_ns if now_ns is not None else time.time_ns()
        with self._l7_lock:
            self.stats.l7_in += events.shape[0]
            if self.rate_limit is not None and events.shape[0]:
                events = self._apply_rate_limit(events, now_ns)
            emitted = self._process_l7_inner(events, attempts=0, now_ns=now_ns)
            retried = self.flush_retries(now_ns)
        if retried is not None and retried.shape[0]:
            emitted = np.concatenate([emitted, retried])
        return emitted

    def _apply_rate_limit(self, events: np.ndarray, now_ns: int) -> np.ndarray:
        """Per-pid token buckets (rate.Limiter semantics, data.go:339-353).
        The only Python walk left is over UNIQUE pids — one dict lookup
        each to fetch/create the bucket; the admit math runs as one array
        pass (``admit_batch``) and the keep mask scatters back without
        per-group slicing. Drops, ledger attribution and post-batch bucket
        state are bit-identical to ``_scalar_apply_rate_limit`` below."""
        rate, burst = self.rate_limit
        now_s = now_ns / 1e9
        n = events.shape[0]
        pids, inverse = np.unique(events["pid"], return_inverse=True)
        # group rows per pid in O(n log n): one sort, contiguous slices
        order = np.argsort(inverse, kind="stable")
        boundaries = np.searchsorted(inverse[order], np.arange(pids.shape[0] + 1))
        sizes = np.diff(boundaries)
        buckets = []
        for pid in pids:
            bucket = self._pid_buckets.get(int(pid))  # alazlint: disable=ALZ010 -- _l7_lock IS held here: _apply_rate_limit's only caller is process_l7 inside `with self._l7_lock` (the per-file rule can't see caller-held locks; alazrace's interprocedural lockset can and agrees)
            if bucket is None:
                bucket = TokenBucket(rate, burst, now_s=now_s)
                self._pid_buckets[int(pid)] = bucket  # alazlint: disable=ALZ010 -- same caller-held _l7_lock as the get above
            buckets.append(bucket)
        admitted = admit_batch(buckets, sizes, now_s)
        # keep the first admitted[g] rows of each pid group in ORIGINAL row
        # order (argsort is stable, so within a group `order` ascends by
        # original index): rank-within-group < allowance, scattered back
        rank = np.arange(n, dtype=np.int64) - np.repeat(boundaries[:-1], sizes)
        keep = np.empty(n, dtype=bool)
        keep[order] = rank < np.repeat(admitted, sizes)
        dropped = int(n - int(keep.sum()))
        if dropped:
            self.stats.l7_rate_limited += dropped
            self.ledger.add("filtered", dropped, reason="rate_limit")
            events = events[keep]
        return events

    def _scalar_apply_rate_limit(self, events: np.ndarray, now_ns: int) -> np.ndarray:
        """Pre-vectorization reference (one ``bucket.admit`` per pid group)
        — kept for the equivalence property tests."""
        rate, burst = self.rate_limit
        now_s = now_ns / 1e9
        keep = np.ones(events.shape[0], dtype=bool)
        pids, inverse = np.unique(events["pid"], return_inverse=True)
        order = np.argsort(inverse, kind="stable")
        boundaries = np.searchsorted(inverse[order], np.arange(pids.shape[0] + 1))
        for g, pid in enumerate(pids):
            bucket = self._pid_buckets.get(int(pid))  # alazlint: disable=ALZ010 -- same caller-held _l7_lock contract as _apply_rate_limit
            if bucket is None:
                bucket = TokenBucket(rate, burst, now_s=now_s)
                self._pid_buckets[int(pid)] = bucket  # alazlint: disable=ALZ010 -- same caller-held _l7_lock as the get above
            idx = order[boundaries[g] : boundaries[g + 1]]
            admitted = bucket.admit(idx.shape[0], now_s)
            if admitted < idx.shape[0]:
                keep[idx[admitted:]] = False
        dropped = int((~keep).sum())
        if dropped:
            self.stats.l7_rate_limited += dropped
            self.ledger.add("filtered", dropped, reason="rate_limit")
            events = events[keep]
        return events

    @property
    def pending_retries(self) -> int:
        with self._l7_lock:  # stat probe races the L7 worker's requeues
            return len(self._retries)

    def flush_retries(self, now_ns: int) -> np.ndarray | None:
        """Re-run due retry entries (the signal-and-requeue path). Safe to
        call from the housekeeping ticker — the reference's retry is
        timer-driven, not gated on the next L7 batch."""
        out = []
        with self._l7_lock:
            pending = len(self._retries)
            for _ in range(pending):
                rows, attempts, not_before = self._retries.popleft()
                if not_before > now_ns:
                    self._retries.append((rows, attempts, not_before))
                    continue
                out.append(self._process_l7_inner(rows, attempts, now_ns))
        if not out:
            return None
        return np.concatenate(out) if len(out) > 1 else out[0]

    def _use_native_engine(self) -> bool:
        if _native_engine_override is not None:
            return _native_engine_override
        return getattr(self.config, "engine_backend", "python") == "native"

    def _native_l7_engine(self):
        """Lazy per-aggregator NativeL7Engine, or None (fallback). The
        miss latches so an unbuildable .so logs one warning, not one per
        batch."""
        if self._native_l7 is None and not self._native_l7_failed:  # alazlint: disable=ALZ010 -- _l7_lock IS held on every concurrent path (process_l7/flush_retries callers); the remaining callers are single-threaded construction-time prewarms (sharded pool init, shm worker pre-ready) before any traffic thread exists
            from alaz_tpu_torch.aggregator import native_l7

            self._native_l7 = native_l7.make_engine()  # alazlint: disable=ALZ010 -- same caller-held _l7_lock / pre-traffic prewarm contract as the check above
            if self._native_l7 is None:  # alazlint: disable=ALZ010 -- same caller-held _l7_lock / pre-traffic prewarm contract as the check above
                self._native_l7_failed = True  # alazlint: disable=ALZ010 -- same caller-held _l7_lock / pre-traffic prewarm contract as the check above
                log.warning(
                    "engine_backend=native requested but libalaz_ingest.so "
                    "is unavailable; falling back to the python L7 engine"
                )
        return self._native_l7  # alazlint: disable=ALZ010 -- same caller-held _l7_lock / pre-traffic prewarm contract as the check above

    def _process_l7_inner(
        self, events: np.ndarray, attempts: int, now_ns: int
    ) -> np.ndarray:
        n = events.shape[0]
        if n == 0:
            return np.zeros(0, dtype=REQUEST_DTYPE)

        # join + attribution + REQUEST-row fill: one native pass when the
        # engine backend allows, else the numpy stage. Both do their own
        # requeue/drop bookkeeping; None means "did not run" (native
        # unavailable — no side effects yet, python fallback is safe),
        # _EMPTY_BATCH means "ran, every row dropped/requeued".
        prep = None
        if self._use_native_engine():
            eng = self._native_l7_engine()
            if eng is not None:
                prep = self._native_join_fill(eng, events, attempts, now_ns)
        if prep is None:
            prep = self._python_join_fill(events, attempts, now_ns)
        if prep is _EMPTY_BATCH:
            return np.zeros(0, dtype=REQUEST_DTYPE)
        events, out, protocol, proto_present = prep

        # outbound destinations: reverse-DNS name when the gated cache has
        # one, else the IP string (setFromToV2 fallback chain,
        # data.go:852-866). Vectorized per UNIQUE address: name_for takes
        # the cache lock and intern hashes a string — per-row they were
        # the single hottest Python loop in the V2 ingest path. Stays
        # Python on both backends (refusal surface: interner + DNS cache).
        outbound = out["to_type"] == np.uint8(EP_OUTBOUND)
        if outbound.any():
            out["to_uid"][outbound] = self._outbound_uids(
                np.ascontiguousarray(out["to_ip"][outbound])
            )

        # per-protocol payload enrichment
        self._enrich_paths(events, out, protocol, proto_present)

        # consume-side direction flips (AMQP DELIVER / Redis PUSHED_EVENT)
        if proto_present[int(L7Protocol.AMQP)] or proto_present[int(L7Protocol.REDIS)]:
            method = np.ascontiguousarray(events["method"])
            flip = (
                (protocol == L7Protocol.AMQP) & (method == AmqpMethod.DELIVER)
            ) | (
                (protocol == L7Protocol.REDIS) & (method == RedisMethod.PUSHED_EVENT)
            )
            if flip.any():
                reverse_direction(out, flip)

        # HTTP2 frames & Kafka payloads detour through their assemblers;
        # the common all-plain batch skips the masks AND the row copy
        has_h2 = bool(proto_present[int(L7Protocol.HTTP2)])
        has_kafka = bool(proto_present[int(L7Protocol.KAFKA)])
        if has_h2 or has_kafka:
            h2_mask = protocol == L7Protocol.HTTP2
            kafka_mask = protocol == L7Protocol.KAFKA
            if has_h2:
                h2_out = self._process_h2(events[h2_mask], out[h2_mask])
                if h2_out is not None and h2_out.shape[0]:
                    self.ds.persist_requests(h2_out)
                    self.stats.edges_out += h2_out.shape[0]
            if has_kafka:
                self._process_kafka(events[kafka_mask], out[kafka_mask])
            result = out[~h2_mask & ~kafka_mask]
        else:
            result = out
        if result.shape[0]:
            self.ds.persist_requests(result)
            self.stats.edges_out += result.shape[0]
            self.stats.l7_joined += result.shape[0]
        return result

    def _native_join_fill(self, eng, events: np.ndarray, attempts: int, now_ns: int):
        """Native join/fill stage: hand the batch plus socket-line snapshot
        and attribution tables to ``alz_process_l7``, then fold the drop
        counts into the SAME requeue/stats/ledger bookkeeping the python
        stage does (order pinned by ``L7_ENGINE_DROP_CAUSES``:
        counts[0]=no_socket-or-retry, counts[1]=not_pod). Returns the
        (events, out, protocol, proto_present) stage tuple, _EMPTY_BATCH
        when everything dropped, or None when the call could not run (no
        side effects — python fallback is exact)."""
        res = eng.process(
            events, now_ns, self.socket_lines, *self.cluster.compiled_tables()
        )
        if res is None:
            return None
        out, kept_idx, unmatched_idx, n_not_pod = res
        if unmatched_idx.shape[0]:
            if attempts + 1 < RETRY_ATTEMPT_LIMIT:
                rows = events[unmatched_idx]  # fancy index -> fresh copy
                backoff = RETRY_INTERVAL_NS * (1 << attempts)  # 20ms, 40ms
                self._retries.append((rows, attempts + 1, now_ns + backoff))  # alazlint: disable=ALZ010 -- _l7_lock IS held: every _process_l7_inner caller (process_l7, flush_retries) wraps the call in the lock
                self.stats.l7_requeued += rows.shape[0]
            else:
                lost = int(unmatched_idx.shape[0])
                self.stats.l7_dropped_no_socket += lost
                self.ledger.add("filtered", lost, reason="no_socket")
        if n_not_pod:
            self.stats.l7_dropped_not_pod += n_not_pod
            self.ledger.add("filtered", n_not_pod, reason="not_pod")
        if out.shape[0] == 0:
            return _EMPTY_BATCH
        if kept_idx.shape[0] != events.shape[0]:
            events = events[kept_idx]
        # else: every row survived — kept_idx is ascending-unique, so it
        # is the identity, and the 331-byte-per-row gather is pure waste;
        # the python stage leaves `events` un-copied on this path too, so
        # aliasing the caller's view is the established contract
        protocol = np.ascontiguousarray(events["protocol"])
        proto_present = np.bincount(protocol, minlength=256)
        return events, out, protocol, proto_present

    def _python_join_fill(self, events: np.ndarray, attempts: int, now_ns: int):
        """Numpy join/fill stage (the pre-ISSUE-16 `_process_l7_inner`
        body, verbatim): V1 socket-line join, retry requeue, pod/outbound
        attribution, REQUEST row fill. Returns (events, out, protocol,
        proto_present) or _EMPTY_BATCH when every row dropped/requeued."""
        saddr = events["saddr"]
        sport = events["sport"]
        daddr = events["daddr"]
        dport = events["dport"]

        # V1 fallback: rows without embedded addresses join via socket lines
        # keyed (pid, fd) at the write timestamp (findRelatedSocket).
        need_join = daddr == 0
        matched = ~need_join
        if need_join.any():
            # the join writes resolved addresses in place — detach from
            # the events array first. The all-V2 hot path (every row
            # carries addresses) skips these four copies entirely.
            saddr, sport = saddr.copy(), sport.copy()
            daddr, dport = daddr.copy(), dport.copy()
            j_idx = np.flatnonzero(need_join)
            sub = events[j_idx]
            _, starts, inverse = np.unique(
                _conn_keys(sub["pid"], sub["fd"]), return_index=True, return_inverse=True
            )
            for g, start in enumerate(starts):
                sel = j_idx[inverse == g]
                pid = int(events["pid"][sel[0]])
                fd = int(events["fd"][sel[0]])
                line = self.socket_lines.get(pid, fd)
                if line is None or len(line) == 0:
                    continue
                found, s_a, s_p, d_a, d_p = line.get_values(
                    events["write_time_ns"][sel], now_ns
                )
                hit = sel[found]
                saddr[hit] = s_a[found]
                sport[hit] = s_p[found]
                daddr[hit] = d_a[found]
                dport[hit] = d_p[found]
                matched[hit] = True

        # requeue unmatched rows (socket state may lag the L7 event)
        unmatched = ~matched
        if unmatched.any():
            if attempts + 1 < RETRY_ATTEMPT_LIMIT:
                rows = events[unmatched].copy()
                backoff = RETRY_INTERVAL_NS * (1 << attempts)  # 20ms, 40ms
                self._retries.append((rows, attempts + 1, now_ns + backoff))  # alazlint: disable=ALZ010 -- _l7_lock IS held: every _process_l7_inner caller (process_l7, flush_retries) wraps the call in the lock
                self.stats.l7_requeued += rows.shape[0]
            else:
                lost = int(unmatched.sum())
                self.stats.l7_dropped_no_socket += lost
                self.ledger.add("filtered", lost, reason="no_socket")
            events = events[matched]
            saddr, sport = saddr[matched], sport[matched]
            daddr, dport = daddr[matched], dport[matched]
            if events.shape[0] == 0:
                return _EMPTY_BATCH

        # attribution: From must be a pod, else drop (setFromToV2 contract)
        from_type, from_uid = self.cluster.attribute(saddr)
        is_pod = from_type == EP_POD
        if not is_pod.all():
            lost = int((~is_pod).sum())
            self.stats.l7_dropped_not_pod += lost
            self.ledger.add("filtered", lost, reason="not_pod")
            events = events[is_pod]
            if events.shape[0] == 0:
                return _EMPTY_BATCH
            saddr, sport = saddr[is_pod], sport[is_pod]
            daddr, dport = daddr[is_pod], dport[is_pod]
            from_type, from_uid = from_type[is_pod], from_uid[is_pod]
        to_type, to_uid = self.cluster.attribute(daddr)

        # one contiguous copy of the protocol column: it is scanned many
        # times below (enrichment masks, direction flips, h2/kafka
        # routing), and every scan of the strided 320-byte-record view
        # costs ~70× the contiguous compare. The presence bincount then
        # gates every protocol-specific pass to protocols actually in
        # the batch — an all-HTTP chunk computes no AMQP/Redis/h2/kafka
        # masks at all.
        protocol = np.ascontiguousarray(events["protocol"])
        proto_present = np.bincount(protocol, minlength=256)

        out = np.zeros(events.shape[0], dtype=REQUEST_DTYPE)
        out["start_time_ms"] = (events["write_time_ns"] // 1_000_000).astype(np.int64)
        out["latency_ns"] = events["duration_ns"]
        out["from_ip"] = saddr
        out["from_type"] = from_type
        out["from_uid"] = from_uid
        out["from_port"] = sport
        out["to_ip"] = daddr
        out["to_type"] = to_type
        out["to_uid"] = to_uid
        out["to_port"] = dport
        out["protocol"] = protocol
        out["tls"] = events["tls"]
        out["completed"] = True
        out["status_code"] = events["status"]
        out["method"] = events["method"]
        return events, out, protocol, proto_present

    # -- outbound naming ----------------------------------------------------

    def _outbound_uids(self, daddrs: np.ndarray) -> np.ndarray:
        """Interned name ids for a column of outbound destination
        addresses: one reverse-DNS probe + one intern per UNIQUE address
        (in first-occurrence order, so id assignment matches the scalar
        reference exactly); rows resolve by vectorized take."""
        uniq, first_idx, inverse = np.unique(
            daddrs, return_index=True, return_inverse=True
        )
        # first-occurrence order (np.unique sorts by value)
        order = np.argsort(first_idx, kind="stable")
        name_for = self.reverse_dns.name_for
        names = [name_for(a) for a in uniq[order].tolist()]
        ids = np.empty(uniq.shape[0], dtype=np.int32)
        ids[order] = self.interner.intern_many(names)
        return ids[inverse]

    def _scalar_outbound_uids(self, daddrs: np.ndarray) -> np.ndarray:
        """Pre-vectorization reference (one name_for + intern per ROW) —
        kept for the equivalence property tests."""
        return np.fromiter(
            (
                self.interner.intern(self.reverse_dns.name_for(int(a)))
                for a in daddrs
            ),
            dtype=np.int32,
            count=daddrs.shape[0],
        )

    # -- payload enrichment -------------------------------------------------

    def _enrich_paths(
        self,
        events: np.ndarray,
        out: np.ndarray,
        protocol: np.ndarray | None = None,
        proto_present: np.ndarray | None = None,
    ) -> None:
        """Fill ``out['path']`` per protocol. Amortized by payload hashing:
        identical payload prefixes parse once *ever* (cross-batch cache).
        ``protocol``/``proto_present`` are the caller's contiguous column
        + presence bincount when it already has them — absent protocols
        then cost nothing, not even a mask compare."""
        if protocol is None:
            protocol = np.ascontiguousarray(events["protocol"])
        if proto_present is None:
            proto_present = np.bincount(protocol, minlength=256)
        if proto_present[int(L7Protocol.HTTP)]:
            idx = np.flatnonzero(protocol == L7Protocol.HTTP)
            self._hashed_parse(events, out, idx, int(L7Protocol.HTTP), self._parse_http_row)
        for proto, parser in (
            (L7Protocol.POSTGRES, self._parse_pg_row),
            (L7Protocol.MYSQL, self._parse_mysql_row),
            (L7Protocol.MONGO, self._parse_mongo_row),
            (L7Protocol.REDIS, self._parse_redis_row),
        ):
            if proto_present[int(proto)]:
                idx = np.flatnonzero(protocol == proto)
                if proto in (L7Protocol.POSTGRES, L7Protocol.MYSQL):
                    # stateful (stmt caches) — parse per row
                    for i in idx:
                        out["path"][i] = parser(events[i])
                else:
                    self._hashed_parse(events, out, idx, int(proto), parser)

    @staticmethod
    def _payload_hashes(window: np.ndarray) -> np.ndarray:
        """Cheap 64-bit mix over the payload window (FNV-ish, vectorized).

        The window is [N, _PATH_WINDOW] uint8 viewed as uint64 lanes; each
        lane is multiplied by a distinct odd constant and xor-folded, so
        identical prefixes collide on purpose and different ones don't in
        any practical batch."""
        lanes = window.view(np.uint64).reshape(window.shape[0], -1)
        mult = (
            np.uint64(0x9E3779B97F4A7C15)
            * (np.arange(1, lanes.shape[1] + 1, dtype=np.uint64) | np.uint64(1))
        )
        with np.errstate(over="ignore"):
            mixed = lanes * mult[None, :]
            h = np.bitwise_xor.reduce(mixed, axis=1)
            h ^= h >> np.uint64(33)
            h *= np.uint64(0xFF51AFD7ED558CCD)
            h ^= h >> np.uint64(33)
        return h

    def _hashed_parse(self, events, out, idx, proto_key: int, row_parser) -> None:
        cache = self._path_cache.setdefault(proto_key, {})
        # hash every captured byte any row's parser can read, plus
        # payload_size: two payloads identical in a prefix but differing
        # beyond (long paths/SQL) must not share the first-seen interned
        # path. The hashed span is the batch's max payload_size rounded
        # up to a power-of-two lane count (few distinct spans → stable
        # cross-batch cache keys): lanes past a row's own size are zeros
        # by the capture contract, parsers never read past size, so
        # dropping all-zero tail lanes cannot merge distinct payloads —
        # typical sub-128-byte HTTP batches hash 8 lanes, not 32.
        sizes = events["payload_size"][idx]
        span = min(int(sizes.max()) if idx.shape[0] else 0, events["payload"].shape[1])
        lanes = 1
        while lanes * 8 < span:
            lanes *= 2
        nbytes = min(lanes * 8, events["payload"].shape[1])
        # single-protocol batches (the common case) take the strided-copy
        # path, not a gather
        if idx.shape[0] == events.shape[0]:
            window = np.ascontiguousarray(events["payload"][:, :nbytes])
        else:
            window = np.ascontiguousarray(events["payload"][idx, :nbytes])
        hashes = self._payload_hashes(window)
        with np.errstate(over="ignore"):
            hashes ^= sizes.astype(np.uint64) * np.uint64(0xD6E8FEB86659FD93)
        uniq, starts, inverse = np.unique(hashes, return_index=True, return_inverse=True)
        path_ids = np.zeros(uniq.shape[0], dtype=np.int32)
        for u in range(uniq.shape[0]):
            key = int(uniq[u])
            pid_cached = cache.get(key)
            if pid_cached is None:
                pid_cached = row_parser(events[idx[starts[u]]])
                cache[key] = pid_cached
            path_ids[u] = pid_cached
        out["path"][idx] = path_ids[inverse]

    def _payload_bytes(self, row) -> bytes:
        size = int(row["payload_size"])
        return bytes(row["payload"][: min(size, row["payload"].shape[0])])

    def _parse_http_row(self, row) -> int:
        _, path, _, _host = http_proto.parse_payload(self._payload_bytes(row))
        return self.interner.intern(path)

    def _parse_pg_row(self, row) -> int:
        cmd = postgres_proto.parse_command(
            self._payload_bytes(row),
            int(row["method"]),
            self.pg_stmts,
            int(row["pid"]),
            int(row["fd"]),
        )
        return self.interner.intern(cmd or "")

    def _parse_mysql_row(self, row) -> int:
        cmd = mysql_proto.parse_command(
            self._payload_bytes(row),
            int(row["method"]),
            self.mysql_stmts,
            int(row["pid"]),
            int(row["fd"]),
            int(row["mysql_prep_stmt_id"]),
        )
        return self.interner.intern(cmd or "")

    def _parse_mongo_row(self, row) -> int:
        summary = mongo_proto.parse_summary(self._payload_bytes(row))
        return self.interner.intern(summary or "")

    def _parse_redis_row(self, row) -> int:
        # raw payload is the query (processRedisEvent, data.go:1120-1160)
        return self.interner.intern(
            self._payload_bytes(row).decode("latin-1", "replace")
        )

    # -- HTTP/2 -------------------------------------------------------------

    def _process_h2(self, events: np.ndarray, out_rows: np.ndarray) -> np.ndarray | None:
        done = []
        for i, row in enumerate(events):
            completed = self.h2.feed(
                pid=int(row["pid"]),
                fd=int(row["fd"]),
                is_client=int(row["method"]) == Http2Method.CLIENT_FRAME,
                payload=self._payload_bytes(row),
                write_time_ns=int(row["write_time_ns"]),
                tls=bool(row["tls"]),
            )
            for c in completed:
                r = out_rows[i : i + 1].copy()
                r["start_time_ms"] = c.start_time_ns // 1_000_000
                r["latency_ns"] = c.latency_ns
                r["status_code"] = c.grpc_status if c.is_grpc and c.grpc_status is not None else c.status
                r["path"] = self.interner.intern(c.path)
                r["completed"] = True
                done.append(r)
        if not done:
            return None
        return np.concatenate(done)

    # -- Kafka --------------------------------------------------------------

    def _process_kafka(self, events: np.ndarray, out_rows: np.ndarray) -> None:
        """Decode Kafka payloads → KAFKA_EVENT_DTYPE batch
        (processKafkaEvent, data.go:929-1017 + aggregator/kafka)."""
        from alaz_tpu_torch.events.schema import KafkaMethod

        rows = []
        for i, row in enumerate(events):
            payload = self._payload_bytes(row)
            method = int(row["method"])
            msgs: list[kafka_proto.KafkaMessage] = []
            # dispatch on the kernel-assigned method like the reference
            # (data.go:953,975); the payload is often truncated to the
            # capture window so the kernel's exact-size check can't re-run
            try:
                if method == KafkaMethod.PRODUCE_REQUEST:
                    _, api_version, _, body = kafka_proto.split_request_header(payload)
                    msgs = kafka_proto.decode_produce_request(body, api_version)
                elif method == KafkaMethod.FETCH_RESPONSE:
                    api_version = int(row["kafka_api_version"])
                    if len(payload) >= 8:
                        msgs = kafka_proto.decode_fetch_response(payload[8:], api_version)
                else:
                    # unclassified: sniff a request header, else try fetch
                    ok, _corr, api_key, api_version = kafka_proto.parse_request_header(payload)
                    if ok and api_key == kafka_proto.API_KEY_PRODUCE:
                        _, _, _, body = kafka_proto.split_request_header(payload)
                        msgs = kafka_proto.decode_produce_request(body, api_version)
                    elif len(payload) >= 8:
                        msgs = kafka_proto.decode_fetch_response(
                            payload[8:], int(row["kafka_api_version"])
                        )
            except Exception:
                msgs = []
            for m in msgs:
                kv = np.zeros(1, dtype=KAFKA_EVENT_DTYPE)
                o = out_rows[i]
                kv["start_time_ms"] = o["start_time_ms"]
                kv["latency_ns"] = o["latency_ns"]
                kv["from_ip"], kv["from_type"], kv["from_uid"], kv["from_port"] = (
                    o["from_ip"], o["from_type"], o["from_uid"], o["from_port"],
                )
                kv["to_ip"], kv["to_type"], kv["to_uid"], kv["to_port"] = (
                    o["to_ip"], o["to_type"], o["to_uid"], o["to_port"],
                )
                kv["topic"] = self.interner.intern(m.topic)
                kv["partition"] = m.partition
                kv["key"] = self.interner.intern(m.key)
                kv["value"] = self.interner.intern(m.value)
                kv["type"] = KAFKA_PUBLISH if m.type == kafka_proto.PUBLISH else KAFKA_CONSUME
                kv["tls"] = o["tls"]
                if m.type == kafka_proto.CONSUME:
                    reverse_direction(kv)
                rows.append(kv)
        if rows:
            batch = np.concatenate(rows)
            self.ds.persist_kafka_events(batch)
            self.stats.kafka_out += batch.shape[0]

    # ------------------------------------------------------------------

    def gc(self, now_ns: int | None = None) -> None:
        """Periodic housekeeping: socket-line GC + h2 stream reaping
        (the 10-worker sockline GC loop, data.go:1688; reaper 551-571)."""
        self.socket_lines.gc()
        self.h2.reap(now_ns if now_ns is not None else time.time_ns())
        self.reverse_dns.purge()  # the 10-minute purge sweep analog
        # bound the parsed-path caches: high-cardinality paths (unique
        # URLs/query strings) must not grow them without limit. The caches
        # belong to the L7 worker — clear under its lock.
        with self._l7_lock:
            for cache in list(self._path_cache.values()):
                if len(cache) > _PATH_CACHE_MAX:
                    cache.clear()
        # prune idle rate-limit buckets (deployments without proc events
        # never hit the EXIT cleanup; idle = 10min behind the newest pid).
        # Under the L7 lock like every other bucket access (alazrace
        # ALZ050: the snapshot+pop used to race the L7 worker's inserts
        # on GIL atomicity alone); the sweep is 10-minute housekeeping,
        # so holding the RLock for the scan costs nothing measurable.
        with self._l7_lock:
            buckets = list(self._pid_buckets.items())
            if buckets:
                newest = max(b._last for _, b in buckets)
                for p, b in buckets:
                    if newest - b._last > 600:
                        self._pid_buckets.pop(p, None)
