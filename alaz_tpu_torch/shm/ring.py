"""Fixed-slot shared-memory ring buffers — the process-mode transport.

ISSUE 15 tentpole: the host plane's thread backend cannot scale past the
GIL (PR 5 measured 1.22× at 2 workers — the wall is GIL-held
intern/dict/small-op Python), so shard workers move into child
PROCESSES. This module is the only channel between them: one SPSC ring
per direction per worker, laid out in ``multiprocessing.shared_memory``
segments. Everything that crosses the fork boundary is bytes in these
rings — wire-dtype rows, pickled k8s control messages, serialized
``EdgePartial`` frames with interner delta tables (codec.py). No Python
object is ever shared; no lock is ever shared (alazrace's process-role
carve-out is sound because of this file's contract).

Layout (alazspec pins every constant below in
``resources/specs/wire_layouts.json`` ``shm_ring`` — a layout edited on
one side of the spawn boundary anchors at analysis time):

    [CTRL 64B][STATS 512B][slot 0][slot 1]...[slot n-1]

- **CTRL** — magic/version/geometry plus the two cursors: ``tail``
  (consumer-written, slots consumed, monotonic) and ``head_hint``
  (producer-written after each commit; an occupancy gauge and the
  respawn resume aid, never the synchronization source).
- **STATS** — the worker's crash-surviving accounting mirror (the
  response ring's producer owns it): done-record counter, store
  watermark, request/late counters, the per-cause DropLedger mirror and
  the AggregatorStats columns. A SIGKILLed worker's books stay readable
  here, which is what makes exact row conservation through a kill
  provable (process_pool._settle_dead_shard).
- **Slots** — fixed stride. A record occupies ``ceil((32+nbytes)/
  slot_size)`` consecutive slots: a 32-byte header in the first slot,
  payload bytes running contiguously through the rest (continuation
  slots carry no headers). A record never wraps the segment end — the
  producer emits a PAD record spanning the remainder and restarts at
  slot 0 (cursors stay monotonic in slot units; position = cursor %
  n_slots).

Publication protocol (single-producer single-consumer, lock-free):
the producer writes payload first, then the header's non-seq fields,
then ``seq = start_cursor + 1`` as one aligned 8-byte store. The
consumer polls the slot at ``tail % n_slots`` for ``seq == tail + 1``;
a match happens-after every prior store under the x86-TSO store-order
guarantee (the data plane's deployment target; the same ordering
assumption the C++ native ring makes). Reused slots can never alias: a
stale seq at that position is exactly ``n_slots`` laps old.

Crash semantics (the supervision plane's contract): the consumer takes
ZERO-COPY views and advances ``tail`` only at ``commit()``, AFTER the
record is fully processed. A kill mid-record therefore REPLAYS it to
the respawned worker against fresh state (the dead process's partial
effects and its buffered ledger adds died with its memory — no loss, no
double count); a kill after commit loses only rows the dead process
still held privately, which the parent attributes from its own
produced-record log minus the mirror (process_pool._settle_dead_shard).
"""

from __future__ import annotations

import struct
import time
from multiprocessing import shared_memory
from typing import Optional

import numpy as np

from alaz_tpu_torch.utils.ledger import DropLedger

# ---------------------------------------------------------------------------
# Pinned constants (alazspec `shm_ring` section; `make specs` regenerates)
# ---------------------------------------------------------------------------

SHM_MAGIC = 0x414C5A52  # "ALZR"
SHM_VERSION = 1

CTRL_BYTES = 64
STATS_BYTES = 512
DATA_OFFSET = CTRL_BYTES + STATS_BYTES

# slot stride and count defaults (RuntimeConfig.shm_slot_bytes /
# shm_ring_slots; SHM_SLOT_BYTES / SHM_RING_SLOTS env knobs)
DEFAULT_SLOT_BYTES = 1 << 16
DEFAULT_RING_SLOTS = 512

# CTRL field offsets
_C_MAGIC = 0  # u32
_C_VERSION = 4  # u32
_C_SLOT_SIZE = 8  # u32
_C_N_SLOTS = 12  # u32
_C_TAIL = 16  # u64, consumer cursor (slots, monotonic)
_C_CLOSED = 24  # u32, producer-side close latch
_C_HEAD_HINT = 32  # u64, producer cursor (post-commit hint/gauge)

# record header: one per record, in its first slot. The seq word is
# written SEPARATELY (and last) — publication order is the protocol —
# so the non-seq fields have their own struct at offset 8.
SLOT_HEADER = struct.Struct("<QIIIIq")  # seq, kind, nbytes, rows, span, now_ns
SLOT_BODY = struct.Struct("<IIIIq")  # kind, nbytes, rows, span, now_ns (@+8)
SLOT_HEADER_BYTES = SLOT_HEADER.size  # 32
_NOW_NONE = -1  # now_ns sentinel for "caller passed None"

# record kinds — parent → worker (request ring) ...
K_PAD = 0  # slot-alignment filler (spans to segment end)
K_L7 = 1  # L7_EVENT_DTYPE rows (wire bytes)
K_TCP = 2  # TCP_EVENT_DTYPE rows
K_PROC = 3  # PROC_EVENT_DTYPE rows
K_K8S = 4  # pickled K8sResourceMessage (control plane)
K_CLOSE = 5  # close wave: payload <qq> = (wave, upto; codec.UPTO_NONE = -(2**62)-1 means "close everything" — distinct from W_FLOOR)
K_GC = 6  # housekeeping broadcast
K_REAP = 7
K_RETRIES = 8  # flush_retries(now_ns)
K_SEAL = 9  # merged-horizon seal: payload <q> = upto
K_STOP = 10  # clean shutdown
# ... and worker → parent (response ring)
K_WINDOW = 16  # one closed window's EdgePartial + interner delta (codec.py)
K_ACK = 17  # close-wave ack: payload <qq> = (wave, upto)

KIND_NAMES = {
    K_PAD: "pad", K_L7: "l7", K_TCP: "tcp", K_PROC: "proc", K_K8S: "k8s",
    K_CLOSE: "close", K_GC: "gc", K_REAP: "reap", K_RETRIES: "retries",
    K_SEAL: "seal", K_STOP: "stop", K_WINDOW: "window", K_ACK: "ack",
}

# "no window closed yet" sentinel — mirrors aggregator/sharded._W_FLOOR
W_FLOOR = -(2**62)

# STATS field offsets (worker-written u64/i64/f64 slots; parent reads)
S_DONE_RECORDS = 0  # u64, records fully processed (task_done analog)
S_WATERMARK = 8  # i64, shard store watermark (W_FLOOR = none)
S_REQUEST_COUNT = 16  # u64, store request_count mirror
S_LATE_DROPPED = 24  # u64, store late_dropped mirror
S_PENDING_RETRIES = 32  # u64, aggregator retry-queue rows
S_LAST_PERSIST = 40  # f64, monotonic stamp (0.0 = never)
S_HEARTBEAT = 48  # u64, item counter (liveness)
S_LEDGER = 56  # u64 × len(DropLedger.CAUSES), cause order pinned
S_AGG_STATS = 104  # u64 × len(AGG_STAT_FIELDS)
S_READY_GEN = 192  # u64, worker writes generation+1 once its loop is up

# AggregatorStats mirror column order — pinned so both sides of the
# spawn boundary index the same slots (alazspec anchors drift)
AGG_STAT_FIELDS = (
    "l7_in",
    "l7_joined",
    "l7_dropped_no_socket",
    "l7_dropped_not_pod",
    "l7_requeued",
    "tcp_in",
    "proc_in",
    "k8s_in",
    "edges_out",
    "kafka_out",
    "l7_rate_limited",
)

_U64 = struct.Struct("<Q")
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")
_U32 = struct.Struct("<I")


def ctrl_layout_string() -> str:
    """Canonical CTRL layout — same shape as ``dtype_layout`` strings."""
    return (
        f"ShmCtrl:{CTRL_BYTES};magic:{_C_MAGIC}:4;version:{_C_VERSION}:4;"
        f"slot_size:{_C_SLOT_SIZE}:4;n_slots:{_C_N_SLOTS}:4;"
        f"tail:{_C_TAIL}:8;closed:{_C_CLOSED}:4;head_hint:{_C_HEAD_HINT}:8"
    )


def stats_layout_string() -> str:
    ledger_w = 8 * len(DropLedger.CAUSES)
    agg_w = 8 * len(AGG_STAT_FIELDS)
    return (
        f"ShmStats:{STATS_BYTES};done_records:{S_DONE_RECORDS}:8;"
        f"watermark:{S_WATERMARK}:8;request_count:{S_REQUEST_COUNT}:8;"
        f"late_dropped:{S_LATE_DROPPED}:8;"
        f"pending_retries:{S_PENDING_RETRIES}:8;"
        f"last_persist:{S_LAST_PERSIST}:8;heartbeat:{S_HEARTBEAT}:8;"
        f"ledger:{S_LEDGER}:{ledger_w};agg_stats:{S_AGG_STATS}:{agg_w};"
        f"ready_gen:{S_READY_GEN}:8"
    )


def slot_header_layout_string() -> str:
    return (
        f"ShmSlotHeader:{SLOT_HEADER_BYTES};seq:0:8;kind:8:4;nbytes:12:4;"
        f"rows:16:4;span:20:4;now_ns:24:8"
    )


class RingClosed(Exception):
    """The producer closed the ring (stop path)."""


class ShmRing:
    """One shared-memory ring segment: CTRL + STATS + fixed slots.

    The parent CREATES both rings per worker and is the only side that
    ever unlinks them; the child ATTACHES by name. All cursor/stats
    traffic goes through the accessors below — aligned 8-byte
    pack/unpack calls, single stores under the GIL on each side.
    """

    def __init__(
        self,
        name: Optional[str] = None,
        slot_bytes: int = DEFAULT_SLOT_BYTES,
        n_slots: int = DEFAULT_RING_SLOTS,
        create: bool = False,
    ):
        if create:
            if slot_bytes % 64 or slot_bytes <= SLOT_HEADER_BYTES:
                raise ValueError("slot_bytes must be a 64-multiple > 32")
            if n_slots < 4:
                raise ValueError("n_slots must be >= 4")
            size = DATA_OFFSET + slot_bytes * n_slots
            self._shm = shared_memory.SharedMemory(
                name=name, create=True, size=size
            )
            buf = self._shm.buf
            # pre-fault every page NOW (one vectorized zero pass): the
            # first production lap through an untouched tmpfs segment
            # otherwise pays its page faults inside the hot put path —
            # measured as ~5× on the per-record store
            np.frombuffer(buf, dtype=np.uint8)[:] = 0
            _U32.pack_into(buf, _C_MAGIC, SHM_MAGIC)
            _U32.pack_into(buf, _C_VERSION, SHM_VERSION)
            _U32.pack_into(buf, _C_SLOT_SIZE, slot_bytes)
            _U32.pack_into(buf, _C_N_SLOTS, n_slots)
            _I64.pack_into(buf, CTRL_BYTES + S_WATERMARK, W_FLOOR)
            self.slot_bytes = slot_bytes
            self.n_slots = n_slots
        else:
            # attach side (the worker). The spawn children share the
            # parent's resource-tracker process, and the tracker's cache
            # is a set — the parent's create-side registration already
            # covers the segment, and the parent's unlink is the one
            # unregister. An attach-side unregister here would race it
            # into a tracker KeyError at exit.
            self._shm = shared_memory.SharedMemory(name=name)
            buf = self._shm.buf
            magic = _U32.unpack_from(buf, _C_MAGIC)[0]
            version = _U32.unpack_from(buf, _C_VERSION)[0]
            if magic != SHM_MAGIC or version != SHM_VERSION:
                raise ValueError(
                    f"shm ring {name}: bad magic/version "
                    f"0x{magic:08X}/{version} (want 0x{SHM_MAGIC:08X}/"
                    f"{SHM_VERSION}) — parent and worker builds disagree"
                )
            self.slot_bytes = _U32.unpack_from(buf, _C_SLOT_SIZE)[0]
            self.n_slots = _U32.unpack_from(buf, _C_N_SLOTS)[0]
        self.name = self._shm.name

    @property
    def buf(self):
        return self._shm.buf

    # -- cursors / flags ----------------------------------------------------

    @property
    def tail(self) -> int:
        return _U64.unpack_from(self._shm.buf, _C_TAIL)[0]

    def set_tail(self, v: int) -> None:
        _U64.pack_into(self._shm.buf, _C_TAIL, v)

    @property
    def head_hint(self) -> int:
        return _U64.unpack_from(self._shm.buf, _C_HEAD_HINT)[0]

    def set_head_hint(self, v: int) -> None:
        _U64.pack_into(self._shm.buf, _C_HEAD_HINT, v)

    @property
    def closed(self) -> bool:
        return _U32.unpack_from(self._shm.buf, _C_CLOSED)[0] != 0

    def close_ring(self) -> None:
        """Producer-side close latch (monotonic False→True)."""
        _U32.pack_into(self._shm.buf, _C_CLOSED, 1)

    @property
    def pending_slots(self) -> int:
        """Occupancy gauge: committed-but-unconsumed slots (hint-based —
        momentarily stale by at most one in-flight record)."""
        return max(0, self.head_hint - self.tail)

    # -- stats block --------------------------------------------------------

    def stat_u64(self, off: int) -> int:
        return _U64.unpack_from(self._shm.buf, CTRL_BYTES + off)[0]

    def set_stat_u64(self, off: int, v: int) -> None:
        _U64.pack_into(self._shm.buf, CTRL_BYTES + off, v)

    def stat_i64(self, off: int) -> int:
        return _I64.unpack_from(self._shm.buf, CTRL_BYTES + off)[0]

    def set_stat_i64(self, off: int, v: int) -> None:
        _I64.pack_into(self._shm.buf, CTRL_BYTES + off, v)

    def stat_f64(self, off: int) -> float:
        return _F64.unpack_from(self._shm.buf, CTRL_BYTES + off)[0]

    def set_stat_f64(self, off: int, v: float) -> None:
        _F64.pack_into(self._shm.buf, CTRL_BYTES + off, v)

    def ledger_mirror(self) -> dict:
        """{cause: count} snapshot of the worker's DropLedger mirror."""
        buf = self._shm.buf
        return {
            c: _U64.unpack_from(buf, CTRL_BYTES + S_LEDGER + 8 * i)[0]
            for i, c in enumerate(DropLedger.CAUSES)
        }

    def agg_stats_mirror(self) -> dict:
        buf = self._shm.buf
        return {
            f: _U64.unpack_from(buf, CTRL_BYTES + S_AGG_STATS + 8 * i)[0]
            for i, f in enumerate(AGG_STAT_FIELDS)
        }

    # -- lifecycle ----------------------------------------------------------

    def detach(self) -> None:
        try:
            self._shm.close()
        except Exception:
            pass

    def unlink(self) -> None:
        try:
            self._shm.unlink()
        except Exception:
            pass


class RingProducer:  # role-private: one instance per ring ENDPOINT — the parent pool serializes its producers under the per-ring put_lock, the worker process is single-threaded; the cursor never has two same-process writers
    """Single-producer cursor over a ring. NOT thread-safe — the pool
    serializes parent-side puts per ring with its own lock; the worker
    is single-threaded by construction."""

    def __init__(self, ring: ShmRing, start_cursor: int = 0):
        self.ring = ring
        self.cursor = int(start_cursor)

    def _free(self) -> int:
        return self.ring.n_slots - (self.cursor - self.ring.tail)

    def _reserve(self, nbytes: int) -> Optional[int]:
        """Space-check + wrap-pad for an ``nbytes``-payload record;
        returns the record's byte offset, or None when the ring is full.
        Raises :class:`RingClosed` once the close latch is set."""
        ring = self.ring
        if ring.closed:
            raise RingClosed(ring.name)
        span = -(-(SLOT_HEADER_BYTES + nbytes) // ring.slot_bytes)
        if span > ring.n_slots - 1:
            raise ValueError(
                f"record of {nbytes}B needs {span} slots > ring capacity "
                f"{ring.n_slots - 1} — raise SHM_SLOT_BYTES/SHM_RING_SLOTS "
                "or shrink the chunk"
            )
        pos = self.cursor % ring.n_slots
        pad = ring.n_slots - pos if pos + span > ring.n_slots else 0
        buf = ring.buf
        if pad:
            # the pad commits INDEPENDENTLY of the record: when
            # pad + span exceeds the whole ring, waiting for both at
            # once can never succeed from this position (the cursor
            # would never move — a livelock the big-record + unlucky-
            # position combination hits); emitting the pad alone
            # advances to slot 0, where the record CAN fit once the
            # consumer drains
            if self._free() < pad:
                return None
            off = DATA_OFFSET + pos * ring.slot_bytes
            SLOT_BODY.pack_into(
                buf, off + 8, K_PAD, 0, 0, pad, _NOW_NONE
            )  # non-seq fields first ...
            _U64.pack_into(buf, off, self.cursor + 1)  # ... seq commits
            self.cursor += pad
            pos = 0
        if self._free() < span:
            return None
        return DATA_OFFSET + pos * ring.slot_bytes

    def _commit(self, off: int, kind: int, nbytes: int, rows: int, now_ns) -> None:
        ring = self.ring
        span = -(-(SLOT_HEADER_BYTES + nbytes) // ring.slot_bytes)
        SLOT_BODY.pack_into(
            ring.buf, off + 8, int(kind), nbytes, int(rows), span,
            _NOW_NONE if now_ns is None else int(now_ns),
        )
        _U64.pack_into(ring.buf, off, self.cursor + 1)  # publish: seq LAST
        self.cursor += span
        ring.set_head_hint(self.cursor)

    def try_put(self, kind: int, payload, rows: int = 0, now_ns=None) -> bool:
        """One attempt: commit the record or return False (ring full)."""
        payload = memoryview(payload) if payload is not None else memoryview(b"")
        nbytes = payload.nbytes
        off = self._reserve(nbytes)
        if off is None:
            return False
        if nbytes:
            # numpy-mediated memcpy: a raw memoryview slice assignment
            # of a cast structured view runs ~5× slower than np.copyto
            # on this path
            dst = np.frombuffer(
                self.ring.buf, dtype=np.uint8, count=nbytes,
                offset=off + SLOT_HEADER_BYTES,
            )
            dst[:] = np.frombuffer(payload, dtype=np.uint8)
        self._commit(off, kind, nbytes, rows, now_ns)
        return True

    def try_put_rows(
        self, kind: int, events, idx, now_ns=None
    ) -> bool:
        """Fused shard-scatter put: gather ``events[idx]`` DIRECTLY into
        the ring slot (``np.take(out=)``), so the scatter thread pays
        ONE row-width copy per record instead of gather-to-temp +
        temp-to-ring — the scatter thread's production rate is the
        pipeline ceiling at high worker counts. ``idx=None`` writes the
        whole batch."""
        k = int(events.shape[0] if idx is None else idx.shape[0])
        nbytes = k * events.dtype.itemsize
        off = self._reserve(nbytes)
        if off is None:
            return False
        dst = np.frombuffer(
            self.ring.buf, dtype=events.dtype, count=k,
            offset=off + SLOT_HEADER_BYTES,
        )
        if idx is None:
            dst[:] = events
        else:
            np.take(events, idx, out=dst)
        self._commit(off, kind, nbytes, k, now_ns)
        return True

    def put_rows(
        self, kind: int, events, idx, now_ns=None,
        timeout: Optional[float] = None,
    ) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self.try_put_rows(kind, events, idx, now_ns=now_ns):
                return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(0.0005)

    def put(
        self, kind: int, payload, rows: int = 0, now_ns=None,
        timeout: Optional[float] = None,
    ) -> bool:
        """Deadline-bounded put: poll until the record fits or the
        deadline passes (False — the caller sheds to the ledger, the
        drop-not-block contract one hop past the fork)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self.try_put(kind, payload, rows=rows, now_ns=now_ns):
                return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(0.0005)


class Record:
    __slots__ = ("kind", "payload", "rows", "now_ns")

    def __init__(self, kind: int, payload, rows: int, now_ns):
        # payload: writable uint8 ndarray (one ring copy) or b""
        self.kind = kind
        self.payload = payload
        self.rows = rows
        self.now_ns = now_ns

    def __len__(self) -> int:  # ledger attribution unit
        return self.rows


class RingConsumer:  # role-private: one instance per ring ENDPOINT — parent-side consumers run only under the pool's _io_lock (single-flight drains), the worker process is single-threaded
    """Single-consumer cursor with DEFERRED commit. ``try_get_view``
    hands out a ZERO-COPY view into the ring; the slots stay reserved
    (the producer's free-space check reads ``tail``) until the caller
    ``commit()``s — after processing. The payoff is twofold: no
    per-record copy on the worker's critical path, and better kill
    semantics — a worker SIGKILLed mid-record never advanced ``tail``,
    so the respawned worker REPLAYS the record against its fresh state
    instead of losing it (the old process's partial effects died with
    its memory; the ledger mirror is flushed only after commit, so a
    replay can never double-attribute). The cursor is persisted in CTRL
    ``tail``, which is exactly the replay point."""

    def __init__(self, ring: ShmRing, start_cursor: Optional[int] = None):
        self.ring = ring
        self.cursor = ring.tail if start_cursor is None else int(start_cursor)
        self._pending_span = 0  # uncommitted record's slot span

    def try_get_view(self) -> Optional[Record]:
        """Next committed record as a zero-copy view, WITHOUT freeing
        its slots — call :meth:`commit` when done with the payload.
        At most one view may be outstanding."""
        if self._pending_span:
            raise RuntimeError("previous record not committed")
        ring = self.ring
        buf = ring.buf
        while True:
            pos = self.cursor % ring.n_slots
            off = DATA_OFFSET + pos * ring.slot_bytes
            seq = _U64.unpack_from(buf, off)[0]
            if seq != self.cursor + 1:
                return None  # not committed yet
            _, kind, nbytes, rows, span, now_ns = SLOT_HEADER.unpack_from(
                buf, off
            )
            if kind == K_PAD:
                self.cursor += span
                ring.set_tail(self.cursor)
                continue
            payload = (
                np.frombuffer(
                    buf, dtype=np.uint8, count=nbytes,
                    offset=off + SLOT_HEADER_BYTES,
                )
                if nbytes
                else b""
            )
            self._pending_span = span
            return Record(
                kind, payload, rows, None if now_ns == _NOW_NONE else now_ns
            )

    def commit(self) -> None:
        """Free the outstanding record's slots (the consume point: a
        kill BEFORE this replays the record, a kill after loses only
        what the dead process still held privately)."""
        if self._pending_span:
            self.cursor += self._pending_span
            self._pending_span = 0
            self.ring.set_tail(self.cursor)

    def try_get(self) -> Optional[Record]:
        """Copying get: view + materialize + commit — for consumers that
        stash the payload past the commit point (tests, simple tools)."""
        rec = self.try_get_view()
        if rec is None:
            return None
        if isinstance(rec.payload, np.ndarray):
            rec.payload = rec.payload.copy()
        self.commit()
        return rec

    def get(self, timeout: Optional[float] = None) -> Optional[Record]:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            rec = self.try_get()
            if rec is not None:
                return rec
            if self.ring.closed:
                # drain-then-stop: one more committed record may have
                # raced the close latch
                rec = self.try_get()
                if rec is not None:
                    return rec
                return None
            if deadline is not None and time.monotonic() >= deadline:
                return None
            time.sleep(0.0005)

    def get_view(self, timeout: Optional[float] = None) -> Optional[Record]:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            rec = self.try_get_view()
            if rec is not None:
                return rec
            if self.ring.closed:
                rec = self.try_get_view()
                if rec is not None:
                    return rec
                return None
            if deadline is not None and time.monotonic() >= deadline:
                return None
            time.sleep(0.0005)
