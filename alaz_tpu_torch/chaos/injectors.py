"""Seeded fault injectors for the four pipeline seams.

Each injector wraps ONE seam of the real pipeline — no mocks of the
thing under test, only of the failure source:

- :class:`FrameChaos`    — the agent→socket wire (sources/ingest_server):
                           corrupt headers, truncated payloads, garbled
                           count fields.
- :class:`BatchChaos`    — the delivery plane between a source and the
                           ingestion surface: duplicated, reordered and
                           late batches (partial agent outage).
- :class:`WorkerChaos`   — the shard worker threads (aggregator/sharded):
                           crashes and stalls at item boundaries.
- :class:`FlakyTransport`— the backend datastore (datastore/backend):
                           5xx bursts and timeouts.

Everything is seed-driven (numpy Generator per injector, split
per-worker where threads are involved) so a chaos run is reproducible:
the same seed draws the same faults, modulo thread interleaving for the
worker seam (the INJECTION decisions are deterministic per worker; which
wall-clock instant they land at is the scheduler's).
"""

from __future__ import annotations

import struct
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

# the crash contract lives with the worker pool (the seam owner): the
# supervisor catches exactly this type, so there must be ONE class
from alaz_tpu_torch.aggregator.sharded import WorkerCrash

__all__ = [
    "WorkerCrash",
    "WorkerChaos",
    "BatchChaos",
    "FrameChaos",
    "FlakyTransport",
]


class WorkerChaos:
    """``fault_hook`` for :class:`~alaz_tpu.aggregator.sharded.ShardedIngest`.

    Called at item boundaries as ``hook(worker_idx, kind)``; may raise
    :class:`WorkerCrash` (the thread dies; the pipeline attributes the
    in-flight rows and the supervisor restarts it) or sleep (a stalled
    worker). Crash/stall draws are per-worker seeded streams, so worker
    i's fault sequence is a pure function of (seed, i, its item count).

    ``max_crashes`` bounds the total kills (shared across workers) so a
    high ``crash_prob`` can't degenerate into an infinite restart storm;
    ``kinds`` selects which item kinds are at risk — ("close",) aims
    every kill mid-wave, the hardest case for the merge plane.
    ``ensure_crash`` guarantees the suite is never vacuous: if the
    random draws produced no kill by the first close item, that close
    dies — every run exercises a mid-wave kill + restart.
    """

    def __init__(
        self,
        seed: int = 0,
        crash_prob: float = 0.0,
        stall_prob: float = 0.0,
        stall_s: float = 0.02,
        max_crashes: Optional[int] = 4,
        kinds: Sequence[str] = ("l7", "tcp", "close"),
        ensure_crash: bool = False,
    ):
        self.seed = int(seed)
        self.crash_prob = float(crash_prob)
        self.stall_prob = float(stall_prob)
        self.stall_s = float(stall_s)
        self.max_crashes = max_crashes
        self.kinds = tuple(kinds)
        self.ensure_crash = bool(ensure_crash) and self.crash_prob > 0
        self.crashes = 0  # guarded-by: self._lock
        self.stalls = 0  # guarded-by: self._lock
        self._rngs: dict = {}  # worker idx -> Generator  # guarded-by: self._lock
        self._lock = threading.Lock()

    def _draw(self, worker: int) -> Tuple[float, float]:
        with self._lock:
            rng = self._rngs.get(worker)
            if rng is None:
                rng = np.random.default_rng((self.seed, worker))
                self._rngs[worker] = rng
            return float(rng.random()), float(rng.random())

    def __call__(self, worker: int, kind: str) -> Optional[str]:
        """Returns ``"stall"`` when THIS call stalled, ``None`` otherwise;
        a crash raises :class:`WorkerCrash`. Per-call attribution lives in
        the return/raise — callers must not diff the shared ``crashes``/
        ``stalls`` totals, which race across concurrent workers."""
        if kind not in self.kinds:
            return None
        r_crash, r_stall = self._draw(worker)
        crash = r_crash < self.crash_prob
        if not crash and self.ensure_crash and kind == "close":
            # coverage floor: the random draws spared every item so far —
            # kill this close (mid-wave, the hardest restart case)
            with self._lock:
                crash = self.crashes == 0
        if crash:
            with self._lock:
                capped = (
                    self.max_crashes is not None
                    and self.crashes >= self.max_crashes
                )
                if not capped:
                    self.crashes += 1
            if not capped:
                raise WorkerCrash(f"chaos kill: worker {worker} on {kind}")
        if r_stall < self.stall_prob:
            with self._lock:
                self.stalls += 1
            time.sleep(self.stall_s)
            return "stall"
        return None


class BatchChaos:
    """Delivery-plane chaos: duplicate, reorder and delay batches.

    ``perturb(chunks)`` is a PURE function of (seed, chunks): it returns
    ``(delivery, late)`` where ``delivery`` is the in-band sequence
    (with duplicates inserted and adjacent swaps applied) and ``late``
    are the held-back batches to deliver after the consumer has sealed
    its window horizon (a flush) — the deterministic replication of a
    partial agent outage re-sending its buffer after the backend moved
    on. Feeding the SAME perturbed sequence to two pipelines makes
    equivalence testable: the chaos is in the data, not the clock.

    ``min_each`` floors the coverage: every enabled fault kind fires at
    least once per perturb even when the random draws spared every batch
    (duplicate the middle, swap the first adjacent pair, hold the last
    batch late) — an acceptance run must never be vacuously green.
    """

    def __init__(
        self,
        seed: int = 0,
        dup_prob: float = 0.05,
        reorder_prob: float = 0.05,
        late_prob: float = 0.0,
        min_each: bool = False,
    ):
        self.rng = np.random.default_rng(seed)
        self.dup_prob = float(dup_prob)
        self.reorder_prob = float(reorder_prob)
        self.late_prob = float(late_prob)
        self.min_each = bool(min_each)
        self.duplicated = 0
        self.reordered = 0
        self.delayed = 0
        self.duplicated_rows = 0
        self.delayed_rows = 0

    def perturb(self, chunks: Sequence) -> Tuple[List, List]:
        out: List = []
        late: List = []
        for c in chunks:
            if self.late_prob and float(self.rng.random()) < self.late_prob:
                late.append(c)
                self.delayed += 1
                self.delayed_rows += len(c)
                continue
            out.append(c)
            if self.dup_prob and float(self.rng.random()) < self.dup_prob:
                out.append(c)
                self.duplicated += 1
                self.duplicated_rows += len(c)
        if self.min_each and out:
            if self.late_prob and not late:
                late.append(out.pop())
                self.delayed += 1
                self.delayed_rows += len(late[-1])
            if self.dup_prob and not self.duplicated and out:
                mid = len(out) // 2
                out.insert(mid + 1, out[mid])
                self.duplicated += 1
                self.duplicated_rows += len(out[mid])
        if self.reorder_prob:
            # adjacent swaps over disjoint pairs: each batch moves at most
            # one slot, so a window spread over several chunks keeps at
            # least one in-order carrier (the window-set invariant)
            i = 0
            while i + 1 < len(out):
                if float(self.rng.random()) < self.reorder_prob:
                    out[i], out[i + 1] = out[i + 1], out[i]
                    self.reordered += 1
                    i += 2
                else:
                    i += 1
            if self.min_each and not self.reordered and len(out) > 1:
                out[0], out[1] = out[1], out[0]
                self.reordered += 1
        return out, late


_MAGIC_LE = struct.Struct("<I")


class FrameChaos:
    """Wire-frame chaos for the socket seam.

    ``perturb(frame, rows)`` takes one packed frame (header + payload)
    and either passes it through or mutates it: header corruption
    (magic garbled — the stream must RESYNC), payload truncation (the
    framing desynchronizes mid-payload), or a count-field garble (the
    header stays framed but the payload no longer matches — the frame
    quarantines without losing stream sync). Destroyed row counts are
    tracked injector-side (``destroyed_rows``) because a frame whose
    header is gone carries no readable count for the server to ledger.

    ``min_each`` floors coverage like BatchChaos: with random draws that
    spared everything, the frames at 1/3 and 2/3 of ``expect_frames``
    get a forced corrupt/garble so every suite run drives a real resync.
    """

    def __init__(
        self,
        seed: int = 0,
        corrupt_prob: float = 0.05,
        truncate_prob: float = 0.0,
        garble_prob: float = 0.05,
        min_each: bool = False,
        expect_frames: int = 0,
    ):
        self.rng = np.random.default_rng(seed)
        self.corrupt_prob = float(corrupt_prob)
        self.truncate_prob = float(truncate_prob)
        self.garble_prob = float(garble_prob)
        self.min_each = bool(min_each)
        self.expect_frames = int(expect_frames)
        self._seen = 0
        self.corrupted = 0
        self.truncated = 0
        self.garbled = 0
        self.destroyed_rows = 0

    def perturb(self, frame: bytes, rows: int) -> bytes:
        self._seen += 1
        if self.min_each and self.expect_frames:
            if (
                self.corrupt_prob
                and not self.corrupted
                and self._seen == self.expect_frames // 3
            ):
                self.corrupted += 1
                self.destroyed_rows += rows
                return b"\xde\xad\xbe\xef" + frame[4:]
            if (
                self.garble_prob
                and not self.garbled
                and self._seen == (2 * self.expect_frames) // 3
            ):
                self.garbled += 1
                self.destroyed_rows += rows
                count = struct.unpack_from("<I", frame, 8)[0]
                out = bytearray(frame)
                struct.pack_into("<I", out, 8, count + 1)
                return bytes(out)
        r = float(self.rng.random())
        if r < self.corrupt_prob:
            # garble the magic: the receiver loses framing and must scan
            self.corrupted += 1
            self.destroyed_rows += rows
            return b"\xde\xad\xbe\xef" + frame[4:]
        r -= self.corrupt_prob
        if r < self.truncate_prob and len(frame) > 24:
            # drop the payload tail: the next header read lands mid-frame
            self.truncated += 1
            self.destroyed_rows += rows
            cut = int(self.rng.integers(16, len(frame) - 4))
            return frame[:cut]
        r -= self.truncate_prob
        if r < self.garble_prob:
            # count field no longer matches length: well-framed, malformed
            self.garbled += 1
            self.destroyed_rows += rows
            count = struct.unpack_from("<I", frame, 8)[0]
            out = bytearray(frame)
            struct.pack_into("<I", out, 8, count + 1)
            return bytes(out)
        return frame


class FlakyTransport:
    """Backend chaos: wrap a ``Transport`` with seeded 5xx and timeouts.

    Thread-safe (the backend pump and forced flushes may race). Faults
    can be turned off mid-run (``heal()``) to exercise circuit-breaker
    recovery."""

    def __init__(
        self,
        inner,
        seed: int = 0,
        error_prob: float = 0.1,
        timeout_prob: float = 0.05,
        error_status: int = 503,
    ):
        self.inner = inner
        self.error_prob = float(error_prob)
        self.timeout_prob = float(timeout_prob)
        self.error_status = int(error_status)
        self._rng = np.random.default_rng(seed)  # guarded-by: self._lock
        self._lock = threading.Lock()
        self.calls = 0  # guarded-by: self._lock
        self.errors = 0  # guarded-by: self._lock
        self.timeouts = 0  # guarded-by: self._lock
        self.delivered = 0  # guarded-by: self._lock

    def heal(self) -> None:
        """Stop injecting: the backend 'recovers'."""
        self.error_prob = 0.0
        self.timeout_prob = 0.0

    def __call__(self, endpoint: str, payload: dict) -> int:
        with self._lock:
            self.calls += 1
            r_t, r_e = float(self._rng.random()), float(self._rng.random())
            if r_t < self.timeout_prob:
                self.timeouts += 1
                fate = "timeout"
            elif r_e < self.error_prob:
                self.errors += 1
                fate = "error"
            else:
                self.delivered += 1
                fate = "ok"
        if fate == "timeout":
            raise TimeoutError("chaos: backend timeout")
        if fate == "error":
            return self.error_status
        return self.inner(endpoint, payload)
