"""String interning: the boundary between string-land and array-land.

The reference carries strings (UIDs, pod names, paths, topics) through its
whole pipeline and pays for it in GC pressure — it mitigates with object
pools (datastore/backend.go:767-797). We instead intern every string to a
dense int32 id the moment it enters the system; everything downstream is
integer arrays, and ids become embedding-table rows on device for free.

Id 0 is always the empty string, so zero-initialized arrays mean "no value".

The batch APIs (``intern_many`` / ``lookup_many``) are the ingest hot
path: they resolve HITS over *unique* strings without touching the lock,
and take the lock a bounded number of times per batch — once for the
instrumentation counters, once more when there are misses
(O(unique-misses) work under it — one probe per miss, needed only
because another thread may have raced the unlocked resolve phase). The
pre-vectorization one-``intern()``-per-row forms are kept as
``_scalar_*`` references for the equivalence property tests.
"""

from __future__ import annotations

import threading
from operator import itemgetter
from typing import Iterable, List

import numpy as np


class Interner:
    """Thread-safe append-only string <-> int32 table."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._to_id: dict[str, int] = {"": 0}  # guarded-by: self._lock
        self._strings: List[str] = [""]  # guarded-by: self._lock
        # batch-path instrumentation: the perf smoke test asserts the
        # vectorized APIs carried the traffic (no silent per-row fallback)
        self.batch_calls = 0  # guarded-by: self._lock
        self.batch_strings = 0  # guarded-by: self._lock

    def __len__(self) -> int:
        return len(self._strings)  # alazlint: disable=ALZ010 -- racy size gauge; append-only table never shrinks

    def intern(self, s: str) -> int:
        sid = self._to_id.get(s)  # alazlint: disable=ALZ010 -- double-checked fast path: GIL-atomic dict probe, re-checked under the lock below on miss
        if sid is not None:
            return sid
        with self._lock:
            sid = self._to_id.get(s)
            if sid is None:
                sid = len(self._strings)
                self._strings.append(s)
                self._to_id[s] = sid
            return sid

    def intern_many(self, strings: Iterable[str]) -> np.ndarray:
        """Batch intern: one dict probe per unique string outside the
        lock, ONE lock acquisition total (counters fold into the same
        critical section as the miss resolution), one probe per unique
        MISS under it (the race re-check the scalar path pays per
        string). Single-acquisition matters under the sharded ingest
        pool: N workers intern concurrently against this one table, and
        a second counters-only acquisition per batch was measurable
        contention there for zero information."""
        if not isinstance(strings, (list, tuple)):
            strings = list(strings)
        n = len(strings)
        if n == 0:
            # counters still advance: the perf smoke test reads them to
            # prove the batch APIs carried the traffic (+= is a lost-
            # update race off-lock — the ALZ010 finding)
            with self._lock:
                self.batch_calls += 1
            return np.zeros(0, dtype=np.int32)
        to_id = self._to_id  # alazlint: disable=ALZ010 -- lock-free resolve phase: GIL-atomic probes of an append-only dict; misses are re-checked under the lock below
        resolved: dict[str, int | None] = {}
        for s in strings:
            if s not in resolved:
                resolved[s] = to_id.get(s)
        misses = [s for s, sid in resolved.items() if sid is None]
        with self._lock:
            self.batch_calls += 1
            self.batch_strings += n
            if misses:
                table = self._strings
                for s in misses:
                    sid = to_id.get(s)
                    if sid is None:
                        sid = len(table)
                        table.append(s)
                        to_id[s] = sid
                    resolved[s] = sid
        return np.fromiter((resolved[s] for s in strings), dtype=np.int32, count=n)

    def _scalar_intern_many(self, strings: Iterable[str]) -> np.ndarray:
        """Pre-vectorization reference (one ``intern`` per row, each with
        its own lock round-trip on miss) — kept for the equivalence tests."""
        return np.fromiter((self.intern(s) for s in strings), dtype=np.int32)

    def lookup(self, sid: int) -> str:
        return self._strings[sid]  # alazlint: disable=ALZ010 -- lock-free read of the append-only table: any published id indexes a row that existed at publication

    def lookup_many(self, ids: np.ndarray) -> List[str]:
        """Batch id → string. ``tolist()`` + ``itemgetter`` keep the loop
        in C — iterating numpy scalars pays a boxing per element."""
        idx = np.asarray(ids).tolist()
        if not idx:
            return []
        if len(idx) == 1:
            return [self._strings[idx[0]]]  # alazlint: disable=ALZ010 -- lock-free read, see lookup()
        return list(itemgetter(*idx)(self._strings))  # alazlint: disable=ALZ010 -- lock-free read, see lookup()

    def _scalar_lookup_many(self, ids: np.ndarray) -> List[str]:
        """Pre-vectorization reference — kept for the equivalence tests."""
        strings = self._strings  # alazlint: disable=ALZ010 -- lock-free read, see lookup()
        return [strings[i] for i in ids]

    def get(self, s: str) -> int | None:
        """Id if already interned, else None (no allocation)."""
        return self._to_id.get(s)  # alazlint: disable=ALZ010 -- GIL-atomic dict probe; a miss during a concurrent insert is indistinguishable from probing a moment earlier

    def snapshot(self) -> List[str]:
        with self._lock:
            return list(self._strings)

    def strings_since(self, start: int) -> List[str]:
        """Rows ``[start, len)`` of the string table — the interner
        DELTA a process-mode shard worker ships at merge so the parent
        can fold its locally-assigned ids into the shared table
        (alaz_tpu/shm id-exchange, ISSUE 15)."""
        with self._lock:
            return self._strings[start:]
