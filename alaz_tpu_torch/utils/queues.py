"""Bounded batch queues — the channel plane.

The reference moves single events through bounded Go channels and prefers
dropping to blocking at the kernel boundary (ebpf/l7_req/l7.go:764-770,
dropped-count logging l7.go:681-687). Here the queue element is a columnar
*batch* and the capacity is counted in **events**, not batches, so config
maps one-to-one to the reference's channel sizes (collector.go:79-81).

``put_nowait_drop`` implements drop-not-block with a running drop counter;
``put`` blocks (used between internal stages where backpressure is safe).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Optional


class QueueClosed(Exception):
    pass


class BatchQueue:
    """Bounded MPMC queue of (batch, aux) items; capacity in events.

    ``ledger``/``drop_cause`` (optional) route mouth drops into the
    unified :class:`~alaz_tpu.utils.ledger.DropLedger` so every lost row
    carries exactly one attribution (ISSUE 6): the queue keeps its local
    ``dropped`` gauge AND reports to the shared ledger."""

    def __init__(
        self,
        capacity_events: int,
        name: str = "queue",
        ledger=None,
        drop_cause: str = "dropped",
    ):
        self.name = name
        self.capacity = int(capacity_events)
        self._ledger = ledger
        self._drop_cause = drop_cause
        self._items: collections.deque = collections.deque()  # guarded-by: self._lock
        self._events = 0  # guarded-by: self._lock
        self._dropped = 0  # guarded-by: self._lock
        self._put_total = 0  # guarded-by: self._lock
        self._unfinished = 0  # enqueued batches not yet task_done()'d  # guarded-by: self._lock
        self._closed = False  # guarded-by: self._lock
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    @property
    def pending_events(self) -> int:
        return self._events  # alazlint: disable=ALZ010 -- racy int read is a metrics gauge; GIL-atomic, momentarily stale at worst

    @property
    def dropped(self) -> int:
        """Total events dropped at the mouth of the queue (l7.go:764-770)."""
        return self._dropped  # alazlint: disable=ALZ010 -- racy gauge read, see pending_events

    @property
    def put_total(self) -> int:
        return self._put_total  # alazlint: disable=ALZ010 -- racy gauge read, see pending_events

    def _size_of(self, batch: Any) -> int:
        try:
            return len(batch)
        except TypeError:
            return 1

    def put_nowait_drop(self, batch: Any) -> bool:
        """Enqueue unless full; on full, count the events as dropped and
        return False. Never blocks — the kernel-boundary contract."""
        n = self._size_of(batch)
        with self._lock:
            if self._closed:
                raise QueueClosed(self.name)
            if self._events + n > self.capacity:
                self._dropped += n
                if self._ledger is not None:
                    # ledger.add is lock-leaf: the queue→ledger edge has
                    # no reverse path (alazsan DAG)
                    self._ledger.add(self._drop_cause, n, reason=self.name)
                return False
            self._items.append(batch)
            self._events += n
            self._put_total += n
            self._unfinished += 1
            self._not_empty.notify()
            return True

    def put(self, batch: Any, timeout: Optional[float] = None) -> bool:
        """Blocking enqueue for interior stages. ``timeout`` is a real
        DEADLINE, not a per-wakeup budget: under producer contention a
        loser's wait used to restart at the full timeout every time a
        competitor stole the freed capacity, making the shed bound
        (sharded _put_or_shed) no bound at all."""
        n = self._size_of(batch)
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._not_full:
            while not self._closed and self._events + n > self.capacity and self._events > 0:
                if deadline is None:
                    self._not_full.wait()  # alazlint: disable=ALZ042 -- the timeout=None branch is the caller's explicit opt-in to block (interior stages where backpressure is safe); every ingest/flush/close-reachable call site passes a deadline, which ALZ042 checks AT those sites
                    continue
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._not_full.wait(remaining)
            if self._closed:
                raise QueueClosed(self.name)
            self._items.append(batch)
            self._events += n
            self._put_total += n
            self._unfinished += 1
            self._not_empty.notify()
            return True

    def get(self, timeout: Optional[float] = None) -> Any:
        """Blocking dequeue; returns None on timeout or when closed+drained."""
        with self._not_empty:
            while not self._items:
                if self._closed:
                    return None
                if not self._not_empty.wait(timeout):
                    return None
            batch = self._items.popleft()
            self._events -= self._size_of(batch)
            self._not_full.notify()
            return batch

    def task_done(self) -> None:
        """Mark one previously-gotten batch as fully processed. A consumer
        that calls this after each ``get`` lets ``unfinished`` distinguish
        "queue empty" from "queue empty but a worker is mid-batch"."""
        with self._lock:
            if self._unfinished > 0:
                self._unfinished -= 1

    @property
    def unfinished(self) -> int:
        """Batches enqueued but not yet marked done (includes in-flight)."""
        return self._unfinished  # alazlint: disable=ALZ010 -- racy gauge read; drain() polls it in a timeout loop, see pending_events

    def drain(self) -> list:
        """Grab everything currently queued (for batch-oriented consumers)."""
        with self._lock:
            items = list(self._items)
            self._items.clear()
            self._events = 0
            self._unfinished -= len(items)
            self._not_full.notify_all()
            return items

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed  # alazlint: disable=ALZ010 -- monotonic latch: False→True once, a stale False only delays the reader one poll

    def stats(self) -> dict:
        """Lag/drop gauges, the data.go:177-186 channel-lag log analog."""
        with self._lock:
            return {
                "name": self.name,
                "pending_events": self._events,
                "pending_batches": len(self._items),
                "capacity": self.capacity,
                "dropped": self._dropped,
                "put_total": self._put_total,
            }
