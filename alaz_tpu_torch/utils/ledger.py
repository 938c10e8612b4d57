"""The drop ledger — unified row-loss accounting for the host plane.

The reference's loss story is scattered counters: perf-buffer drops
logged per ring (l7.go:681-687), channel-mouth drops (l7.go:764-770),
late-window drops in the store, HTTP batches that exhausted retries.
Under fault injection (alaz_tpu/chaos) that scatter is unauditable, so
the ledger centralizes it behind one contract:

    every row the pipeline loses is attributed to EXACTLY ONE cause,
    and row conservation becomes a checkable invariant:

        pushed == emitted + ledger.total

The causes are closed-world on purpose — a new loss path must pick one
(or grow the vocabulary here, `make specs` for the wire table, and the
metric registry, in ONE move — alazflow's ALZ041 pins all three sides):

- ``dropped``      — infrastructure loss: a full bounded queue at the
                     source boundary, or rows in flight on a worker
                     thread when it crashed.
- ``late``         — rows that arrived behind the sealed window horizon
                     (duplicate/reordered/stalled delivery).
- ``quarantined``  — rows in malformed wire frames the ingest socket
                     rejected while resyncing the stream.
- ``shed``         — deliberate backpressure: the pipeline chose to
                     drop under sustained overload rather than block
                     its producer past the shed window.
- ``sampled``      — degree-capped reservoir sampling at window close
                     (ISSUE 7): request rows on edges cut because their
                     dst exceeded ``degree_cap`` fan-in. Deliberate and
                     deterministic — the hot-key defense, not a fault.
- ``filtered``     — semantic aggregator rejection (ISSUE 8): rows the
                     join/attribution stage dropped by design — no
                     socket line after the retry ladder, non-pod
                     source, per-pid rate limit. Previously a separate
                     "semantic" side-channel (stats counters) the
                     conservation gates had to add back in; ledgering
                     them makes ``pushed == emitted + ledger.total``
                     exact with no second bookkeeper.

``reason`` sub-attribution is free-form ("shard2", "worker_crash") and
feeds debugging; the conservation math uses only the cause totals.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple


class DropLedger:
    """Thread-safe per-cause drop counters with reason sub-attribution.

    Shared by every stage of one pipeline (queues, shard stores, the
    scatter plane, the ingest socket), so a chaos run can check
    conservation with one read instead of chasing per-stage counters.
    """

    CAUSES = ("dropped", "late", "quarantined", "shed", "sampled", "filtered")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {c: 0 for c in self.CAUSES}  # guarded-by: self._lock
        self._reasons: Dict[Tuple[str, str], int] = {}  # guarded-by: self._lock
        # optional flight recorder (alaz_tpu/obs): when attached,
        # every ledger decision becomes a structured ring event — the
        # drop trail a post-incident dump replays. Attach-once at wiring
        # time (service / harness); adds are per-chunk, never per row.
        self.recorder = None  # lockless-ok: attach-once wiring before the pipeline runs; readers null-check an atomic reference swap

    def add(self, cause: str, n: int, reason: Optional[str] = None) -> None:
        """Attribute ``n`` lost rows to ``cause``. Unknown causes raise —
        the exactly-one-of contract forbids inventing buckets at a call
        site the conservation gates don't know about."""
        if cause not in self.CAUSES:
            raise ValueError(
                f"unknown drop cause {cause!r}; pick one of {self.CAUSES}"
            )
        if n <= 0:
            return
        with self._lock:
            self._counts[cause] += int(n)
            if reason is not None:
                key = (cause, reason)
                self._reasons[key] = self._reasons.get(key, 0) + int(n)
        rec = self.recorder
        if rec is not None:
            # outside the ledger lock: the recorder has its own ring
            # lock and never calls back into the ledger
            rec.record("ledger", cause=cause, n=int(n), reason=reason)

    def count(self, cause: str) -> int:
        with self._lock:
            return self._counts[cause]

    @property
    def total(self) -> int:
        with self._lock:
            return sum(self._counts.values())

    def snapshot(self) -> dict:
        """One JSON-able view: cause totals, the grand total, and the
        reason breakdown as "cause/reason" keys."""
        with self._lock:
            out = dict(self._counts)
            out["total"] = sum(self._counts.values())
            out["reasons"] = {
                f"{c}/{r}": n for (c, r), n in sorted(self._reasons.items())
            }
            return out

    def conservation_gap(self, pushed: int, emitted: int) -> int:
        """``pushed - emitted - total`` — zero iff every pushed row is
        either emitted or attributed. Positive = rows vanished untracked;
        negative = double counting (both are bugs)."""
        return int(pushed) - int(emitted) - self.total
