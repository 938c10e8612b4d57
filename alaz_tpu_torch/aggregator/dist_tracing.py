"""Distributed-tracing correlation (gated off by default).

The reference ships a full design that is compiled out
(``DIST_TRACING_ENABLED``, ebpf/c/bpf.c:19; tcp seq/tid capture
tcp_sock.c:206-282; the ``ingress_egress_calls`` perf map and the
``/dist_tracing/traffic/`` endpoint backend.go:879-900). The captured
signals are the thread id and tcp sequence number on each L7 event
(l7.go:409-410 — our schema carries both).

This correlator implements that design: within one process, an *ingress*
event (a request this process served) is linked to the *egress* events
(requests it made) observed on the same thread while handling it — the
classic thread-propagation heuristic. Links export as caller→callee span
pairs. Enable with ``ALAZ_TPU_DIST_TRACING_ENABLED=1`` or by constructing
the correlator explicitly; the default build leaves it off, matching the
reference.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List

import numpy as np

from alaz_tpu_torch.config import env_bool

DEFAULT_WINDOW_NS = 5_000_000_000  # how long an ingress stays linkable


def enabled() -> bool:
    return env_bool("DIST_TRACING_ENABLED", False)


@dataclass
class SpanLink:
    """caller (ingress into pid) → callee (egress out of pid)."""

    pid: int
    tid: int
    ingress_seq: int
    egress_seq: int
    ingress_time_ns: int
    egress_time_ns: int


@dataclass
class _Ingress:
    seq: int
    time_ns: int


class DistTracingCorrelator:
    """Feed L7 event batches tagged with direction; emit span links.

    Direction convention: ``is_ingress`` True for events this process
    *served* (read-side), False for calls it *made* (write-side) — the
    aggregator knows which from the protocol handler (e.g. server frames,
    DELIVER/PUSHED events are ingress-shaped).
    """

    def __init__(
        self,
        window_ns: int = DEFAULT_WINDOW_NS,
        max_per_thread: int = 8,
        max_links: int = 100_000,
    ):
        self.window_ns = window_ns
        self.max_per_thread = max_per_thread
        self._open: Dict[tuple[int, int], Deque[_Ingress]] = {}
        # bounded: export/drain or the oldest links fall off
        self.links: Deque[SpanLink] = deque(maxlen=max_links)
        self.dropped_unmatched = 0
        self._last_seen: Dict[tuple[int, int], int] = {}

    def observe(self, events: np.ndarray, is_ingress: np.ndarray) -> List[SpanLink]:
        """events: L7_EVENT_DTYPE rows (need pid/tid/seq/write_time_ns)."""
        out: List[SpanLink] = []
        order = np.argsort(events["write_time_ns"], kind="stable")
        now = int(events["write_time_ns"].max()) if events.shape[0] else 0
        for i in order:
            row = events[i]
            key = (int(row["pid"]), int(row["tid"]))
            t = int(row["write_time_ns"])
            self._last_seen[key] = t
            if is_ingress[i]:
                dq = self._open.setdefault(key, deque(maxlen=self.max_per_thread))
                dq.append(_Ingress(seq=int(row["seq"]), time_ns=t))
            else:
                dq = self._open.get(key)
                if not dq:
                    self.dropped_unmatched += 1
                    continue
                # most recent ingress on this thread still inside the window
                while dq and t - dq[0].time_ns > self.window_ns:
                    dq.popleft()
                if not dq:
                    self.dropped_unmatched += 1
                    continue
                ing = dq[-1]
                out.append(
                    SpanLink(
                        pid=key[0],
                        tid=key[1],
                        ingress_seq=ing.seq,
                        egress_seq=int(row["seq"]),
                        ingress_time_ns=ing.time_ns,
                        egress_time_ns=t,
                    )
                )
        self.links.extend(out)
        # evict idle threads so _open stays bounded on long runs
        if len(self._open) > 4096:
            stale = [
                k
                for k, last in self._last_seen.items()
                if now - last > 2 * self.window_ns
            ]
            for k in stale:
                self._open.pop(k, None)
                self._last_seen.pop(k, None)
        return out

    def export_rows(self, drain: bool = True) -> list[list]:
        """Wire rows for a /dist_tracing/traffic/ style endpoint
        (backend.go:879-900 analog); drains the buffer by default."""
        rows = [
            [l.pid, l.tid, l.ingress_seq, l.egress_seq, l.ingress_time_ns, l.egress_time_ns]
            for l in self.links
        ]
        if drain:
            self.links.clear()
        return rows
