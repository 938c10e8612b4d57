"""Native L7 engine binding (ISSUE 16).

``alz_process_l7`` (native/ingest.cc) executes the ``_process_l7_inner``
join + attribution + REQUEST-row emission body in one C++ pass. This
module owns the Python side of that handoff:

- the **socket-line snapshot**: the store's per-(pid, fd) histories
  flattened into one contiguous arena (lines lexsorted by key, offsets
  array), cached per engine instance and rebuilt only when the store's
  revision counter moves — steady-state batches hand the same arrays over
  again, so the GIL is held only for pointer marshalling;
- the **attribution tables**: `_IpTable._compile()`'s sorted arrays,
  passed by reference (recompiles swap arrays, never mutate in place);
- the **last-match writeback**: the C side flags touched snapshot entries,
  and `SocketLine.touch` folds them back under each line's lock so
  DeleteUnused staleness GC sees native joins exactly like Python ones.

Everything stateful beyond that is the caller's (aggregator/engine.py)
refusal surface: retry scheduling, drop-ledger accounting (the engine
consumes the counts vector — order pinned as
``graph.native.L7_ENGINE_DROP_CAUSES``), outbound reverse-DNS interning,
payload enrichment, h2/kafka reassembly.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from alaz_tpu_torch.aggregator.sockline import SocketLine, SocketLineStore
from alaz_tpu_torch.datastore.dto import REQUEST_DTYPE


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


class SockSnapshot:
    """The socket-line store flattened for ``alz_process_l7``: entry
    columns concatenated line-major, lines lexsorted by (pid, fd)."""

    __slots__ = (
        "rev", "pid", "fd", "off", "ts", "open_", "saddr", "sport",
        "daddr", "dport", "lines",
    )

    def __init__(self, store: SocketLineStore):
        # record the revision BEFORE flattening: a concurrent mutation
        # mid-build leaves rev behind the store's, so the next batch
        # rebuilds instead of reusing a torn snapshot
        self.rev = store.rev.n
        items = store.items()
        n_lines = len(items)
        self.pid = np.empty(n_lines, dtype=np.uint32)
        self.fd = np.empty(n_lines, dtype=np.uint64)
        exports = []
        for i, ((pid, fd), line) in enumerate(items):
            self.pid[i] = pid
            self.fd[i] = fd
            exports.append(line.export_arrays())  # per-line consistent copy
        order = np.lexsort((self.fd, self.pid))
        self.pid = np.ascontiguousarray(self.pid[order])
        self.fd = np.ascontiguousarray(self.fd[order])
        self.lines: list[SocketLine] = [items[int(j)][1] for j in order]
        lens = np.array(
            [exports[int(j)][0].shape[0] for j in order], dtype=np.int64
        )
        self.off = np.zeros(n_lines + 1, dtype=np.int64)
        np.cumsum(lens, out=self.off[1:])
        total = int(self.off[-1]) if n_lines else 0
        self.ts = np.empty(total, dtype=np.uint64)
        self.open_ = np.empty(total, dtype=np.uint8)
        self.saddr = np.empty(total, dtype=np.uint32)
        self.sport = np.empty(total, dtype=np.uint16)
        self.daddr = np.empty(total, dtype=np.uint32)
        self.dport = np.empty(total, dtype=np.uint16)
        for k, j in enumerate(order):
            ts, open_, saddr, sport, daddr, dport = exports[int(j)]
            a, b = self.off[k], self.off[k + 1]
            self.ts[a:b] = ts
            self.open_[a:b] = open_
            self.saddr[a:b] = saddr
            self.sport[a:b] = sport
            self.daddr[a:b] = daddr
            self.dport[a:b] = dport

    @property
    def n_entries(self) -> int:
        return self.ts.shape[0]


class NativeL7Engine:
    """Per-aggregator handle: owns the snapshot cache (keyed by the
    aggregator's OWN socket-line store revision — engines are not shared
    across aggregators)."""

    def __init__(self, lib):
        self._lib = lib
        self._snap: Optional[SockSnapshot] = None

    def snapshot(self, store: SocketLineStore) -> SockSnapshot:
        snap = self._snap
        if snap is None or snap.rev != store.rev.n:
            snap = SockSnapshot(store)
            self._snap = snap
        return snap

    def process(
        self,
        events: np.ndarray,
        now_ns: int,
        store: SocketLineStore,
        pod_table: tuple[np.ndarray, np.ndarray],
        svc_table: tuple[np.ndarray, np.ndarray],
    ):
        """One native pass over an L7_EVENT_DTYPE batch. Returns
        ``(out_rows, kept_idx, unmatched_idx, n_not_pod)`` with indexes
        ascending in ORIGINAL row order (the numpy boolean-mask order), or
        None when the call cannot run (caller falls back to Python)."""
        n = events.shape[0]
        events = np.ascontiguousarray(events)
        snap = self.snapshot(store)
        pod_ips, pod_uids = pod_table
        svc_ips, svc_uids = svc_table
        out = np.zeros(n, dtype=REQUEST_DTYPE)
        kept_idx = np.empty(n, dtype=np.int64)
        unmatched_idx = np.empty(n, dtype=np.int64)
        counts = np.zeros(2, dtype=np.int64)
        touched = np.zeros(max(snap.n_entries, 1), dtype=np.uint8)
        emitted = int(
            self._lib.alz_process_l7(
                _ptr(events), n, now_ns,
                _ptr(snap.pid), _ptr(snap.fd), _ptr(snap.off),
                snap.pid.shape[0],
                _ptr(snap.ts), _ptr(snap.open_), _ptr(snap.saddr),
                _ptr(snap.sport), _ptr(snap.daddr), _ptr(snap.dport),
                _ptr(touched),
                _ptr(pod_ips), _ptr(pod_uids), pod_ips.shape[0],
                _ptr(svc_ips), _ptr(svc_uids), svc_ips.shape[0],
                _ptr(out), _ptr(kept_idx), _ptr(unmatched_idx), _ptr(counts),
            )
        )
        if emitted < 0:  # defensive: no current failure mode returns < 0
            return None
        if now_ns and snap.n_entries and touched.any():
            # fold last-match marks back into the authoritative lines —
            # identical to get_values' `_last_match[np.unique(si)] = now`
            t_idx = np.flatnonzero(touched[: snap.n_entries])
            line_of = np.searchsorted(snap.off, t_idx, side="right") - 1
            for ln in np.unique(line_of):
                local = t_idx[line_of == ln] - snap.off[ln]
                snap.lines[int(ln)].touch(local, now_ns)
        return (
            out[:emitted],
            kept_idx[:emitted],
            unmatched_idx[: int(counts[0])],
            int(counts[1]),
        )


def make_engine() -> Optional[NativeL7Engine]:
    """A fresh per-aggregator engine handle, or None when the .so is
    unavailable (stale, unbuilt, or layout-drifted — graph.native's load
    path already logged/raised accordingly)."""
    from alaz_tpu_torch.graph import native

    lib = native._load()
    if lib is None:
        return None
    return NativeL7Engine(lib)


def available() -> bool:
    from alaz_tpu_torch.graph import native

    return native.available()
