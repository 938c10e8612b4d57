"""Socket-line interval join — the sock_num_line.go analog.

A socket line is the time-ordered history of connections seen on one
(pid, fd): open intervals carry a ``SockInfo`` (addresses), closes are nil
markers. L7 events are attributed to a connection by binary-searching their
write timestamp into this history with tolerance heuristics for out-of-order
arrival and close races (GetValue, sock_num_line.go:82-158).

This implementation keeps each line as parallel numpy arrays and answers a
whole batch of timestamps per line in one vectorized call — the per-event
semantics match the reference case for case (see tests/test_sockline.py).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np

ONE_MINUTE_NS = 60_000_000_000
ASSUMED_INTERVAL_NS = 5 * ONE_MINUTE_NS  # DeleteUnused assumedInterval


class _Rev:
    """Store-wide mutation counter. The native L7 engine flattens the whole
    store into contiguous arrays once and reuses that snapshot until this
    revision moves — only mutations that can change a join result bump it
    (inserts, clears, compaction, pid removal; ``_last_match`` writes don't)."""

    __slots__ = ("n", "_lock")

    def __init__(self) -> None:
        self.n = 0  # guarded-by: self._lock (writes); racy reads see a
        # value at most one bump behind — the snapshot records it BEFORE
        # flattening, so any later mutation forces a rebuild
        self._lock = threading.Lock()

    def bump(self) -> None:
        # the lock makes every mutation ADVANCE the counter (a lost
        # update could leave the revision unchanged across a mutation
        # and let a torn snapshot be reused forever)
        with self._lock:
            self.n += 1


@dataclass
class SockInfo:
    pid: int
    fd: int
    saddr: int  # u32
    sport: int
    daddr: int  # u32
    dport: int


class SocketLine:
    """Sorted (timestamp, sockinfo|None) history for one (pid, fd)."""

    __slots__ = ("pid", "fd", "_ts", "_open", "_saddr", "_sport", "_daddr", "_dport", "_last_match", "_n", "_lock", "_rev")

    def __init__(self, pid: int, fd: int, cap: int = 4, rev: _Rev | None = None):
        self.pid = pid
        self.fd = fd
        self._rev = rev if rev is not None else _Rev()
        self._n = 0
        self._ts = np.zeros(cap, dtype=np.uint64)
        self._open = np.zeros(cap, dtype=bool)  # False = close marker
        self._saddr = np.zeros(cap, dtype=np.uint32)
        self._sport = np.zeros(cap, dtype=np.uint16)
        self._daddr = np.zeros(cap, dtype=np.uint32)
        self._dport = np.zeros(cap, dtype=np.uint16)
        self._last_match = np.zeros(cap, dtype=np.uint64)
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return self._n

    def _grow(self) -> None:
        cap = max(8, self._ts.shape[0] * 2)
        for name in ("_ts", "_open", "_saddr", "_sport", "_daddr", "_dport", "_last_match"):
            arr = getattr(self, name)
            new = np.zeros(cap, dtype=arr.dtype)
            new[: self._n] = arr[: self._n]
            setattr(self, name, new)

    def clear(self) -> None:
        with self._lock:
            self._n = 0
            self._rev.bump()

    def add_value(self, timestamp: int, info: SockInfo | None) -> None:
        """Sorted insert with tail dedup (AddValue, sock_num_line.go:62-80):
        if the last entry is an identical open socket, skip."""
        with self._lock:
            n = self._n
            if n > 0 and info is not None and self._open[n - 1]:
                if (
                    self._saddr[n - 1] == info.saddr
                    and self._sport[n - 1] == info.sport
                    and self._daddr[n - 1] == info.daddr
                    and self._dport[n - 1] == info.dport
                ):
                    return
            if n == self._ts.shape[0]:
                self._grow()
            idx = int(np.searchsorted(self._ts[:n], np.uint64(timestamp)))
            for name in ("_ts", "_open", "_saddr", "_sport", "_daddr", "_dport", "_last_match"):
                arr = getattr(self, name)
                arr[idx + 1 : n + 1] = arr[idx:n]
            self._ts[idx] = timestamp
            if info is None:
                self._open[idx] = False
                self._saddr[idx] = 0
                self._sport[idx] = 0
                self._daddr[idx] = 0
                self._dport[idx] = 0
            else:
                self._open[idx] = True
                self._saddr[idx] = info.saddr
                self._sport[idx] = info.sport
                self._daddr[idx] = info.daddr
                self._dport[idx] = info.dport
            self._last_match[idx] = 0
            self._n = n + 1
            self._rev.bump()

    def get_value(self, timestamp: int, now_ns: int = 0) -> SockInfo | None:
        out = self.get_values(np.asarray([timestamp], dtype=np.uint64), now_ns)
        if not out[0][0]:
            return None
        return SockInfo(
            pid=self.pid,
            fd=self.fd,
            saddr=int(out[1][0]),
            sport=int(out[2][0]),
            daddr=int(out[3][0]),
            dport=int(out[4][0]),
        )

    def get_values(
        self, timestamps: np.ndarray, now_ns: int = 0
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Vectorized GetValue (sock_num_line.go:82-158) for a batch of
        timestamps → (found, saddr, sport, daddr, dport).

        Case-for-case with the reference:
        - after the last entry → last entry if open; if the line ends with a
          close, fall back to the previous open when within 1 minute.
        - before the first entry → first entry if it's an open (cold-start
          userspace-timestamp tolerance), else miss.
        - landed on a close → if the neighboring opens agree on daddr:dport,
          take the closest; else miss.
        """
        n = self._n
        m = timestamps.shape[0]
        found = np.zeros(m, dtype=bool)
        saddr = np.zeros(m, dtype=np.uint32)
        sport = np.zeros(m, dtype=np.uint16)
        daddr = np.zeros(m, dtype=np.uint32)
        dport = np.zeros(m, dtype=np.uint16)
        if n == 0:
            return found, saddr, sport, daddr, dport

        with self._lock:
            ts = self._ts[:n]
            is_open = self._open[:n]
            idx = np.searchsorted(ts, timestamps, side="left")  # first >= t

            sel = np.full(m, -1, dtype=np.int64)

            # -- case: timestamp after the last entry
            after = idx == n
            if after.any():
                if is_open[n - 1]:
                    sel[after] = n - 1
                else:
                    # closed last entry: use n-2 if open and within 1 minute
                    if n >= 2 and is_open[n - 2]:
                        within = (timestamps - ts[n - 2]) < ONE_MINUTE_NS
                        sel[after & within] = n - 2

            # -- case: timestamp before or at the first entry
            first = (idx == 0) & ~after
            if first.any() and is_open[0]:
                sel[first] = 0

            # -- general case: previous entry
            mid = ~after & ~first
            if mid.any():
                prev = idx[mid] - 1
                prev_open = is_open[prev]
                sel_mid = np.where(prev_open, prev, -1)
                # landed on a close: neighbor agreement heuristic
                closed = ~prev_open
                if closed.any():
                    c_prev = prev[closed] - 1  # index-2
                    c_after = prev[closed] + 1  # index
                    ok_prev = (c_prev >= 0) & is_open[np.clip(c_prev, 0, n - 1)]
                    ok_after = (c_after < n) & is_open[np.clip(c_after, 0, n - 1)]
                    both = ok_prev & ok_after
                    cp = np.clip(c_prev, 0, n - 1)
                    ca = np.clip(c_after, 0, n - 1)
                    agree = both & (self._daddr[cp] == self._daddr[ca]) & (
                        self._dport[cp] == self._dport[ca]
                    )
                    t_mid = timestamps[mid][closed]
                    pick_prev = (t_mid - ts[cp]) < (ts[ca] - t_mid)
                    chosen = np.where(pick_prev, cp, ca)
                    resolved = np.where(agree, chosen, -1)
                    sel_closed = sel_mid[closed]
                    sel_closed = np.where(agree, resolved, sel_closed)
                    sel_mid[closed] = sel_closed
                sel[mid] = sel_mid

            hit = sel >= 0
            found[hit] = True
            si = sel[hit]
            saddr[hit] = self._saddr[si]
            sport[hit] = self._sport[si]
            daddr[hit] = self._daddr[si]
            dport[hit] = self._dport[si]
            if hit.any() and now_ns:
                self._last_match[np.unique(si)] = now_ns
            return found, saddr, sport, daddr, dport

    def delete_unused(self) -> None:
        """GC (DeleteUnused, sock_num_line.go:160-208): collapse paired
        consecutive opens (lost close), then drop open+close pairs whose
        last match is ≥5 minutes older than the newest match on the line."""
        with self._lock:
            n = self._n
            if n <= 1:
                return
            # collapse consecutive opens, keeping the later one
            keep: list[int] = []
            i = 0
            while i < n - 1:
                if self._open[i] and self._open[i + 1]:
                    keep.append(i + 1)
                    i += 2
                else:
                    keep.append(i)
                    i += 1
            if i == n - 1:
                keep.append(n - 1)
            self._compact(keep)
            n = self._n

            last_matched = int(self._last_match[:n].max()) if n else 0
            # drop (open@i-1, close@i) pairs that went stale
            i = n - 1
            dead: set[int] = set()
            while i >= 1:
                if (
                    not self._open[i]
                    and self._open[i - 1]
                    and int(self._last_match[i - 1]) + ASSUMED_INTERVAL_NS < last_matched
                    and i - 1 not in dead
                ):
                    dead.add(i)
                    dead.add(i - 1)
                    i -= 2
                else:
                    i -= 1
            if dead:
                self._compact([j for j in range(n) if j not in dead])

    def _compact(self, keep: list[int]) -> None:
        k = np.asarray(keep, dtype=np.int64)
        for name in ("_ts", "_open", "_saddr", "_sport", "_daddr", "_dport", "_last_match"):
            arr = getattr(self, name)
            arr[: k.shape[0]] = arr[k]
        self._n = k.shape[0]
        self._rev.bump()

    def snapshot(self) -> list[tuple[int, bool]]:
        with self._lock:
            return [(int(self._ts[i]), bool(self._open[i])) for i in range(self._n)]

    def export_arrays(
        self,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Consistent copies of (ts, open, saddr, sport, daddr, dport) for the
        native engine's flattened snapshot."""
        with self._lock:
            n = self._n
            return (
                self._ts[:n].copy(),
                self._open[:n].copy(),
                self._saddr[:n].copy(),
                self._sport[:n].copy(),
                self._daddr[:n].copy(),
                self._dport[:n].copy(),
            )

    def touch(self, local_idx: np.ndarray, now_ns: int) -> None:
        """Mark snapshot-resolved entries as matched (native join writeback).

        ``local_idx`` indexes the entries as of the snapshot; a concurrent
        insert can shift them, so out-of-range hits are clipped away — this
        only feeds the DeleteUnused staleness heuristic, not join results."""
        if not now_ns:
            return
        with self._lock:
            idx = local_idx[local_idx < self._n]
            if idx.shape[0]:
                self._last_match[idx] = np.uint64(now_ns)


class SocketLineStore:
    """All socket lines, keyed (pid, fd) — the SocketMaps[pid] analog
    (cluster.go:20-37) without the pid_max-sized array: a dict is enough
    because keys are interned tuples, not a kernel address space."""

    def __init__(self) -> None:
        self._lines: dict[tuple[int, int], SocketLine] = {}  # lockless-ok: double-checked fast path — reads are single GIL-atomic dict lookups; every structural mutation holds self._lock
        self._lock = threading.Lock()
        self.rev = _Rev()  # shared with every line; native snapshot cache key

    def __len__(self) -> int:
        return len(self._lines)

    def items(self) -> list[tuple[tuple[int, int], SocketLine]]:
        return list(self._lines.items())

    def get(self, pid: int, fd: int) -> SocketLine | None:
        return self._lines.get((pid, fd))

    def get_or_create(self, pid: int, fd: int) -> SocketLine:
        key = (pid, fd)
        line = self._lines.get(key)
        if line is None:
            with self._lock:
                line = self._lines.get(key)
                if line is None:
                    line = SocketLine(pid, fd, rev=self.rev)
                    self._lines[key] = line
        return line

    def remove_pid(self, pid: int) -> int:
        """Drop all lines of an exited process (processExit path,
        data.go:404-437 vicinity)."""
        with self._lock:
            doomed = [k for k in self._lines if k[0] == pid]
            for k in doomed:
                del self._lines[k]
            if doomed:
                self.rev.bump()
            return len(doomed)

    def gc(self) -> None:
        for line in list(self._lines.values()):
            line.delete_unused()
