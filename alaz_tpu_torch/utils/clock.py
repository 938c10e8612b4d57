"""Clocks.

The reference anchors kernel monotonic time to wall time once at startup
(FirstKernelTime/FirstUserspaceTime, l7.go:327-328,707-710) and converts
with ``convertKernelTimeToUserspaceTime``. We model the same anchor pair,
plus a virtual clock so replay runs are deterministic and faster than real
time.
"""

from __future__ import annotations

import threading
import time


class Clock:
    """Kernel(ns, monotonic) <-> wall(ns, epoch) anchored conversion."""

    def __init__(self, kernel_anchor_ns: int | None = None, wall_anchor_ns: int | None = None):
        self.kernel_anchor_ns = (
            kernel_anchor_ns if kernel_anchor_ns is not None else time.monotonic_ns()
        )
        self.wall_anchor_ns = wall_anchor_ns if wall_anchor_ns is not None else time.time_ns()

    def kernel_to_wall_ns(self, kernel_ns):
        return kernel_ns - self.kernel_anchor_ns + self.wall_anchor_ns

    def wall_to_kernel_ns(self, wall_ns):
        return wall_ns - self.wall_anchor_ns + self.kernel_anchor_ns

    def now_ns(self) -> int:
        return time.time_ns()

    def monotonic_ns(self) -> int:
        return time.monotonic_ns()


class WallClock(Clock):
    pass


class VirtualClock(Clock):
    """Deterministic, manually-advanced clock for replay/tests."""

    def __init__(self, start_ns: int = 1_700_000_000_000_000_000):
        super().__init__(kernel_anchor_ns=0, wall_anchor_ns=start_ns)
        self._now = start_ns
        self._lock = threading.Lock()

    def now_ns(self) -> int:
        return self._now

    def monotonic_ns(self) -> int:
        return self._now - self.wall_anchor_ns

    def advance(self, ns: int) -> int:
        with self._lock:
            self._now += int(ns)
            return self._now
