"""Flight recorder: a bounded ring of structured runtime events (ISSUE 9).

Chaos-suite failures used to arrive as a bare assertion ("conservation
gap=412") with the run's history already gone. The flight recorder keeps
the last-N structured events — window closes with stage timings, worker
crashes/restarts, breaker flips, shed/ledger decisions, chaos
injections — in a fixed ring, so any gate failure or worker crash comes
with a replayable trail instead of a post-mortem guess.

Contract:

- ``record(kind, **fields)`` is O(1) under one short lock (a dict build
  plus a slot write; the ring never grows, never allocates after
  construction beyond the event dicts themselves) — cheap enough to sit
  on drop paths and close waves, NOT on per-row paths.
- events carry a global ``seq`` and wall-clock ``t``; ``events()``
  returns the surviving window oldest→newest, so a dump reads as a
  story.
- ``crash_dump(logger, reason)`` writes the formatted tail to the log
  (gated by ``dump_on_crash``); the sharded supervisor calls it when a
  worker dies, the chaos harness attaches ``dump()`` to failing
  reports, and the debug HTTP server serves it at ``/recorder``.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional


class FlightRecorder:
    def __init__(
        self,
        capacity: int = 512,
        metrics=None,
        dump_on_crash: bool = True,
    ):
        self.capacity = max(1, int(capacity))
        self.dump_on_crash = dump_on_crash
        self._buf: List[Optional[dict]] = [None] * self.capacity  # guarded-by: self._lock
        self._n = 0  # total ever recorded  # guarded-by: self._lock
        self._lock = threading.Lock()
        if metrics is not None:
            metrics.gauge("recorder.recorded", lambda: self.recorded)
            metrics.gauge("recorder.overwritten", lambda: self.overwritten)

    # envelope keys the recorder owns; caller fields with these names are
    # kept under a ``field_`` prefix instead of colliding (a field named
    # ``kind`` used to TypeError — and get swallowed by worker poison
    # nets — while ``t``/``seq`` silently corrupted event ordering)
    _RESERVED = ("kind", "t", "seq")

    def record(self, _kind: str, **fields) -> None:
        ev = {
            (f"field_{k}" if k in self._RESERVED else k): v
            for k, v in fields.items()
        }
        ev["kind"] = _kind
        with self._lock:
            # t stamped under the ring lock: seq order and t order must
            # agree, or a dump's oldest→newest story shows time running
            # backwards across concurrently-recording workers
            ev["t"] = round(time.time(), 6)
            ev["seq"] = self._n
            self._buf[self._n % self.capacity] = ev
            self._n += 1

    @property
    def recorded(self) -> int:
        with self._lock:
            return self._n

    @property
    def overwritten(self) -> int:
        """Events that fell off the ring (recorded - retained)."""
        with self._lock:
            return max(0, self._n - self.capacity)

    def events(self) -> List[dict]:
        """Surviving events, oldest→newest."""
        with self._lock:
            start = max(0, self._n - self.capacity)
            return [dict(self._buf[i % self.capacity]) for i in range(start, self._n)]

    def dump(self) -> dict:
        evs = self.events()
        return {
            "capacity": self.capacity,
            "recorded": self.recorded,
            "events": evs,
        }

    def dump_text(self, last: Optional[int] = None) -> str:
        evs = self.events()
        if last is not None:
            evs = evs[-last:]
        lines = []
        for e in evs:
            extra = " ".join(
                f"{k}={v}" for k, v in e.items() if k not in ("seq", "t", "kind")
            )
            lines.append(f"  #{e['seq']} t={e['t']:.3f} {e['kind']} {extra}".rstrip())
        return "\n".join(lines)

    def tail_summary(self, last: int = 64) -> str:
        """``last N of M events:\\n<tail>`` — the ONE framing shared by
        the crash dump and the chaos-gate warning (two hand-maintained
        copies would drift)."""
        shown = min(last, self.capacity, self.recorded)  # ring keeps ≤ capacity
        return (
            f"last {shown} of {self.recorded} events:\n"
            f"{self.dump_text(last=last)}"
        )

    def crash_dump(self, logger, reason: str, last: int = 64) -> None:
        """Write the tail of the ring to ``logger`` — the automatic
        worker-crash path. No-op when ``dump_on_crash`` is off."""
        if not self.dump_on_crash:
            return
        logger.error(
            f"flight recorder dump ({reason}): {self.tail_summary(last)}"
        )
