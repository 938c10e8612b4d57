"""Replay source: simulator or recorded trace → Service queues.

Supports flat-out replay (throughput benchmarking) and real-time pacing
(the reference simulator's rate.Limiter behavior,
main_benchmark_test.go:561-617).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from alaz_tpu_torch.config import SimulationConfig
from alaz_tpu_torch.events.intern import Interner
from alaz_tpu_torch.replay.simulator import Simulator


class ReplaySource:
    def __init__(
        self,
        config: SimulationConfig,
        interner: Interner,
        realtime: bool = False,
    ):
        self.sim = Simulator(config, interner=interner)
        self.realtime = realtime
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.emitted = 0

    def start(self, service) -> None:
        self._stop.clear()

        def run() -> None:
            for msg in self.sim.setup():
                service.submit_k8s(msg)
            service.submit_tcp(self.sim.tcp_events())
            rate = self.sim.cfg.edge_rate * self.sim.cfg.edge_count  # events/s
            t0 = time.monotonic()
            for batch in self.sim.iter_l7_batches():
                if self._stop.is_set():
                    return
                if self.realtime and rate > 0:
                    # pace so `emitted` tracks wall time × rate
                    target = self.emitted / rate
                    ahead = target - (time.monotonic() - t0)
                    if ahead > 0:
                        time.sleep(ahead)
                service.submit_l7(batch)
                self.emitted += batch.shape[0]

        self._thread = threading.Thread(target=run, name="alaz-replay", daemon=True)
        self._thread.start()

    def join(self, timeout: float | None = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def stop(self) -> None:
        self._stop.set()
        self.join(2)
        self._thread = None
