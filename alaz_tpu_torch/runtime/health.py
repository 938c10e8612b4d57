"""Health-check loop with backend-commanded stop/resume.

The reference PUTs a healthcheck every 10s and obeys a "payment required"
protocol: on HTTP 402 the agent stops its collectors, and resumes when the
backend starts answering 200 again (backend.go:950-1036, main.go:149-187).
Here the commands pause/resume the scoring service via callbacks; the
transport is the same pluggable callable the datastore uses.
"""

from __future__ import annotations

import enum
import threading
from typing import Callable, Optional

from alaz_tpu_torch.datastore.backend import Transport
from alaz_tpu_torch.logging import get_logger

log = get_logger("alaz_tpu.health")

EP_HEALTHCHECK = "/healthcheck/"


class HealthState(str, enum.Enum):
    RUNNING = "running"
    STOPPED = "stopped"  # backend-commanded (the payment-required state)


class HealthChecker:
    def __init__(
        self,
        transport: Transport,
        interval_s: float = 10.0,
        on_stop: Optional[Callable[[], None]] = None,
        on_resume: Optional[Callable[[], None]] = None,
        metrics_snapshot: Optional[Callable[[], dict]] = None,
        degraded_snapshot: Optional[Callable[[], dict]] = None,
    ):
        self.transport = transport
        self.interval_s = interval_s
        self.on_stop = on_stop
        self.on_resume = on_resume
        self.metrics_snapshot = metrics_snapshot
        # self-healing visibility (ISSUE 6): drop-ledger breakdown,
        # worker restarts, breaker state, last-wave age — wire it to
        # Service.degraded_snapshot so a stalled merge thread or an open
        # circuit shows up in every health PUT instead of staying silent
        self.degraded_snapshot = degraded_snapshot
        self.state = HealthState.RUNNING
        self.checks = 0
        self.failures = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def check_once(self) -> HealthState:
        payload = {"state": self.state.value}
        if self.metrics_snapshot is not None:
            payload["metrics"] = self.metrics_snapshot()
        if self.degraded_snapshot is not None:
            try:
                payload["degraded"] = self.degraded_snapshot()
            except Exception as exc:
                log.warning(f"degraded snapshot failed: {exc}")
        try:
            status = self.transport(EP_HEALTHCHECK, payload)
        except Exception as exc:
            log.warning(f"healthcheck transport error: {exc}")
            self.failures += 1
            return self.state
        self.checks += 1
        if status == 402 and self.state == HealthState.RUNNING:
            # payment-required: stop collectors until told otherwise
            log.warning("healthcheck: backend commanded STOP (402)")
            self.state = HealthState.STOPPED
            if self.on_stop is not None:
                self.on_stop()
        elif status < 400 and self.state == HealthState.STOPPED:
            log.warning("healthcheck: backend resumed (2xx), restarting")
            self.state = HealthState.RUNNING
            if self.on_resume is not None:
                self.on_resume()
        return self.state

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def run() -> None:
            while not self._stop.wait(self.interval_s):
                self.check_once()

        self._thread = threading.Thread(target=run, name="alaz-health", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
