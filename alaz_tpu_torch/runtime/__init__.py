"""Runtime wiring: the main.go analog.

``Service`` assembles the full streaming pipeline — event queues →
aggregator workers → windowed graph store → GNN scorer → score sink —
with health checking (stop/resume protocol), per-stage metrics, and
graceful shutdown.
"""

from alaz_tpu_torch.runtime.metrics import Metrics, Counter, Gauge
from alaz_tpu_torch.runtime.health import HealthChecker, HealthState
from alaz_tpu_torch.runtime.service import Service, ScoreBatch, ScoreRecord

__all__ = [
    "Metrics",
    "Counter",
    "Gauge",
    "HealthChecker",
    "HealthState",
    "Service",
    "ScoreRecord",
    "ScoreBatch",
]
