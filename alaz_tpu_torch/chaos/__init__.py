"""alaz_tpu.chaos — deterministic fault injection + the chaos suite.

The four injection seams (ARCHITECTURE §3j):

1. wire frames     → :class:`FrameChaos`    (sources/ingest_server.py)
2. batch delivery  → :class:`BatchChaos`    (source → ingestion surface)
3. shard workers   → :class:`WorkerChaos`   (aggregator/sharded.py)
4. backend sends   → :class:`FlakyTransport`(datastore/backend.py)

`run_chaos_suite` wires them around the real pipeline and checks the
invariant gates (bounded flush/drain, exact row conservation through the
:class:`DropLedger`, monotonic window emission, crash→restart). Entry
points: ``make chaos`` / ``python -m alaz_tpu.chaos`` and
``bench.py --ingest [--chaos SEED]``.
"""

from alaz_tpu_torch.aggregator.sharded import WorkerCrash
from alaz_tpu_torch.chaos.harness import ChaosReport, emitted_rows, run_chaos_suite
from alaz_tpu_torch.chaos.injectors import (
    BatchChaos,
    FlakyTransport,
    FrameChaos,
    WorkerChaos,
)
from alaz_tpu_torch.utils.ledger import DropLedger

__all__ = [
    "BatchChaos",
    "ChaosReport",
    "DropLedger",
    "FlakyTransport",
    "FrameChaos",
    "WorkerChaos",
    "WorkerCrash",
    "emitted_rows",
    "run_chaos_suite",
]
