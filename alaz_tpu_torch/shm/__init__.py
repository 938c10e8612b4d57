"""Process-mode sharded ingest (ISSUE 15): shared-memory ring buffers +
spawn shard workers + the out-of-GIL ``ShardedIngest`` backend.

Selected by ``RuntimeConfig.ingest_backend = "process"``
(``INGEST_BACKEND`` env); the thread backend in ``aggregator/sharded.py``
stays the default. See ARCHITECTURE §3r.
"""

from alaz_tpu_torch.shm.process_pool import ProcessShardedIngest
from alaz_tpu_torch.shm.ring import (
    RingClosed,
    RingConsumer,
    RingProducer,
    ShmRing,
)

__all__ = [
    "ProcessShardedIngest",
    "ShmRing",
    "RingProducer",
    "RingConsumer",
    "RingClosed",
]
