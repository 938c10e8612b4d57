"""Shared utilities: bounded queues, clocks, rate limiting."""

from alaz_tpu_torch.utils.queues import BatchQueue, QueueClosed
from alaz_tpu_torch.utils.clock import Clock, VirtualClock, WallClock
from alaz_tpu_torch.utils.ratelimit import TokenBucket

__all__ = [
    "BatchQueue",
    "QueueClosed",
    "Clock",
    "VirtualClock",
    "WallClock",
    "TokenBucket",
]
