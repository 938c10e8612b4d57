"""Token-bucket rate limiting.

The reference rate-limits per-pid event processing at 100 events/s with a
burst of 1000 (aggregator/data.go:339-353, golang.org/x/time/rate). This is
a vectorized variant: one call admits/charges a whole batch.
"""

from __future__ import annotations

import threading

import numpy as np


class TokenBucket:
    def __init__(self, rate_per_s: float, burst: float, now_s: float = 0.0):
        self.rate = float(rate_per_s)
        self.burst = float(burst)
        self._tokens = float(burst)  # guarded-by: self._lock
        self._last = float(now_s)  # guarded-by: self._lock
        self._lock = threading.Lock()

    def admit(self, n: int, now_s: float) -> int:
        """Admit up to n units at time now_s; returns how many were admitted
        (the rest should be dropped, mirroring rate.Limiter.Allow).

        Only whole admitted units are charged — fractional refill carries
        over instead of being burned, so sub-token refills between calls
        still accumulate to the configured rate."""
        with self._lock:
            elapsed = max(0.0, now_s - self._last)
            self._last = now_s
            self._tokens = min(self.burst, self._tokens + elapsed * self.rate)
            take = min(n, int(self._tokens))
            self._tokens -= take
            return take


def admit_batch(buckets: list[TokenBucket], counts, now_s: float) -> np.ndarray:
    """Vectorized ``TokenBucket.admit`` across many buckets: admits
    ``counts[i]`` units on ``buckets[i]`` at ``now_s`` in one array pass.

    Per-bucket results and post-call bucket state are bit-identical to
    calling ``buckets[i].admit(counts[i], now_s)`` one by one — the same
    max/min/int-truncation chain over IEEE doubles, in the same order
    (``int()`` truncates toward zero; tokens are non-negative so
    ``astype(int64)`` matches).

    The per-bucket locks are taken only to snapshot and write back state:
    callers serialize whole admissions themselves (the aggregator holds
    ``_l7_lock`` across the batch), the bucket locks just fence concurrent
    readers like the gc staleness sweep.
    """
    k = len(buckets)
    tokens = np.empty(k, dtype=np.float64)
    last = np.empty(k, dtype=np.float64)
    rate = np.empty(k, dtype=np.float64)
    burst = np.empty(k, dtype=np.float64)
    for i, b in enumerate(buckets):
        with b._lock:
            tokens[i] = b._tokens
            last[i] = b._last
        rate[i] = b.rate
        burst[i] = b.burst
    elapsed = np.maximum(0.0, now_s - last)
    tokens = np.minimum(burst, tokens + elapsed * rate)
    take = np.minimum(
        np.asarray(counts, dtype=np.int64), tokens.astype(np.int64)
    )
    tokens -= take
    for i, b in enumerate(buckets):
        with b._lock:
            b._tokens = float(tokens[i])
            b._last = now_s
    return take
