"""Lock-striped, mergeable log-bucket latency histogram (ISSUE 9).

The metrics registry had counters and gauges; per-stage latency needs a
*distribution* — p50/p95/p99 of "how long did the merge stage take" is
the number that gates every future perf claim (FeatGraph-style kernel
wins and multi-tenant isolation are per-stage, per-percentile
statements). Design constraints, in order:

1. **Cheap on the hot path.** ``observe`` is one bisect over ~30
   geometric bucket bounds plus three adds under a *striped* lock —
   each thread is round-robin-assigned one of ``N_STRIPES`` independent
   (lock, counts) cells at first use (a thread-local; see
   ``_stripe_index`` for why modulo-by-ident is a trap), so N shard
   workers recording concurrently never contend on one global lock
   (the ALZ042 discipline: the ingest surface must not gain a
   contended blocking point).
2. **Mergeable.** Buckets are a fixed geometric ladder shared by every
   instance, so histograms merge by vector addition — associative and
   commutative, which is what lets per-worker or per-tenant histograms
   fold into one fleet view (tested: merge order is invisible).
3. **Bounded error.** Buckets grow by 2×, percentiles interpolate
   linearly inside the bucket, so any reported quantile q satisfies
   ``true/2 <= q <= true*2`` — a factor-two band, constant memory,
   no reservoir, no decay bookkeeping.

Prometheus exposition follows the histogram text format (cumulative
``_bucket{le=...}`` + ``_sum`` + ``_count``), rendered by the metrics
registry next to its gauges.
"""

from __future__ import annotations

import itertools
import threading
from bisect import bisect_left
from typing import List, Optional, Sequence

# 1 µs .. ~537 s in 2× steps: spans every plausible stage latency from a
# sub-microsecond sample decision to a wedged close wave. The ladder is
# the merge contract — every Histogram shares it unless a caller opts
# into custom bounds (and then only merges with like-bounded peers).
DEFAULT_BOUNDS = tuple(1e-6 * (2.0 ** i) for i in range(30))

N_STRIPES = 8

# Stripe selection is a round-robin thread-local, NOT `get_ident() % N`:
# on Linux CPython the ident is the pthread_t — a stack address aligned
# to multi-MB boundaries — so the modulo maps EVERY thread to stripe 0
# and the striping silently degrades to one global contended lock
# (caught in review; regression-tested). First use assigns the thread
# the next index; every later observe is one thread-local read.
_stripe_tls = threading.local()
_stripe_counter = itertools.count()


def _stripe_index() -> int:
    idx = getattr(_stripe_tls, "idx", None)
    if idx is None:
        # itertools.count.__next__ is atomic in CPython; one call per
        # thread lifetime, so contention here is immaterial anyway
        idx = next(_stripe_counter) % N_STRIPES
        _stripe_tls.idx = idx
    return idx


class _Stripe:
    __slots__ = ("lock", "counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.lock = threading.Lock()
        self.counts = [0] * n_buckets  # guarded-by: self.lock
        self.sum = 0.0  # guarded-by: self.lock
        self.count = 0  # guarded-by: self.lock


class Histogram:
    """Thread-safe log-bucket histogram; see module docstring."""

    __slots__ = ("name", "bounds", "_stripes")

    def __init__(self, name: str = "", bounds: Optional[Sequence[float]] = None):
        self.name = name
        self.bounds = tuple(bounds) if bounds is not None else DEFAULT_BOUNDS
        # +1: the overflow bucket (> last bound, le="+Inf")
        self._stripes = [_Stripe(len(self.bounds) + 1) for _ in range(N_STRIPES)]

    # -- hot path ------------------------------------------------------------

    def observe(self, v: float) -> None:
        v = float(v)
        if v < 0.0:  # clock skew / monotonic misuse: clamp, never throw
            v = 0.0
        i = bisect_left(self.bounds, v)
        s = self._stripes[_stripe_index()]
        with s.lock:
            s.counts[i] += 1
            s.sum += v
            s.count += 1

    # -- read side -----------------------------------------------------------

    def _merged(self) -> tuple:
        counts = [0] * (len(self.bounds) + 1)
        total = 0
        vsum = 0.0
        for s in self._stripes:
            with s.lock:
                for i, c in enumerate(s.counts):
                    counts[i] += c
                total += s.count
                vsum += s.sum
        return counts, total, vsum

    @property
    def total_count(self) -> int:
        return self._merged()[1]

    @property
    def total_sum(self) -> float:
        return self._merged()[2]

    def bucket_counts(self) -> List[int]:
        """Non-cumulative per-bucket counts (len(bounds)+1, last=+Inf)."""
        return self._merged()[0]

    def percentile(self, q: float) -> float:
        """q∈[0,1] quantile, linearly interpolated inside its bucket.
        Error bound: within the containing bucket, i.e. a factor of the
        bucket growth (2×) of the true order statistic."""
        counts, total, _ = self._merged()
        return self._percentile_from(counts, total, q)

    def _percentile_from(self, counts: Sequence[int], total: int, q: float) -> float:
        # percentile over an already-merged view: snapshot() merges the
        # stripes ONCE and derives count + p50/p95/p99 from that single
        # instant (four independent merges would quadruple read-side
        # lock traffic and let count disagree with the percentiles)
        if total == 0:
            return 0.0
        target = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) else self.bounds[-1]
                if hi <= lo:  # overflow bucket: report the last bound
                    return lo
                frac = (target - cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            cum += c
        return self.bounds[-1]

    def snapshot(self) -> dict:
        counts, total, vsum = self._merged()
        out = {"count": total, "sum": vsum}
        for q, key in ((0.50, "p50"), (0.95, "p95"), (0.99, "p99")):
            out[key] = self._percentile_from(counts, total, q)
        return out

    def add_counts(self, counts: Sequence[int], vsum: float) -> None:
        """Fold an already-bucketed batch of observations in — the
        vectorized batch-observe path (obs/scores.py buckets a whole
        per-window score vector with one searchsorted+bincount instead
        of E bisects). ``counts`` is NON-cumulative per-bucket counts of
        length ``len(bounds)+1`` (last = overflow); ``vsum`` the sum of
        the raw values. Exactly equivalent to observing each value
        individually (tested), so merged sketches stay associative."""
        if len(counts) != len(self.bounds) + 1:
            raise ValueError("counts length must be len(bounds)+1")
        total = 0
        s = self._stripes[_stripe_index()]
        with s.lock:
            for i, c in enumerate(counts):
                c = int(c)
                s.counts[i] += c
                total += c
            s.count += total
            s.sum += float(vsum)

    # -- merge (associative: shared ladder, vector addition) -----------------

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other``'s state into self (in place); returns self."""
        if other.bounds != self.bounds:
            raise ValueError("cannot merge histograms with different bucket ladders")
        counts, total, vsum = other._merged()
        s = self._stripes[0]
        with s.lock:
            for i, c in enumerate(counts):
                s.counts[i] += c
            s.count += total
            s.sum += vsum
        return self

    def copy(self) -> "Histogram":
        out = Histogram(self.name, self.bounds)
        out.merge(self)
        return out

    # -- exposition ----------------------------------------------------------

    def render_prometheus(self, metric: str) -> List[str]:
        """Prometheus histogram text lines: cumulative buckets, sum,
        count (the node_exporter histogram shape)."""
        counts, total, vsum = self._merged()
        lines = [f"# TYPE {metric} histogram"]
        cum = 0
        for i, bound in enumerate(self.bounds):
            cum += counts[i]
            lines.append(f'{metric}_bucket{{le="{format(bound, ".9g")}"}} {cum}')
        lines.append(f'{metric}_bucket{{le="+Inf"}} {total}')
        lines.append(f"{metric}_sum {format(vsum, '.9g')}")
        lines.append(f"{metric}_count {total}")
        return lines
