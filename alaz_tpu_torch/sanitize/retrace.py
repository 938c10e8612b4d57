"""Build and launch budgets for the port's entry points, and a guard
against implicit synchronizing transfers: the JAX package's
``sanitize/retrace.py`` for eager PyTorch on the card.

The JAX package counts XLA compiles per jit entry point from jax's
compile log. Eager PyTorch traces and compiles nothing per call; what the
port compiles is native code, once per process or per source:

- **Builds.** The kernels' library (nvcc, ``csrc/segment.cu``,
  ``ops/_build.py``), the C++ ingest core and the two native binaries
  (g++, ``graph/native.py``). Each build site wraps its work in
  ``build_event(name, what)``, which hands every open
  :class:`CompileWatcher` ``("compiling", name, None)`` before the work
  and ``("finished", name, secs)`` after it. A build found by its source
  hash, and only loaded, is one event too, as a jit compile is one event
  per process. The names are ``BUILD_NAMES``; ``STEADY_STATE_BUDGETS``
  holds each at 0.
- **Launches.** Steady state for eager scoring is a launch budget: one
  dispatch of an entry point launches a fixed number of each
  hand-written kernel. Each entry point wraps its work in
  ``dispatch(name, graph)``, which reads
  ``ops.segment_kernels.launch_counts()`` around it and hands every open
  watcher ``(name, bucket, {kernel: launches})``. The entry points are
  ``score_apply``, ``batched_score_apply``, ``tgn_step`` and
  ``train_step``. The counts are exact while one thread launches at a
  time, as the service's scorer does.

``retrace_budget`` holds a block to its build budgets and, given
``launches``, every dispatch in it to its entry point's launch budget,
and raises :class:`RetraceBudgetExceeded` naming the build, or the entry
point, the bucket and each kernel's count against its budget.

``no_implicit_transfers`` makes a synchronizing host↔device operation on
the card raise (``torch.cuda.set_sync_debug_mode("error")``): a
``.item()``, a pageable copy, a ``.cpu()``. The scorer's staging copy is
asynchronous from page-locked buffers and passes; its readback is
declared with ``explicit_transfer``, as jax's "disallow" level lets
``np.asarray`` through. Unlike jax's guard, the mode is process-wide,
not per thread, and it catches synchronizing operations, not transfers
as such: an asynchronous copy from page-locked memory is never refused,
and a device→host copy is refused because it waits.

Nothing on the serving path imports ``torch`` from here at import time:
the build sites run in processes that import no torch.
"""

from __future__ import annotations

import threading
import time
from collections import Counter, deque
from contextlib import contextmanager
from typing import Dict, Iterator, Optional, Tuple


class RetraceBudgetExceeded(AssertionError):
    """A build ran more often than its budget, or a dispatch launched
    other kernel counts than its entry point's budget."""


# what the port builds, by build-event name
BUILD_NAMES = ("segment", "libalaz_ingest", "agent_example", "tsan_test")

# the declared steady-state budgets: after warmup, ZERO builds — the
# kernels' library and the native code are built (or found by their
# source hash) once, before serving, and never again
STEADY_STATE_BUDGETS: Dict[str, int] = {name: 0 for name in BUILD_NAMES}

# the open watchers, which every build site and dispatch reports to
_LISTENERS: list = []
_LISTENERS_LOCK = threading.Lock()


class CompileWatcher:
    """Context manager counting the port's builds by name, and recording
    each entry point's dispatches with their kernel launches.

    >>> with CompileWatcher() as w:
    ...     _build.library()
    ...     assert w.count("segment") <= 1

    Nesting is safe: each open watcher hears every event.

    ``on_event``: an optional callback fired per build event —
    ``("compiling", name, None)`` when a build starts (the countable
    event budgets assert on) and ``("finished", name, secs)`` when it
    ends, with its wall duration. A raising callback is swallowed: the
    capture must never take down the building thread.

    Retention: ``events``/``finished``/``dispatches`` are rings of the
    last ``max_events`` entries, so a watcher held open for a service's
    lifetime stays bounded; ``dispatch_total`` counts every dispatch.
    """

    def __init__(self, on_event=None, max_events: int = 4096) -> None:
        # (build name, message), oldest dropped past max_events
        self.events: "deque[Tuple[str, str]]" = deque(maxlen=max_events)
        self.finished: "deque[Tuple[str, float]]" = deque(maxlen=max_events)
        # (entry point, bucket, {kernel: launches})
        self.dispatches: "deque[Tuple[str, Optional[str], dict]]" = deque(maxlen=max_events)
        self.dispatch_total = 0
        self._on_event = on_event

    def _record(self, name: str, msg: str) -> None:
        self.events.append((name, msg))
        if self._on_event is not None:
            try:
                self._on_event("compiling", name, None)
            except Exception:  # noqa: BLE001 - see docstring
                pass

    def _finished(self, name: str, secs: float) -> None:
        self.finished.append((name, secs))
        if self._on_event is not None:
            try:
                self._on_event("finished", name, secs)
            except Exception:  # noqa: BLE001 - see docstring
                pass

    def _dispatched(self, entry: str, bucket: Optional[str], launches: dict) -> None:
        self.dispatches.append((entry, bucket, launches))
        self.dispatch_total += 1

    def __enter__(self) -> "CompileWatcher":
        with _LISTENERS_LOCK:
            if self not in _LISTENERS:
                _LISTENERS.append(self)
        return self

    def __exit__(self, *exc) -> None:
        with _LISTENERS_LOCK:
            if self in _LISTENERS:
                _LISTENERS.remove(self)

    # -- queries -------------------------------------------------------------

    @property
    def counts(self) -> Counter:
        return Counter(name for name, _ in self.events)

    @property
    def total(self) -> int:
        return len(self.events)

    def count(self, name: str) -> int:
        """Builds of one name (exact match)."""
        return self.counts[name]


@contextmanager
def build_event(name: str, what: str) -> Iterator[None]:
    """Report the enclosed build (or cache lookup) of ``name`` to every
    open watcher: ``compiling`` before, ``finished`` with its seconds
    after. A build that raises reports no ``finished``."""
    watchers = tuple(_LISTENERS)
    for w in watchers:
        w._record(name, f"Compiling {name}: {what}")
    t0 = time.perf_counter()
    yield
    secs = time.perf_counter() - t0
    for w in watchers:
        w._finished(name, secs)


def _bucket_of(graph) -> Optional[str]:
    """``n<N_pad>xe<E_pad>`` of a window's arrays, or of each window of a
    stacked group ([W, ...] leading axis)."""
    if not graph or "node_feats" not in graph or "edge_src" not in graph:
        return None
    nf, es = graph["node_feats"], graph["edge_src"]
    if len(nf.shape) == 3:
        return f"n{nf.shape[1]}xe{es.shape[1]}"
    return f"n{nf.shape[0]}xe{es.shape[0]}"


@contextmanager
def dispatch(entry: str, graph: Optional[dict] = None) -> Iterator[None]:
    """Record one dispatch of ``entry`` with the kernel launches made
    inside the block, for every open watcher. Free when none is open."""
    watchers = tuple(_LISTENERS)
    if not watchers:
        yield
        return
    from alaz_tpu_torch.ops.segment_kernels import launch_counts

    before = launch_counts()
    yield
    after = launch_counts()
    launches = {k: after[k] - before[k] for k in after}
    bucket = _bucket_of(graph)
    for w in watchers:
        w._dispatched(entry, bucket, launches)


def _launch_findings(dispatches: list, launches: Dict[str, dict]) -> list:
    found = []
    for i, (entry, bucket, got) in enumerate(dispatches):
        want = launches.get(entry)
        if want is None:
            continue
        kernels = sorted(set(got) | set(want))
        if all(got.get(k, 0) == want.get(k, 0) for k in kernels):
            continue
        detail = ", ".join(
            f"{k} {got.get(k, 0)} launch(es) {'==' if got.get(k, 0) == want.get(k, 0) else '!='} "
            f"budget {want.get(k, 0)}"
            for k in kernels
        )
        found.append(f"{entry} [{bucket}] dispatch {i + 1} of {len(dispatches)}: {detail}")
    return found


@contextmanager
def retrace_budget(
    budgets: Dict[str, int],
    watcher: Optional[CompileWatcher] = None,
    launches: Optional[Dict[str, dict]] = None,
) -> Iterator[CompileWatcher]:
    """Assert build budgets, and launch budgets per dispatch, over a
    ``with`` block.

    ``budgets`` maps build names to the most builds allowed inside the
    block (0 = steady state). ``launches`` maps entry points to the
    kernel launches ONE dispatch must make, by kernel name
    (``segment_kernels.launch_counts()``'s keys; a kernel left out must
    launch 0 times); dispatches of other entry points are not held.
    Pass an already-open ``watcher`` to share one capture; counts are
    measured as a delta either way."""
    own = watcher is None
    w = CompileWatcher() if watcher is None else watcher
    if own:
        w.__enter__()
    base = {name: w.count(name) for name in budgets}
    base_dispatches = w.dispatch_total
    try:
        yield w
    finally:
        if own:
            w.__exit__()
    over = {
        name: (w.count(name) - base[name], limit)
        for name, limit in budgets.items()
        if w.count(name) - base[name] > limit
    }
    findings = [
        f"{name}: {got} build(s) > budget {limit}"
        for name, (got, limit) in sorted(over.items())
    ]
    if launches is not None:
        n_new = min(w.dispatch_total - base_dispatches, len(w.dispatches))
        new = list(w.dispatches)[len(w.dispatches) - n_new:]
        findings += _launch_findings(new, launches)
    if findings:
        raise RetraceBudgetExceeded(
            f"retrace budget exceeded — {'; '.join(findings)}. A steady-state "
            "scorer builds its kernels once, before serving, and every "
            "dispatch of an entry point launches the same kernels; a build "
            "here means a source or flag change mid-run or a library loaded "
            "per call, and other launch counts mean the dispatch took "
            "another path (plain versions, another layout or gather mode)."
        )


@contextmanager
def no_implicit_transfers() -> Iterator[None]:
    """Make synchronizing host↔device operations on the card raise for
    the enclosed block — the steady-state scorer contract: staging is an
    asynchronous copy from page-locked buffers, readback is declared
    (``explicit_transfer``), and anything else silently serializing the
    pipeline raises. The mode is process-wide while the block runs.
    Without a card there is nothing to guard."""
    import torch

    if not torch.cuda.is_available():
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


@contextmanager
def explicit_transfer() -> Iterator[None]:
    """Declare the enclosed host↔device copy (the scorer's readback)
    explicit: an enclosing ``no_implicit_transfers`` lets it through."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.get_sync_debug_mode() == 0:
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("default")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)
