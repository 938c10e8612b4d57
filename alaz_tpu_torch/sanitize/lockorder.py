"""Lock-order sanitizer: instrumented threading primitives + a global
lock-order graph.

``instrument()`` patches ``threading.Lock`` / ``RLock`` / ``Condition``
so every primitive *constructed inside the context* is wrapped. Each
wrapper reports acquisitions to a :class:`LockOrderMonitor`, which keeps
a per-thread held stack and a global directed graph: an edge A→B means
"some thread acquired B while holding A", recorded with the acquiring
thread's stack. A cycle in that graph is a potential deadlock even if no
run has deadlocked yet — two threads walking the two orders concurrently
is all it takes. Cycles are detected eagerly at edge-insert time (into
``monitor.violations`` — raising inside an arbitrary worker thread would
be swallowed) and on demand via ``cycles()`` / ``assert_acyclic()``.

Nodes are per *instance* (two different ``BatchQueue`` locks are
distinct nodes — ordering two queue locks both ways is a real deadlock
that a per-class graph would miss), labeled by their construction site.
Re-entrant re-acquisition (RLock, condition re-entry) adds no self
edges. ``Condition.wait`` releases and re-acquires the underlying lock,
and the bookkeeping follows it.

Scope: a test/bench-time sanitizer. The wrappers add a dict update per
acquisition — fine under stress tests, not meant for the serving path.
"""

from __future__ import annotations

import threading
import traceback
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Set, Tuple

_SELF_FILE = __file__


class LockOrderViolation(RuntimeError):
    """A cycle exists in the observed lock-order graph."""


@dataclass
class OrderEdge:
    """First observation of "held ``src`` while acquiring ``dst``"."""

    src: str
    dst: str
    thread: str
    stack: str
    count: int = 1


def _acquisition_site(skip_threading: bool = True) -> str:
    """file:lineno of the outermost caller frame that isn't sanitizer or
    threading machinery — the label a human can map back to code."""
    for frame in reversed(traceback.extract_stack()):
        fn = frame.filename
        if fn == _SELF_FILE or (skip_threading and fn.endswith("threading.py")):
            continue
        return f"{fn}:{frame.lineno}"
    return "<unknown>"


def _acquisition_stack(limit: int = 12) -> str:
    frames = [
        f
        for f in traceback.extract_stack()
        if f.filename != _SELF_FILE and not f.filename.endswith("threading.py")
    ]
    return "".join(traceback.StackSummary.from_list(frames[-limit:]).format())


class LockOrderMonitor:
    """Global lock-order graph + per-thread held stacks."""

    def __init__(self) -> None:
        # the monitor's own lock is a REAL primitive created before any
        # patching, and is only ever held for dict updates — it can never
        # be held while acquiring a tracked lock, so it adds no edges and
        # no deadlock surface of its own
        self._meta = threading.Lock()
        self._held = threading.local()
        self._next_id = 0
        self.labels: Dict[int, str] = {}  # guarded-by: self._meta
        self.edges: Dict[Tuple[int, int], OrderEdge] = {}  # guarded-by: self._meta
        self.adj: Dict[int, Set[int]] = {}  # guarded-by: self._meta
        self.violations: List[str] = []  # guarded-by: self._meta
        self.acquisitions = 0  # guarded-by: self._meta

    # -- registration / bookkeeping ----------------------------------------

    def register(self, label: str) -> int:
        with self._meta:
            nid = self._next_id
            self._next_id += 1
            self.labels[nid] = label
            self.adj.setdefault(nid, set())
            return nid

    def _stack_of_thread(self) -> List[int]:
        stack = getattr(self._held, "stack", None)
        if stack is None:
            stack = []
            self._held.stack = stack
        return stack

    def on_acquired(self, nid: int) -> None:
        held = self._stack_of_thread()
        if nid not in held and held:
            self._record_edges(held, nid)
        with self._meta:
            self.acquisitions += 1
        held.append(nid)

    def on_released(self, nid: int) -> None:
        held = self._stack_of_thread()
        # remove the LAST occurrence: re-entrant holds release inner-first
        for i in range(len(held) - 1, -1, -1):
            if held[i] == nid:
                del held[i]
                return

    def _record_edges(self, held: List[int], nid: int) -> None:
        tname = threading.current_thread().name
        stack: Optional[str] = None
        with self._meta:
            for h in dict.fromkeys(held):  # de-dup, preserve order
                key = (h, nid)
                edge = self.edges.get(key)
                if edge is not None:
                    edge.count += 1
                    continue
                if stack is None:
                    stack = _acquisition_stack()
                self.edges[key] = OrderEdge(
                    self.labels[h], self.labels[nid], tname, stack
                )
                self.adj.setdefault(h, set()).add(nid)
                self.adj.setdefault(nid, set())
                # eager cycle check: does nid already reach h?
                if self._reaches(nid, h):
                    self.violations.append(
                        f"lock-order cycle closed by {tname}: "
                        f"{self.labels[h]} -> {self.labels[nid]} while a "
                        f"path {self.labels[nid]} -> ... -> {self.labels[h]} "
                        f"already exists; acquisition stack:\n{stack}"
                    )

    def _reaches(self, src: int, dst: int) -> bool:
        # callers hold self._meta
        seen = {src}
        frontier = [src]
        while frontier:
            n = frontier.pop()
            if n == dst:
                return True
            for m in self.adj.get(n, ()):  # alazlint: disable=ALZ010 -- _reaches is only called from _record_edges, which holds self._meta
                if m not in seen:
                    seen.add(m)
                    frontier.append(m)
        return False

    # -- reporting ----------------------------------------------------------

    def cycles(self) -> List[List[str]]:
        """Strongly connected components of size ≥ 2, as label lists."""
        with self._meta:
            adj = {n: set(ms) for n, ms in self.adj.items()}
            labels = dict(self.labels)
        sccs: List[List[str]] = []
        index: Dict[int, int] = {}
        low: Dict[int, int] = {}
        on_stack: Set[int] = set()
        stack: List[int] = []
        counter = [0]

        def connect(root: int) -> None:
            work = [(root, iter(sorted(adj.get(root, ()))))]
            index[root] = low[root] = counter[0]
            counter[0] += 1
            stack.append(root)
            on_stack.add(root)
            while work:
                node, it = work[-1]
                advanced = False
                for w in it:
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        on_stack.add(w)
                        work.append((w, iter(sorted(adj.get(w, ())))))
                        advanced = True
                        break
                    elif w in on_stack:
                        low[node] = min(low[node], index[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    low[work[-1][0]] = min(low[work[-1][0]], low[node])
                if low[node] == index[node]:
                    comp = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        comp.append(w)
                        if w == node:
                            break
                    if len(comp) > 1:
                        sccs.append([labels[w] for w in sorted(comp)])

        for n in sorted(adj):
            if n not in index:
                connect(n)
        return sccs

    def graph_summary(self) -> Dict[str, int]:
        with self._meta:
            return {
                "locks": len(self.labels),
                "edges": len(self.edges),
                "acquisitions": self.acquisitions,
            }

    def assert_acyclic(self) -> None:
        cycles = self.cycles()
        with self._meta:
            violations = list(self.violations)
        if cycles or violations:
            detail = "\n".join(
                [f"cycle: {' <-> '.join(c)}" for c in cycles] + violations
            )
            raise LockOrderViolation(
                f"lock-order graph has {len(cycles)} cycle(s):\n{detail}"
            )


# ---------------------------------------------------------------------------
# Instrumented primitives
# ---------------------------------------------------------------------------


class TrackedLock:
    """Wraps a real Lock/RLock; reports acquisitions to the monitor."""

    def __init__(self, monitor: LockOrderMonitor, inner, label: str):
        self._monitor = monitor
        self._inner = inner
        self._nid = monitor.register(label)
        self.label = label

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._monitor.on_acquired(self._nid)
        return got

    def release(self) -> None:
        self._inner.release()
        self._monitor.on_released(self._nid)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<TrackedLock {self.label} inner={self._inner!r}>"


class TrackedCondition:
    """Condition over a TrackedLock. The REAL ``threading.Condition``
    runs against the real inner lock (so wait/notify semantics are
    untouched); this wrapper only mirrors the acquire/release bookkeeping
    — including the release-and-reacquire inside ``wait``."""

    def __init__(self, monitor: LockOrderMonitor, lockw: TrackedLock):
        self._monitor = monitor
        self._lockw = lockw
        self._cond = threading.Condition(lockw._inner)

    # context manager / lock surface ----------------------------------------

    def acquire(self, *a, **kw) -> bool:
        return self._lockw.acquire(*a, **kw)

    def release(self) -> None:
        self._lockw.release()

    def __enter__(self) -> "TrackedCondition":
        self._lockw.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self._lockw.release()

    # condition surface ------------------------------------------------------

    def wait(self, timeout: Optional[float] = None) -> bool:
        self._monitor.on_released(self._lockw._nid)
        try:
            return self._cond.wait(timeout)  # alazlint: disable=ALZ013 -- delegation shim: the CALLER owns the predicate loop (wait_for below, and every instrumented call site keeps its own while)
        finally:
            # re-acquired: re-record (edges from still-held outer locks
            # re-apply — waiting with another lock held is itself an order)
            self._monitor.on_acquired(self._lockw._nid)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        # reimplemented over self.wait so the bookkeeping sees every
        # release/reacquire (threading's wait_for would bypass ours)
        import time as _time

        end = None if timeout is None else _time.monotonic() + timeout
        result = predicate()
        while not result:
            remaining = None if end is None else end - _time.monotonic()
            if remaining is not None and remaining <= 0:
                break
            self.wait(remaining)
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()


# ---------------------------------------------------------------------------
# Patch-in installation
# ---------------------------------------------------------------------------


@contextmanager
def instrument() -> Iterator[LockOrderMonitor]:
    """Patch ``threading.Lock/RLock/Condition`` so every primitive
    constructed inside the context is tracked. Locks constructed BEFORE
    entry stay untracked (their acquisitions are invisible, not broken).
    Restores the real factories on exit; tracked locks created inside
    keep working (and keep recording) afterwards."""
    monitor = LockOrderMonitor()
    real_lock = threading.Lock
    real_rlock = threading.RLock
    real_condition = threading.Condition

    def make_lock():
        return TrackedLock(monitor, real_lock(), _acquisition_site())

    def make_rlock():
        return TrackedLock(monitor, real_rlock(), _acquisition_site())

    def make_condition(lock=None):
        if isinstance(lock, TrackedLock):
            return TrackedCondition(monitor, lock)
        if isinstance(lock, TrackedCondition):  # pragma: no cover - odd but legal
            return TrackedCondition(monitor, lock._lockw)
        if lock is None:
            return TrackedCondition(monitor, make_rlock())
        # unknown foreign lock type: leave untracked rather than guess
        return real_condition(lock)

    threading.Lock = make_lock  # type: ignore[assignment]
    threading.RLock = make_rlock  # type: ignore[assignment]
    threading.Condition = make_condition  # type: ignore[assignment]
    try:
        yield monitor
    finally:
        threading.Lock = real_lock  # type: ignore[assignment]
        threading.RLock = real_rlock  # type: ignore[assignment]
        threading.Condition = real_condition  # type: ignore[assignment]
