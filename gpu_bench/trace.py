"""The device trace of a measured window: ``torch.profiler`` (CUPTI on the
card) around it, reduced to the device's busy time, each kernel's device
time and the longest idle gaps with what the host was doing in them.

The window is marked by a user annotation, so the device's activity is
clipped to it on the profiler's own clock.
"""

from __future__ import annotations

import contextlib
import re
import sys
from dataclasses import dataclass, field

MARK = "gpu_bench.window"


@dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    # device activity clipped to the window: (name, start_ns, end_ns)
    device: list = field(default_factory=list)
    # host operations in the window: (name, start_ns, end_ns, thread)
    host: list = field(default_factory=list)
    span_ns: tuple = (0, 0)  # the window on the profiler's clock

    def kernel_time(self, patterns) -> tuple:
        """(launches, device seconds) of the kernels whose name matches any
        of ``patterns`` (regular expressions, searched)."""
        rx = re.compile("|".join(f"(?:{p})" for p in patterns))
        n, ns = 0, 0
        for name, s, e in self.device:
            if rx.search(name):
                n += 1
                ns += e - s
        return n, ns * 1e-9

    def top_ops(self, k: int = 10) -> list:
        by: dict = {}
        for name, s, e in self.device:
            key = name[:120]
            by[key] = by.get(key, 0) + (e - s)
        return [[n, t * 1e-9] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """The ``k`` longest stretches of the window with nothing on the
        device, each named by the longest host operation that overlaps it
        (or none recorded)."""
        w0, w1 = self.span_ns
        iv = [[w0, w0]] + _union([(s, e) for _, s, e in self.device]) + [[w1, w1]]
        gaps = [(iv[i][1], iv[i + 1][0]) for i in range(len(iv) - 1) if iv[i + 1][0] > iv[i][1]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        hosts = sorted(self.host, key=lambda h: h[1])
        for gs, ge in gaps[:k]:
            best, best_len = "no host op recorded", 0
            for name, hs, he, tid in hosts:
                if hs >= ge:
                    break
                ov = min(he, ge) - max(hs, gs)
                if ov > best_len:
                    best, best_len = f"{name[:80]} (thread {tid})", ov
            out.append([best, (ge - gs) * 1e-9])
        return out


def _union(intervals) -> list:
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


@contextlib.contextmanager
def traced(enabled: bool, sink: dict):
    """Profile the body when ``enabled`` and put its ``DeviceTrace`` in
    ``sink["trace"]`` on exit."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(MARK):
            yield
    sink["trace"] = reduce(prof.profiler.kineto_results.events())


@contextlib.contextmanager
def device_busy(enabled: bool, sink: dict):
    """Record the card's activity alone (CUPTI; no host operation is
    recorded) around the body, and put the seconds in which a kernel, copy
    or set ran on it in ``sink["busy_s"]`` on exit: what an untraced run
    reads of the device. The profiler starts before the body and
    synchronises the card on leaving it."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield
    busy = busy_seconds(prof.profiler.kineto_results.events())
    if busy is not None:
        sink["busy_s"] = busy


def busy_seconds(events):
    """The seconds covered by the union of the device's activities in
    ``events``; None where the device recorded none (no reading, never 0)."""
    iv = [(ev.start_ns(), ev.start_ns() + ev.duration_ns()) for ev in events
          if not str(ev.device_type()).endswith("CPU") and ev.name() != MARK]
    return sum(e - s for s, e in _union(iv)) * 1e-9 if iv else None


def reduce(events) -> DeviceTrace:
    w0 = w1 = None
    device, host = [], []
    for ev in events:
        name = ev.name()
        s = ev.start_ns()
        e = s + ev.duration_ns()
        on_host = str(ev.device_type()).endswith("CPU")
        if name == MARK:  # the window; its copy on the device timeline is no work
            if on_host:
                w0, w1 = s, e
            continue
        if on_host:
            host.append((name, s, e, ev.start_thread_id()))
        else:
            device.append((name, s, e))
    if w0 is None:
        raise RuntimeError("the trace holds no window mark")
    device = [(n, max(s, w0), min(e, w1)) for n, s, e in device if e > w0 and s < w1]
    host = [h for h in host if h[2] > w0 and h[1] < w1]
    busy = sum(e - s for s, e in _union([(s, e) for _, s, e in device]))
    return DeviceTrace(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9, device=device, host=host, span_ns=(w0, w1))


def idle_pct(run: dict):
    """The share of the traced window with no kernel, copy or set on the
    card, in %; nothing without a trace."""
    tr = run.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def roofline(run: dict, name: str, patterns, work_patterns, bytes_per_work: float):
    """A kernel operation's share of its bound, in %: ``bytes_per_work``
    for each launch matching ``work_patterns`` (one a unit of the
    operation's work), over the HBM rate, against the device time of every
    launch matching ``patterns``. Nothing without a trace or a launch."""
    from gpu_bench import yardstick

    tr = run.get("trace")
    if tr is None:
        return None
    _, secs = tr.kernel_time(patterns)
    units, _ = tr.kernel_time(work_patterns)
    if units == 0 or secs <= 0:
        print(f"gpu_bench: {name}: no launch matches {tuple(work_patterns)}", file=sys.stderr)
        return None
    return yardstick.roofline_pct(bytes_per_work * units, 0.0, secs)
