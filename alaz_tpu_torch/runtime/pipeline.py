"""Host→device pipeline: double-buffered window feeding (SURVEY §2.3 P3).

The reference pipelines stages with channels; on the card the analog is
overlapping the host→device copy of window N+1 with the scoring of
window N. ``DevicePrefetcher`` wraps an iterator of GraphBatches. On the
card a staging thread takes each window, fills page-locked host buffers
with its arrays and issues their copy (``non_blocking=True``) on a side
stream, one window ahead of the caller: while the caller computes on
window N, window N+1 is filled and copied, as ``jax.device_put`` runs a
transfer off the caller's thread. The caller's stream waits on the
copy's event before it touches the tensors, and the tensors are recorded
on that stream, so the allocator does not reuse them while it still
reads them. On the CPU the windows' arrays are handed out as tensors in
place, on the caller's thread.

``PinnedSets`` is the page-locked double buffer under the prefetcher,
the train step's feed (``train/trainstep.py``) and the Service's scorer
(``runtime/service.py``, a window or a stacked group at a time): two
sets of buffers take turns for each signature of arrays, and a set is
refilled only after its last copies have finished.
A fill splits the arrays by rows into parts of about equal bytes, one
for each of half the cores the process may use, and copies them with
``np.copyto`` (which lets go of the GIL) on the calling thread and a
small pool of threads the sets keep. On the H100's 8-core host, in the train
loop, 4 threads fill a 1M-edge window's ~103 MB in ~8-11 ms against
~25 ms on one; torch's intra-op ``copy_`` fills it in 2.2 ms alone but
~14-24 ms in the loop, its idle threads spinning on the cores the step's
own threads need.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator

import numpy as np
import torch

from alaz_tpu_torch.device import resolve_device
from alaz_tpu_torch.graph.snapshot import GraphBatch

_DONE = object()


# a dtype numpy lacks (bf16) is copied as the integer type of its size
_SAME_SIZE_INT = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def fill_threads() -> int:
    """The threads a fill copies on, the calling one included: half the
    cores the process may use, at least one."""
    return max(1, len(os.sched_getaffinity(0)) // 2)


def _numpy_view(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    try:
        return t.numpy()
    except TypeError:
        return t.view(_SAME_SIZE_INT[t.element_size()]).numpy()


def split_rows(pairs: list, n: int) -> list:
    """``[(dst, src), ...]``, arrays of one shape each, as at most ``n``
    parts of about equal bytes: part ``j`` holds the rows whose first byte
    lies in the ``j``-th ``n``-th of all the bytes, as ``(dst, src)``
    slices of the first axis, so the parts together cover every row once."""
    total = sum(s.nbytes for _, s in pairs)
    parts: list = [[] for _ in range(n)]
    start = 0  # the bytes of the pairs before this one
    for d, s in pairs:
        if s.ndim == 0:
            parts[start * n // max(total, 1)].append((d, s))
        elif s.nbytes:
            row = s.nbytes // s.shape[0]
            lo = 0
            while lo < s.shape[0]:
                j = (start + lo * row) * n // total
                hi = min(s.shape[0], -(-(total * (j + 1) - start * n) // (n * row)))
                parts[j].append((d[lo:hi], s[lo:hi]))
                lo = hi
        start += s.nbytes
    return [p for p in parts if p]


def _copy_part(part: list) -> None:
    for d, s in part:
        np.copyto(d, s)


class PinnedSets:
    """Page-locked host buffers, ``{name: tensor}``, two sets for each
    signature of the arrays filled (their names, shapes and dtypes): a
    signature's two sets take turns, and ``fill`` waits on the next set's
    last copies (the event handed to ``copied``), then copies the arrays
    in, in parallel. A set's buffers are made at its first fill and kept.
    The threads the fill copies on besides the caller's are made at the
    first fill that splits, and end with the sets. One thread fills;
    ``fills`` counts its fills and ``reuses`` those into a set made
    before. ``pin`` False makes plain host buffers (the CPU)."""

    def __init__(self, pin: bool = True):
        self.pin = pin
        self._sets: list = []  # by slot; a signature's pair at 2k, 2k + 1
        self._copied: list = []  # each set's last copies' event
        self._turn: dict = {}  # signature → the slot it fills next
        self._pool: ThreadPoolExecutor | None = None
        self.fills = self.reuses = 0

    def fill(self, arrays: dict) -> tuple:
        """``arrays`` (numpy arrays or CPU tensors; for a name, a list of
        W of one shape is stacked as ``[W, ...]``) into the next set of
        their signature → ``(slot, {name: buffer})``; the arrays are not
        read after this returns."""
        srcs, sig = [], []
        for k, a in arrays.items():
            stacked = isinstance(a, list)
            parts = [torch.as_tensor(x) for x in a] if stacked else [torch.as_tensor(a)]
            srcs.append((parts, stacked))
            sig.append((k, (len(a), *parts[0].shape) if stacked else tuple(parts[0].shape), parts[0].dtype))
        sig = tuple(sig)
        slot = self._turn.get(sig)
        if slot is None:
            slot = len(self._sets)
            self._sets += [None, None]
            self._copied += [None, None]
        self._turn[sig] = slot ^ 1
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()  # its last copies have landed
            self._copied[slot] = None
        self.fills += 1
        bufs = self._sets[slot]
        if bufs is None:
            bufs = self._sets[slot] = {
                k: torch.empty(shape, dtype=dtype, pin_memory=self.pin) for k, shape, dtype in sig
            }
        else:
            self.reuses += 1
        pairs = []
        for (k, _, _), (parts, stacked) in zip(sig, srcs):
            dst = _numpy_view(bufs[k])
            # a stacked name's windows: one more (dst, src) pair each
            dsts = [dst[w, ...] for w in range(len(parts))] if stacked else [dst]
            pairs += [(d, _numpy_view(x)) for d, x in zip(dsts, parts)]
        n = fill_threads()
        first, *rest = split_rows(pairs, n) or [[]]
        if rest and self._pool is None:
            self._pool = ThreadPoolExecutor(n - 1, thread_name_prefix="alaz-fill")
        running = [self._pool.submit(_copy_part, part) for part in rest]
        _copy_part(first)
        for r in running:
            r.result()
        return slot, bufs

    def copied(self, slot: int, event) -> None:
        """``event`` completes once set ``slot``'s copies have read it."""
        self._copied[slot] = event


class DevicePrefetcher:
    """Yields ``(batch, tensors)``: each window with its
    ``device_arrays()`` on ``device`` (default ``cuda``; with no card that
    raises)."""

    def __init__(self, batches: Iterable[GraphBatch], device="cuda"):
        self._it = iter(batches)
        self.device = resolve_device(device)
        self._on_card = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._on_card else None
        self._sets = PinnedSets()  # the staging thread's alone
        self.copies = 0  # windows copied to the card

    def _stage(self, batch: GraphBatch) -> tuple:
        """Fill a page-locked set with the window's arrays and issue its
        copy on the side stream; returns (batch, tensors, copy event)."""
        slot, bufs = self._sets.fill(batch.device_arrays())
        with torch.cuda.stream(self._stream):
            tensors = {k: b.to(self.device, non_blocking=True) for k, b in bufs.items()}
            done = torch.cuda.Event()
            done.record(self._stream)
        self._sets.copied(slot, done)
        self.copies += 1
        return batch, tensors, done

    def _stager(self, out: "queue.Queue", stop: threading.Event) -> None:
        try:
            with torch.cuda.device(self.device):
                for batch in self._it:
                    staged = self._stage(batch)
                    while not stop.is_set():
                        try:
                            out.put(staged, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            out.put(_DONE)
        except BaseException as exc:  # handed to the caller, raised there
            out.put(exc)

    def __iter__(self) -> Iterator[tuple]:
        if not self._on_card:
            for batch in self._it:
                yield batch, {k: torch.from_numpy(v) for k, v in batch.device_arrays().items()}
            return
        # one staged window waits in the queue while the next is filled
        staged: "queue.Queue" = queue.Queue(maxsize=1)
        stop = threading.Event()
        stager = threading.Thread(target=self._stager, args=(staged, stop), name="alaz-prefetch", daemon=True)
        stager.start()
        consumer = torch.cuda.current_stream(self.device)
        try:
            while True:
                item = staged.get()
                if item is _DONE:
                    return
                if isinstance(item, BaseException):
                    raise item
                batch, tensors, done = item
                consumer.wait_event(done)
                for t in tensors.values():
                    t.record_stream(consumer)
                yield batch, tensors
        finally:
            stop.set()
            while stager.is_alive():
                try:
                    staged.get(timeout=0.1)
                except queue.Empty:
                    pass
            stager.join()
