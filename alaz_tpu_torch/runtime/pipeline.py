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
reads them. Two sets of page-locked buffers take turns; a set is refilled
only after its last copy has finished. On the CPU the windows' arrays
are handed out as tensors in place, on the caller's thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

from alaz_tpu_torch.device import resolve_device
from alaz_tpu_torch.graph.snapshot import GraphBatch

_DONE = object()


class DevicePrefetcher:
    """Yields ``(batch, tensors)``: each window with its
    ``device_arrays()`` on ``device`` (default ``cuda``; with no card that
    raises)."""

    def __init__(self, batches: Iterable[GraphBatch], device="cuda"):
        self._it = iter(batches)
        self.device = resolve_device(device)
        self._on_card = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._on_card else None
        # two sets of page-locked buffers, {name: tensor}, and the event of
        # each set's last copy (the staging thread's alone)
        self._pinned: list = [{}, {}]
        self._copied: list = [None, None]
        self._turn = 0
        self.copies = 0  # windows copied to the card

    def _fill(self, arrays: dict) -> tuple:
        slot = self._turn
        self._turn ^= 1
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()  # its last copy has landed
        bufs = self._pinned[slot]
        for k, a in arrays.items():
            buf = bufs.get(k)
            want = torch.from_numpy(np.empty(0, a.dtype)).dtype
            if buf is None or tuple(buf.shape) != a.shape or buf.dtype != want:
                bufs[k] = buf = torch.empty(a.shape, dtype=want, pin_memory=True)
            np.copyto(buf.numpy(), a)
        return slot, bufs

    def _stage(self, batch: GraphBatch) -> tuple:
        """Fill a page-locked set with the window's arrays and issue its
        copy on the side stream; returns (batch, tensors, copy event)."""
        slot, bufs = self._fill(batch.device_arrays())
        with torch.cuda.stream(self._stream):
            tensors = {k: b.to(self.device, non_blocking=True) for k, b in bufs.items()}
            done = torch.cuda.Event()
            done.record(self._stream)
        self._copied[slot] = done
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
