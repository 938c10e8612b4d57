"""The EventSource seam (the ebpf.EbpfCollector interface analog,
collector.go:40-64): a source owns its production loop and feeds a
Service's submit_* surface."""

from __future__ import annotations

from typing import Protocol, runtime_checkable


@runtime_checkable
class EventSource(Protocol):
    def start(self, service) -> None:  # Service or anything with submit_*
        ...

    def stop(self) -> None:
        ...
