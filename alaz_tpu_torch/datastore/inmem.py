"""In-memory datastore — the MockDataStore analog
(main_benchmark_test.go:639-678): counts everything, optionally retains
batches for assertions, and is the CPU-reference sink for replay configs.
"""

from __future__ import annotations

import threading
from typing import Any, List

import numpy as np

from alaz_tpu_torch.datastore.interface import BaseDataStore
from alaz_tpu_torch.events.k8s import EventType, ResourceType


class InMemDataStore(BaseDataStore):
    def __init__(self, retain: bool = False):
        self.retain = retain
        self.request_count = 0
        self.kafka_count = 0
        self.alive_count = 0
        self.resource_counts: dict[str, int] = {}
        self.request_batches: List[np.ndarray] = []
        self.kafka_batches: List[np.ndarray] = []
        self.alive_batches: List[np.ndarray] = []
        self.resources: List[tuple[ResourceType, EventType, Any]] = []
        self._lock = threading.Lock()

    def persist_requests(self, batch: np.ndarray) -> None:
        with self._lock:
            self.request_count += batch.shape[0]
            if self.retain:
                self.request_batches.append(batch.copy())

    def persist_kafka_events(self, batch: np.ndarray) -> None:
        with self._lock:
            self.kafka_count += batch.shape[0]
            if self.retain:
                self.kafka_batches.append(batch.copy())

    def persist_alive_connections(self, batch: np.ndarray) -> None:
        with self._lock:
            self.alive_count += batch.shape[0]
            if self.retain:
                self.alive_batches.append(batch.copy())

    def persist_resource(self, rtype: ResourceType, event: EventType, obj: Any) -> None:
        with self._lock:
            key = rtype.value
            self.resource_counts[key] = self.resource_counts.get(key, 0) + 1
            if self.retain:
                self.resources.append((rtype, event, obj))

    def all_requests(self) -> np.ndarray:
        with self._lock:
            if not self.request_batches:
                from alaz_tpu_torch.datastore.dto import REQUEST_DTYPE

                return np.zeros(0, dtype=REQUEST_DTYPE)
            return np.concatenate(self.request_batches)
