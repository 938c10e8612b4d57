"""The DataStore plugin seam — datastore/datastore.go:3-21 analog.

The reference's interface has one Persist method per resource kind plus
PersistRequest / PersistKafkaEvent / PersistAliveConnection. Here the event
side is columnar (batches of structured rows) and the resource side is a
single generic ``persist_resource`` plus named convenience wrappers, so a
sink implements 4 methods instead of 11. The TPU GNN scorer and the
batching export backend both implement exactly this.
"""

from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

import numpy as np

from alaz_tpu_torch.events.k8s import EventType, ResourceType


@runtime_checkable
class DataStore(Protocol):
    def persist_requests(self, batch: np.ndarray) -> None:
        """REQUEST_DTYPE rows (PersistRequest analog, batched)."""
        ...

    def persist_kafka_events(self, batch: np.ndarray) -> None:
        """KAFKA_EVENT_DTYPE rows (PersistKafkaEvent analog)."""
        ...

    def persist_alive_connections(self, batch: np.ndarray) -> None:
        """ALIVE_CONNECTION_DTYPE rows (PersistAliveConnection analog)."""
        ...

    def persist_resource(self, rtype: ResourceType, event: EventType, obj: Any) -> None:
        """K8s resource DTO (PersistPod/Service/... analog)."""
        ...


class BaseDataStore:
    """No-op base with the named per-resource wrappers the reference's
    interface spells out (PersistPod, PersistService, ...)."""

    def persist_requests(self, batch: np.ndarray) -> None:  # pragma: no cover
        pass

    def persist_kafka_events(self, batch: np.ndarray) -> None:  # pragma: no cover
        pass

    def persist_alive_connections(self, batch: np.ndarray) -> None:  # pragma: no cover
        pass

    def persist_resource(self, rtype: ResourceType, event: EventType, obj: Any) -> None:
        pass

    # named wrappers (datastore.go:4-14 surface)
    def persist_pod(self, pod, event: EventType) -> None:
        self.persist_resource(ResourceType.POD, event, pod)

    def persist_service(self, svc, event: EventType) -> None:
        self.persist_resource(ResourceType.SERVICE, event, svc)

    def persist_replicaset(self, rs, event: EventType) -> None:
        self.persist_resource(ResourceType.REPLICASET, event, rs)

    def persist_deployment(self, dep, event: EventType) -> None:
        self.persist_resource(ResourceType.DEPLOYMENT, event, dep)

    def persist_endpoints(self, ep, event: EventType) -> None:
        self.persist_resource(ResourceType.ENDPOINTS, event, ep)

    def persist_container(self, c, event: EventType) -> None:
        self.persist_resource(ResourceType.CONTAINER, event, c)

    def persist_daemonset(self, d, event: EventType) -> None:
        self.persist_resource(ResourceType.DAEMONSET, event, d)

    def persist_statefulset(self, s, event: EventType) -> None:
        self.persist_resource(ResourceType.STATEFULSET, event, s)
