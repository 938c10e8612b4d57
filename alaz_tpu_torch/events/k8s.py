"""Kubernetes resource messages — the k8s/informer.go analog.

The reference's informers emit ``K8sResourceMessage{ResourceType, EventType,
Object}`` (k8s/informer.go:236-240) for 7 resource kinds, with pods fanned
out into per-container CONTAINER messages (k8s/pod.go:48-87). K8s metadata
is low-rate control plane, so unlike the data plane these stay as plain
Python dataclasses; the aggregator folds them into integer lookup tables.

Field sets mirror datastore/dto.go:3-94.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, List, Tuple


class EventType(str, enum.Enum):
    ADD = "Add"
    UPDATE = "Update"
    DELETE = "Delete"


class ResourceType(str, enum.Enum):
    POD = "Pod"
    SERVICE = "Service"
    REPLICASET = "ReplicaSet"
    DEPLOYMENT = "Deployment"
    ENDPOINTS = "Endpoints"
    CONTAINER = "Container"
    DAEMONSET = "DaemonSet"
    STATEFULSET = "StatefulSet"


@dataclass
class Pod:
    uid: str
    name: str = ""
    namespace: str = ""
    image: str = ""  # main container image
    ip: str = ""
    owner_type: str = ""  # "ReplicaSet" or ""
    owner_id: str = ""
    owner_name: str = ""


@dataclass
class Service:
    uid: str
    name: str = ""
    namespace: str = ""
    type: str = ""
    cluster_ip: str = ""
    cluster_ips: List[str] = field(default_factory=list)
    # (name, src, dest, protocol) — dto.go:21-26
    ports: List[Tuple[str, int, int, str]] = field(default_factory=list)


@dataclass
class ReplicaSet:
    uid: str
    name: str = ""
    namespace: str = ""
    owner_type: str = ""
    owner_id: str = ""
    owner_name: str = ""
    replicas: int = 0


@dataclass
class Deployment:
    uid: str
    name: str = ""
    namespace: str = ""
    replicas: int = 0


@dataclass
class DaemonSet:
    uid: str
    name: str = ""
    namespace: str = ""


@dataclass
class StatefulSet:
    uid: str
    name: str = ""
    namespace: str = ""


@dataclass
class AddressIP:
    type: str = ""  # "pod" or "external"
    id: str = ""
    name: str = ""
    namespace: str = ""
    ip: str = ""


@dataclass
class AddressPort:
    port: int = 0
    protocol: str = "TCP"
    name: str = ""


@dataclass
class Address:
    ips: List[AddressIP] = field(default_factory=list)
    ports: List[AddressPort] = field(default_factory=list)


@dataclass
class Endpoints:
    uid: str
    name: str = ""
    namespace: str = ""
    addresses: List[Address] = field(default_factory=list)


@dataclass
class Container:
    name: str
    namespace: str = ""
    pod_uid: str = ""
    image: str = ""
    ports: List[Tuple[int, str]] = field(default_factory=list)


@dataclass
class K8sResourceMessage:
    resource_type: ResourceType
    event_type: EventType
    object: Any
