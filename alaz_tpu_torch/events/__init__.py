"""Columnar event schemas and string interning.

The reference's ebpf consumers (ebpf/l7_req/l7.go, ebpf/tcp_state/tcp.go,
ebpf/proc/proc.go) turn perf-ring samples into one Go struct per event and
push them down channels one at a time. Here the unit of flow is a **batch**:
a numpy structured array of a fixed dtype per event kind. That choice is the
whole performance story of the host data plane — every downstream stage
(protocol parse, socket join, k8s attribution, graph batching) is a
vectorized operation over these arrays, and the device handoff is a view,
not a million tiny objects.
"""

from alaz_tpu_torch.events.schema import (
    L7_EVENT_DTYPE,
    TCP_EVENT_DTYPE,
    PROC_EVENT_DTYPE,
    L7Protocol,
    HttpMethod,
    Http2Method,
    AmqpMethod,
    PostgresMethod,
    RedisMethod,
    KafkaMethod,
    MySqlMethod,
    MongoMethod,
    TcpEventType,
    ProcEventType,
    MAX_PAYLOAD_SIZE,
    make_l7_events,
    make_tcp_events,
    make_proc_events,
    method_to_string,
)
from alaz_tpu_torch.events.intern import Interner
from alaz_tpu_torch.events.net import ip_to_u32, u32_to_ip, ips_to_u32
from alaz_tpu_torch.events.k8s import (
    EventType,
    ResourceType,
    K8sResourceMessage,
    Pod,
    Service,
    ReplicaSet,
    Deployment,
    DaemonSet,
    StatefulSet,
    Endpoints,
    Container,
)

__all__ = [
    "L7_EVENT_DTYPE",
    "TCP_EVENT_DTYPE",
    "PROC_EVENT_DTYPE",
    "L7Protocol",
    "HttpMethod",
    "Http2Method",
    "AmqpMethod",
    "PostgresMethod",
    "RedisMethod",
    "KafkaMethod",
    "MySqlMethod",
    "MongoMethod",
    "TcpEventType",
    "ProcEventType",
    "MAX_PAYLOAD_SIZE",
    "make_l7_events",
    "make_tcp_events",
    "make_proc_events",
    "method_to_string",
    "Interner",
    "ip_to_u32",
    "u32_to_ip",
    "ips_to_u32",
    "EventType",
    "ResourceType",
    "K8sResourceMessage",
    "Pod",
    "Service",
    "ReplicaSet",
    "Deployment",
    "DaemonSet",
    "StatefulSet",
    "Endpoints",
    "Container",
]
