"""Columnar DTOs — the datastore/dto.go analog.

The reference's ``Request`` (dto.go:177-198), ``KafkaEvent`` (122-142) and
``AliveConnection`` (96-106) become structured-array rows; strings (UIDs,
methods, paths, topics) are interned int32 ids resolved against the
pipeline's shared :class:`~alaz_tpu.events.intern.Interner` at export time.

``EdgeBatch`` wraps a REQUEST_DTYPE array — it is both the unit the
datastore sinks consume and the raw material of graph batching.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

from alaz_tpu_torch.events.intern import Interner
from alaz_tpu_torch.events.net import u32_to_ip
from alaz_tpu_torch.events.schema import L7Protocol, method_to_string

# From/To endpoint types (dto.go FromType/ToType ∈ pod|service|outbound)
EP_NONE = 0
EP_POD = 1
EP_SERVICE = 2
EP_OUTBOUND = 3

_EP_NAMES = ["", "pod", "service", "outbound"]

REQUEST_DTYPE = np.dtype(
    [
        ("start_time_ms", np.int64),
        ("latency_ns", np.uint64),
        ("from_ip", np.uint32),
        ("from_type", np.uint8),  # EP_*
        ("from_uid", np.int32),  # interned
        ("from_port", np.uint16),
        ("to_ip", np.uint32),
        ("to_type", np.uint8),
        ("to_uid", np.int32),
        ("to_port", np.uint16),
        ("protocol", np.uint8),  # L7Protocol
        ("tls", np.bool_),
        ("completed", np.bool_),
        ("status_code", np.uint32),
        ("fail_reason", np.int32),  # interned
        ("method", np.uint8),  # per-protocol method enum
        ("path", np.int32),  # interned
    ]
)

KAFKA_EVENT_DTYPE = np.dtype(
    [
        ("start_time_ms", np.int64),
        ("latency_ns", np.uint64),
        ("from_ip", np.uint32),
        ("from_type", np.uint8),
        ("from_uid", np.int32),
        ("from_port", np.uint16),
        ("to_ip", np.uint32),
        ("to_type", np.uint8),
        ("to_uid", np.int32),
        ("to_port", np.uint16),
        ("topic", np.int32),  # interned
        ("partition", np.uint32),
        ("key", np.int32),  # interned
        ("value", np.int32),  # interned
        ("type", np.uint8),  # 1=PUBLISH 2=CONSUME
        ("tls", np.bool_),
    ]
)

KAFKA_PUBLISH = 1
KAFKA_CONSUME = 2

ALIVE_CONNECTION_DTYPE = np.dtype(
    [
        ("check_time_ms", np.int64),
        ("from_ip", np.uint32),
        ("from_type", np.uint8),
        ("from_uid", np.int32),
        ("from_port", np.uint16),
        ("to_ip", np.uint32),
        ("to_type", np.uint8),
        ("to_uid", np.int32),
        ("to_port", np.uint16),
    ]
)


def make_requests(n: int) -> np.ndarray:
    return np.zeros(n, dtype=REQUEST_DTYPE)


def reverse_direction(rows: np.ndarray, mask: np.ndarray | None = None) -> None:
    """In-place from/to swap for consume-side events (dto.go:226-231,
    ReverseDirection; applied for AMQP DELIVER / Redis PUSHED_EVENT,
    data.go:1110-1112,1151-1153)."""
    idx = slice(None) if mask is None else mask
    for a, b in (
        ("from_ip", "to_ip"),
        ("from_port", "to_port"),
        ("from_uid", "to_uid"),
        ("from_type", "to_type"),
    ):
        tmp = rows[a][idx].copy()
        rows[a][idx] = rows[b][idx]
        rows[b][idx] = tmp


@dataclass
class RequestView:
    """Scalar, string-resolved view of one REQUEST_DTYPE row — the shape the
    reference's ``datastore.Request`` has. For tests/exports, not hot paths."""

    start_time_ms: int
    latency_ns: int
    from_ip: str
    from_type: str
    from_uid: str
    from_port: int
    to_ip: str
    to_type: str
    to_uid: str
    to_port: int
    protocol: str
    tls: bool
    completed: bool
    status_code: int
    fail_reason: str
    method: str
    path: str


def iter_request_views(rows: np.ndarray, interner: Interner) -> Iterator[RequestView]:
    for r in rows:
        yield RequestView(
            start_time_ms=int(r["start_time_ms"]),
            latency_ns=int(r["latency_ns"]),
            from_ip=u32_to_ip(r["from_ip"]) if r["from_ip"] else "",
            from_type=_EP_NAMES[r["from_type"]],
            from_uid=interner.lookup(int(r["from_uid"])),
            from_port=int(r["from_port"]),
            to_ip=u32_to_ip(r["to_ip"]) if r["to_ip"] else "",
            to_type=_EP_NAMES[r["to_type"]],
            to_uid=interner.lookup(int(r["to_uid"])),
            to_port=int(r["to_port"]),
            # TLS'd HTTP renders as HTTPS at the export boundary
            # (processHttpEvent, data.go:1240-1242)
            protocol=(
                "HTTPS"
                if r["tls"] and r["protocol"] == L7Protocol.HTTP
                else L7Protocol(r["protocol"]).wire_name()
            ),
            tls=bool(r["tls"]),
            completed=bool(r["completed"]),
            status_code=int(r["status_code"]),
            fail_reason=interner.lookup(int(r["fail_reason"])),
            method=method_to_string(int(r["protocol"]), int(r["method"])),
            path=interner.lookup(int(r["path"])),
        )


def request_rows_to_payload(rows: np.ndarray, interner: Interner) -> list[list]:
    """Fixed-arity array payload rows, the ReqInfo[16] wire shape
    (datastore/payload.go:109-130)."""
    out = []
    for v in iter_request_views(rows, interner):
        out.append(
            [
                v.start_time_ms,
                v.latency_ns,
                v.from_ip,
                v.from_type,
                v.from_uid,
                v.from_port,
                v.to_ip,
                v.to_type,
                v.to_uid,
                v.to_port,
                v.protocol,
                v.status_code,
                v.fail_reason,
                v.method,
                v.path,
                v.tls,
            ]
        )
    return out
