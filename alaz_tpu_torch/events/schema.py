"""Event dtypes and protocol/method enums.

Field sets mirror the reference's userspace event structs so behavior (and
tests) can be compared one-to-one:

- L7 event   : ebpf/l7_req/l7.go:396-421 (``L7Event``)
- TCP event  : ebpf/tcp_state/tcp.go (``TcpConnectEvent``, enum at 20-33)
- Proc event : ebpf/proc/proc.go (``ProcEvent``)

Enum values match the reference's BPF-side constants (l7.go:19-144) so a
recorded trace from either system replays into the other.

Payloads: the reference captures up to 1024 bytes per event (ebpf/c/l7.c:14).
A 1024-byte inline field would make the hot dtype 1KiB/event, so the columnar
schema stores a configurable prefix inline (``MAX_PAYLOAD_SIZE``, default
256 — enough for every parser in protocols/) and the true ``payload_size``.
Trace files that need full fidelity can carry a side array.
"""

from __future__ import annotations

import enum

import numpy as np

MAX_PAYLOAD_SIZE = 256

# ---------------------------------------------------------------------------
# Tenancy: the frame header carries a one-byte tenant id so N
# agent fleets can multiplex onto one scoring backend. The byte sits in
# what was header padding (sources/ingest_server.py FRAME_HEADER), so a
# legacy agent — which zero-fills the pad — IS a tenant-0 agent byte for
# byte: every recorded trace replays unchanged. The width is a wire
# contract (alazspec pins it in resources/specs/wire_layouts.json);
# RuntimeConfig.tenants must stay ≤ MAX_TENANTS.
# ---------------------------------------------------------------------------

TENANT_WIRE_BITS = 8
MAX_TENANTS = 1 << TENANT_WIRE_BITS


class L7Protocol(enum.IntEnum):
    """BPF_L7_PROTOCOL_* (l7.go:19-28)."""

    UNKNOWN = 0
    HTTP = 1
    AMQP = 2
    POSTGRES = 3
    HTTP2 = 4
    REDIS = 5
    KAFKA = 6
    MYSQL = 7
    MONGO = 8

    def wire_name(self) -> str:
        return _PROTOCOL_NAMES[int(self)]


_PROTOCOL_NAMES = [
    "UNKNOWN",
    "HTTP",
    "AMQP",
    "POSTGRES",
    "HTTP2",
    "REDIS",
    "KAFKA",
    "MYSQL",
    "MONGO",
]

PROTOCOL_BY_NAME = {n: L7Protocol(i) for i, n in enumerate(_PROTOCOL_NAMES)}


class HttpMethod(enum.IntEnum):
    """BPF_METHOD_* (l7.go:75-85)."""

    UNKNOWN = 0
    GET = 1
    POST = 2
    PUT = 3
    PATCH = 4
    DELETE = 5
    HEAD = 6
    CONNECT = 7
    OPTIONS = 8
    TRACE = 9


class Http2Method(enum.IntEnum):
    UNKNOWN = 0
    CLIENT_FRAME = 1
    SERVER_FRAME = 2


class AmqpMethod(enum.IntEnum):
    UNKNOWN = 0
    PUBLISH = 1
    DELIVER = 2


class PostgresMethod(enum.IntEnum):
    UNKNOWN = 0
    CLOSE_OR_TERMINATE = 1
    SIMPLE_QUERY = 2
    EXTENDED_QUERY = 3


class RedisMethod(enum.IntEnum):
    UNKNOWN = 0
    COMMAND = 1
    PUSHED_EVENT = 2
    PING = 3


class KafkaMethod(enum.IntEnum):
    UNKNOWN = 0
    PRODUCE_REQUEST = 1
    FETCH_RESPONSE = 2


class MySqlMethod(enum.IntEnum):
    UNKNOWN = 0
    TEXT_QUERY = 1
    PREPARE_STMT = 2
    EXEC_STMT = 3
    STMT_CLOSE = 4


class MongoMethod(enum.IntEnum):
    UNKNOWN = 0
    OP_MSG = 1
    OP_COMPRESSED = 2


_METHOD_ENUMS = {
    L7Protocol.HTTP: HttpMethod,
    L7Protocol.HTTP2: Http2Method,
    L7Protocol.AMQP: AmqpMethod,
    L7Protocol.POSTGRES: PostgresMethod,
    L7Protocol.REDIS: RedisMethod,
    L7Protocol.KAFKA: KafkaMethod,
    L7Protocol.MYSQL: MySqlMethod,
    L7Protocol.MONGO: MongoMethod,
}

# String forms as the reference datastore emits them (l7.go:204-325).
_METHOD_STRINGS = {
    (L7Protocol.HTTP, HttpMethod.GET): "GET",
    (L7Protocol.HTTP, HttpMethod.POST): "POST",
    (L7Protocol.HTTP, HttpMethod.PUT): "PUT",
    (L7Protocol.HTTP, HttpMethod.PATCH): "PATCH",
    (L7Protocol.HTTP, HttpMethod.DELETE): "DELETE",
    (L7Protocol.HTTP, HttpMethod.HEAD): "HEAD",
    (L7Protocol.HTTP, HttpMethod.CONNECT): "CONNECT",
    (L7Protocol.HTTP, HttpMethod.OPTIONS): "OPTIONS",
    (L7Protocol.HTTP, HttpMethod.TRACE): "TRACE",
    (L7Protocol.HTTP2, Http2Method.CLIENT_FRAME): "CLIENT_FRAME",
    (L7Protocol.HTTP2, Http2Method.SERVER_FRAME): "SERVER_FRAME",
    (L7Protocol.AMQP, AmqpMethod.PUBLISH): "PUBLISH",
    (L7Protocol.AMQP, AmqpMethod.DELIVER): "DELIVER",
    (L7Protocol.POSTGRES, PostgresMethod.CLOSE_OR_TERMINATE): "CLOSE_OR_TERMINATE",
    (L7Protocol.POSTGRES, PostgresMethod.SIMPLE_QUERY): "SIMPLE_QUERY",
    (L7Protocol.POSTGRES, PostgresMethod.EXTENDED_QUERY): "EXTENDED_QUERY",
    (L7Protocol.REDIS, RedisMethod.COMMAND): "COMMAND",
    (L7Protocol.REDIS, RedisMethod.PUSHED_EVENT): "PUSHED_EVENT",
    (L7Protocol.REDIS, RedisMethod.PING): "PING",
    (L7Protocol.KAFKA, KafkaMethod.PRODUCE_REQUEST): "PRODUCE_REQUEST",
    (L7Protocol.KAFKA, KafkaMethod.FETCH_RESPONSE): "FETCH_RESPONSE",
    (L7Protocol.MYSQL, MySqlMethod.TEXT_QUERY): "TEXT_QUERY",
    (L7Protocol.MYSQL, MySqlMethod.PREPARE_STMT): "PREPARE_STMT",
    (L7Protocol.MYSQL, MySqlMethod.EXEC_STMT): "EXEC_STMT",
    (L7Protocol.MYSQL, MySqlMethod.STMT_CLOSE): "STMT_CLOSE",
    (L7Protocol.MONGO, MongoMethod.OP_MSG): "OP_MSG",
    (L7Protocol.MONGO, MongoMethod.OP_COMPRESSED): "OP_COMPRESSED",
}


def method_to_string(protocol: int, method: int) -> str:
    """Userspace method string, per l7.go:204-325; '' for unknown."""
    return _METHOD_STRINGS.get((L7Protocol(protocol), _coerce(protocol, method)), "")


def _coerce(protocol: int, method: int):
    e = _METHOD_ENUMS.get(L7Protocol(protocol))
    if e is None:
        return method
    try:
        return e(method)
    except ValueError:
        return method


class TcpEventType(enum.IntEnum):
    """BPF_EVENT_TCP_* (tcp.go:20-24); value 0 unused, matching the iota+1."""

    UNKNOWN = 0
    ESTABLISHED = 1
    CONNECT_FAILED = 2
    LISTEN = 3
    LISTEN_CLOSED = 4
    CLOSED = 5


class ProcEventType(enum.IntEnum):
    """EVENT_PROC_EXEC / EVENT_PROC_EXIT (ebpf/proc/proc.go)."""

    UNKNOWN = 0
    EXEC = 1
    EXIT = 2


# ---------------------------------------------------------------------------
# Structured dtypes. Field order groups the hot join keys first.
# ---------------------------------------------------------------------------

L7_EVENT_DTYPE = np.dtype(
    [
        ("pid", np.uint32),
        ("fd", np.uint64),
        ("write_time_ns", np.uint64),  # start time of the write syscall
        ("duration_ns", np.uint64),
        ("protocol", np.uint8),  # L7Protocol
        ("method", np.uint8),  # per-protocol method enum
        ("tls", np.bool_),
        ("failed", np.bool_),
        ("status", np.uint32),
        ("payload_size", np.uint32),
        ("payload_read_complete", np.bool_),
        ("tid", np.uint32),
        ("seq", np.uint32),  # tcp seq (dist tracing; l7.go:410)
        ("kafka_api_version", np.int16),
        ("mysql_prep_stmt_id", np.uint32),
        ("saddr", np.uint32),  # V2 path: addrs straight off the event (data.go:1760)
        ("sport", np.uint16),
        ("daddr", np.uint32),
        ("dport", np.uint16),
        ("event_read_time_ns", np.uint64),
        ("payload", np.uint8, (MAX_PAYLOAD_SIZE,)),
    ]
)

TCP_EVENT_DTYPE = np.dtype(
    [
        ("pid", np.uint32),
        ("fd", np.uint64),
        ("timestamp_ns", np.uint64),
        ("type", np.uint8),  # TcpEventType
        ("saddr", np.uint32),
        ("sport", np.uint16),
        ("daddr", np.uint32),
        ("dport", np.uint16),
    ]
)

PROC_EVENT_DTYPE = np.dtype(
    [
        ("pid", np.uint32),
        ("type", np.uint8),  # ProcEventType
        ("timestamp_ns", np.uint64),
    ]
)


# The wire-visible structured dtypes: everything an out-of-process agent
# serializes byte-for-byte (sources/ingest_server.py frames). alazspec
# pins each one's layout in resources/specs/wire_layouts.json and fails
# tier-1 on drift — the Go-struct-vs-C-struct desync of the reference,
# caught statically (tools/alazspec).
WIRE_DTYPES = {
    "L7_EVENT_DTYPE": L7_EVENT_DTYPE,
    "TCP_EVENT_DTYPE": TCP_EVENT_DTYPE,
    "PROC_EVENT_DTYPE": PROC_EVENT_DTYPE,
}


def dtype_layout(dtype: np.dtype, name: str) -> str:
    """Canonical layout string for a structured dtype:
    ``"Name:<itemsize>;<field>:<offset>:<size>;..."`` — byte-compatible
    with the C side's ``alz_abi_record_layout()`` (native/ingest.cc), so
    struct↔dtype parity is one string comparison. Subarray fields (the
    payload prefix) report their total byte span."""
    parts = [f"{name}:{dtype.itemsize}"]
    for field in dtype.names or ():
        ft, off = dtype.fields[field][:2]
        parts.append(f"{field}:{off}:{ft.itemsize}")
    return ";".join(parts)


def make_l7_events(n: int) -> np.ndarray:
    return np.zeros(n, dtype=L7_EVENT_DTYPE)


def make_tcp_events(n: int) -> np.ndarray:
    return np.zeros(n, dtype=TCP_EVENT_DTYPE)


def make_proc_events(n: int) -> np.ndarray:
    return np.zeros(n, dtype=PROC_EVENT_DTYPE)


def set_payloads(events: np.ndarray, payload: bytes) -> None:
    """Set the same payload prefix on every row of an L7 event batch."""
    buf = np.frombuffer(payload[:MAX_PAYLOAD_SIZE], dtype=np.uint8)
    events["payload"][:, : buf.shape[0]] = buf
    events["payload_size"] = len(payload)
