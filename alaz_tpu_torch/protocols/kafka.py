"""Kafka wire protocol: kernel-style header sanity + userspace decode.

Kernel side (ebpf/c/kafka.c:38-79): request header sanity (size == buffer,
api_key in 0..74), capture correlation_id/api_key/api_version; responses
matched by correlation_id. Payload decode is deferred to userspace — the
reference vendors a trimmed Sarama decoder (aggregator/kafka/, ~2.6k LoC,
SURVEY G14). This module is the from-scratch equivalent: ProduceRequest and
FetchResponse decode over both legacy message sets (magic 0/1) and record
batches (magic 2), with gzip decompression (the other codecs are gated on
optional libs, like the reference's decompress.go codec table).

Both non-flexible (produce v0-v8, fetch v0-v11) and flexible/compact
versions (KIP-482: produce v9+, fetch v12+ — compact strings/arrays,
unsigned-varint lengths, tagged fields; fetch v13+ topic ids) decode;
modern clients (Kafka ≥2.4) negotiate the flexible versions.
"""

from __future__ import annotations

import gzip
import io
import struct
from dataclasses import dataclass
from typing import List


API_KEY_PRODUCE = 0
API_KEY_FETCH = 1

PUBLISH = "PUBLISH"
CONSUME = "CONSUME"

# Kafka error code → symbolic name (the errors.go KError table analog;
# common subset — unknown codes format as 'KError-<n>').
KERROR = {
    -1: "UNKNOWN_SERVER_ERROR",
    0: "NONE",
    1: "OFFSET_OUT_OF_RANGE",
    2: "CORRUPT_MESSAGE",
    3: "UNKNOWN_TOPIC_OR_PARTITION",
    4: "INVALID_FETCH_SIZE",
    5: "LEADER_NOT_AVAILABLE",
    6: "NOT_LEADER_OR_FOLLOWER",
    7: "REQUEST_TIMED_OUT",
    8: "BROKER_NOT_AVAILABLE",
    9: "REPLICA_NOT_AVAILABLE",
    10: "MESSAGE_TOO_LARGE",
    11: "STALE_CONTROLLER_EPOCH",
    12: "OFFSET_METADATA_TOO_LARGE",
    13: "NETWORK_EXCEPTION",
    14: "COORDINATOR_LOAD_IN_PROGRESS",
    15: "COORDINATOR_NOT_AVAILABLE",
    16: "NOT_COORDINATOR",
    17: "INVALID_TOPIC_EXCEPTION",
    18: "RECORD_LIST_TOO_LARGE",
    19: "NOT_ENOUGH_REPLICAS",
    20: "NOT_ENOUGH_REPLICAS_AFTER_APPEND",
    21: "INVALID_REQUIRED_ACKS",
    22: "ILLEGAL_GENERATION",
    23: "INCONSISTENT_GROUP_PROTOCOL",
    24: "INVALID_GROUP_ID",
    25: "UNKNOWN_MEMBER_ID",
    26: "INVALID_SESSION_TIMEOUT",
    27: "REBALANCE_IN_PROGRESS",
    28: "INVALID_COMMIT_OFFSET_SIZE",
    29: "TOPIC_AUTHORIZATION_FAILED",
    30: "GROUP_AUTHORIZATION_FAILED",
    31: "CLUSTER_AUTHORIZATION_FAILED",
    32: "INVALID_TIMESTAMP",
    33: "UNSUPPORTED_SASL_MECHANISM",
    34: "ILLEGAL_SASL_STATE",
    35: "UNSUPPORTED_VERSION",
    36: "TOPIC_ALREADY_EXISTS",
    37: "INVALID_PARTITIONS",
    38: "INVALID_REPLICATION_FACTOR",
    39: "INVALID_REPLICA_ASSIGNMENT",
    40: "INVALID_CONFIG",
    41: "NOT_CONTROLLER",
    42: "INVALID_REQUEST",
    43: "UNSUPPORTED_FOR_MESSAGE_FORMAT",
    44: "POLICY_VIOLATION",
    45: "OUT_OF_ORDER_SEQUENCE_NUMBER",
    46: "DUPLICATE_SEQUENCE_NUMBER",
    47: "INVALID_PRODUCER_EPOCH",
    48: "INVALID_TXN_STATE",
    49: "INVALID_PRODUCER_ID_MAPPING",
    50: "INVALID_TRANSACTION_TIMEOUT",
    51: "CONCURRENT_TRANSACTIONS",
    52: "TRANSACTION_COORDINATOR_FENCED",
    53: "TRANSACTIONAL_ID_AUTHORIZATION_FAILED",
    54: "SECURITY_DISABLED",
    55: "OPERATION_NOT_ATTEMPTED",
    56: "KAFKA_STORAGE_ERROR",
    57: "LOG_DIR_NOT_FOUND",
    58: "SASL_AUTHENTICATION_FAILED",
    59: "UNKNOWN_PRODUCER_ID",
    60: "REASSIGNMENT_IN_PROGRESS",
}


def kerror_name(code: int) -> str:
    return KERROR.get(code, f"KError-{code}")


@dataclass
class KafkaMessage:
    """Decoded record → datastore.KafkaEvent fields (dto.go:122-142)."""

    topic: str
    partition: int
    key: str
    value: str
    type: str  # PUBLISH | CONSUME


def parse_request_header(buf: bytes) -> tuple[bool, int, int, int]:
    """(ok, correlation_id, api_key, api_version) — kafka.c:38-66."""
    if len(buf) < 12:
        return (False, 0, 0, 0)
    size, api_key, api_version, correlation_id = struct.unpack_from("!ihhi", buf, 0)
    if size + 4 != len(buf):
        return (False, 0, 0, 0)
    if correlation_id > 0 and 0 <= api_key <= 74:
        return (True, correlation_id, api_key, api_version)
    return (False, 0, 0, 0)


def is_response_header(buf: bytes, correlation_id: int) -> bool:
    """kafka.c:69-79: match by correlation id."""
    if len(buf) < 8:
        return False
    _size, corr = struct.unpack_from("!ii", buf, 0)
    return corr == correlation_id


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def remaining(self) -> int:
        return len(self.buf) - self.off

    def read(self, n: int) -> bytes:
        if self.off + n > len(self.buf):
            raise EOFError
        out = self.buf[self.off : self.off + n]
        self.off += n
        return out

    def skip(self, n: int) -> None:
        if self.off + n > len(self.buf):
            raise EOFError
        self.off += n

    def i8(self) -> int:
        return struct.unpack("!b", self.read(1))[0]

    def i16(self) -> int:
        return struct.unpack("!h", self.read(2))[0]

    def i32(self) -> int:
        return struct.unpack("!i", self.read(4))[0]

    def i64(self) -> int:
        return struct.unpack("!q", self.read(8))[0]

    def string(self) -> str | None:
        n = self.i16()
        if n < 0:
            return None
        return self.read(n).decode("utf-8", "replace")

    def bytes_(self) -> bytes | None:
        n = self.i32()
        if n < 0:
            return None
        return self.read(n)

    def varint(self) -> int:
        """Zigzag varint (record batch v2 encoding)."""
        value = 0
        shift = 0
        while True:
            b = self.read(1)[0]
            value |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
            if shift > 63:
                raise EOFError
        return (value >> 1) ^ -(value & 1)

    def varint_bytes(self) -> bytes | None:
        n = self.varint()
        if n < 0:
            return None
        return self.read(n)

    def bytes_lenient(self) -> bytes:
        """BYTES field tolerating truncation: events carry at most the
        capture window (MAX_PAYLOAD_SIZE), so a record set's declared
        length routinely exceeds what was captured — decode what's there."""
        n = self.i32()
        if n < 0:
            return b""
        take = min(n, self.remaining())
        return self.read(take)

    # -- flexible-version (KIP-482) primitives ---------------------------

    def uvarint(self) -> int:
        """Unsigned varint (compact lengths, tagged-field tags/sizes)."""
        value = 0
        shift = 0
        while True:
            b = self.read(1)[0]
            value |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
            if shift > 63:
                raise EOFError
        return value

    def compact_string(self) -> str | None:
        n = self.uvarint()
        if n == 0:
            return None
        return self.read(n - 1).decode("utf-8", "replace")

    def compact_bytes_lenient(self) -> bytes:
        """COMPACT_BYTES tolerating capture-window truncation."""
        n = self.uvarint()
        if n == 0:
            return b""
        take = min(n - 1, self.remaining())
        return self.read(take)

    def compact_array_len(self) -> int:
        """Compact array length: uvarint(count + 1); -1 means null."""
        return self.uvarint() - 1

    def tagged_fields(self) -> None:
        """Skip a tagged-field section: uvarint count, then per field
        uvarint tag + uvarint size + bytes."""
        n = self.uvarint()
        for _ in range(n):
            self.uvarint()  # tag
            size = self.uvarint()
            self.skip(size)

    def uuid_hex(self) -> str:
        """16-byte UUID (fetch v13+ topic ids) as canonical hex."""
        raw = self.read(16)
        h = raw.hex()
        return f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}"


def _decompress(codec: int, data: bytes) -> bytes | None:
    """Codec table analog of decompress.go; returns None when the codec's
    lib isn't available (caller emits a placeholder)."""
    if codec == 0:
        return data
    if codec == 1:
        try:
            return gzip.GzipFile(fileobj=io.BytesIO(data)).read()
        except OSError:
            return None
    if codec == 2:  # snappy (pure-python decoder, xerial framing aware)
        try:
            from alaz_tpu_torch.protocols.compression import snappy_decompress

            return snappy_decompress(data)
        except Exception:
            return None
    if codec == 3:  # lz4 (pure-python frame/block decoder)
        try:
            from alaz_tpu_torch.protocols.compression import lz4_frame_decompress

            return lz4_frame_decompress(data)
        except Exception:
            return None
    if codec == 4:  # zstd (system libzstd via ctypes → wheel fallback;
        # never silently absent — decompress.go:87 decodes unconditionally)
        try:
            from alaz_tpu_torch.protocols.compression import zstd_decompress

            return zstd_decompress(data)
        except Exception:
            return None
    return None


def _txt(b: bytes | None) -> str:
    if b is None:
        return ""
    return b.decode("utf-8", "replace")


def decode_record_set(topic: str, partition: int, data: bytes, mtype: str) -> List[KafkaMessage]:
    """Decode a record set: record batches v2 or legacy message sets v0/v1
    (records.go/record_batch.go/message_set.go analog)."""
    out: List[KafkaMessage] = []
    r = _Reader(data)
    try:
        while r.remaining() >= 17:
            base_off_pos = r.off
            _base_offset = r.i64()
            batch_len = r.i32()
            if r.remaining() < 1:
                break
            magic_probe = r.buf[r.off + 4] if r.remaining() >= 5 else -1
            if magic_probe == 2:
                # RecordBatch v2
                _leader_epoch = r.i32()
                magic = r.i8()
                _crc = r.i32()
                attrs = r.i16()
                _last_offset_delta = r.i32()
                _first_ts = r.i64()
                _max_ts = r.i64()
                _producer_id = r.i64()
                _producer_epoch = r.i16()
                _base_seq = r.i32()
                n_records = r.i32()
                codec = attrs & 0x07
                records_size = batch_len - 49  # bytes after the count field
                payload = r.read(max(0, min(records_size, r.remaining())))
                if codec:
                    payload2 = _decompress(codec, payload)
                    if payload2 is None:
                        out.append(
                            KafkaMessage(topic, partition, "", "<compressed>", mtype)
                        )
                        continue
                    payload = payload2
                rr = _Reader(payload)
                for _ in range(max(0, n_records)):
                    if rr.remaining() <= 0:
                        break
                    _rec_len = rr.varint()
                    _attr = rr.i8()
                    _ts_delta = rr.varint()
                    _off_delta = rr.varint()
                    key = rr.varint_bytes()
                    value = rr.varint_bytes()
                    n_headers = rr.varint()
                    for _h in range(max(0, n_headers)):
                        rr.varint_bytes()
                        rr.varint_bytes()
                    out.append(KafkaMessage(topic, partition, _txt(key), _txt(value), mtype))
            else:
                # Legacy message: crc i32, magic i8, attrs i8, [ts i64], key, value
                r.off = base_off_pos + 12  # past offset + message_size
                _crc = r.i32()
                magic = r.i8()
                attrs = r.i8()
                if magic >= 1:
                    _ts = r.i64()
                key = r.bytes_()
                value = r.bytes_()
                codec = attrs & 0x07
                if codec and value is not None:
                    inner = _decompress(codec, value)
                    if inner is None:
                        out.append(KafkaMessage(topic, partition, _txt(key), "<compressed>", mtype))
                    else:
                        out.extend(decode_record_set(topic, partition, inner, mtype))
                else:
                    out.append(KafkaMessage(topic, partition, _txt(key), _txt(value), mtype))
    except (EOFError, struct.error):
        pass
    return out


# First flexible api_version per api_key (versions.go analog): flexible
# requests use header v2 (tagged fields after client_id), flexible
# responses use header v1 (tagged fields after correlation_id).
FLEXIBLE_SINCE = {API_KEY_PRODUCE: 9, API_KEY_FETCH: 12}


def is_flexible(api_key: int, api_version: int) -> bool:
    since = FLEXIBLE_SINCE.get(api_key)
    return since is not None and api_version >= since


def decode_produce_request(buf: bytes, api_version: int) -> List[KafkaMessage]:
    """ProduceRequest body (after the request header) → PUBLISH messages
    (produce_request.go analog). v0-v8 classic encoding; v9+ flexible
    (compact strings/arrays, tagged fields)."""
    flexible = api_version >= FLEXIBLE_SINCE[API_KEY_PRODUCE]
    out: List[KafkaMessage] = []
    r = _Reader(buf)
    try:
        if flexible:
            r.compact_string()  # transactional_id
        elif api_version >= 3:
            r.string()  # transactional_id
        _acks = r.i16()
        _timeout = r.i32()
        n_topics = r.compact_array_len() if flexible else r.i32()
        for _ in range(max(0, n_topics)):
            topic = (r.compact_string() if flexible else r.string()) or ""
            n_parts = r.compact_array_len() if flexible else r.i32()
            for _p in range(max(0, n_parts)):
                partition = r.i32()
                record_set = (
                    r.compact_bytes_lenient() if flexible else r.bytes_lenient()
                )
                out.extend(decode_record_set(topic, partition, record_set, PUBLISH))
                if flexible:
                    r.tagged_fields()  # partition tail
            if flexible:
                r.tagged_fields()  # topic tail
        if flexible:
            r.tagged_fields()  # request tail
    except (EOFError, struct.error):
        pass
    return out


def split_request_header(buf: bytes) -> tuple[int, int, int, bytes]:
    """Full request wire bytes → (api_key, api_version, correlation_id,
    body). Header v1: size, api_key, api_version, correlation_id,
    client_id (nullable non-compact string). Header v2 (flexible versions)
    appends tagged fields; client_id stays a legacy string (KIP-482)."""
    r = _Reader(buf)
    _size = r.i32()
    api_key = r.i16()
    api_version = r.i16()
    corr = r.i32()
    r.string()  # client_id
    if is_flexible(api_key, api_version):
        r.tagged_fields()
    return api_key, api_version, corr, buf[r.off :]


def decode_fetch_response(buf: bytes, api_version: int) -> List[KafkaMessage]:
    """FetchResponse body (after size+correlation_id) → CONSUME messages
    (fetch_response.go analog). v0-v11 classic; v12+ flexible (the
    response-header-v1 tagged-field tail is consumed here so the caller
    can keep slicing off size+correlation_id uniformly); v13+ carries
    topic ids (UUID) instead of names."""
    flexible = api_version >= FLEXIBLE_SINCE[API_KEY_FETCH]
    out: List[KafkaMessage] = []
    r = _Reader(buf)
    try:
        if flexible:
            r.tagged_fields()  # response header v1 tail
        if api_version >= 1:
            r.i32()  # throttle_time_ms
        if api_version >= 7:
            r.i16()  # error_code
            r.i32()  # session_id
        n_topics = r.compact_array_len() if flexible else r.i32()
        for _ in range(max(0, n_topics)):
            if api_version >= 13:
                topic = r.uuid_hex()  # topic_id; name resolution is broker-side
            elif flexible:
                topic = r.compact_string() or ""
            else:
                topic = r.string() or ""
            n_parts = r.compact_array_len() if flexible else r.i32()
            for _p in range(max(0, n_parts)):
                partition = r.i32()
                _err = r.i16()
                _high_watermark = r.i64()
                if api_version >= 4:
                    _last_stable = r.i64()
                    if api_version >= 5:
                        _log_start = r.i64()
                    n_aborted = r.compact_array_len() if flexible else r.i32()
                    for _a in range(max(0, n_aborted)):
                        r.i64()  # producer_id
                        r.i64()  # first_offset
                        if flexible:
                            r.tagged_fields()
                if api_version >= 11:
                    r.i32()  # preferred_read_replica
                record_set = (
                    r.compact_bytes_lenient() if flexible else r.bytes_lenient()
                )
                out.extend(decode_record_set(topic, partition, record_set, CONSUME))
                if flexible:
                    r.tagged_fields()  # partition tail
            if flexible:
                r.tagged_fields()  # topic tail
        if flexible:
            r.tagged_fields()  # response tail
    except (EOFError, struct.error):
        pass
    return out
