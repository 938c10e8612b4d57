"""AMQP 0-9-1 classify (ebpf/c/amqp.c).

METHOD frames of class BASIC with method PUBLISH(40)/DELIVER(60); publish
completion is observed on the write-exit path in the reference
(l7.c:178-191,485-573). DELIVER events get their direction reversed by the
aggregator (data.go:1110-1112).
"""

from __future__ import annotations

import struct

from alaz_tpu_torch.events.schema import AmqpMethod

FRAME_TYPE_METHOD = 0x01
FRAME_END = 0xCE
CLASS_BASIC = 60
METHOD_PUBLISH = 40
METHOD_DELIVER = 60


def _method_is(buf: bytes, expected_method: int) -> bool:
    if len(buf) < 12:
        return False
    if buf[0] != FRAME_TYPE_METHOD:
        return False
    (size,) = struct.unpack_from("!I", buf, 3)
    if 7 + size + 1 > len(buf):
        return False
    if buf[7 + size] != FRAME_END:
        return False
    (class_id,) = struct.unpack_from("!H", buf, 7)
    if class_id != CLASS_BASIC:
        return False
    (method,) = struct.unpack_from("!H", buf, 9)
    return method == expected_method


def is_publish(buf: bytes) -> bool:
    return _method_is(buf, METHOD_PUBLISH)


def is_deliver(buf: bytes) -> bool:
    return _method_is(buf, METHOD_DELIVER)


def classify_request(buf: bytes) -> int:
    if is_publish(buf):
        return AmqpMethod.PUBLISH
    if is_deliver(buf):
        return AmqpMethod.DELIVER
    return 0


def build_method_frame(channel: int, class_id: int, method_id: int, args: bytes = b"") -> bytes:
    """Fabricate a METHOD frame (simulator/test helper)."""
    payload = struct.pack("!HH", class_id, method_id) + args
    return (
        struct.pack("!BHI", FRAME_TYPE_METHOD, channel, len(payload))
        + payload
        + bytes([FRAME_END])
    )
