"""MongoDB wire protocol classify + parse.

Kernel side: OP_MSG/OP_COMPRESSED header match, request vs reply via the
``response_to`` field (ebpf/c/mongo.c:55-92). Userspace: OP_MSG body
section walk extracting "<command> <collection>" (data.go:1558-1617).
"""

from __future__ import annotations

import struct

from alaz_tpu_torch.events.schema import MongoMethod

OP_COMPRESSED = 2012
OP_MSG = 2013


def classify_request(buf: bytes) -> int:
    """→ MongoMethod value or 0; requires response_to == 0 (mongo.c:55-66)."""
    if len(buf) < 16:
        return 0
    _length, _request_id, response_to, opcode = struct.unpack_from("<iiii", buf, 0)
    if response_to != 0:
        return 0
    if opcode == OP_MSG:
        return MongoMethod.OP_MSG
    if opcode == OP_COMPRESSED:
        return MongoMethod.OP_COMPRESSED
    return 0


def is_reply(buf: bytes) -> bool:
    """Reply headers arrive without the length prefix (mongo.c:70-92): the
    first 12 bytes are request_id, response_to, opcode."""
    if len(buf) < 12:
        return False
    _request_id, response_to, opcode = struct.unpack_from("<iii", buf, 0)
    return response_to != 0 and opcode in (OP_MSG, OP_COMPRESSED)


def parse_summary(payload: bytes) -> str | None:
    """'<first-element-name> <string-value>' from an OP_MSG kind-0 body
    section — e.g. 'find myCollection' — mirroring parseMongoEvent
    (data.go:1558-1617). None on anything unparsable."""
    try:
        p = payload[12:]  # cut length, request_id, response_to
        (opcode,) = struct.unpack_from("<I", p, 0)
        p = p[8:]  # cut opcode + flags
        if opcode == OP_COMPRESSED:
            return "compressed mongo event"
        if opcode != OP_MSG:
            return None
        kind = p[0]
        p = p[1:]
        if kind != 0:
            return None
        (doc_len,) = struct.unpack_from("<I", p, 0)
        p = p[4:doc_len]
        elem_type = p[0]
        if elem_type != 2:  # BSON string
            return None
        p = p[1:]
        null_at = p.index(0)
        element = p[:null_at]
        (elem_len,) = struct.unpack_from("<I", p, null_at + 1)
        p = p[null_at + 5 :]
        value = p[: elem_len - 1]
        return f"{element.decode('latin-1')} {value.decode('latin-1')}"
    except (IndexError, ValueError, struct.error):
        return None
