"""HTTP/2 frame detection and parsing (gRPC rides on this).

Kernel-side behavior (ebpf/c/http2.c:54-113): recognize the client magic
preface or a plausible frame header, and only track client-initiated (odd)
stream ids; frames are forwarded raw to userspace, where the aggregator
pairs client/server HEADERS per stream (data.go:533-810, G13).

Here: ``is_frame`` is the classifier; ``iter_frames`` walks a byte buffer
into (stream_id, type, flags, payload) tuples for the userspace assembler in
``alaz_tpu.aggregator.h2``.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple

CLIENT_FRAME = 1
SERVER_FRAME = 2

MAGIC = bytes(
    [
        0x50, 0x52, 0x49, 0x20, 0x2A, 0x20, 0x48, 0x54,
        0x54, 0x50, 0x2F, 0x32, 0x2E, 0x30, 0x0D, 0x0A,
        0x0D, 0x0A, 0x53, 0x4D, 0x0D, 0x0A, 0x0D, 0x0A,
    ]
)

FRAME_DATA = 0x0
FRAME_HEADERS = 0x1
FRAME_PRIORITY = 0x2
FRAME_RST_STREAM = 0x3
FRAME_SETTINGS = 0x4
FRAME_PUSH_PROMISE = 0x5
FRAME_PING = 0x6
FRAME_GOAWAY = 0x7
FRAME_WINDOW_UPDATE = 0x8
FRAME_CONTINUATION = 0x9

FLAG_END_STREAM = 0x1
FLAG_END_HEADERS = 0x4
FLAG_PADDED = 0x8
FLAG_PRIORITY = 0x20


def is_magic(buf: bytes) -> bool:
    return buf[:14] == MAGIC[:14]  # is_http2_magic_2 checks the first 14 bytes


def is_frame(buf: bytes) -> bool:
    """http2.c:54-113: magic, or valid frame type with stream id 0 or odd."""
    if len(buf) < 9:
        return False
    if is_magic(buf):
        return True
    ftype = buf[3]
    if ftype > 0x09:
        return False
    stream_id = int.from_bytes(buf[5:9], "big") & 0x7FFFFFFF
    if stream_id == 0:
        return True
    return stream_id % 2 == 1


class Frame(NamedTuple):
    length: int
    type: int
    flags: int
    stream_id: int
    payload: bytes


def parse_frame_header(buf: bytes, off: int = 0) -> Frame | None:
    """Parse one 9-byte frame header (+payload view) at ``off``; None if the
    buffer is exhausted. Mirrors the aggregator's alloc-free manual parse
    (data.go:619-628)."""
    if off + 9 > len(buf):
        return None
    length = int.from_bytes(buf[off : off + 3], "big")
    ftype = buf[off + 3]
    flags = buf[off + 4]
    stream_id = int.from_bytes(buf[off + 5 : off + 9], "big") & 0x7FFFFFFF
    payload = bytes(buf[off + 9 : off + 9 + length])
    return Frame(length, ftype, flags, stream_id, payload)


def iter_frames(buf: bytes) -> Iterator[Frame]:
    """Walk a buffer of concatenated frames, skipping a leading magic.

    Truncated trailing frames yield with whatever payload prefix survived
    (payload capture is capped, like the kernel's 1024-byte window)."""
    off = 24 if buf[:24] == MAGIC else 0
    while off < len(buf):
        f = parse_frame_header(buf, off)
        if f is None:
            return
        yield f
        off += 9 + f.length


def build_frame(ftype: int, flags: int, stream_id: int, payload: bytes = b"") -> bytes:
    """Serialize one frame (the write side of parse_frame_header) — used by
    the CRI gRPC client, which speaks HTTP/2 over the runtime socket."""
    return (
        len(payload).to_bytes(3, "big")
        + bytes([ftype & 0xFF, flags & 0xFF])
        + (stream_id & 0x7FFFFFFF).to_bytes(4, "big")
        + payload
    )


def headers_block(frame: Frame) -> bytes:
    """Strip padding/priority from a HEADERS frame payload → HPACK block."""
    payload = frame.payload
    if frame.flags & FLAG_PADDED and payload:
        pad = payload[0]
        payload = payload[1 : len(payload) - pad if pad < len(payload) else 1]
    if frame.flags & FLAG_PRIORITY and len(payload) >= 5:
        payload = payload[5:]
    return payload
