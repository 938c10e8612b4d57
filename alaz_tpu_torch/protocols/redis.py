"""Redis RESP classify + parse (ebpf/c/redis.c).

ping/pong, client commands, server-pushed pub/sub events, and response
type → success/error classification; the userspace side uses the raw
payload as the query string (data.go:1120-1160).
"""

from __future__ import annotations

from alaz_tpu_torch.events.schema import RedisMethod

STATUS_SUCCESS = 1
STATUS_ERROR = 2
STATUS_UNKNOWN = 3


def is_ping(buf: bytes) -> bool:
    return len(buf) >= 14 and buf[:8] == b"*1\r\n$4\r\n" and buf[8:14] == b"ping\r\n"


def is_pong(buf: bytes) -> bool:
    if len(buf) < 14:
        return False
    return (
        buf[0:1] == b"*"
        and buf[1:2].isdigit()
        and buf[2:8] == b"\r\n$4\r\n"
        and buf[8:14] == b"pong\r\n"
    )


def is_command(buf: bytes) -> bool:
    """Client RESP array that isn't a pub/sub 'message' (redis.c:60-100)."""
    if len(buf) < 11:
        return False
    if buf[0:1] != b"*" or not buf[1:2].isdigit():
        return False
    if buf[2:4] == b"\r\n":
        if buf[4:11] == b"$7\r\nmes"[:7]:
            return False
        return True
    if buf[2:3].isdigit() and buf[3:5] == b"\r\n":
        if buf[5:11] == b"$7\r\nme":
            return False
        return True
    return False


def is_pushed_event(buf: bytes) -> bool:
    """RESP2 '*' / RESP3 '>' pushed 'message' event (redis.c:103-137)."""
    if len(buf) < 17:
        return False
    if buf[0:1] not in (b">", b"*") or not buf[1:2].isdigit():
        return False
    return buf[2:4] == b"\r\n" and buf[4:17] == b"$7\r\nmessage\r\n"


def classify_request(buf: bytes) -> int:
    """→ RedisMethod value or 0, following the l7.c dispatch order: ping,
    then pushed-event (server→client seen on writes), then command."""
    if is_ping(buf):
        return RedisMethod.PING
    if is_pushed_event(buf):
        return RedisMethod.PUSHED_EVENT
    if is_command(buf):
        return RedisMethod.COMMAND
    return 0


def parse_response(buf: bytes) -> int:
    """Response first-byte type → status (redis.c:140-181)."""
    if not buf:
        return STATUS_UNKNOWN
    if len(buf) < 2 or buf[-2:] != b"\r\n":
        return STATUS_UNKNOWN
    t = buf[0:1]
    if t in (b"*", b":", b"$", b"+", b"_", b"#", b",", b"(", b"=", b"%", b"~"):
        return STATUS_SUCCESS
    if t in (b"-", b"!"):
        return STATUS_ERROR
    return STATUS_UNKNOWN
