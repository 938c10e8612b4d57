"""HTTP/1.x classify + parse.

Kernel-side behavior: method byte-match on the first bytes of a write
payload and ``HTTP/x.y NNN`` status parse on the read side
(ebpf/c/http.c:17-77). Userspace: request-line + Host header extraction
(aggregator/data.go:508-531).

``classify_batch``/``parse_status_batch`` are the vectorized forms used on
columnar payload matrices — the replay hot path.
"""

from __future__ import annotations

import numpy as np

from alaz_tpu_torch.events.schema import HttpMethod

MIN_METHOD_LEN = 8
MIN_RESP_LEN = 12

_METHOD_PREFIXES: list[tuple[bytes, int]] = [
    (b"GET", HttpMethod.GET),
    (b"POST", HttpMethod.POST),
    (b"PUT", HttpMethod.PUT),
    (b"PATCH", HttpMethod.PATCH),
    (b"DELETE", HttpMethod.DELETE),
    (b"HEAD", HttpMethod.HEAD),
    (b"CONNECT", HttpMethod.CONNECT),
    (b"OPTIONS", HttpMethod.OPTIONS),
    (b"TRACE", HttpMethod.TRACE),
]


def parse_method(buf: bytes) -> int:
    """Method enum, or 0/-1 matching http.c:17-45 semantics (0 = too short,
    -1 folded to 0 here: both mean 'not HTTP')."""
    if len(buf) < MIN_METHOD_LEN:
        return 0
    for prefix, method in _METHOD_PREFIXES:
        if buf.startswith(prefix):
            return method
    return 0


def parse_status(buf: bytes) -> int:
    """``HTTP/d.d NNN`` → NNN, else -1 (http.c:48-77); 0 if too short."""
    if len(buf) < MIN_RESP_LEN:
        return 0
    b = buf
    if not (b[0:5] == b"HTTP/" and b[5:6].isdigit() and b[6:7] == b"." and b[7:8].isdigit() and b[8:9] == b" "):
        return -1
    if not b[9:12].isdigit():
        return -1
    return int(b[9:12])


def parse_payload(request: bytes | str) -> tuple[str, str, str, str]:
    """Request line + Host header → (method, path, http_version, host),
    mirroring parseHttpPayload (data.go:508-531)."""
    if isinstance(request, (bytes, bytearray, memoryview)):
        request = bytes(request).split(b"\x00", 1)[0].decode("latin-1")
    method = path = version = host = ""
    lines = request.split("\n")
    parts = lines[0].split(" ")
    if len(parts) >= 3:
        method, path, version = parts[0], parts[1], parts[2]
    for line in lines[1:]:
        if line.startswith("Host:"):
            host_parts = line.split(" ")
            if len(host_parts) >= 2:
                host = host_parts[1].rstrip("\r")
                break
    return method, path, version, host


# ---------------------------------------------------------------------------
# Vectorized forms over payload matrices (uint8 [N, MAX_PAYLOAD_SIZE]).
# ---------------------------------------------------------------------------

_PREFIX_TABLE = np.zeros((len(_METHOD_PREFIXES), MIN_METHOD_LEN), dtype=np.uint8)
_PREFIX_LENS = np.zeros(len(_METHOD_PREFIXES), dtype=np.int64)
_PREFIX_IDS = np.zeros(len(_METHOD_PREFIXES), dtype=np.uint8)
for _i, (_p, _m) in enumerate(_METHOD_PREFIXES):
    _PREFIX_TABLE[_i, : len(_p)] = np.frombuffer(_p, dtype=np.uint8)
    _PREFIX_LENS[_i] = len(_p)
    _PREFIX_IDS[_i] = _m


def classify_batch(payloads: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """Vectorized parse_method over a [N, >=8] uint8 payload matrix.

    Returns a uint8 method array (0 where not HTTP)."""
    n = payloads.shape[0]
    out = np.zeros(n, dtype=np.uint8)
    window = payloads[:, :MIN_METHOD_LEN]  # [N, 8]
    for i in range(len(_METHOD_PREFIXES)):
        plen = _PREFIX_LENS[i]
        match = (window[:, :plen] == _PREFIX_TABLE[i, :plen]).all(axis=1)
        out = np.where((out == 0) & match, _PREFIX_IDS[i], out)
    out[sizes < MIN_METHOD_LEN] = 0
    return out


def parse_status_batch(payloads: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """Vectorized parse_status. int32 array: NNN, -1 not-HTTP, 0 too-short."""
    n = payloads.shape[0]
    b = payloads[:, :MIN_RESP_LEN]
    digits = (b >= ord("0")) & (b <= ord("9"))
    head_ok = (
        (b[:, 0] == ord("H"))
        & (b[:, 1] == ord("T"))
        & (b[:, 2] == ord("T"))
        & (b[:, 3] == ord("P"))
        & (b[:, 4] == ord("/"))
        & digits[:, 5]
        & (b[:, 6] == ord("."))
        & digits[:, 7]
        & (b[:, 8] == ord(" "))
        & digits[:, 9]
        & digits[:, 10]
        & digits[:, 11]
    )
    status = (
        (b[:, 9].astype(np.int32) - ord("0")) * 100
        + (b[:, 10].astype(np.int32) - ord("0")) * 10
        + (b[:, 11].astype(np.int32) - ord("0"))
    )
    out = np.where(head_ok, status, np.int32(-1))
    out = np.where(sizes < MIN_RESP_LEN, np.int32(0), out)
    return out
