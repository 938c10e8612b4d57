"""IPv4 helpers.

The reference formats kernel-side __u32 addresses into dotted strings at the
perf-reader boundary (ebpf/tcp_state/tcp.go:209-254) and keys maps by those
strings. We keep addresses as uint32 end to end and only render strings at
the export boundary.
"""

from __future__ import annotations

import socket
import struct

import numpy as np


def ip_to_u32(ip: str) -> int:
    """Dotted-quad -> host-order uint32 (big-endian semantic order)."""
    return struct.unpack("!I", socket.inet_aton(ip))[0]


def u32_to_ip(v: int) -> str:
    return socket.inet_ntoa(struct.pack("!I", int(v)))


def ips_to_u32(ips) -> np.ndarray:
    return np.fromiter((ip_to_u32(ip) for ip in ips), dtype=np.uint32)
