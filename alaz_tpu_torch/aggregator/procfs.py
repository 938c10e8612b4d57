"""Cold-start socket backfill from procfs — the sock_num_line.go:223-269,
352-429 analog.

On agent (re)start every pre-existing TCP connection is invisible until a
new kernel TCP event arrives, so L7 events on long-lived connections drop
for minutes. The reference rebuilds initial socket lines by joining
``/proc/<pid>/fd`` socket inodes against ``/proc/<pid>/net/tcp`` (the
pid's network-namespace view) and seeding an open interval per
established connection; this module does the same over a pluggable proc
root so fixtures can drive it in tests.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Iterable

from alaz_tpu_torch.aggregator.sockline import SockInfo, SocketLineStore

TCP_ESTABLISHED = 0x01  # include/net/tcp_states.h

_SOCKET_LINK = re.compile(r"socket:\[(\d+)\]")


def _parse_hex_addr(addr: str) -> tuple[int, int]:
    """'0100007F:1F90' → (u32 big-endian ip, port). procfs stores the IPv4
    address as little-endian hex (readSockets parses the same columns)."""
    ip_hex, port_hex = addr.split(":")
    ip = int.from_bytes(bytes.fromhex(ip_hex), "little")
    return ip, int(port_hex, 16)


def parse_proc_net_tcp(text: str) -> dict[int, tuple[int, int, int, int]]:
    """/proc/<pid>/net/tcp → {inode: (saddr, sport, daddr, dport)} for
    ESTABLISHED sockets only (sock_num_line.go:236-265 keeps st==01)."""
    out: dict[int, tuple[int, int, int, int]] = {}
    for line in text.splitlines()[1:]:  # first line is the header
        parts = line.split()
        if len(parts) < 10:
            continue
        try:
            local, remote, state = parts[1], parts[2], int(parts[3], 16)
            inode = int(parts[9])
        except (ValueError, IndexError):
            continue
        if state != TCP_ESTABLISHED or inode == 0:
            continue
        try:
            saddr, sport = _parse_hex_addr(local)
            daddr, dport = _parse_hex_addr(remote)
        except ValueError:
            continue
        out[inode] = (saddr, sport, daddr, dport)
    return out


def read_fd_socket_inodes(proc_root: str | os.PathLike, pid: int) -> dict[int, int]:
    """/proc/<pid>/fd/* symlinks → {fd: socket inode}
    (getInodes, sock_num_line.go:352-383)."""
    out: dict[int, int] = {}
    fd_dir = Path(proc_root) / str(pid) / "fd"
    try:
        entries = os.listdir(fd_dir)
    except OSError:
        return out
    for name in entries:
        try:
            fd = int(name)
            target = os.readlink(fd_dir / name)
        except (ValueError, OSError):
            continue
        m = _SOCKET_LINK.match(target)
        if m:
            out[fd] = int(m.group(1))
    return out


def list_pids(proc_root: str | os.PathLike) -> list[int]:
    try:
        return sorted(int(d) for d in os.listdir(proc_root) if d.isdigit())
    except OSError:
        return []


def backfill_socket_lines(
    store: SocketLineStore,
    pids: Iterable[int] | None = None,
    proc_root: str | os.PathLike = "/proc",
    now_ns: int = 0,
) -> int:
    """Seed socket lines for every established connection visible in
    procfs; returns the number of lines created. Called once at aggregator
    construction (createSocketLine fetch path, sock_num_line.go:399-429)."""
    created = 0
    if pids is None:
        pids = list_pids(proc_root)
    # every pid in a network namespace sees the identical tcp table; parse
    # each namespace once (hostNetwork nodes would otherwise re-parse a
    # 50k-socket table per process at startup)
    tables_by_ns: dict[object, dict[int, tuple[int, int, int, int]]] = {}
    for pid in pids:
        inodes = read_fd_socket_inodes(proc_root, pid)
        if not inodes:
            continue
        pid_dir = Path(proc_root) / str(pid)
        try:
            ns_key = os.stat(pid_dir / "ns" / "net").st_ino
        except OSError:
            ns_key = pid  # no ns info (fixtures): parse per pid
        table = tables_by_ns.get(ns_key)
        if table is None:
            try:
                table = parse_proc_net_tcp((pid_dir / "net" / "tcp").read_text())
            except OSError:
                continue
            tables_by_ns[ns_key] = table
        for fd, inode in inodes.items():
            conn = table.get(inode)
            if conn is None:
                continue
            saddr, sport, daddr, dport = conn
            line = store.get_or_create(pid, fd)
            line.add_value(
                now_ns,
                SockInfo(
                    pid=pid, fd=fd, saddr=saddr, sport=sport, daddr=daddr, dport=dport
                ),
            )
            created += 1
    return created
