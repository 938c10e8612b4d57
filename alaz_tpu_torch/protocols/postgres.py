"""Postgres wire protocol classify + parse.

Kernel side: client Q/X and P/B+Sync detection, server response →
COMMAND_COMPLETE / ERROR_RESPONSE (ebpf/c/postgres.c:104-208). Userspace:
SQL statement extraction incl. the extended-protocol prepared-statement
cache (aggregator/data.go:1474-1556).
"""

from __future__ import annotations

import struct

from alaz_tpu_torch.events.schema import PostgresMethod
from alaz_tpu_torch.protocols.sql import contains_sql_keywords

COMMAND_COMPLETE = 1
ERROR_RESPONSE = 2


def classify_request(buf: bytes) -> int:
    """→ PostgresMethod value or 0; postgres.c:104-151 semantics."""
    if len(buf) < 5:
        return 0
    ident = buf[0:1]
    (length,) = struct.unpack_from("!I", buf, 1)
    if ident == b"X" and length == 4:
        return PostgresMethod.CLOSE_OR_TERMINATE
    if ident == b"Q":
        return PostgresMethod.SIMPLE_QUERY
    if ident in (b"P", b"B"):
        # distinguish from the HTTP/2 magic ('PRI * ...') by requiring a
        # trailing Sync message: 'S' + int32(4)
        tail = buf[-5:]
        if tail == b"S\x00\x00\x00\x04":
            return PostgresMethod.EXTENDED_QUERY
    return 0


def parse_response(buf: bytes) -> int:
    """→ COMMAND_COMPLETE | ERROR_RESPONSE | 0; postgres.c:153-208."""
    if len(buf) < 5:
        return 0
    (length,) = struct.unpack_from("!I", buf, 1)
    if length + 1 > len(buf):
        return 0
    ident = buf[0:1]
    if ident == b"E":
        return ERROR_RESPONSE
    if ident in (b"t", b"T", b"D", b"C"):
        return COMMAND_COMPLETE
    return 0


def parse_command(
    payload: bytes,
    method: int,
    stmt_cache: dict[tuple[int, int, str], str] | None = None,
    pid: int = 0,
    fd: int = 0,
) -> str | None:
    """SQL text for the Request.path field, mirroring parsePostgresCommand
    (data.go:1474-1556). ``stmt_cache`` is the pgStmts analog keyed
    (pid, fd, stmt_name); pass the same dict across calls per aggregator.

    Returns None where the reference returns an error (caller drops path).
    """
    r = payload
    if method == PostgresMethod.SIMPLE_QUERY:
        if len(r) < 5:
            return None
        sql = r[5:].split(b"\x00", 1)[0].decode("latin-1")
        if not contains_sql_keywords(sql):
            return None
        return sql
    if method == PostgresMethod.EXTENDED_QUERY:
        if not r:
            return None
        ident = r[0:1]
        if ident == b"P":
            parts = r[5:].split(b"\x00")
            if len(parts) >= 2:
                stmt_name = parts[0].decode("latin-1")
                query = parts[1].decode("latin-1")
                if len(parts) == 2:  # query truncated by capture window
                    query += "..."
            else:
                return None
            if stmt_cache is not None:
                stmt_cache[(pid, fd, stmt_name)] = query
            return f"PREPARE {stmt_name} AS {query}"
        if ident == b"B":
            parts = r[5:].split(b"\x00")
            if len(parts) < 2:
                return None
            stmt_name = parts[1].decode("latin-1")
            query = (stmt_cache or {}).get((pid, fd, stmt_name), "")
            if not query:
                return f"EXECUTE {stmt_name} *values*"
            return query
        return None
    if method == PostgresMethod.CLOSE_OR_TERMINATE:
        return payload.split(b"\x00", 1)[0].decode("latin-1")
    return None
