"""MySQL client/server protocol classify + parse.

Kernel side: COM_QUERY/STMT_PREPARE/EXECUTE/CLOSE detection and OK/EOF/ERR
responses with prepared statement_id extraction (ebpf/c/mysql.c:39-99).
Userspace: SQL extraction + prepared-statement cache
(aggregator/data.go:1431-1472).
"""

from __future__ import annotations

import struct

from alaz_tpu_torch.events.schema import MySqlMethod
from alaz_tpu_torch.protocols.sql import contains_sql_keywords

COM_QUERY = 0x03
COM_STMT_PREPARE = 0x16
COM_STMT_EXECUTE = 0x17
COM_STMT_CLOSE = 0x19

RESPONSE_OK = 0x00
RESPONSE_EOF = 0xFE
RESPONSE_ERROR = 0xFF

STATUS_OK = 1
STATUS_FAILED = 2

_COM_TO_METHOD = {
    COM_QUERY: MySqlMethod.TEXT_QUERY,
    COM_STMT_PREPARE: MySqlMethod.PREPARE_STMT,
    COM_STMT_EXECUTE: MySqlMethod.EXEC_STMT,
    COM_STMT_CLOSE: MySqlMethod.STMT_CLOSE,
}


def classify_request(buf: bytes) -> tuple[int, int]:
    """→ (MySqlMethod value or 0, command byte); mysql.c:39-68. The packet
    length must cover the buffer exactly and sequence id must be 0."""
    if len(buf) < 5:
        return (0, 0)
    length = buf[0] | buf[1] << 8 | buf[2] << 16
    if length + 4 != len(buf) or buf[3] != 0:
        return (0, 0)
    method = _COM_TO_METHOD.get(buf[4])
    if method is None:
        return (0, 0)
    return (method, buf[4])


def parse_response(buf: bytes, request_method: int) -> tuple[int, int]:
    """→ (STATUS_OK | STATUS_FAILED | 0, statement_id); mysql.c:72-99."""
    if len(buf) < 5:
        return (0, 0)
    if buf[3] <= 0:  # sequence must be > 0
        return (0, 0)
    length = buf[0] | buf[1] << 8 | buf[2] << 16
    if length == 1 or buf[4] == RESPONSE_EOF:
        return (STATUS_OK, 0)
    if buf[4] == RESPONSE_OK:
        stmt_id = 0
        if request_method == MySqlMethod.PREPARE_STMT and len(buf) >= 9:
            (stmt_id,) = struct.unpack_from("<I", buf, 5)
        return (STATUS_OK, stmt_id)
    if buf[4] == RESPONSE_ERROR:
        return (STATUS_FAILED, 0)
    return (0, 0)


def parse_command(
    payload: bytes,
    method: int,
    stmt_cache: dict[tuple[int, int, int], str] | None = None,
    pid: int = 0,
    fd: int = 0,
    prep_stmt_id: int = 0,
) -> str | None:
    """SQL text for Request.path, mirroring parseMySQLCommand
    (data.go:1431-1472). ``stmt_cache`` is the mySqlStmts analog keyed
    (pid, fd, statement_id)."""
    if len(payload) < 5:
        return None
    r = payload[5:]
    if method == MySqlMethod.TEXT_QUERY:
        sql = r.split(b"\x00", 1)[0].decode("latin-1")
        if not contains_sql_keywords(sql):
            return None
        return sql
    if method == MySqlMethod.PREPARE_STMT:
        sql = r.split(b"\x00", 1)[0].decode("latin-1")
        if stmt_cache is not None:
            stmt_cache[(pid, fd, prep_stmt_id)] = sql
        return sql
    if method == MySqlMethod.EXEC_STMT:
        if len(r) < 4:
            return None
        (stmt_id,) = struct.unpack_from("<I", r, 0)
        query = (stmt_cache or {}).get((pid, fd, stmt_id), "")
        if not query:
            return f"EXECUTE {stmt_id} *values*"
        return query
    if method == MySqlMethod.STMT_CLOSE:
        if len(r) < 4:
            return None
        (stmt_id,) = struct.unpack_from("<I", r, 0)
        if stmt_cache is not None:
            stmt_cache.pop((pid, fd, stmt_id), None)
        return f"CLOSE STMT {stmt_id} "
    return None
