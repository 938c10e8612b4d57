"""SQL keyword gate shared by the Postgres and MySQL parsers.

The reference filters garbage payloads with a case-sensitive keyword regexp
(aggregator/data.go:120-127,1623-1626).
"""

from __future__ import annotations

import re

_KEYWORDS = [
    "SELECT",
    "INSERT INTO",
    "UPDATE",
    "DELETE FROM",
    "CREATE TABLE",
    "ALTER TABLE",
    "DROP TABLE",
    "TRUNCATE TABLE",
    "BEGIN",
    "COMMIT",
    "ROLLBACK",
    "SAVEPOINT",
    "CREATE INDEX",
    "DROP INDEX",
    "CREATE VIEW",
    "DROP VIEW",
    "GRANT",
    "REVOKE",
    "EXECUTE",
]

_RE = re.compile("|".join(_KEYWORDS))


def contains_sql_keywords(text: str) -> bool:
    return _RE.search(text) is not None
