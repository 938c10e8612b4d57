"""Structured logging — the zerolog analog (reference log/log.go).

Honors the same env contract: ``LOG_LEVEL`` (debug|info|warn|error),
``DISABLE_LOGS``, and ``LOG_CONTEXT_KEY`` (filter log records to a single
pid context, log.go:55-75).
"""

from __future__ import annotations

import logging
import os
import sys

_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}


class _PidContextFilter(logging.Filter):
    """When LOG_CONTEXT_KEY is set, only pass records whose ``pid`` extra
    matches — the log.go:55-75 behavior."""

    def __init__(self, pid: str):
        super().__init__()
        self.pid = pid

    def filter(self, record: logging.LogRecord) -> bool:
        pid = getattr(record, "pid", None)
        return pid is None or str(pid) == self.pid


def get_logger(name: str = "alaz_tpu") -> logging.Logger:
    logger = logging.getLogger(name)
    if getattr(logger, "_alaz_configured", False):
        return logger
    logger._alaz_configured = True  # type: ignore[attr-defined]

    if os.environ.get("DISABLE_LOGS", "").lower() in ("1", "true"):
        logger.addHandler(logging.NullHandler())
        logger.propagate = False
        return logger

    level = _LEVELS.get(os.environ.get("LOG_LEVEL", "info").lower(), logging.INFO)
    logger.setLevel(level)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(
            logging.Formatter(
                '{"ts":"%(asctime)s","level":"%(levelname)s","logger":"%(name)s","msg":"%(message)s"}'
            )
        )
        logger.addHandler(h)
    ctx = os.environ.get("LOG_CONTEXT_KEY")
    if ctx:
        logger.addFilter(_PidContextFilter(ctx))
    logger.propagate = False
    return logger


logger = get_logger()
