"""L7 protocol classifiers and parsers.

This package is the userspace re-realization of the reference's kernel-side
classifiers (ebpf/c/{http,http2,postgres,mysql,mongo,redis,kafka,amqp}.c,
SURVEY §2.1 N5-N12) plus its userspace payload post-parsers
(aggregator/data.go:508-531,1431-1617 and aggregator/kafka/, G13-G15).

Two call surfaces:

- ``classify_request(buf)`` / per-protocol ``parse_response(buf)`` — given a
  raw payload, detect protocol + method the way the kernel programs do on
  write-syscall entry. Used by the trace replayer and by parity tests; the
  simulator emits pre-classified events so the hot path never touches bytes.
- richer post-parsers (HTTP path/host, SQL statement extraction with
  prepared-statement caches, Mongo section walk, Kafka record decode) used
  by the aggregator to fill ``Request.path``-style fields.

Classification order follows the kernel's write-path chain
(ebpf/c/l7.c:248-384): HTTP, Postgres, Redis (ping then command, unless a
pong), Kafka, AMQP publish, MySQL, Mongo, and HTTP2 frames **last** (the
frame check is permissive, so everything else must win first).
"""

from __future__ import annotations

from alaz_tpu_torch.events.schema import L7Protocol

from alaz_tpu_torch.protocols import amqp, http, http2, kafka, mongo, mysql, postgres, redis


def classify_request(buf: bytes) -> tuple[int, int]:
    """Classify a request payload → (protocol, method) the way
    process_enter_of_syscalls_write_sendto does (l7.c:248-384).

    Returns (L7Protocol.UNKNOWN, 0) when nothing matches.
    """
    m = http.parse_method(buf)
    if m > 0:
        return (L7Protocol.HTTP, m)
    m = postgres.classify_request(buf)
    if m > 0:
        return (L7Protocol.POSTGRES, m)
    if redis.is_ping(buf):
        return (L7Protocol.REDIS, 3)
    if not redis.is_pong(buf) and redis.is_command(buf):
        return (L7Protocol.REDIS, 1)
    ok, _corr, _key, _ver = kafka.parse_request_header(buf)
    if ok:
        return (L7Protocol.KAFKA, 0)  # method resolved in userspace decode
    m = amqp.classify_request(buf)
    if m > 0:
        return (L7Protocol.AMQP, m)
    m, _stmt = mysql.classify_request(buf)
    if m > 0:
        return (L7Protocol.MYSQL, m)
    m = mongo.classify_request(buf)
    if m > 0:
        return (L7Protocol.MONGO, m)
    if http2.is_frame(buf):
        return (L7Protocol.HTTP2, http2.CLIENT_FRAME)
    return (L7Protocol.UNKNOWN, 0)


__all__ = [
    "classify_request",
    "http",
    "http2",
    "postgres",
    "mysql",
    "mongo",
    "redis",
    "kafka",
    "amqp",
]
