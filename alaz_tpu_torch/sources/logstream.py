"""Container log streaming — the logstreamer/ analog (G21).

The reference watches CRI log files with fsnotify, seeks preexisting files
to the end, and ships a metadata line + raw bytes over pooled TLS TCP
connections with a 1-byte liveness probe ('X' close marker, pool.go:24-45)
and a 10s container-poll reconcile (stream.go:324-430). The transport is a
pluggable connection factory: ``SocketConnection`` + ``dial`` below are
the production leg (TLS per stream.go:51-66 — but the CA comes from
env/config, not an embedded SaaS certificate), and tests use in-memory
sinks or a loopback TLS server. File watching is poll-based (inotify adds
a dependency for no behavioral difference at 10s reconcile granularity).
"""

from __future__ import annotations

import socket
import ssl
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

from alaz_tpu_torch.logging import get_logger

log = get_logger("alaz_tpu.logstream")


class Connection:
    """Minimal conn surface: send(bytes), alive() probe, close()."""

    def send(self, data: bytes) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def alive(self) -> bool:
        return True

    def close(self) -> None:
        pass


class SocketConnection(Connection):
    """A pooled TCP/TLS connection. ``alive()`` is the pool.go:24-45
    probe: read one byte under a 1 ms deadline — a timeout means the
    peer simply has nothing to say (alive), EOF or an error means dead,
    and the byte ``X`` is the server's explicit close marker. Sends
    carry a deadline too: a peer that accepted the conn but stopped
    reading (zero TCP window) must not wedge the shipper thread —
    timeout surfaces as a send failure and the conn is retired."""

    def __init__(self, sock: socket.socket, send_timeout_s: float = 60.0):
        self._sock = sock
        self._send_timeout_s = send_timeout_s

    def send(self, data: bytes) -> None:
        self._sock.settimeout(self._send_timeout_s)
        try:
            self._sock.sendall(data)
        finally:
            try:
                self._sock.settimeout(None)
            except OSError:
                pass

    def alive(self) -> bool:
        try:
            self._sock.settimeout(0.001)
            buf = self._sock.recv(1)
        except (TimeoutError, socket.timeout, ssl.SSLWantReadError, BlockingIOError):
            return True
        except OSError:
            return False
        finally:
            try:
                self._sock.settimeout(None)
            except OSError:
                pass
        if not buf:  # EOF: peer closed
            return False
        if buf == b"X":  # explicit close marker
            return False
        return True  # unexpected data on a send-only conn: ignore

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def _make_tls_context(ca_file: str | None) -> ssl.SSLContext:
    """CA resolution chain (the caCert.go embedded-bundle analog):
    an explicit ``ca_file`` pins a private CA; otherwise the system
    trust store, and when THAT is empty (slim containers routinely ship
    no /etc/ssl bundle — the situation the reference embeds its CA for)
    fall back to certifi's bundled roots if importable. A context with
    zero CAs would otherwise fail every handshake with a misleading
    verify error."""
    ctx = ssl.create_default_context(cafile=ca_file)
    if ca_file is None and not ctx.get_ca_certs():
        try:
            import certifi

            ctx.load_verify_locations(cafile=certifi.where())
        except Exception:  # noqa: BLE001 - no bundle anywhere: leave as-is
            pass
    return ctx


def dial(
    host: str,
    port: int,
    use_tls: bool = True,
    ca_file: str | None = None,
    server_name: str | None = None,
    timeout_s: float = 60.0,
) -> SocketConnection:
    """Production connection factory body (stream.go:81-105: 60 s dial
    timeout, TLS by default). ``ca_file`` pins a private CA; None falls
    back to the system trust store, then certifi's bundled roots
    (_make_tls_context — the analog of the reference's embedded SaaS CA,
    caCert.go, generalized to any backend)."""
    if use_tls:
        # build the context BEFORE dialing: a bad ca_file path must not
        # leak an established TCP fd per attempt
        ctx = _make_tls_context(ca_file)
    raw = socket.create_connection((host, port), timeout=timeout_s)
    if not use_tls:
        raw.settimeout(None)
        return SocketConnection(raw)
    try:
        wrapped = ctx.wrap_socket(raw, server_hostname=server_name or host)
    except BaseException:
        raw.close()
        raise
    wrapped.settimeout(None)
    return SocketConnection(wrapped)


def factory_from_env(env=None) -> Callable[[], Connection]:
    """Build the dial factory from the reference's env surface:
    LOG_BACKEND (host:port), LOG_BACKEND_TLS (default true),
    LOG_BACKEND_SERVER_NAME, plus LOG_BACKEND_CA_FILE for the CA pin
    (stream.go:51-66,76-124). All accept the ALAZ_TPU_ prefix like every
    other knob (config.lookup_env)."""
    from alaz_tpu_torch.config import lookup_env, parse_bool

    backend = lookup_env("LOG_BACKEND", "", env) or ""
    if not backend or ":" not in backend:
        raise ValueError("LOG_BACKEND must be host:port")
    host, _, port_s = backend.rpartition(":")
    port = int(port_s)
    use_tls = parse_bool(lookup_env("LOG_BACKEND_TLS", None, env), True)
    ca_file = lookup_env("LOG_BACKEND_CA_FILE", None, env) or None
    server_name = lookup_env("LOG_BACKEND_SERVER_NAME", None, env) or None

    def factory() -> Connection:
        return dial(host, port, use_tls=use_tls, ca_file=ca_file, server_name=server_name)

    return factory


class ConnectionPool:
    """Channel-style pool with liveness checks (pool.go semantics): get()
    pops a pooled conn, discarding dead ones; put() returns it."""

    def __init__(self, factory: Callable[[], Connection], max_size: int = 4):
        self.factory = factory
        self.max_size = max_size
        self._pool: List[Connection] = []  # guarded-by: self._lock
        self._lock = threading.Lock()
        self.created = 0  # guarded-by: self._lock
        self.discarded = 0  # guarded-by: self._lock

    def get(self) -> Connection:
        """Pop a live pooled conn, else dial. The ``alive()`` probe is a
        1 ms socket read — real I/O, so it runs OUTSIDE the lock (ALZ011
        in spirit: a stack of dead conns would otherwise stall every
        thread contending for the pool behind serial probe timeouts)."""
        while True:
            with self._lock:
                if not self._pool:
                    break
                conn = self._pool.pop()
            if conn.alive():
                return conn
            with self._lock:
                self.discarded += 1
            conn.close()
        with self._lock:
            self.created += 1
        return self.factory()

    def put(self, conn: Connection) -> None:
        # probe before taking the lock (same I/O-outside-lock rule);
        # worst case a racing put overfills by a probe's width and the
        # length re-check under the lock closes the extra conn
        if conn.alive():
            with self._lock:
                if len(self._pool) < self.max_size:
                    self._pool.append(conn)
                    return
        conn.close()

    def close(self) -> None:
        with self._lock:
            for c in self._pool:
                c.close()
            self._pool.clear()


@dataclass
class _Tail:
    path: Path
    pos: int
    meta: dict = field(default_factory=dict)


class LogStreamer:
    def __init__(
        self,
        pool: ConnectionPool,
        poll_interval_s: float = 10.0,
        read_interval_s: float = 0.5,
    ):
        self.pool = pool
        self.poll_interval_s = poll_interval_s
        self.read_interval_s = read_interval_s
        # watch/unwatch race the pump thread's snapshot
        self._tails: Dict[str, _Tail] = {}  # guarded-by: self._lock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.bytes_sent = 0  # guarded-by: self._lock

    def watch(self, key: str, path: str | Path, metadata: dict | None = None, from_start: bool = False) -> None:
        """Start tailing a log file; preexisting content is skipped
        (seek-to-end, stream.go:324-352) unless from_start."""
        p = Path(path)
        pos = 0
        if not from_start:
            try:
                pos = p.stat().st_size
            except OSError:
                pos = 0
        with self._lock:
            self._tails[key] = _Tail(path=p, pos=pos, meta=metadata or {})

    def unwatch(self, key: str) -> None:
        with self._lock:
            self._tails.pop(key, None)

    def pump_once(self) -> int:
        """Read new bytes from every tail and ship them; returns bytes sent."""
        sent = 0
        with self._lock:
            tails = list(self._tails.items())
        for key, tail in tails:
            try:
                size = tail.path.stat().st_size
            except OSError:
                continue
            if size < tail.pos:  # rotation: start over
                tail.pos = 0
            if size == tail.pos:
                continue
            with open(tail.path, "rb") as f:
                f.seek(tail.pos)
                data = f.read(size - tail.pos)
                new_pos = f.tell()
            if not data:
                continue
            header = (
                "**AlazLogs_" + "_".join(str(v) for v in ([key] + list(tail.meta.values()))) + "\n"
            ).encode()
            conn = self.pool.get()
            try:
                conn.send(header + data)
            except Exception as exc:
                # don't advance: the bytes re-send next pump; the failing
                # conn is closed, not re-pooled
                log.warning(f"log send failed for {key}: {exc}")
                conn.close()
                continue
            tail.pos = new_pos
            sent += len(data)
            self.pool.put(conn)
        with self._lock:
            self.bytes_sent += sent
        return sent

    def start(self, service=None) -> None:
        self._stop.clear()

        def run() -> None:
            while not self._stop.wait(self.read_interval_s):
                try:
                    self.pump_once()
                except Exception as exc:
                    log.warning(f"log pump failed: {exc}")

        self._thread = threading.Thread(target=run, name="alaz-logstream", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        self.pool.close()
