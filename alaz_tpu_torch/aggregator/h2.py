"""HTTP/2-gRPC request/response assembly — the G13 analog
(aggregator/data.go:533-810).

L7 events for HTTP2 carry raw frame bytes (the kernel forwards them
unparsed, l7.c:335-379,687-730). Per connection (pid, fd) we keep client-
and server-side HPACK decoders (data.go:93-103) and a stream table pairing
client HEADERS (:method, :path, :authority, content-type→gRPC) with server
HEADERS (:status, grpc-status) (data.go:705-800). Latency is server frame
write time − client frame write time (data.go:586,702). Half-arrived pairs
are reaped after one minute (data.go:551-571).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

from alaz_tpu_torch.protocols import hpack, http2

ONE_MINUTE_NS = 60_000_000_000


@dataclass
class _StreamState:
    stream_id: int
    method: str = ""
    path: str = ""
    authority: str = ""
    content_type: str = ""
    client_time_ns: int = 0
    status: int = 0
    grpc_status: int | None = None
    server_time_ns: int = 0
    has_client: bool = False
    has_server: bool = False


@dataclass
class _ConnState:
    client_decoder: hpack.Decoder = field(default_factory=hpack.Decoder)
    server_decoder: hpack.Decoder = field(default_factory=hpack.Decoder)
    streams: dict[int, _StreamState] = field(default_factory=dict)
    # header block spanning HEADERS + CONTINUATION frames, per direction:
    # (stream_id, accumulated block, first frame time) until END_HEADERS
    client_partial: tuple[int, bytes, int] | None = None
    server_partial: tuple[int, bytes, int] | None = None


@dataclass
class CompletedH2Request:
    pid: int
    fd: int
    stream_id: int
    method: str
    path: str
    authority: str
    is_grpc: bool
    status: int
    grpc_status: int | None
    start_time_ns: int
    latency_ns: int
    tls: bool


class Http2Assembler:
    """Thread-safe: feed() runs on the l7 worker while reap() runs on the
    housekeeping ticker."""

    def __init__(self) -> None:
        self._conns: dict[tuple[int, int], _ConnState] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _set_partial(conn: _ConnState, is_client: bool, value) -> None:
        if is_client:
            conn.client_partial = value
        else:
            conn.server_partial = value

    def _conn(self, pid: int, fd: int) -> _ConnState:
        key = (pid, fd)
        st = self._conns.get(key)
        if st is None:
            st = _ConnState()
            self._conns[key] = st
        return st

    def feed(
        self,
        pid: int,
        fd: int,
        is_client: bool,
        payload: bytes,
        write_time_ns: int,
        tls: bool = False,
    ) -> list[CompletedH2Request]:
        """Feed one captured frame buffer; returns any completed requests."""
        with self._lock:
            return self._feed_locked(pid, fd, is_client, payload, write_time_ns, tls)

    def _feed_locked(self, pid, fd, is_client, payload, write_time_ns, tls) -> list[CompletedH2Request]:
        conn = self._conn(pid, fd)
        done: list[CompletedH2Request] = []
        for frame in http2.iter_frames(payload):
            if len(frame.payload) < frame.length:
                # truncated by the capture window — also drop any pending
                # partial: a later CONTINUATION would assemble a block with
                # a missing middle chunk and desync the HPACK table
                self._set_partial(conn, is_client, None)
                continue
            # header blocks may span HEADERS + CONTINUATION frames; hold the
            # partial block per direction until END_HEADERS
            partial = conn.client_partial if is_client else conn.server_partial
            if frame.type == http2.FRAME_HEADERS:
                block = http2.headers_block(frame)
                stream_id = frame.stream_id
                block_time_ns = write_time_ns
            elif frame.type == http2.FRAME_CONTINUATION and partial is not None:
                stream_id, acc, block_time_ns = partial
                if stream_id != frame.stream_id:
                    # interleaved continuation for a different stream is a
                    # protocol error; drop the partial
                    self._set_partial(conn, is_client, None)
                    continue
                block = acc + frame.payload
            else:
                continue
            if not frame.flags & http2.FLAG_END_HEADERS:
                self._set_partial(conn, is_client, (stream_id, block, block_time_ns))
                continue
            self._set_partial(conn, is_client, None)
            decoder = conn.client_decoder if is_client else conn.server_decoder
            try:
                headers = decoder.decode(block)
            except hpack.HpackError:
                continue
            stream = conn.streams.get(stream_id)
            if stream is None:
                stream = _StreamState(stream_id)
                conn.streams[stream_id] = stream
            if is_client:
                stream.has_client = True
                stream.client_time_ns = block_time_ns
                for name, value in headers:
                    if name == ":method":
                        stream.method = value
                    elif name == ":path":
                        stream.path = value
                    elif name == ":authority":
                        stream.authority = value
                    elif name == "content-type":
                        stream.content_type = value
            else:
                # any server HEADERS frame completes the server side, even
                # without a decodable :status — the reference flags
                # ServerHeadersFrameArrived unconditionally (data.go:775-777)
                stream.has_server = True
                stream.server_time_ns = block_time_ns
                for name, value in headers:
                    if name == ":status":
                        try:
                            stream.status = int(value)
                        except ValueError:
                            pass
                    elif name == "grpc-status":
                        try:
                            stream.grpc_status = int(value)
                        except ValueError:
                            pass
            if stream.has_client and stream.has_server:
                done.append(
                    CompletedH2Request(
                        pid=pid,
                        fd=fd,
                        stream_id=stream.stream_id,
                        method=stream.method,
                        path=stream.path,
                        authority=stream.authority,
                        is_grpc=stream.content_type.startswith("application/grpc"),
                        status=stream.status,
                        grpc_status=stream.grpc_status,
                        start_time_ns=stream.client_time_ns,
                        latency_ns=max(0, stream.server_time_ns - stream.client_time_ns),
                        tls=tls,
                    )
                )
                del conn.streams[stream_id]
        return done

    def remove_conn(self, pid: int, fd: int) -> None:
        """Tear down one connection's state on TCP CLOSED — the reference
        deletes h2Parsers on close (data.go:363-380); without this a reused
        (pid, fd) inherits a desynced HPACK table from the prior
        connection."""
        with self._lock:
            self._conns.pop((pid, fd), None)

    def remove_pid(self, pid: int) -> None:
        """Tear down all of a pid's connections on process EXIT
        (data.go:486-494)."""
        with self._lock:
            doomed = [k for k in self._conns if k[0] == pid]
            for k in doomed:
                del self._conns[k]

    def conn_count(self) -> int:
        with self._lock:
            return len(self._conns)

    def reap(self, now_ns: int) -> int:
        """Drop half-arrived pairs older than a minute (data.go:551-571)."""
        with self._lock:
            return self._reap_locked(now_ns)

    def _reap_locked(self, now_ns: int) -> int:
        dropped = 0
        for conn in self._conns.values():
            doomed = [
                sid
                for sid, s in conn.streams.items()
                if max(s.client_time_ns, s.server_time_ns) + ONE_MINUTE_NS < now_ns
            ]
            for sid in doomed:
                del conn.streams[sid]
                dropped += 1
            # stale partial header blocks age out the same way
            for attr in ("client_partial", "server_partial"):
                partial = getattr(conn, attr)
                if partial is not None and partial[2] + ONE_MINUTE_NS < now_ns:
                    setattr(conn, attr, None)
                    dropped += 1
        return dropped
