"""Socket ingest plane for out-of-process agents — the process boundary
of SURVEY §2.3 P8 (the reference's kernel↔userspace perf-buffer seam,
re-drawn as agent↔service).

INTEGRATION.md's contract is "ship the event dtypes as raw bytes over
any transport"; this is that transport: a length-prefixed binary frame
protocol over a unix or TCP socket that a C/C++/Go agent can emit with
one writev per batch and zero serialization (numpy structured arrays are
fixed-layout).

Frame layout (little-endian, 16-byte header):

    u32 magic   = 0x414C5A31  ("ALZ1")
    u8  kind    = 1 l7 | 2 tcp | 3 proc | 4 native (AlzRecord rows)
    u8  tenant  = tenant id (ISSUE 14); 0 = the primary/legacy tenant
    u8  _pad[2]
    u32 count   = number of records
    u32 length  = payload bytes (must equal count * itemsize)
    ...payload  = `count` packed records of the kind's dtype

The tenant byte occupies what was header padding, which legacy agents
zero-fill — so a pre-tenancy frame IS a tenant-0 frame byte for byte
and recorded traces replay unchanged. Frames route to the service's
per-tenant ingest partition (``submit_*(…, tenant=)``); a tenant id the
service has no partition for is refused at the door — its rows land in
the service's dedicated REFUSED ledger (cause ``filtered``, surfaced as
``degraded_snapshot()["refused"]`` + ``ingest.unknown_tenant``), never
in any tenant's conservation books and never silently folded into
another tenant's stream. The byte is unauthenticated like
the rest of the header: deployments multiplexing mutually untrusted
fleets must terminate per-tenant transport (one socket per fleet, or a
TLS sidecar) in front of this listener.

kind 4 bypasses the aggregator: records are the 32-byte AlzRecord wire
format (graph/native.py) for pre-attributed edges pushed straight at the
windowed graph store — the "native fast path" of INTEGRATION.md over a
socket instead of in-process ctypes.

Malformed frames QUARANTINE instead of killing the connection (ISSUE 6,
ARCHITECTURE §3j): a frame whose header parses but whose payload is
inconsistent (count*itemsize != length, unknown kind) is counted and
skipped — the framing is intact, so the stream just continues. A frame
whose HEADER is garbage (bad magic, absurd length) means framing is
lost: the reader resyncs by scanning the byte stream for the next frame
magic and resumes there. A healthy agent behind one corrupted frame
keeps its connection; rows in quarantined frames land in the service's
drop ledger (cause ``quarantined``) when their count is readable.
Backpressure follows the service contract: submit_* drop-not-block, so
a flooding agent loses events rather than stalling the socket reader
into TCP backpressure.
"""

from __future__ import annotations

import socket
import struct
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from alaz_tpu_torch.events.schema import (
    L7_EVENT_DTYPE,
    PROC_EVENT_DTYPE,
    TCP_EVENT_DTYPE,
)
from alaz_tpu_torch.logging import get_logger

log = get_logger("alaz_tpu.ingest_server")

MAGIC = 0x414C5A31
# Public: the 16-byte frame header IS the wire contract out-of-process
# agents compile against (agent_example.cc FrameHeader). alazspec pins
# its size/format in resources/specs/wire_layouts.json (ALZ021). The
# tenant byte (ISSUE 14) sits in the old pad region: same 16 bytes,
# legacy zero-filled frames parse as tenant 0.
FRAME_HEADER = struct.Struct("<IBB2xII")

KIND_L7 = 1
KIND_TCP = 2
KIND_PROC = 3
KIND_NATIVE = 4

_KIND_DTYPE = {
    KIND_L7: L7_EVENT_DTYPE,
    KIND_TCP: TCP_EVENT_DTYPE,
    KIND_PROC: PROC_EVENT_DTYPE,
}

MAX_FRAME_BYTES = 64 * 1024 * 1024  # one frame must fit in memory comfortably

# the 4 magic bytes as they appear on the wire (little-endian), the
# resync scanner's needle
_MAGIC_BYTES = struct.pack("<I", MAGIC)

# per-connection garbage budgets: quarantine/resync keep a healthy
# agent's stream alive through the occasional corrupted frame, but an
# agent streaming endless garbage is hostile or broken — past either
# budget the connection drops (the pre-ISSUE-6 defense, restored with
# margins). Bytes bound the unframeable-garbage scan; the frame count
# bounds the well-framed-but-malformed flood (valid magic/length,
# inconsistent count or unknown kind), which never touches the scanner.
MAX_RESYNC_BYTES_PER_CONN = 16 * 1024 * 1024
MAX_QUARANTINED_FRAMES_PER_CONN = 64


def pack_frame(kind: int, batch: np.ndarray, tenant: int = 0) -> bytes:
    """Client-side helper: one event batch → one wire frame. ``tenant``
    names the fleet this batch belongs to (0 = primary/legacy)."""
    from alaz_tpu_torch.events.schema import MAX_TENANTS

    if not 0 <= tenant < MAX_TENANTS:
        raise ValueError(f"tenant must be in [0, {MAX_TENANTS}); got {tenant}")
    payload = np.ascontiguousarray(batch).tobytes()
    return (
        FRAME_HEADER.pack(MAGIC, kind, tenant, batch.shape[0], len(payload))
        + payload
    )


class IngestServer:
    """Accepts agent connections and feeds their frames into a Service.

    ``path`` starts a unix-domain listener; ``port`` a TCP one (use the
    loopback/TLS-terminating sidecar of your deployment for anything
    off-host — the reference's log streamer does the same)."""

    def __init__(
        self,
        service,
        path: str | Path | None = None,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        self.service = service
        self.frames = 0  # guarded-by: self._state_lock
        self.records = 0  # guarded-by: self._state_lock
        self.bad_frames = 0  # guarded-by: self._state_lock
        self.unsupported_frames = 0  # guarded-by: self._state_lock
        # ISSUE 6 quarantine/resync plane: frames rejected while keeping
        # the connection, resync scans performed, and garbage bytes
        # skipped while hunting for the next frame magic
        self.quarantined_frames = 0  # guarded-by: self._state_lock
        self.resyncs = 0  # guarded-by: self._state_lock
        self.resync_bytes = 0  # guarded-by: self._state_lock
        # rows in quarantined frames attribute to the service's unified
        # drop ledger when it has one (and their count field is readable)
        self._ledger = getattr(service, "ledger", None)
        self._state_lock = threading.Lock()
        self._stop = threading.Event()
        # the accept loop rebinds/appends while stop() iterates — the
        # list must live under the state lock (alazlint ALZ010 finding,
        # fixed in ISSUE 2: a join missed mid-rebind leaked the thread)
        self._threads: list[threading.Thread] = []  # guarded-by: self._state_lock
        self._unix_path: Optional[Path] = None
        if path is not None:
            self._unix_path = Path(path)
            self.address: str | tuple = str(path)
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            if self._unix_path.exists():
                # A stale socket file from a previous run blocks bind —
                # but only unlink if nothing answers: silently stealing a
                # LIVE instance's listener would redirect its agents here.
                probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                try:
                    probe.settimeout(0.5)
                    probe.connect(str(path))
                except (ConnectionRefusedError, FileNotFoundError):
                    # nothing accepting: stale file from a dead process.
                    # missing_ok: a concurrently-restarting sibling may
                    # have reclaimed it first — bind() then reports the
                    # conflict cleanly
                    self._unix_path.unlink(missing_ok=True)
                except (socket.timeout, BlockingIOError):
                    # a full backlog on a stalled-but-live listener shows
                    # as EAGAIN (BlockingIOError; AF_UNIX connect under
                    # settimeout is non-blocking) or as a timeout —
                    # ambiguity must favor NOT stealing
                    self._sock.close()
                    raise OSError(
                        f"ingest socket {path} did not answer a connect "
                        "probe but may be live (backlog full?); refusing "
                        "to steal it — remove the file manually if stale"
                    ) from None
                else:
                    self._sock.close()
                    raise OSError(
                        f"ingest socket {path} is in use by a live process; "
                        "refusing to steal its listener"
                    )
                finally:
                    probe.close()
            self._sock.bind(str(path))
        else:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._sock.bind((host, port))
            self.address = self._sock.getsockname()
        self._sock.listen(16)
        self._sock.settimeout(0.2)
        # KIND_NATIVE needs the C++ ring (push_records); the numpy store
        # doesn't speak the wire record format
        store = getattr(service, "graph_store", None)
        self._native_store = store if hasattr(store, "push_records") else None
        # separate warn-once latches: the two native-frame refusal modes
        # have different operator fixes, and the first firing must not
        # silence the other's diagnostic
        self._warned_no_native = False
        self._warned_tenant_native = False

    def start(self) -> None:
        # self-register observability like every other component
        metrics = getattr(self.service, "metrics", None)
        if metrics is not None:
            metrics.gauge("ingest_socket.frames", lambda: self.frames)  # alazlint: disable=ALZ010 -- racy int read is a metrics gauge; GIL-atomic, momentarily stale at worst
            metrics.gauge("ingest_socket.records", lambda: self.records)  # alazlint: disable=ALZ010 -- racy gauge read, see above
            metrics.gauge("ingest_socket.bad_frames", lambda: self.bad_frames)  # alazlint: disable=ALZ010 -- racy gauge read, see above
            metrics.gauge(
                "ingest_socket.unsupported_frames", lambda: self.unsupported_frames  # alazlint: disable=ALZ010 -- racy gauge read, see above
            )
            metrics.gauge(
                "ingest_socket.quarantined_frames", lambda: self.quarantined_frames  # alazlint: disable=ALZ010 -- racy gauge read, see above
            )
            metrics.gauge("ingest_socket.resyncs", lambda: self.resyncs)  # alazlint: disable=ALZ010 -- racy gauge read, see above
        t = threading.Thread(target=self._accept_loop, name="alaz-ingest-accept", daemon=True)
        t.start()
        with self._state_lock:
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        if self._unix_path is not None:
            try:
                self._unix_path.unlink()
            except OSError:
                pass
        # drain in rounds: the accept loop may append one last connection
        # thread between our snapshot and its own _stop check — joining
        # the accept thread (in the first round) serializes that append,
        # so the next round's snapshot is guaranteed to see it
        while True:
            with self._state_lock:
                threads = list(self._threads)
                self._threads.clear()
            if not threads:
                break
            for t in threads:  # join OUTSIDE the lock: the accept loop takes it
                t.join(timeout=2)

    # -- internals -----------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError as exc:
                if self._stop.is_set():
                    return  # shutdown closed the listener
                # transient accept failure (EMFILE under connection
                # floods, ECONNABORTED): keep the listener alive
                log.warning(f"accept failed: {exc}")
                self._stop.wait(0.1)
                continue
            t = threading.Thread(
                target=self._serve_conn, args=(conn,), name="alaz-ingest-conn", daemon=True
            )
            t.start()
            # track only live connections (per-batch clients would
            # otherwise grow this list without bound)
            with self._state_lock:
                self._threads = [x for x in self._threads if x.is_alive()]
                self._threads.append(t)

    def _recv_exact(
        self, conn: socket.socket, n: int, carry: bytes = b""
    ) -> tuple[Optional[bytearray], bytes]:
        """Read exactly n bytes into one preallocated buffer (no copies:
        struct.unpack and np.frombuffer consume the bytearray directly),
        consuming ``carry`` — bytes already pulled off the socket by a
        resync scan — first. Returns (buf, remaining_carry); buf is None
        when the stream ended."""
        buf = bytearray(n)
        view = memoryview(buf)
        got = 0
        if carry:
            take = min(n, len(carry))
            view[:take] = carry[:take]
            got = take
            carry = carry[take:]
        while got < n:
            try:
                k = conn.recv_into(view[got:], n - got)
            except socket.timeout:
                if self._stop.is_set():
                    return None, b""
                continue
            except OSError:
                return None, b""
            if k == 0:
                return None, b""
            got += k
        return buf, carry

    def _recv_some(self, conn: socket.socket, n: int) -> Optional[bytes]:
        """One bounded read (for the resync scanner); None on EOF/error."""
        while True:
            try:
                chunk = conn.recv(n)
            except socket.timeout:
                if self._stop.is_set():
                    return None
                continue
            except OSError:
                return None
            return chunk if chunk else None

    def _resync(
        self, conn: socket.socket, garbage: bytes, scanned_before: int
    ) -> tuple[Optional[bytes], int]:
        """Framing lost: scan the byte stream for the next frame magic.
        Returns ``(carry, scanned)`` where carry holds the bytes
        STARTING AT the magic (the next header read consumes them) and
        scanned is this scan's garbage byte count; carry is None when
        the stream ended first — or when the connection's cumulative
        garbage (``scanned_before`` + this scan) exceeds
        MAX_RESYNC_BYTES_PER_CONN: an agent that streams unframeable
        bytes without end gets dropped, not served a CPU spin. The scan
        starts at offset 1 of ``garbage`` — offset 0 is the header that
        just failed — and keeps a 3-byte tail between reads so a magic
        straddling a read boundary is found."""
        with self._state_lock:
            self.resyncs += 1
        budget = MAX_RESYNC_BYTES_PER_CONN - scanned_before
        scanned = 0
        buf = bytes(garbage)
        start = 1
        while True:
            idx = buf.find(_MAGIC_BYTES, start)
            if idx >= 0:
                scanned += idx
                with self._state_lock:
                    self.resync_bytes += idx
                return buf[idx:], scanned
            skipped = max(len(buf) - 3, 0)
            scanned += skipped
            with self._state_lock:
                self.resync_bytes += skipped
            if scanned >= budget:
                log.warning(
                    "resync budget exhausted "
                    f"({MAX_RESYNC_BYTES_PER_CONN} garbage bytes); "
                    "dropping connection"
                )
                return None, scanned
            tail = buf[-3:]
            chunk = self._recv_some(conn, 4096)
            if chunk is None:
                return None, scanned
            buf = tail + chunk
            start = 0

    @staticmethod
    def _rows_in(kind: int, length: int) -> Optional[int]:
        """Whole records the verified payload length can hold — the
        trusted row measure for ledger attribution (None for unknown
        kinds, whose record size we cannot know)."""
        if kind == KIND_NATIVE:
            from alaz_tpu_torch.graph.native import NATIVE_RECORD_DTYPE

            return length // NATIVE_RECORD_DTYPE.itemsize
        dtype = _KIND_DTYPE.get(kind)
        return None if dtype is None else length // dtype.itemsize

    def _quarantine(self, count: Optional[int], why: str) -> None:
        """Account one rejected frame without dropping the connection."""
        with self._state_lock:
            self.bad_frames += 1
            self.quarantined_frames += 1
        if self._ledger is not None and count:
            self._ledger.add("quarantined", int(count), reason=why)
        log.warning(f"quarantined frame ({why}); stream continues")

    def _serve_conn(self, conn: socket.socket) -> None:
        conn.settimeout(0.5)
        carry = b""  # bytes a resync scan already pulled off the socket
        conn_garbage = 0  # cumulative resync-scanned bytes, this conn
        conn_quarantined = 0  # frames quarantined on this conn
        try:
            while not self._stop.is_set():
                if conn_quarantined > MAX_QUARANTINED_FRAMES_PER_CONN:
                    log.warning(
                        "quarantine budget exhausted "
                        f"({MAX_QUARANTINED_FRAMES_PER_CONN} frames); "
                        "dropping connection"
                    )
                    return
                header, carry = self._recv_exact(conn, FRAME_HEADER.size, carry)
                if header is None:
                    return
                magic, kind, tenant, count, length = FRAME_HEADER.unpack(header)
                if magic != MAGIC or length > MAX_FRAME_BYTES:
                    # header corruption: framing is lost — the count/
                    # length fields are untrustworthy, so no row count
                    # can be attributed; scan forward to the next magic
                    self._quarantine(None, "bad_header")
                    conn_quarantined += 1
                    carry, scanned = self._resync(
                        conn, bytes(header) + carry, conn_garbage
                    )
                    conn_garbage += scanned
                    if carry is None:
                        return
                    continue
                payload, carry = self._recv_exact(conn, length, carry)
                if payload is None:
                    return
                ok = self._dispatch(kind, count, payload, tenant)
                if ok is None:
                    # well-formed but unsupported here (native frame on a
                    # numpy-store service): config mismatch, not protocol
                    # corruption — keep the connection, drop the frame
                    with self._state_lock:
                        self.unsupported_frames += 1
                    continue
                if not ok:
                    # well-FRAMED but malformed payload (count/length
                    # mismatch, unknown kind): the boundary held, so the
                    # stream is still in sync — quarantine and continue.
                    # Rows attribute from the TRUSTED measure (payload
                    # bytes actually read / itemsize), never the count
                    # field — that field being wrong is why we're here,
                    # and a bit-flipped count must not poison the ledger
                    # with billions of phantom rows.
                    self._quarantine(
                        self._rows_in(kind, length), f"malformed_kind{kind}"
                    )
                    conn_quarantined += 1
                    continue
                with self._state_lock:
                    self.frames += 1
                    self.records += count
        finally:
            conn.close()

    def _dispatch(
        self, kind: int, count: int, payload: bytes | bytearray, tenant: int = 0
    ) -> bool | None:
        """True = accepted; False = malformed payload (quarantine the
        frame, keep the connection — framing held); None = well-formed
        but unsupported by this service's configuration."""
        if kind == KIND_NATIVE:
            from alaz_tpu_torch.graph.native import NATIVE_RECORD_DTYPE

            if count * NATIVE_RECORD_DTYPE.itemsize != len(payload):
                return False
            if tenant:
                # the C++ window accumulator is a single-tenant plane: a
                # tenant-tagged native frame has no partition to land in
                # (config mismatch, not protocol corruption)
                if not self._warned_tenant_native:
                    self._warned_tenant_native = True
                    log.warning(
                        "agent sent a tenant-tagged native frame; the "
                        "native ring is single-tenant — use the event "
                        "kinds for multi-tenant fleets"
                    )
                return None
            if self._native_store is None:
                if not self._warned_no_native:
                    self._warned_no_native = True
                    log.warning(
                        "agent sent native frames but the service runs the "
                        "numpy store — start with use_native_ingest=True "
                        "(and build libalaz_ingest.so) to accept them"
                    )
                return None
            rows = np.frombuffer(payload, dtype=NATIVE_RECORD_DTYPE)
            # pre-attributed edges go straight into the native ring
            self._native_store.push_records(rows)
            return True
        dtype = _KIND_DTYPE.get(kind)
        if dtype is None or count * dtype.itemsize != len(payload):
            return False
        batch = np.frombuffer(payload, dtype=dtype)
        # tenant routing (ISSUE 14): tagged frames name their partition
        # explicitly; untagged (legacy) frames take the positional path
        # so pre-tenancy service duck-types keep working unchanged
        if kind == KIND_L7:
            if tenant:
                self.service.submit_l7(batch, tenant=tenant)
            else:
                self.service.submit_l7(batch)
        elif kind == KIND_TCP:
            if tenant:
                self.service.submit_tcp(batch, tenant=tenant)
            else:
                self.service.submit_tcp(batch)
        else:
            if tenant:
                self.service.submit_proc(batch, tenant=tenant)
            else:
                self.service.submit_proc(batch)
        return True


def send_batches(
    address: str | tuple, frames: list[tuple[int, np.ndarray]]
) -> None:
    """Client-side helper (tests / Python agents): connect, send, close."""
    if isinstance(address, str):
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    else:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.connect(address)
    try:
        for kind, batch in frames:
            sock.sendall(pack_frame(kind, batch))
    finally:
        sock.close()
