"""CRI runtime client — the cri/cri.go analog (G20).

The reference talks CRI gRPC to the container runtime over candidate
unix sockets under /proc/1/root (containerd/crio/cri-dockerd,
cri.go:24-26), lists running containers, and resolves container → pids
via ContainerStatus's verbose info (main pid) plus a cgroup.procs walk
(cri.go:160-233). This is the from-scratch equivalent: a minimal
gRPC-over-HTTP/2 unary client built on the repo's own HTTP/2 framing and
HPACK codec (protocols/http2.py, protocols/hpack.py) and a hand-rolled
protobuf wire codec for the three CRI v1 RPCs used (Version,
ListContainers, ContainerStatus). Field numbers follow the public
kubernetes cri-api runtime/v1 api.proto.

``CriContainerLister`` adapts the client to the ContainerIndex lister
seam (sources/containers.py), so live nodes populate the index the same
way test fixtures do.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import threading
from pathlib import Path
from typing import Iterator, List, Optional

from alaz_tpu_torch.logging import get_logger
from alaz_tpu_torch.protocols import hpack, http2
from alaz_tpu_torch.sources.containers import ContainerInfo, cgroup_pids

log = get_logger("alaz_tpu.cri")

# cri.go:24-26 candidate endpoints (host root via /proc/1/root)
DEFAULT_RUNTIME_SOCKETS = [
    "/proc/1/root/run/k3s/containerd/containerd.sock",
    "/proc/1/root/run/containerd/containerd.sock",
    "/proc/1/root/var/run/containerd/containerd.sock",
    "/proc/1/root/var/run/crio/crio.sock",
    "/proc/1/root/run/crio/crio.sock",
    "/proc/1/root/run/cri-dockerd.sock",
    "/proc/1/root/var/run/cri-dockerd.sock",
]

RUNTIME_SERVICE = "/runtime.v1.RuntimeService"

# kubelet-standard container labels (ContainerStatus/ListContainers)
LABEL_POD_UID = "io.kubernetes.pod.uid"
LABEL_POD_NAME = "io.kubernetes.pod.name"
LABEL_POD_NAMESPACE = "io.kubernetes.pod.namespace"
LABEL_CONTAINER_NAME = "io.kubernetes.container.name"

CONTAINER_STATE_RUNNING = 1  # pb.ContainerState_CONTAINER_RUNNING


# ---------------------------------------------------------------------------
# Minimal protobuf wire codec
# ---------------------------------------------------------------------------


def _uv(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def pb_varint(field: int, value: int) -> bytes:
    return _uv(field << 3 | 0) + _uv(value)


def pb_len(field: int, data: bytes) -> bytes:
    return _uv(field << 3 | 2) + _uv(len(data)) + data


def pb_str(field: int, s: str) -> bytes:
    return pb_len(field, s.encode("utf-8"))


def pb_fields(data: bytes) -> Iterator[tuple[int, int, int | bytes]]:
    """Walk protobuf wire fields → (field_no, wire_type, value). Varints
    yield ints; length-delimited yield bytes; fixed32/64 yield ints."""
    off = 0
    n = len(data)
    while off < n:
        key = 0
        shift = 0
        while True:
            if off >= n:
                return
            b = data[off]
            off += 1
            key |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        field, wt = key >> 3, key & 0x7
        if wt == 0:
            val = 0
            shift = 0
            while True:
                if off >= n:
                    return
                b = data[off]
                off += 1
                val |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            yield field, wt, val
        elif wt == 2:
            ln = 0
            shift = 0
            while True:
                if off >= n:
                    return
                b = data[off]
                off += 1
                ln |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            if off + ln > n:
                return
            yield field, wt, data[off : off + ln]
            off += ln
        elif wt == 1:
            if off + 8 > n:
                return
            yield field, wt, int.from_bytes(data[off : off + 8], "little")
            off += 8
        elif wt == 5:
            if off + 4 > n:
                return
            yield field, wt, int.from_bytes(data[off : off + 4], "little")
            off += 4
        else:  # groups (3/4): unsupported/legacy — stop rather than misparse
            return


def pb_map_entry(data: bytes) -> tuple[str, str]:
    """map<string,string> entry {key=1, value=2}."""
    k = v = ""
    for field, wt, val in pb_fields(data):
        if wt != 2:
            continue
        if field == 1:
            k = bytes(val).decode("utf-8", "replace")
        elif field == 2:
            v = bytes(val).decode("utf-8", "replace")
    return k, v


# ---------------------------------------------------------------------------
# gRPC unary client over a unix socket (HTTP/2 + HPACK from this repo)
# ---------------------------------------------------------------------------


class GrpcError(Exception):
    pass


class GrpcUnixClient:
    """Blocking unary-call gRPC client. One HTTP/2 connection, odd stream
    ids, HPACK via the repo codec; handles SETTINGS/PING/WINDOW_UPDATE
    bookkeeping and grpc-status trailers."""

    def __init__(self, socket_path: str, timeout_s: float = 10.0):
        self.socket_path = socket_path
        self.timeout_s = timeout_s
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.settimeout(timeout_s)
        self._sock.connect(socket_path)
        self._init_conn()

    def _init_conn(self) -> None:
        """Shared post-connect setup (TCP subclass reuses everything but
        the dial)."""
        self._enc = hpack.Encoder()
        self._dec = hpack.Decoder()
        self._buf = b""
        self._next_stream = 1
        self._lock = threading.Lock()
        self._sock.sendall(http2.MAGIC + http2.build_frame(http2.FRAME_SETTINGS, 0, 0))

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def _read_frame(self) -> http2.Frame:
        while True:
            if len(self._buf) >= 9:
                length = int.from_bytes(self._buf[:3], "big")
                if len(self._buf) >= 9 + length:
                    f = http2.parse_frame_header(self._buf)
                    self._buf = self._buf[9 + length :]
                    return f
            chunk = self._sock.recv(65536)
            if not chunk:
                raise GrpcError("connection closed by runtime")
            self._buf += chunk

    def call(self, path: str, request: bytes) -> bytes:
        """One unary RPC: returns the response message bytes (after the
        5-byte gRPC frame header); raises GrpcError on non-zero
        grpc-status."""
        with self._lock:
            stream_id = self._next_stream
            self._next_stream += 2
            headers = self._enc.encode(
                [
                    (":method", "POST"),
                    (":scheme", "http"),
                    (":path", path),
                    (":authority", "localhost"),
                    ("content-type", "application/grpc"),
                    ("te", "trailers"),
                ]
            )
            grpc_frame = b"\x00" + struct.pack("!I", len(request)) + request
            self._sock.sendall(  # alazlint: disable=ALZ011 -- the lock IS the RPC serializer: one in-flight unary call per h2 connection (shared _buf/_next_stream/hpack state); no thread does lock-free work
                http2.build_frame(
                    http2.FRAME_HEADERS, http2.FLAG_END_HEADERS, stream_id, headers
                )
                + http2.build_frame(
                    http2.FRAME_DATA, http2.FLAG_END_STREAM, stream_id, grpc_frame
                )
            )
            body = b""
            grpc_status: Optional[int] = None
            grpc_message = ""
            while True:
                f = self._read_frame()
                if f.type == http2.FRAME_SETTINGS:
                    if not f.flags & 0x1:  # ack theirs
                        self._sock.sendall(  # alazlint: disable=ALZ011 -- see above: whole-RPC lock is this client's serialization design
                            http2.build_frame(http2.FRAME_SETTINGS, 0x1, 0)
                        )
                    continue
                if f.type == http2.FRAME_PING:
                    if not f.flags & 0x1:
                        self._sock.sendall(  # alazlint: disable=ALZ011 -- see above: whole-RPC lock is this client's serialization design
                            http2.build_frame(http2.FRAME_PING, 0x1, 0, f.payload)
                        )
                    continue
                if f.type == http2.FRAME_GOAWAY:
                    raise GrpcError(f"GOAWAY from runtime: {f.payload[:64]!r}")
                if f.type == http2.FRAME_RST_STREAM and f.stream_id == stream_id:
                    raise GrpcError("stream reset by runtime")
                if f.stream_id != stream_id:
                    continue  # WINDOW_UPDATE etc. for other streams
                if f.type == http2.FRAME_HEADERS:
                    try:
                        for name, value in self._dec.decode(http2.headers_block(f)):
                            if name == "grpc-status":
                                grpc_status = int(value)
                            elif name == "grpc-message":
                                grpc_message = value
                    except hpack.HpackError as exc:
                        raise GrpcError(f"bad response headers: {exc}")
                elif f.type == http2.FRAME_DATA:
                    body += f.payload
                    if f.length:
                        # replenish flow-control windows (conn + stream)
                        inc = struct.pack("!I", f.length)
                        self._sock.sendall(  # alazlint: disable=ALZ011 -- see above: whole-RPC lock is this client's serialization design
                            http2.build_frame(http2.FRAME_WINDOW_UPDATE, 0, 0, inc)
                            + http2.build_frame(
                                http2.FRAME_WINDOW_UPDATE, 0, stream_id, inc
                            )
                        )
                if f.flags & http2.FLAG_END_STREAM:
                    break
            if grpc_status not in (None, 0):
                raise GrpcError(f"grpc-status {grpc_status}: {grpc_message}")
            if len(body) < 5:
                return b""
            if body[0] != 0:
                raise GrpcError("compressed gRPC responses unsupported")
            (msg_len,) = struct.unpack("!I", body[1:5])
            return body[5 : 5 + msg_len]


class GrpcTcpClient(GrpcUnixClient):
    """Same unary client over TCP (the libtpu runtime-metrics service
    listens on localhost:8431 — runtime/tpu_env.py)."""

    def __init__(self, host: str, port: int, timeout_s: float = 10.0):
        self.timeout_s = timeout_s
        self._sock = socket.create_connection((host, port), timeout=timeout_s)
        self._init_conn()


# ---------------------------------------------------------------------------
# CRI v1 typed surface
# ---------------------------------------------------------------------------


class CriContainer:
    __slots__ = ("id", "name", "pod_uid", "pod_name", "pod_namespace")

    def __init__(self, id: str, name: str, pod_uid: str, pod_name: str, pod_namespace: str):
        self.id = id
        self.name = name
        self.pod_uid = pod_uid
        self.pod_name = pod_name
        self.pod_namespace = pod_namespace


class CriClient:
    """Typed CRI v1 RuntimeService calls (the internalapi.RuntimeService
    subset the reference uses)."""

    def __init__(self, socket_path: str, timeout_s: float = 10.0):
        self.socket_path = socket_path
        self._grpc = GrpcUnixClient(socket_path, timeout_s)

    def close(self) -> None:
        self._grpc.close()

    def version(self) -> str:
        """VersionResponse.runtime_name/runtime_version — the probe RPC."""
        resp = self._grpc.call(f"{RUNTIME_SERVICE}/Version", pb_str(1, "v1"))
        name = ver = ""
        for field, wt, val in pb_fields(resp):
            if wt != 2:
                continue
            if field == 2:
                name = bytes(val).decode("utf-8", "replace")
            elif field == 3:
                ver = bytes(val).decode("utf-8", "replace")
        return f"{name} {ver}".strip()

    def list_containers(self) -> List[CriContainer]:
        """ListContainers(filter: state=RUNNING) (cri.go:100-120)."""
        # ListContainersRequest{filter=1{ContainerFilter: state=2{state=1}}}
        req = pb_len(1, pb_len(2, pb_varint(1, CONTAINER_STATE_RUNNING)))
        resp = self._grpc.call(f"{RUNTIME_SERVICE}/ListContainers", req)
        out: List[CriContainer] = []
        for field, wt, val in pb_fields(resp):
            if field != 1 or wt != 2:
                continue
            cid = cname = ""
            labels: dict[str, str] = {}
            for f2, w2, v2 in pb_fields(bytes(val)):
                if f2 == 1 and w2 == 2:
                    cid = bytes(v2).decode("utf-8", "replace")
                elif f2 == 3 and w2 == 2:  # ContainerMetadata{name=1}
                    for f3, w3, v3 in pb_fields(bytes(v2)):
                        if f3 == 1 and w3 == 2:
                            cname = bytes(v3).decode("utf-8", "replace")
                elif f2 == 8 and w2 == 2:  # labels map entry
                    k, v = pb_map_entry(bytes(v2))
                    labels[k] = v
            out.append(
                CriContainer(
                    id=cid,
                    name=labels.get(LABEL_CONTAINER_NAME, cname),
                    pod_uid=labels.get(LABEL_POD_UID, ""),
                    pod_name=labels.get(LABEL_POD_NAME, ""),
                    pod_namespace=labels.get(LABEL_POD_NAMESPACE, ""),
                )
            )
        return out

    def container_status(self, container_id: str) -> tuple[int, str, dict[str, str]]:
        """ContainerStatus(id, verbose=True) → (main pid, log_path, labels)
        (cri.go:160-190: pid comes from the verbose info JSON)."""
        req = pb_str(1, container_id) + pb_varint(2, 1)
        resp = self._grpc.call(f"{RUNTIME_SERVICE}/ContainerStatus", req)
        pid = 0
        log_path = ""
        labels: dict[str, str] = {}
        for field, wt, val in pb_fields(resp):
            if wt != 2:
                continue
            if field == 1:  # ContainerStatus
                for f2, w2, v2 in pb_fields(bytes(val)):
                    if f2 == 15 and w2 == 2:
                        log_path = bytes(v2).decode("utf-8", "replace")
                    elif f2 == 12 and w2 == 2:
                        k, v = pb_map_entry(bytes(v2))
                        labels[k] = v
            elif field == 2:  # info map
                k, v = pb_map_entry(bytes(val))
                if k == "info":
                    try:
                        pid = int(json.loads(v).get("pid", 0))
                    except (ValueError, TypeError):
                        pid = 0
        return pid, log_path, labels


def probe_runtime_socket(
    candidates: Optional[List[str]] = None, timeout_s: float = 2.0
) -> Optional[str]:
    """First candidate socket that answers the Version RPC (cri.go:39-63);
    CRI_RUNTIME_ENDPOINT env takes priority."""
    paths = list(candidates) if candidates is not None else list(DEFAULT_RUNTIME_SOCKETS)
    env = os.environ.get("CRI_RUNTIME_ENDPOINT", "")
    if env:
        paths.insert(0, env.removeprefix("unix://"))
    for path in paths:
        try:
            if not Path(path).exists():
                continue
        except OSError:  # /proc/1/root may deny traversal in containers
            continue
        try:
            client = CriClient(path, timeout_s=timeout_s)
            try:
                ver = client.version()
            finally:
                client.close()
            log.info(f"connected to CRI at {path} ({ver})")
            return path
        except (OSError, GrpcError) as exc:
            log.debug(f"CRI probe {path} failed: {exc}")
    return None


class CriContainerLister:
    """ContainerIndex lister over a CRI socket: container → main pid via
    verbose status, then the pid's cgroup walked for the full pid set
    (cri.go:192-233), log path prefixed with the host root."""

    def __init__(
        self,
        socket_path: str,
        host_root: str = "/proc/1/root",
        timeout_s: float = 10.0,
    ):
        self.socket_path = socket_path
        self.host_root = host_root.rstrip("/")
        self.timeout_s = timeout_s
        self._client: Optional[CriClient] = None

    def _get_client(self) -> CriClient:
        if self._client is None:
            self._client = CriClient(self.socket_path, self.timeout_s)
        return self._client

    def close(self) -> None:
        if self._client is not None:
            self._client.close()
            self._client = None

    def _pids_for(self, main_pid: int) -> set[int]:
        """Main pid → every pid in its cgroup (v2: /sys/fs/cgroup<path>;
        v1: memory controller), read through the host root."""
        if main_pid <= 0:
            return set()
        pids: set[int] = set()
        cgroup_file = Path(self.host_root) / "proc" / str(main_pid) / "cgroup"
        try:
            lines = cgroup_file.read_text().splitlines()
        except OSError:
            return pids
        for line in lines:
            parts = line.split(":", 2)
            if len(parts) != 3:
                continue
            hierarchy, controllers, cpath = parts
            if hierarchy == "0":  # cgroup v2
                procs = f"{self.host_root}/sys/fs/cgroup{cpath}/cgroup.procs"
            elif "memory" in controllers.split(","):
                procs = f"{self.host_root}/sys/fs/cgroup/memory{cpath}/cgroup.procs"
            else:
                continue
            pids |= cgroup_pids(procs)
        if not pids:
            pids = {main_pid}
        return pids

    def __call__(self) -> List[ContainerInfo]:
        client = self._get_client()
        try:
            containers = client.list_containers()
        except (OSError, GrpcError):
            self.close()  # reconnect next sync
            raise
        out: List[ContainerInfo] = []
        for c in containers:
            try:
                pid, log_path, _labels = client.container_status(c.id)
            except (OSError, GrpcError) as exc:
                log.warning(f"container status {c.id[:12]} failed: {exc}")
                continue
            out.append(
                ContainerInfo(
                    container_id=c.id,
                    name=c.name,
                    namespace=c.pod_namespace or "default",
                    pod_uid=c.pod_uid,
                    pids=self._pids_for(pid),
                    log_path=f"{self.host_root}{log_path}" if log_path else "",
                )
            )
        return out
