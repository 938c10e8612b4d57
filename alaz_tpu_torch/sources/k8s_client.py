"""Minimal from-scratch Kubernetes REST client: LIST + WATCH.

The reference vendors client-go for its informers (k8s/informer.go:67-157);
this repo's pattern is from-scratch protocol clients over the stdlib
(cf. sources/cri.py's gRPC/HTTP-2 stack). The surface here is exactly
what the informer loop needs and nothing more:

- ``KindEndpoint(client, path)`` — a lister: ``endpoint(timeout_seconds=30)``
  issues an all-namespaces LIST and returns the decoded object list.
- ``BuiltinWatch().stream(lister, resource_version=, timeout_seconds=)`` —
  a WATCH stream from a resourceVersion, yielding ``{"type", "object"}``
  events, the same shape kubernetes.watch.Watch yields.

Decoded JSON is wrapped in :class:`JsonObj`, an attribute shim that maps
the kubernetes-client snake_case attribute convention onto raw camelCase
API keys (``pod.status.pod_ip`` → ``status.podIP``) so the pure
translation layer in ``k8s_watch`` is client-agnostic.

In-cluster discovery follows the serviceaccount convention the reference
relies on via client-go's rest.InClusterConfig: KUBERNETES_SERVICE_HOST /
_PORT plus the mounted token and CA under
/var/run/secrets/kubernetes.io/serviceaccount.
"""

from __future__ import annotations

import json
import os
import socket as socket_module
import ssl
import threading
from dataclasses import dataclass
from http.client import HTTPConnection, HTTPSConnection
from pathlib import Path
from typing import Iterator, Optional
from urllib.parse import urlencode, urlsplit

from alaz_tpu_torch.logging import get_logger

log = get_logger("alaz_tpu.k8s_client")

SERVICEACCOUNT_ROOT = "/var/run/secrets/kubernetes.io/serviceaccount"


class ApiException(Exception):
    """HTTP or in-stream API error; ``status`` carries the code the
    informer loop dispatches on (410 Gone → immediate re-LIST)."""

    def __init__(self, status: int, reason: str = ""):
        super().__init__(f"k8s api error {status}: {reason}")
        self.status = status
        self.reason = reason


def _normalize(name: str) -> str:
    return name.replace("_", "").lower()


class JsonObj:
    """Attribute access over a decoded JSON dict, matching keys by
    case/underscore-insensitive name so both the kubernetes client's
    snake_case (``resource_version``, ``cluster_i_ps``) and the wire's
    camelCase (``resourceVersion``, ``clusterIPs``) resolve. Missing
    attributes are None — the translators treat absent fields as empty.
    """

    __slots__ = ("_data", "_keys")

    def __init__(self, data: dict):
        self._data = data
        self._keys = {_normalize(k): k for k in data}

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        key = self._keys.get(_normalize(name))
        if key is None:
            return None
        return _wrap(self._data[key])

    def __repr__(self) -> str:  # debug aid only
        return f"JsonObj({self._data!r})"


def _wrap(value):
    if isinstance(value, dict):
        return JsonObj(value)
    if isinstance(value, list):
        return [_wrap(v) for v in value]
    return value


@dataclass
class ClusterConfig:
    base_url: str
    token: Optional[str] = None
    # read per-request, not once: bound serviceaccount tokens expire and
    # the kubelet rotates the file in place (client-go re-reads it too)
    token_file: Optional[str] = None
    ca_file: Optional[str] = None

    def bearer_token(self) -> Optional[str]:
        if self.token_file:
            try:
                return Path(self.token_file).read_text().strip()
            except OSError:
                return self.token
        return self.token

    @staticmethod
    def in_cluster(sa_root: str = SERVICEACCOUNT_ROOT) -> Optional["ClusterConfig"]:
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        if not host:
            return None
        token_path = Path(sa_root) / "token"
        ca_path = Path(sa_root) / "ca.crt"
        if ":" in host:  # IPv6 service host needs brackets in a URL
            host = f"[{host}]"
        return ClusterConfig(
            base_url=f"https://{host}:{port}",
            token_file=str(token_path) if token_path.exists() else None,
            ca_file=str(ca_path) if ca_path.exists() else None,
        )


class K8sRestClient:
    """One client per source; a fresh connection per request so the seven
    kind loops can share it across threads (http.client connections are
    not thread-safe, and at one LIST/WATCH per 30s per kind, connection
    reuse buys nothing)."""

    def __init__(self, config: ClusterConfig):
        self.config = config
        parts = urlsplit(config.base_url)
        self._https = parts.scheme == "https"
        self._host = parts.hostname or "localhost"
        self._port = parts.port or (443 if self._https else 80)
        # live LIST connections, so close_all() can interrupt a thread
        # parked in a blocking read at informer teardown
        self._live: set = set()
        self._live_lock = threading.Lock()
        self._closed = False

    def _track(self, conn) -> None:
        with self._live_lock:
            if self._closed:
                conn.close()
                raise ApiException(499, "client closed")
            self._live.add(conn)

    def _untrack(self, conn) -> None:
        with self._live_lock:
            self._live.discard(conn)

    def close_all(self) -> None:
        """Shut down every in-flight LIST so blocked reads unblock now;
        subsequent requests fail fast with status 499."""
        with self._live_lock:
            self._closed = True
            conns = list(self._live)
            self._live.clear()
        for conn in conns:
            sock = getattr(conn, "sock", None)
            if sock is not None:
                try:
                    sock.shutdown(socket_module.SHUT_RDWR)
                except OSError:
                    pass
            try:
                conn.close()
            except OSError:  # pragma: no cover - already dead
                pass

    def _connect(self, timeout_s: float):
        if self._https:
            # no ca_file → system trust store; never downgrade to
            # CERT_NONE — the bearer token rides these connections
            ctx = ssl.create_default_context(cafile=self.config.ca_file)
            return HTTPSConnection(self._host, self._port, timeout=timeout_s, context=ctx)
        return HTTPConnection(self._host, self._port, timeout=timeout_s)

    def _headers(self) -> dict:
        headers = {"Accept": "application/json"}
        token = self.config.bearer_token()
        if token:
            headers["Authorization"] = f"Bearer {token}"
        return headers

    def list(self, path: str, timeout_seconds: int = 30) -> JsonObj:
        with self._live_lock:
            if self._closed:  # fail fast BEFORE dialing — close_all()
                raise ApiException(499, "client closed")  # can't interrupt a dial
        query = urlencode({"timeoutSeconds": timeout_seconds})
        conn = self._connect(timeout_seconds + 5)
        conn.auto_open = 0
        try:
            conn.connect()
            self._track(conn)
            try:
                conn.request("GET", f"{path}?{query}", headers=self._headers())
                resp = conn.getresponse()
                body = resp.read()
            finally:
                self._untrack(conn)
            if resp.status != 200:
                raise ApiException(resp.status, body[:200].decode("utf-8", "replace"))
            return JsonObj(json.loads(body))
        finally:
            conn.close()


class KindEndpoint:
    """Lister for one resource kind across all namespaces. Carries the
    path + client so BuiltinWatch can open the matching watch stream from
    the lister alone — the same introspection trick kubernetes.watch
    plays on its bound API methods."""

    def __init__(self, client: K8sRestClient, path: str):
        self.client = client
        self.path = path

    def __call__(self, timeout_seconds: int = 30) -> JsonObj:
        return self.client.list(self.path, timeout_seconds=timeout_seconds)


class BuiltinWatch:
    """One WATCH stream: chunked GET with ?watch=1, newline-delimited
    JSON events. ``stop()`` closes the socket from another thread, which
    unblocks a reader waiting on a quiet stream (informer teardown)."""

    def __init__(self):
        self._conn = None
        self._sock = None
        self._lock = threading.Lock()
        self._stopped = False

    def stream(
        self, lister: KindEndpoint, resource_version: str, timeout_seconds: int = 30
    ) -> Iterator[dict]:
        client = lister.client
        query = urlencode(
            {
                "watch": "1",
                "resourceVersion": resource_version or "",
                "timeoutSeconds": timeout_seconds,
                "allowWatchBookmarks": "false",
            }
        )
        with self._lock:
            if self._stopped:
                return
        conn = client._connect(timeout_seconds + 5)
        # without this, a stop() racing the dial is defeated by
        # http.client's auto_open: request() on the closed conn silently
        # re-dials and streams anyway
        conn.auto_open = 0
        try:
            conn.connect()  # outside the lock: a slow dial must not block stop()
        except Exception:
            if self._stopped:
                return
            raise
        with self._lock:
            if self._stopped:  # stop() ran while we were dialing
                conn.close()
                return
            self._conn = conn
            self._sock = conn.sock
        try:
            try:
                conn.request("GET", f"{lister.path}?{query}", headers=client._headers())
                resp = conn.getresponse()
            except Exception:
                if self._stopped:
                    return  # stop() raced the dial — orderly teardown
                raise
            if resp.status != 200:
                raise ApiException(
                    resp.status, resp.read()[:200].decode("utf-8", "replace")
                )
            while True:
                try:
                    line = resp.readline()
                except TimeoutError:
                    # quiet stream past the socket deadline: the server
                    # missed its own timeoutSeconds close. Treat as a
                    # stream end — the informer re-watches from the last
                    # rv instead of backing off.
                    return
                except Exception:
                    # stop() shut the socket down under us — orderly
                    # teardown, not a stream error
                    if self._stopped:
                        return
                    raise
                if not line:
                    return  # server closed the stream (watch timeout)
                line = line.strip()
                if not line:
                    continue
                event = json.loads(line)
                if event.get("type") == "ERROR":
                    status = (event.get("object") or {}).get("code", 0)
                    raise ApiException(
                        int(status or 500),
                        (event.get("object") or {}).get("message", "watch error"),
                    )
                obj = event.get("object")
                yield {
                    "type": event.get("type", ""),
                    "object": JsonObj(obj) if isinstance(obj, dict) else obj,
                }
        finally:
            self.stop()

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            if self._sock is not None:
                # close() alone does not unblock a recv() parked in
                # another thread; shutdown() does
                try:
                    self._sock.shutdown(socket_module.SHUT_RDWR)
                except OSError:
                    pass
                self._sock = None
            if self._conn is not None:
                try:
                    self._conn.close()
                except OSError:  # pragma: no cover - already dead
                    pass
                self._conn = None
