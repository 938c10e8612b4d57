"""Kubernetes metadata source — the k8s/informer.go analog (G19).

Live mode mirrors the reference's 7 SharedInformers (informer.go:67-157):
per kind, a LIST seeds the state (emitted as UPDATEs), then a WATCH
stream translates ADDED/MODIFIED/DELETED into EventType.ADD/UPDATE/DELETE
— so deletions reach the cluster IP maps immediately instead of going
stale forever, and adds are not up to 2 minutes late. A full re-LIST
every ``resync_interval_s`` (informer.go:47: 120s) remains the fallback
for missed watch events. The transport is the repo's own minimal REST
client (``k8s_client``: LIST + chunked WATCH over the stdlib — the
client-go analog), discovered in-cluster via the serviceaccount
convention or pointed at any apiserver with ``api_server=``; the whole
loop (seed, rv tracking, 410 resume, error backoff, reconcile-deletes)
is exercised against a local fake apiserver in
tests/test_k8s_apiserver.py. The object→DTO translation layer is pure
functions over duck-typed objects, unit-tested with stubs
(tests/test_sources.py). Without an apiserver the source runs in
injected mode: tests and replay push messages through ``inject``. Pods
additionally fan out one CONTAINER message per container (pod.go:48-87).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Iterable, List, Optional

from alaz_tpu_torch.events.k8s import (
    Address,
    AddressIP,
    Container,
    DaemonSet,
    Deployment,
    Endpoints,
    EventType,
    K8sResourceMessage,
    Pod,
    ReplicaSet,
    ResourceType,
    Service,
    StatefulSet,
)
from alaz_tpu_torch.logging import get_logger
from alaz_tpu_torch.sources.k8s_client import (
    BuiltinWatch,
    ClusterConfig,
    K8sRestClient,
    KindEndpoint,
)

log = get_logger("alaz_tpu.k8s")

# all-namespaces collection paths, one per informer kind
KIND_PATHS = {
    ResourceType.POD: "/api/v1/pods",
    ResourceType.SERVICE: "/api/v1/services",
    ResourceType.ENDPOINTS: "/api/v1/endpoints",
    ResourceType.REPLICASET: "/apis/apps/v1/replicasets",
    ResourceType.DEPLOYMENT: "/apis/apps/v1/deployments",
    ResourceType.DAEMONSET: "/apis/apps/v1/daemonsets",
    ResourceType.STATEFULSET: "/apis/apps/v1/statefulsets",
}

_WATCH_KINDS = (
    ResourceType.POD,
    ResourceType.SERVICE,
    ResourceType.REPLICASET,
    ResourceType.DEPLOYMENT,
    ResourceType.ENDPOINTS,
    ResourceType.DAEMONSET,
    ResourceType.STATEFULSET,
)

# watch event type → EventType (informer Add/Update/Delete handlers)
WATCH_EVENT_MAP = {
    "ADDED": EventType.ADD,
    "MODIFIED": EventType.UPDATE,
    "DELETED": EventType.DELETE,
}


def fan_out_containers(msg: K8sResourceMessage) -> List[K8sResourceMessage]:
    """Pod message → [pod message, CONTAINER message per container]."""
    out = [msg]
    pod = msg.object
    if msg.resource_type == ResourceType.POD and isinstance(pod, Pod) and pod.image:
        out.append(
            K8sResourceMessage(
                ResourceType.CONTAINER,
                msg.event_type,
                Container(
                    name=pod.name, namespace=pod.namespace, pod_uid=pod.uid, image=pod.image
                ),
            )
        )
    return out


# ---------------------------------------------------------------------------
# Pure translation layer (client object → DTO) — stub-testable
# ---------------------------------------------------------------------------


def pod_from_obj(pod) -> Pod:
    return Pod(
        uid=pod.metadata.uid,
        name=pod.metadata.name,
        namespace=pod.metadata.namespace,
        ip=(pod.status.pod_ip or "") if pod.status else "",
        image=(
            pod.spec.containers[0].image
            if pod.spec and pod.spec.containers
            else ""
        ),
    )


def service_from_obj(svc) -> Service:
    spec = svc.spec
    return Service(
        uid=svc.metadata.uid,
        name=svc.metadata.name,
        namespace=svc.metadata.namespace,
        type=(spec.type or "") if spec else "",
        cluster_ip=(spec.cluster_ip or "") if spec else "",
        cluster_ips=list(getattr(spec, "cluster_i_ps", None) or []) if spec else [],
        ports=[
            (
                p.name or "",
                int(p.port),
                int(p.target_port or 0) if str(p.target_port or "").isdigit() else 0,
                p.protocol or "TCP",
            )
            for p in ((spec.ports if spec else None) or [])
        ],
    )


def endpoints_from_obj(ep) -> Endpoints:
    addresses = []
    for subset in ep.subsets or []:
        ips = [
            AddressIP(
                type="pod" if a.target_ref and a.target_ref.kind == "Pod" else "external",
                id=(a.target_ref.uid if a.target_ref else ""),
                name=(a.target_ref.name if a.target_ref else ""),
                namespace=ep.metadata.namespace,
                ip=a.ip,
            )
            for a in (subset.addresses or [])
        ]
        addresses.append(Address(ips=ips))
    return Endpoints(
        uid=ep.metadata.uid,
        name=ep.metadata.name,
        namespace=ep.metadata.namespace,
        addresses=addresses,
    )


def _workload_from_obj(obj, cls):
    kwargs = dict(
        uid=obj.metadata.uid, name=obj.metadata.name, namespace=obj.metadata.namespace
    )
    if cls in (ReplicaSet, Deployment) and getattr(obj.spec, "replicas", None) is not None:
        kwargs["replicas"] = int(obj.spec.replicas)
    return cls(**kwargs)


TRANSLATORS: dict[ResourceType, Callable] = {
    ResourceType.POD: pod_from_obj,
    ResourceType.SERVICE: service_from_obj,
    ResourceType.ENDPOINTS: endpoints_from_obj,
    ResourceType.REPLICASET: lambda o: _workload_from_obj(o, ReplicaSet),
    ResourceType.DEPLOYMENT: lambda o: _workload_from_obj(o, Deployment),
    ResourceType.DAEMONSET: lambda o: _workload_from_obj(o, DaemonSet),
    ResourceType.STATEFULSET: lambda o: _workload_from_obj(o, StatefulSet),
}


def translate_watch_event(kind: ResourceType, raw_event: dict) -> K8sResourceMessage | None:
    """One watch-stream event → K8sResourceMessage (the informer
    Add/Update/Delete handler body). Unknown event types (BOOKMARK, ERROR)
    return None."""
    etype = WATCH_EVENT_MAP.get(raw_event.get("type", ""))
    if etype is None:
        return None
    obj = raw_event.get("object")
    if obj is None or getattr(obj, "metadata", None) is None:
        return None
    try:
        dto = TRANSLATORS[kind](obj)
    except (AttributeError, TypeError, ValueError) as exc:
        log.warning(f"k8s translate failed for {kind}: {exc}")
        return None
    return K8sResourceMessage(kind, etype, dto)


def translate_list(kind: ResourceType, items) -> List[K8sResourceMessage]:
    """A LIST response's items → UPDATE messages (resync semantics)."""
    out = []
    for obj in items:
        msg = translate_watch_event(kind, {"type": "MODIFIED", "object": obj})
        if msg is not None:
            out.append(msg)
    return out


def reconcile_list(
    kind: ResourceType,
    msgs: List[K8sResourceMessage],
    known: dict[str, object],
) -> tuple[List[K8sResourceMessage], dict[str, object]]:
    """Diff a re-LIST against the previously-known objects and synthesize
    DELETEs for objects that vanished while the watch was down — the
    DeltaFIFO Replace semantics of a real informer. Without this, a pod
    deleted during a watch outage keeps its IP in the cluster maps
    forever. Returns (delete messages, new known map)."""
    new_known = {m.object.uid: m.object for m in msgs if getattr(m.object, "uid", "")}
    deletes = [
        K8sResourceMessage(kind, EventType.DELETE, dto)
        for uid, dto in known.items()
        if uid not in new_known
    ]
    return deletes, new_known


class K8sWatchSource:
    def __init__(
        self,
        exclude_namespaces: Iterable[str] = (),
        resync_interval_s: float = 120.0,
        in_cluster: bool = True,
        error_backoff_s: float = 5.0,
        api_server: Optional[str] = None,
        token: Optional[str] = None,
        token_file: Optional[str] = None,
        ca_file: Optional[str] = None,
    ):
        self.exclude = set(exclude_namespaces)
        self.resync_interval_s = resync_interval_s
        self.in_cluster = in_cluster
        self.error_backoff_s = error_backoff_s
        self.api_server = api_server
        self.token = token
        self.token_file = token_file
        self.ca_file = ca_file
        self._stop = threading.Event()
        # control-plane lifecycle only: appended in start(), joined in
        # stop(), both on the owner's thread — unlike ingest_server's
        # accept-loop-rebound list this is never touched by the workers
        self._threads: List[threading.Thread] = []
        # live watch streams: kind loops add/discard them concurrently
        # with stop()'s close sweep
        self._watches: set = set()  # guarded-by: self._watch_lock
        self._watch_lock = threading.Lock()
        self._client: Optional[K8sRestClient] = None
        self._service = None  # lockless-ok: attach-once publication in start() before the watch threads exist; readers null-check an atomic reference swap
        self.live = False

    # -- injected mode (tests / replay) ------------------------------------

    def inject(self, msg: K8sResourceMessage) -> None:
        if self._service is None or self._stop.is_set():
            return
        obj = msg.object
        ns = getattr(obj, "namespace", "")
        if ns and ns in self.exclude:
            return
        for m in fan_out_containers(msg):
            self._service.submit_k8s(m)

    # -- live mode ----------------------------------------------------------

    def start(self, service) -> None:
        self._service = service
        self._stop.clear()
        config = self._resolve_config()
        if config is None:
            log.info("no apiserver configured or discovered; k8s source in injected mode")
            return
        self.live = True
        listers = self._make_listers(config)
        for kind in _WATCH_KINDS:
            t = threading.Thread(
                target=self._kind_loop,
                args=(kind, listers[kind], self._watch_factory),
                name=f"alaz-k8s-{kind.value}",
                daemon=True,
            )
            t.start()
            self._threads.append(t)

    def _resolve_config(self) -> Optional[ClusterConfig]:
        """Explicit ``api_server`` beats in-cluster serviceaccount
        discovery (client-go rest.InClusterConfig order)."""
        if self.api_server is not None:
            return ClusterConfig(
                base_url=self.api_server,
                token=self.token,
                token_file=self.token_file,
                ca_file=self.ca_file,
            )
        if self.in_cluster:
            return ClusterConfig.in_cluster()
        return None

    def _make_listers(self, config: ClusterConfig) -> dict:
        self._client = K8sRestClient(config)
        return {
            kind: KindEndpoint(self._client, path) for kind, path in KIND_PATHS.items()
        }

    def _watch_factory(self) -> BuiltinWatch:
        """BuiltinWatch with source-level registration so stop() can close
        a stream blocked mid-read from another thread."""
        w = BuiltinWatch()
        with self._watch_lock:
            self._watches.add(w)
        # a kind loop past stop()'s registry drain would otherwise dial an
        # unstoppable stream; marking it stopped makes stream() a no-op
        if self._stop.is_set():
            w.stop()
        return w

    def _kind_loop(self, kind: ResourceType, lister, watch_factory=None) -> None:
        """One informer: LIST (seed + resync, with vanished-object DELETE
        reconciliation), then WATCH re-established from the last-seen
        resourceVersion until the resync deadline; only then re-LIST
        (informer.go:67-157; a LIST is the expensive call, so the stream's
        30s server timeout must NOT trigger one). A 410 Gone from the
        watch means the resourceVersion expired server-side — that IS a
        re-LIST trigger, taken immediately without the error backoff.
        ``watch_factory`` is the client seam: registered BuiltinWatch
        instances in live mode, protocol-faithful fakes in tests."""
        if watch_factory is None:
            watch_factory = BuiltinWatch

        known: dict[str, object] = {}
        while not self._stop.is_set():
            try:
                resp = lister(timeout_seconds=30)
                msgs = translate_list(kind, resp.items)
                deletes, known = reconcile_list(kind, msgs, known)
                for msg in deletes:
                    self.inject(msg)
                for msg in msgs:
                    self.inject(msg)
                rv = resp.metadata.resource_version
                deadline = time.monotonic() + self.resync_interval_s
                expired = False
                while (
                    not expired
                    and not self._stop.is_set()
                    and time.monotonic() < deadline
                ):
                    w = watch_factory()
                    try:
                        for raw in w.stream(
                            lister, resource_version=rv, timeout_seconds=30
                        ):
                            obj = raw.get("object")
                            new_rv = getattr(
                                getattr(obj, "metadata", None), "resource_version", None
                            )
                            if new_rv:
                                rv = new_rv
                            msg = translate_watch_event(kind, raw)
                            if msg is not None:
                                uid = getattr(msg.object, "uid", "")
                                if msg.event_type == EventType.DELETE:
                                    known.pop(uid, None)
                                elif uid:
                                    known[uid] = msg.object
                                self.inject(msg)
                            if self._stop.is_set():
                                break
                    except Exception as exc:
                        if getattr(exc, "status", None) == 410:
                            # expired rv: the server forgot this history
                            # window; re-seed via LIST right away
                            log.info(f"k8s watch {kind.value}: 410 Gone, re-listing")
                            expired = True
                        else:
                            raise
                    finally:
                        w.stop()
                        with self._watch_lock:
                            self._watches.discard(w)
                    # stream timeout: loop re-watches from the last rv
            except Exception as exc:
                if self._stop.is_set():
                    break  # teardown interrupted the call — not an error
                log.warning(f"k8s watch {kind.value} failed: {exc}")
                self._stop.wait(self.error_backoff_s)

    def stop(self) -> None:
        self._stop.set()
        # close live streams and in-flight LISTs so a loop blocked on a
        # quiet watch or a slow LIST unblocks now, not at socket timeout
        with self._watch_lock:
            watches = list(self._watches)
            self._watches.clear()
        for w in watches:
            w.stop()
        if self._client is not None:
            self._client.close_all()
        for t in self._threads:
            t.join(timeout=2)
        self._threads.clear()
