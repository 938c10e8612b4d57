"""Cluster metadata state — the aggregator/cluster.go + persist.go analog.

The reference keeps ``PodIPToPodUid`` / ``ServiceIPToServiceUid`` string
maps guarded by RWMutexes (cluster.go:15-16). Here the authoritative state
is a dict keyed by uint32 IP, compiled lazily into sorted numpy arrays so a
whole event batch resolves src/dst attribution with two ``searchsorted``
calls (the setFromToV2 analog, data.go:827-870).
"""

from __future__ import annotations

import threading

import numpy as np

from alaz_tpu_torch.datastore.dto import EP_OUTBOUND, EP_POD, EP_SERVICE
from alaz_tpu_torch.events.intern import Interner
from alaz_tpu_torch.events.k8s import (
    Endpoints,
    EventType,
    K8sResourceMessage,
    Pod,
    ResourceType,
    Service,
)
from alaz_tpu_torch.events.net import ip_to_u32


class _IpTable:
    """dict[u32 ip] -> int32 uid-id with a lazily compiled sorted-array view."""

    def __init__(self) -> None:
        self._map: dict[int, int] = {}  # guarded-by: self._lock
        self._dirty = True  # guarded-by: self._lock
        self._ips = np.zeros(0, dtype=np.uint32)  # guarded-by: self._lock
        self._uids = np.zeros(0, dtype=np.int32)  # guarded-by: self._lock
        self._lock = threading.Lock()

    def set(self, ip: int, uid_id: int) -> None:
        with self._lock:
            self._map[ip] = uid_id
            self._dirty = True

    def remove(self, ip: int) -> None:
        with self._lock:
            if self._map.pop(ip, None) is not None:
                self._dirty = True

    def _compile(self) -> tuple[np.ndarray, np.ndarray]:
        """Return a consistent (ips, uids) snapshot, recompiling if dirty."""
        with self._lock:
            if self._dirty:
                if self._map:
                    ips = np.fromiter(self._map.keys(), dtype=np.uint32, count=len(self._map))
                    uids = np.fromiter(self._map.values(), dtype=np.int32, count=len(self._map))
                    order = np.argsort(ips, kind="stable")
                    self._ips = ips[order]
                    self._uids = uids[order]
                else:
                    self._ips = np.zeros(0, dtype=np.uint32)
                    self._uids = np.zeros(0, dtype=np.int32)
                self._dirty = False
            return self._ips, self._uids

    def contains(self, ip: int) -> bool:
        # under the lock like every other _map access (alazrace ALZ050:
        # this read used to race the k8s fold's set/remove rehash)
        with self._lock:
            return ip in self._map

    def lookup(self, ips: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(found_mask, uid_ids) for a batch of uint32 IPs."""
        table_ips, table_uids = self._compile()
        if table_ips.size == 0:
            z = np.zeros(ips.shape[0], dtype=np.int32)
            return np.zeros(ips.shape[0], dtype=bool), z
        pos = np.searchsorted(table_ips, ips)
        pos = np.minimum(pos, table_ips.size - 1)
        found = table_ips[pos] == ips
        uids = np.where(found, table_uids[pos], np.int32(0))
        return found, uids

    def __len__(self) -> int:
        with self._lock:
            return len(self._map)


class ClusterInfo:
    """IP→identity attribution + the metadata pass-through to the datastore."""

    def __init__(self, interner: Interner):
        self.interner = interner
        self.pod_ips = _IpTable()
        self.svc_ips = _IpTable()
        # uid-id keyed object snapshots (for features + datastore
        # forward). The IP tables carry their own locks; these dicts
        # used to ride bare on "only the k8s fold writes them" — true
        # today, but the fold thread differs by mode (k8s worker serial,
        # the scatter caller sharded) and nothing stopped a reader from
        # growing on another role (alazrace ALZ050). One low-rate lock
        # per k8s EVENT — control plane, never the row path.
        self._meta_lock = threading.Lock()
        self.pods: dict[int, Pod] = {}  # guarded-by: self._meta_lock
        self.services: dict[int, Service] = {}  # guarded-by: self._meta_lock
        self._pod_uid_to_ip: dict[int, int] = {}  # guarded-by: self._meta_lock
        self._svc_uid_to_ips: dict[int, list[int]] = {}  # guarded-by: self._meta_lock

    # -- k8s event folding (persist.go:55-130 handler analog) --------------

    def handle_msg(self, msg: K8sResourceMessage) -> None:
        if msg.resource_type == ResourceType.POD:
            self._handle_pod(msg.event_type, msg.object)
        elif msg.resource_type == ResourceType.SERVICE:
            self._handle_service(msg.event_type, msg.object)
        elif msg.resource_type == ResourceType.ENDPOINTS:
            self._handle_endpoints(msg.event_type, msg.object)
        # ReplicaSet/Deployment/DaemonSet/StatefulSet/Container carry no IPs;
        # they flow straight through to the datastore (engine forwards them).

    def _handle_pod(self, event: EventType, pod: Pod) -> None:
        uid_id = self.interner.intern(pod.uid)
        # lock order: _meta_lock → _IpTable._lock (one direction — the
        # IP tables never call back into ClusterInfo)
        with self._meta_lock:
            old_ip = self._pod_uid_to_ip.get(uid_id)
            if event == EventType.DELETE:
                if old_ip is not None:
                    self.pod_ips.remove(old_ip)
                    self._pod_uid_to_ip.pop(uid_id, None)
                self.pods.pop(uid_id, None)
                return
            self.pods[uid_id] = pod
            if not pod.ip:
                return
            ip = ip_to_u32(pod.ip)
            if old_ip is not None and old_ip != ip:
                self.pod_ips.remove(old_ip)
            self.pod_ips.set(ip, uid_id)
            self._pod_uid_to_ip[uid_id] = ip

    def _handle_service(self, event: EventType, svc: Service) -> None:
        uid_id = self.interner.intern(svc.uid)
        with self._meta_lock:
            old_ips = self._svc_uid_to_ips.get(uid_id, [])
            if event == EventType.DELETE:
                for ip in old_ips:
                    self.svc_ips.remove(ip)
                self._svc_uid_to_ips.pop(uid_id, None)
                self.services.pop(uid_id, None)
                return
            self.services[uid_id] = svc
            ips = []
            candidates = list(svc.cluster_ips) if svc.cluster_ips else []
            if svc.cluster_ip and svc.cluster_ip not in candidates:
                candidates.append(svc.cluster_ip)
            for ip_s in candidates:
                if ip_s and ip_s not in ("None", ""):
                    try:
                        ips.append(ip_to_u32(ip_s))
                    except OSError:
                        continue
            for ip in old_ips:
                if ip not in ips:
                    self.svc_ips.remove(ip)
            for ip in ips:
                self.svc_ips.set(ip, uid_id)
            self._svc_uid_to_ips[uid_id] = ips

    def _handle_endpoints(self, event: EventType, ep: Endpoints) -> None:
        # Endpoints → pod-IP hints for pods scheduled before their informer
        # event landed (persist.go forwards them; we fold addresses in).
        if event == EventType.DELETE:
            return
        with self._meta_lock:
            for addr in ep.addresses:
                for aip in addr.ips:
                    if aip.type == "pod" and aip.ip and aip.id:
                        try:
                            ip = ip_to_u32(aip.ip)
                        except OSError:
                            continue
                        if self.pod_ips.contains(ip):
                            continue  # pod informer already owns this IP
                        uid_id = self.interner.intern(aip.id)
                        self.pod_ips.set(ip, uid_id)
                        # record ownership so a later pod DELETE cleans it up
                        self._pod_uid_to_ip.setdefault(uid_id, ip)

    # -- batch attribution (setFromToV2, data.go:827-870) ------------------

    def attribute(self, ips: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """For a batch of IPs → (ep_type, uid_id): pod first, then service,
        else outbound — the reference's resolution order. Large batches
        compress to unique IPs first: a 64k-row chunk usually carries a
        few hundred distinct addresses, so the interval lookups and masks
        run over those and rows resolve by one take each."""
        if ips.shape[0] > 2048:
            uniq, inverse = np.unique(ips, return_inverse=True)
            if uniq.shape[0] < ips.shape[0]:
                # the sort is paid either way — resolve over the uniques
                # whenever they compress the batch at all (straight to
                # the lookup body: uniq is already unique, re-running
                # this compression on it could only waste a second sort)
                ep_type, uid = self._attribute_direct(uniq)
                return ep_type[inverse], uid[inverse]
        return self._attribute_direct(ips)

    def compiled_tables(
        self,
    ) -> tuple[tuple[np.ndarray, np.ndarray], tuple[np.ndarray, np.ndarray]]:
        """((pod_ips, pod_uids), (svc_ips, svc_uids)) — the sorted-array
        snapshots the native L7 engine binary-searches. Recompiles swap in
        NEW arrays (never mutate in place), so handing these out without
        holding the table locks is safe; a stale snapshot is at most one
        k8s fold behind, same as the numpy lookup path."""
        return self.pod_ips._compile(), self.svc_ips._compile()

    def _attribute_direct(self, ips: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        pod_found, pod_uid = self.pod_ips.lookup(ips)
        svc_found, svc_uid = self.svc_ips.lookup(ips)
        ep_type = np.full(ips.shape[0], EP_OUTBOUND, dtype=np.uint8)
        ep_type[svc_found] = EP_SERVICE
        ep_type[pod_found] = EP_POD
        uid = np.where(pod_found, pod_uid, np.where(svc_found, svc_uid, np.int32(0)))
        return ep_type, uid
