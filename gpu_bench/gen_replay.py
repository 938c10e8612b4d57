"""Replayed fleet traffic from a seed: a frozen copy of the port's
``replay/simulator.py Simulator`` (pods, services, one TCP establish a
pod → service edge, then each edge's L7 requests at ``edge_rate`` on a
virtual clock), kept here so that a change to the program cannot change the
traffic it is measured on.

The messages and event arrays are the program's own input types (its K8s
resource messages and event dtypes), imported inside the functions.
``Topology`` keeps what the reference needs: which pod calls which service
over which protocol, and when each connection opened.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

BASE_TIME_NS = 1_700_000_000_000_000_000

# protocol name -> (L7 protocol code, method code, payload)
PAYLOADS = {
    "HTTP": (1, 1, b"GET /user HTTP/1.1\r\nHost: svc\r\n\r\n"),
    "POSTGRES": (3, 2, b"Q\x00\x00\x00\x20SELECT id, name FROM users\x00"),
    "REDIS": (5, 1, b"*2\r\n$3\r\nGET\r\n$7\r\nuser:42\r\n"),
    "MYSQL": (7, 1, b"\x1c\x00\x00\x00\x03SELECT id FROM users LIMIT 1"),
}


@dataclass
class Topology:
    pod_idx: np.ndarray  # [E] the calling pod of each edge
    svc_idx: np.ndarray  # [E] the called service
    proto: np.ndarray  # [E] L7 protocol code
    conn_ts: np.ndarray  # [E] u64 ns, the connection's establish
    pid: np.ndarray
    fd: np.ndarray


def _ip(base: str, i: int) -> str:
    a, b, c, d = (int(x) for x in base.split("."))
    v = ((a << 24) | (b << 16) | (c << 8) | d) + 1 + i
    return f"{(v >> 24) & 255}.{(v >> 16) & 255}.{(v >> 8) & 255}.{v & 255}"


def topology(traffic: dict, seed) -> Topology:
    """The seed's edges, drawn as the port's simulator draws them."""
    rng = np.random.default_rng(seed)
    n_pods, n_svcs, n_edges = traffic["pods"], traffic["services"], traffic["edges"]
    protos = list(traffic["protocol_mix"].keys())
    weights = np.asarray([traffic["protocol_mix"][p] for p in protos], dtype=np.float64)
    weights = weights / weights.sum()
    pod_idx = rng.integers(0, n_pods, size=n_edges)
    svc_idx = rng.integers(0, n_svcs, size=n_edges)
    fds = rng.choice(np.arange(10, 10 + 10 * n_edges), size=n_edges, replace=False)
    proto_pick = rng.choice(len(protos), size=n_edges, p=weights)
    conn = np.array([BASE_TIME_NS + int(rng.integers(0, 1_000_000)) for _ in range(n_edges)], dtype=np.uint64)
    codes = np.array([PAYLOADS[p][0] for p in protos], dtype=np.uint8)
    return Topology(pod_idx=pod_idx, svc_idx=svc_idx, proto=codes[proto_pick], conn_ts=conn,
                    pid=(1000 + pod_idx).astype(np.uint32), fd=fds.astype(np.uint64))


def k8s_messages(traffic: dict) -> list:
    """A pod and a service resource message each, as the cluster's watch
    would deliver them."""
    from alaz_tpu_torch.events.k8s import EventType, K8sResourceMessage, Pod, ResourceType, Service

    msgs = []
    for i in range(traffic["pods"]):
        ip = _ip("10.0.0.0", i)
        msgs.append(K8sResourceMessage(ResourceType.POD, EventType.ADD, Pod(
            uid=f"pod-uid-{i}", name=f"pod-{i}", namespace="default", image=f"img-{i % 7}", ip=ip)))
    for i in range(traffic["services"]):
        ip = _ip("10.96.0.0", i)
        msgs.append(K8sResourceMessage(ResourceType.SERVICE, EventType.ADD, Service(
            uid=f"svc-uid-{i}", name=f"svc-{i}", namespace="default", cluster_ip=ip, cluster_ips=[ip])))
    return msgs


def tcp_events(topo: Topology) -> np.ndarray:
    """One established connection an edge."""
    from alaz_tpu_torch.events.net import ip_to_u32
    from alaz_tpu_torch.events.schema import TCP_EVENT_DTYPE, TcpEventType

    n = topo.pod_idx.shape[0]
    ev = np.zeros(n, dtype=TCP_EVENT_DTYPE)
    ev["pid"] = topo.pid
    ev["fd"] = topo.fd
    ev["timestamp_ns"] = topo.conn_ts
    ev["type"] = TcpEventType.ESTABLISHED
    pod0, svc0 = ip_to_u32("10.0.0.0") + 1, ip_to_u32("10.96.0.0") + 1
    ev["saddr"] = (pod0 + topo.pod_idx).astype(np.uint32)
    ev["sport"] = ((40_000 + np.arange(n)) & 0xFFFF).astype(ev["sport"].dtype)
    ev["daddr"] = (svc0 + topo.svc_idx).astype(np.uint32)
    ev["dport"] = 80
    return ev


def l7_batches(topo: Topology, traffic: dict) -> list:
    """Every edge's requests over ``event_seconds`` of event time, edges
    interleaved round robin so each batch is in time order: request k of
    edge e is written at conn_ts + 10 + k / edge_rate."""
    from alaz_tpu_torch.events.schema import make_l7_events, set_payloads

    n_edges = topo.pod_idx.shape[0]
    per_edge = int(traffic["edge_rate"] * traffic["event_seconds"])
    total = per_edge * n_edges
    dt = int(1e9 / traffic["edge_rate"])
    chunk = int(traffic["chunk_size"])
    method = {code: m for code, m, _ in PAYLOADS.values()}
    edge_method = np.array([method[int(p)] for p in topo.proto], dtype=np.uint8)
    out, k = [], 0
    while k < total:
        rows = min(chunk, total - k)
        ev = make_l7_events(rows)
        idx = np.arange(rows)
        e = (k + idx) % n_edges
        seq = (k + idx) // n_edges
        ev["pid"] = topo.pid[e]
        ev["fd"] = topo.fd[e]
        ev["write_time_ns"] = topo.conn_ts[e] + 10 + seq.astype(np.uint64) * np.uint64(dt)
        ev["duration_ns"] = 50
        ev["protocol"] = topo.proto[e]
        ev["method"] = edge_method[e]
        ev["status"] = 200
        for code, _, payload in PAYLOADS.values():
            mask = ev["protocol"] == code
            if mask.all():
                set_payloads(ev, payload)
                break
            if mask.any():
                sub = ev[mask]
                set_payloads(sub, payload)
                ev[mask] = sub
        out.append(ev)
        k += rows
    return out
