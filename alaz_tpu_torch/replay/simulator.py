"""Deterministic synthetic workload generator.

Mirrors the reference Simulator (main_benchmark_test.go:311-633): fabricate
``pod_count`` pods and ``service_count`` services, pick ``edge_count``
pod→service edges each with a unique (pid, fd) and a TCP-establish event,
then emit HTTP traffic at ``edge_rate`` events/s/edge for
``test_duration_s`` — except the traffic is generated as columnar batches
on a virtual clock, so replay runs as fast as the pipeline can go and
throughput is measured rather than imposed.

The acceptance invariant is the reference's own (main_benchmark_test.go:
140-147): ≥90% of ``duration × edges × rate`` events must come out of the
pipeline as persisted requests.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Iterator, List

import numpy as np

from alaz_tpu_torch.aggregator.engine import Aggregator
from alaz_tpu_torch.config import SimulationConfig
from alaz_tpu_torch.datastore.inmem import InMemDataStore
from alaz_tpu_torch.events.intern import Interner
from alaz_tpu_torch.events.k8s import (
    EventType,
    K8sResourceMessage,
    Pod,
    ResourceType,
    Service,
)
from alaz_tpu_torch.events.net import ip_to_u32, u32_to_ip
from alaz_tpu_torch.events.schema import (
    HttpMethod,
    L7Protocol,
    TCP_EVENT_DTYPE,
    TcpEventType,
    make_l7_events,
    set_payloads,
)

_BASE_TIME_NS = 1_700_000_000_000_000_000

_PROTO_PAYLOADS = {
    "HTTP": (L7Protocol.HTTP, HttpMethod.GET, b"GET /user HTTP/1.1\r\nHost: svc\r\n\r\n"),
    "POSTGRES": (
        L7Protocol.POSTGRES,
        2,  # PostgresMethod.SIMPLE_QUERY
        b"Q\x00\x00\x00\x20SELECT id, name FROM users\x00",
    ),
    "REDIS": (L7Protocol.REDIS, 1, b"*2\r\n$3\r\nGET\r\n$7\r\nuser:42\r\n"),
    "MYSQL": (
        L7Protocol.MYSQL,
        1,
        b"\x1c\x00\x00\x00\x03SELECT id FROM users LIMIT 1",
    ),
}


@dataclass
class SimEdge:
    pod_idx: int
    svc_idx: int
    pid: int
    fd: int
    conn_ts: int
    protocol: str


class Simulator:
    def __init__(self, config: SimulationConfig, interner: Interner | None = None):
        self.cfg = config
        self.rng = np.random.default_rng(config.seed)
        self.interner = interner if interner is not None else Interner()
        self.pods: List[Pod] = []
        self.services: List[Service] = []
        self.edges: List[SimEdge] = []
        self._setup_done = False  # lockless-ok: setup() completes before any delivery thread reads it (bool flip is a single store; asserts are the only readers)

    # -- topology ----------------------------------------------------------

    def setup(self) -> List[K8sResourceMessage]:
        """Create pods/services (PodCreateEvent/ServiceCreateEvent analog)
        and pick edges; returns the kube-event stream."""
        cfg = self.cfg
        msgs: List[K8sResourceMessage] = []
        for i in range(cfg.pod_count):
            ip = u32_to_ip(ip_to_u32("10.0.0.0") + 1 + i)
            pod = Pod(
                uid=f"pod-uid-{i}",
                name=f"pod-{i}",
                namespace="default",
                image=f"img-{i % 7}",
                ip=ip,
            )
            self.pods.append(pod)  # alazlint: disable=ALZ051 -- setup() completes before any delivery thread starts (the _setup_done contract); the topology lists are append-frozen thereafter
            msgs.append(K8sResourceMessage(ResourceType.POD, EventType.ADD, pod))
        for i in range(cfg.service_count):
            ip = u32_to_ip(ip_to_u32("10.96.0.0") + 1 + i)
            svc = Service(
                uid=f"svc-uid-{i}",
                name=f"svc-{i}",
                namespace="default",
                cluster_ip=ip,
                cluster_ips=[ip],
            )
            self.services.append(svc)  # alazlint: disable=ALZ051 -- setup() completes before any delivery thread starts (the _setup_done contract); the topology lists are append-frozen thereafter
            msgs.append(K8sResourceMessage(ResourceType.SERVICE, EventType.ADD, svc))

        protos = list(cfg.protocol_mix.keys())
        weights = np.asarray([cfg.protocol_mix[p] for p in protos], dtype=np.float64)
        weights = weights / weights.sum()
        pod_idx = self.rng.integers(0, cfg.pod_count, size=cfg.edge_count)
        svc_idx = self.rng.integers(0, cfg.service_count, size=cfg.edge_count)
        fds = self.rng.choice(np.arange(10, 10 + 10 * cfg.edge_count), size=cfg.edge_count, replace=False)
        pids = 1000 + pod_idx  # one pid per pod
        proto_pick = self.rng.choice(len(protos), size=cfg.edge_count, p=weights)
        for e in range(cfg.edge_count):
            self.edges.append(  # alazlint: disable=ALZ051 -- setup() completes before any delivery thread starts (the _setup_done contract); the topology lists are append-frozen thereafter
                SimEdge(
                    pod_idx=int(pod_idx[e]),
                    svc_idx=int(svc_idx[e]),
                    pid=int(pids[e]),
                    fd=int(fds[e]),
                    conn_ts=_BASE_TIME_NS + int(self.rng.integers(0, 1_000_000)),
                    protocol=protos[proto_pick[e]],
                )
            )
        self._setup_done = True
        return msgs

    def tcp_events(self) -> np.ndarray:
        """One ESTABLISHED per edge (tcpEstablish analog,
        main_benchmark_test.go:622-633)."""
        assert self._setup_done
        ev = np.zeros(len(self.edges), dtype=TCP_EVENT_DTYPE)
        for i, e in enumerate(self.edges):
            ev["pid"][i] = e.pid
            ev["fd"][i] = e.fd
            ev["timestamp_ns"][i] = e.conn_ts
            ev["type"][i] = TcpEventType.ESTABLISHED
            ev["saddr"][i] = ip_to_u32(self.pods[e.pod_idx].ip)
            # a 16-bit source port wraps, as numpy 1 wrapped the JAX
            # package's 40_000 + i; numpy 2 raises there past edge 25,535
            ev["sport"][i] = (40_000 + i) & 0xFFFF
            ev["daddr"][i] = ip_to_u32(self.services[e.svc_idx].cluster_ip)
            ev["dport"][i] = 80
        return ev

    @property
    def expected_events(self) -> int:
        return int(self.cfg.edge_count * self.cfg.edge_rate * self.cfg.test_duration_s)

    def iter_l7_batches(self) -> Iterator[np.ndarray]:
        """Time-ordered L7 event batches across all edges.

        Each edge contributes ``rate × duration`` events with evenly spread
        virtual write timestamps starting just after its TCP establish
        (WriteTimeNs = conn_ts + 10 in the reference's httpTraffic,
        main_benchmark_test.go:597)."""
        assert self._setup_done
        cfg = self.cfg
        per_edge = int(cfg.edge_rate * cfg.test_duration_s)
        n_edges = len(self.edges)
        total = per_edge * n_edges
        if total == 0:
            return

        # interleave edges round-robin so batches are time-sorted without a
        # global 3M-element sort: event k of edge e has ts = base + k*dt(+e)
        dt = int(1e9 / cfg.edge_rate)
        chunk = cfg.chunk_size
        # per-edge constant columns
        pid = np.array([e.pid for e in self.edges], dtype=np.uint32)
        fd = np.array([e.fd for e in self.edges], dtype=np.uint64)
        conn = np.array([e.conn_ts for e in self.edges], dtype=np.uint64)
        proto_rows = {}
        for name, (proto, method, payload) in _PROTO_PAYLOADS.items():
            proto_rows[name] = (proto, method, payload)
        edge_proto = np.array(
            [proto_rows[e.protocol][0] for e in self.edges], dtype=np.uint8
        )
        edge_method = np.array(
            [proto_rows[e.protocol][1] for e in self.edges], dtype=np.uint8
        )

        emitted = 0
        k = 0  # per-edge sequence number
        while emitted < total:
            rows_this = min(chunk, total - emitted)
            # how many full rounds of n_edges fit
            ev = make_l7_events(rows_this)
            idx = np.arange(rows_this)
            edge_ids = (k + idx) % n_edges
            seq = (k + idx) // n_edges
            ev["pid"] = pid[edge_ids]
            ev["fd"] = fd[edge_ids]
            ev["write_time_ns"] = conn[edge_ids] + 10 + seq.astype(np.uint64) * np.uint64(dt)
            ev["duration_ns"] = 50
            ev["protocol"] = edge_proto[edge_ids]
            ev["method"] = edge_method[edge_ids]
            ev["status"] = 200
            # payloads: group rows by edge protocol, one memcpy per protocol
            for name, (proto, method, payload) in _PROTO_PAYLOADS.items():
                mask = ev["protocol"] == proto
                if not mask.any():
                    continue
                if mask.all():
                    # single-protocol batch (config1 is HTTP-only): write
                    # payloads in place — fancy-indexed structured-array
                    # round-trips copy the whole batch twice — and stop
                    # scanning: no other protocol can match
                    set_payloads(ev, payload)
                    break
                else:
                    sub = ev[mask]
                    set_payloads(sub, payload)
                    ev[mask] = sub
            k += rows_this
            emitted += rows_this
            yield ev


@dataclass
class ReplayResult:
    generated: int
    persisted: int
    wall_s: float
    events_per_s: float
    processed_ratio: float
    aggregator_stats: dict = field(default_factory=dict)

    @property
    def passed(self) -> bool:
        """The reference's ≥90% acceptance (main_benchmark_test.go:140-147)."""
        return self.processed_ratio >= 0.9


def run_replay(
    config: SimulationConfig,
    ds: InMemDataStore | None = None,
    aggregator: Aggregator | None = None,
) -> ReplayResult:
    """Synchronous replay: simulator → aggregator → datastore, flat out."""
    interner = Interner()
    if ds is None:
        ds = InMemDataStore()
    if aggregator is None:
        aggregator = Aggregator(ds, interner=interner)
    sim = Simulator(config, interner=interner)

    t0 = time.perf_counter()
    for msg in sim.setup():
        aggregator.process_k8s(msg)
    aggregator.process_tcp(sim.tcp_events())
    generated = 0
    now_ns = _BASE_TIME_NS
    for batch in sim.iter_l7_batches():
        generated += batch.shape[0]
        now_ns = int(batch["write_time_ns"][-1])
        aggregator.process_l7(batch, now_ns=now_ns)
    # drain any retries
    for _ in range(RETRY_DRAIN_ROUNDS):
        if not aggregator._retries:
            break
        aggregator.flush_retries(now_ns + 10_000_000_000)
    wall = time.perf_counter() - t0

    persisted = ds.request_count
    return ReplayResult(
        generated=generated,
        persisted=persisted,
        wall_s=wall,
        events_per_s=generated / wall if wall > 0 else 0.0,
        processed_ratio=persisted / generated if generated else 0.0,
        aggregator_stats=aggregator.stats.as_dict(),
    )


RETRY_DRAIN_ROUNDS = 5
