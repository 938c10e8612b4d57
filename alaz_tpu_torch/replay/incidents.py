"""Incident scenario library — the graph shapes that break service maps.

PR 6's chaos harness covered *delivery* faults (corrupt frames, crashed
workers, backend brownouts). This module covers the *semantic* shapes —
the traffic patterns production incidents draw on the service graph:

- ``deploy_rollout``     — mass pod churn re-keying half the node table
                           (DELETE + replacement ADDs mid-stream; traffic
                           continues from the replacements' new IPs).
- ``dns_storm``          — a burst of lookups fanning out to thousands of
                           UNIQUE outbound destinations (the reverse-DNS
                           naming / interner / node-table growth path).
- ``hot_key``            — one destination with in-degree up to 500k
                           (fan-in collapse; survivable only with
                           degree-capped sampling, graph/builder.py).
- ``retry_storm``        — a victim service 5xx's and its callers retry:
                           correlated error-amplifying fan-out, load
                           multiplying on the victim AND the callers'
                           other dependencies.
- ``backpressure_wave``  — bursty rate with stalls: k windows of traffic
                           compressed into one, delivered as jumbo
                           batches (the post-stall buffer dump).

Every incident is a seed-driven **composable transform** over the
existing :class:`~alaz_tpu.replay.simulator.Simulator` traffic: it takes
a :class:`Traffic` (topology + TCP establishes + an ordered stream of
:class:`Delivery` items) and returns a perturbed one, so
``hot_key ∘ backpressure_wave`` is just two ``apply`` calls, and the
PR 6 chaos seams compose at the delivery plane (``BatchChaos.perturb``
operates on the same Delivery stream; ``run_anomaly_scenario(incident=,
chaos=)`` makes "hot-key during a degraded delivery" one line).

Each scenario's **eval record** (:class:`ScenarioReport`) is gated on
three invariants:

1. *detection holds* — blended AUROC within tolerance of the clean gate
   (the detection leg trains on scenario-shaped traffic);
2. *the host plane holds rate* — bounded flush/drain, EXACT row
   conservation through the drop ledger (now including the ``sampled``
   cause the degree cap attributes to);
3. *windows stay exactly-once* — strictly ascending emission, no window
   emitted twice.

``python -m alaz_tpu.replay`` (= ``make scenarios``) sweeps fixed seeds
over every scenario; ``bench.py --scenario NAME`` records one scenario's
rows/s + p99 close latency + ledger breakdown + AUROC, and ``bench.py
--ingest`` runs the host gates for all scenarios every round
(``scenario_findings``, expected 0).
"""

from __future__ import annotations

import bisect
import time
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from alaz_tpu_torch.config import ChaosConfig, SimulationConfig
from alaz_tpu_torch.events.k8s import (
    EventType,
    K8sResourceMessage,
    Pod,
    ResourceType,
)
from alaz_tpu_torch.events.net import ip_to_u32, u32_to_ip
from alaz_tpu_torch.events.schema import make_l7_events
from alaz_tpu_torch.logging import get_logger
from alaz_tpu_torch.replay.simulator import Simulator

log = get_logger("alaz_tpu.incidents")

SCENARIO_NAMES = (
    "deploy_rollout",
    "dns_storm",
    "hot_key",
    "retry_storm",
    "backpressure_wave",
)

_WINDOW_NS = 1_000_000_000  # scenario traffic runs at window_s = 1.0


class Delivery:
    """One L7 batch plus the control events that must land before it.

    Attaching topology (k8s) and establish (tcp) events to the batch
    they gate — instead of interleaving bare control items — is what
    makes the stream safely perturbable: chaos duplication/reordering
    moves a batch WITH its prerequisites (k8s ADDs are idempotent), so
    a hot-key batch never outruns its pods' registrations by more than
    the adjacent-swap the chaos plane is allowed.

    ``__len__`` is the ROW count, the contract BatchChaos and the
    bounded queues already key on."""

    __slots__ = ("pre", "batch")

    def __init__(self, batch: np.ndarray, pre: Optional[list] = None):
        self.pre = pre if pre is not None else []  # [("k8s", msgs) | ("tcp", ev)]
        self.batch = batch

    def __len__(self) -> int:
        return int(self.batch.shape[0])

    @property
    def t0(self) -> int:
        return int(self.batch["write_time_ns"][0]) if len(self) else 0


@dataclass
class Traffic:
    """A scenario's full input stream: initial topology + establishes +
    the time-ordered delivery stream, plus the labeling the incident
    contributes to the detection oracle (pairs it made anomalous)."""

    kube: List[K8sResourceMessage]
    tcp: np.ndarray
    deliveries: List[Delivery]
    # (from_uid_id, to_uid_id) pairs the incident makes anomalous, and
    # the [start_ms, end_ms) span they are anomalous in — composed into
    # the detection oracle next to the fault plan's labels
    label_pairs: Set[Tuple[int, int]] = field(default_factory=set)
    label_span_ms: Tuple[int, int] = (0, 1 << 62)
    meta: Dict = field(default_factory=dict)

    @property
    def total_rows(self) -> int:
        return sum(len(d) for d in self.deliveries)


def base_traffic(sim: Simulator) -> Traffic:
    """Wrap a set-up Simulator's stream as the identity Traffic every
    incident transforms. ``sim.setup()`` must have run."""
    return Traffic(
        kube=[],  # callers fold sim.setup()'s messages themselves
        tcp=sim.tcp_events(),
        deliveries=[Delivery(b) for b in sim.iter_l7_batches()],
    )


def _insert_by_time(deliveries: List[Delivery], extra: List[Delivery]) -> List[Delivery]:
    """Merge extra deliveries into a time-ordered stream by first-row
    timestamp (stable: base traffic keeps its order)."""
    keys = [d.t0 for d in deliveries]
    out = list(deliveries)
    offset = 0
    for d in sorted(extra, key=lambda d: d.t0):
        pos = bisect.bisect_right(keys, d.t0)
        out.insert(pos + offset, d)
        offset += 1
    return out


def flatten_sorted(traffic: Traffic, chunk: int = 4096) -> Traffic:
    """Row-level time-sorted re-chunking of the delivery stream, with
    every control event moved up front. ``_insert_by_time`` orders
    deliveries only by their FIRST row, so overlapping batches (a hot
    key's fan-in interleaving with base traffic) deliver rows out of
    order — realistic, and exactly what the conservation gates are for.
    The EXACTNESS equivalence tests (serial == sharded, bit for bit)
    need the in-order shape instead: close timing is a documented
    degree of freedom between the two stores, and only an in-order
    stream removes it."""
    if not traffic.deliveries:
        return traffic
    pre = [p for d in traffic.deliveries for p in d.pre]
    allb = np.concatenate([d.batch for d in traffic.deliveries])
    allb = allb[np.argsort(allb["write_time_ns"], kind="stable")]
    deliveries = [
        Delivery(allb[i : i + chunk]) for i in range(0, allb.shape[0], chunk)
    ]
    deliveries[0].pre = pre
    return Traffic(
        kube=traffic.kube,
        tcp=traffic.tcp,
        deliveries=deliveries,
        label_pairs=traffic.label_pairs,
        label_span_ms=traffic.label_span_ms,
        meta=traffic.meta,
    )


def replay_delivery(target, d: Delivery, now_ns: Optional[int] = None) -> int:
    """Replay one Delivery into an aggregator-shaped ``target``
    (``process_k8s``/``process_tcp``/``process_l7``): its prerequisite
    control events first, then the L7 batch stamped at its own write
    horizon (or an explicit ``now_ns`` — how late deliveries land past
    a sealed watermark). Returns the batch's write horizon, so drivers
    can track the stream's high-water mark."""
    for kind, payload in d.pre:
        if kind == "k8s":
            # control events must not race ahead of queued data rows:
            # the sharded pipeline folds k8s synchronously while L7
            # rows may still sit in shard queues, so a rollout's pod
            # DELETE would apply BEFORE the pod's earlier traffic
            # attributes (its pre-cut rows all drop as not_pod and the
            # pod never appears in any emitted window). Stream position
            # is the contract — drain the data plane first. Serial
            # targets process synchronously and have no drain: no-op.
            drain = getattr(target, "drain", None)
            if drain is not None:
                drain(timeout_s=10.0)
            for m in payload:
                target.process_k8s(m)
        else:
            target.process_tcp(payload)
    end = int(d.batch["write_time_ns"][-1])
    target.process_l7(d.batch, now_ns=end if now_ns is None else now_ns)
    return end


def _edge_key_table(sim: Simulator):
    """(sorted conn keys, svc_ip_u32 per key, pod_idx per key, svc_idx
    per key) — the vectorized row→edge resolver incidents use to rewrite
    or amplify traffic on chosen edges."""
    keys = np.array(
        [(e.pid << 32) | e.fd for e in sim.edges], dtype=np.uint64
    )
    svc_ip = np.array(
        [ip_to_u32(sim.services[e.svc_idx].cluster_ip) for e in sim.edges],
        dtype=np.uint32,
    )
    pod_idx = np.array([e.pod_idx for e in sim.edges], dtype=np.int64)
    svc_idx = np.array([e.svc_idx for e in sim.edges], dtype=np.int64)
    order = np.argsort(keys)
    return keys[order], svc_ip[order], pod_idx[order], svc_idx[order]


def _row_edge_lookup(batch: np.ndarray, sorted_keys: np.ndarray) -> np.ndarray:
    """Index into the sorted edge-key table for every row (conn-key
    join); rows with no edge get -1."""
    rk = (batch["pid"].astype(np.uint64) << np.uint64(32)) | batch["fd"].astype(
        np.uint64
    )
    pos = np.searchsorted(sorted_keys, rk)
    pos = np.minimum(pos, sorted_keys.shape[0] - 1)
    hit = sorted_keys[pos] == rk
    return np.where(hit, pos, -1)


class Incident:
    """Base incident: a named, seed-driven transform over Traffic."""

    name = "incident"

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        # per-incident stream: (name hash, seed) so composed incidents
        # with the same seed still draw independently; crc32, not
        # hash() — PYTHONHASHSEED randomizes str hashes per process and
        # the fixed-seed gates promise cross-run reproducibility
        self.rng = np.random.default_rng(
            (zlib.crc32(self.name.encode()), int(seed))
        )

    def apply(self, sim: Simulator, traffic: Traffic) -> Traffic:
        raise NotImplementedError


class HotKey(Incident):
    """One destination service accumulates in-degree ``fan_in``: that
    many NEW pods each send ``reqs_per_src`` requests into it inside
    ``hot_windows``. V2 events (addresses embedded) so the fan-in needs
    no socket state — exactly how a thundering herd looks to the agent.

    This is the scenario the degree cap exists for: uncapped, every hot
    window becomes a fan_in-row batch (bucket-ladder top rung, close
    stall); capped, the dst keeps its true in-degree signal in the node
    features while its edge list is bounded."""

    name = "hot_key"

    def __init__(
        self,
        seed: int = 0,
        fan_in: int = 8_000,
        hot_windows: Sequence[int] = (2, 3),
        reqs_per_src: int = 1,
        chunk: int = 1 << 16,
    ):
        super().__init__(seed)
        self.fan_in = int(fan_in)
        self.hot_windows = tuple(hot_windows)
        self.reqs_per_src = int(reqs_per_src)
        self.chunk = int(chunk)

    def apply(self, sim: Simulator, traffic: Traffic) -> Traffic:
        svc = sim.services[int(self.rng.integers(0, len(sim.services)))]
        svc_ip = ip_to_u32(svc.cluster_ip)
        n = self.fan_in
        base_ip = ip_to_u32("11.0.0.0")
        ips = base_ip + 1 + np.arange(n, dtype=np.uint64)
        msgs = [
            K8sResourceMessage(
                ResourceType.POD,
                EventType.ADD,
                Pod(
                    uid=f"hk-pod-{self.seed}-{i}",
                    name=f"hk{i}",
                    namespace="hot",
                    ip=u32_to_ip(int(ips[i])),
                ),
            )
            for i in range(n)
        ]
        t_base = int(traffic.deliveries[0].t0) if traffic.deliveries else 0
        w0 = t_base // _WINDOW_NS
        total = n * self.reqs_per_src
        src = np.tile(np.arange(n, dtype=np.int64), self.reqs_per_src)
        win = np.asarray(self.hot_windows, dtype=np.int64)[
            self.rng.integers(0, len(self.hot_windows), total)
        ]
        ts = (
            (w0 + win) * _WINDOW_NS
            + self.rng.integers(0, _WINDOW_NS, total)
        ).astype(np.uint64)
        order = np.argsort(ts, kind="stable")
        src, ts = src[order], ts[order]
        extra: List[Delivery] = []
        for lo in range(0, total, self.chunk):
            hi = min(lo + self.chunk, total)
            ev = make_l7_events(hi - lo)
            s = src[lo:hi]
            ev["pid"] = (3_000_000 + s).astype(np.uint32)
            ev["fd"] = 7
            ev["write_time_ns"] = ts[lo:hi]
            ev["duration_ns"] = self.rng.integers(20_000, 400_000, hi - lo)
            ev["protocol"] = 1  # HTTP
            ev["method"] = 1
            ev["status"] = 200
            ev["saddr"] = ips[s].astype(np.uint32)
            ev["sport"] = (20_000 + (s % 40_000)).astype(np.uint16)
            ev["daddr"] = np.uint32(svc_ip)
            ev["dport"] = 80
            pre = [("k8s", msgs)] if lo == 0 else []
            extra.append(Delivery(ev, pre=pre))
        traffic.deliveries = _insert_by_time(traffic.deliveries, extra)
        traffic.meta["hot_key"] = {
            "svc_uid": svc.uid,
            "fan_in": n,
            "hot_windows": [int(w0 + w) for w in self.hot_windows],
            "rows": int(total),
        }
        return traffic


class DeployRollout(Incident):
    """Mass pod churn: at window ``at_window``, ``churn_frac`` of the
    pods are DELETEd and replaced by new uids on new IPs — re-keying
    that half of the node table — and their edges' traffic continues
    from the replacements (rewritten to V2 rows carrying the new
    addresses, as a re-scheduled pod's connections would)."""

    name = "deploy_rollout"

    def __init__(self, seed: int = 0, churn_frac: float = 0.5, at_window: int = 2):
        super().__init__(seed)
        self.churn_frac = float(churn_frac)
        self.at_window = int(at_window)

    def apply(self, sim: Simulator, traffic: Traffic) -> Traffic:
        n_pods = len(sim.pods)
        n_churn = max(1, int(n_pods * self.churn_frac))
        churned = self.rng.choice(n_pods, size=n_churn, replace=False)
        churn_mask = np.zeros(n_pods, dtype=bool)
        churn_mask[churned] = True
        new_ip = np.zeros(n_pods, dtype=np.uint32)
        base_ip = ip_to_u32("13.0.0.0")
        msgs: List[K8sResourceMessage] = []
        for j, p in enumerate(churned):
            old = sim.pods[int(p)]
            ip = int(base_ip + 1 + j)
            new_ip[p] = ip
            msgs.append(K8sResourceMessage(ResourceType.POD, EventType.DELETE, old))
            msgs.append(
                K8sResourceMessage(
                    ResourceType.POD,
                    EventType.ADD,
                    Pod(
                        uid=f"{old.uid}-r1",
                        name=f"{old.name}-r1",
                        namespace=old.namespace,
                        image=old.image,
                        ip=u32_to_ip(ip),
                    ),
                )
            )
        keys, svc_ip, pod_idx, _svc = _edge_key_table(sim)
        t_base = int(traffic.deliveries[0].t0) if traffic.deliveries else 0
        t_cut = ((t_base // _WINDOW_NS) + self.at_window) * _WINDOW_NS
        rolled = False
        rewritten = 0
        out_deliveries: List[Delivery] = []
        for d in traffic.deliveries:
            b = d.batch
            after = b["write_time_ns"] >= np.uint64(t_cut)
            if not after.any():
                out_deliveries.append(d)
                continue
            if not rolled:
                if not after.all():
                    # the chunk straddles the cut: split it so the
                    # DELETE+ADD lands exactly at the rollout's window
                    # boundary — attached to the straddling chunk it
                    # would apply mid-window and cut the victims' rows
                    # HALF a window early (a phantom perturbation the
                    # drift monitor rightly paged on)
                    out_deliveries.append(Delivery(b[~after], pre=d.pre))
                    d = Delivery(b[after], pre=[("k8s", msgs)])
                    b = d.batch
                    after = b["write_time_ns"] >= np.uint64(t_cut)
                else:
                    d.pre.append(("k8s", msgs))
                rolled = True
            out_deliveries.append(d)
            eidx = _row_edge_lookup(b, keys)
            hit = after & (eidx >= 0)
            if hit.any():
                pi = pod_idx[eidx[hit]]
                sub = hit.copy()
                sub[hit] = churn_mask[pi]
                if sub.any():
                    pi = pod_idx[eidx[sub]]
                    # V2 rewrite: the replacement pod's address + the
                    # edge's service address (re-established connection)
                    b["saddr"][sub] = new_ip[pi]
                    b["daddr"][sub] = svc_ip[eidx[sub]]
                    b["dport"][sub] = 80
                    rewritten += int(sub.sum())
        traffic.deliveries = out_deliveries
        traffic.meta["deploy_rollout"] = {
            "churned_pods": int(n_churn),
            "rewritten_rows": rewritten,
            "cut_ms": t_cut // 1_000_000,
        }
        return traffic


class DnsStorm(Incident):
    """A lookup storm: existing pods fan out to ``n_names`` UNIQUE
    outbound destinations over ``storm_windows``, ``rows_per_window``
    rows per window — the reverse-DNS naming + interner + node-table
    growth stress (every unique address becomes a named outbound node)."""

    name = "dns_storm"

    def __init__(
        self,
        seed: int = 0,
        n_names: int = 2_000,
        storm_windows: Sequence[int] = (2, 3),
        rows_per_window: int = 8_000,
    ):
        super().__init__(seed)
        self.n_names = int(n_names)
        self.storm_windows = tuple(storm_windows)
        self.rows_per_window = int(rows_per_window)

    def apply(self, sim: Simulator, traffic: Traffic) -> Traffic:
        pod_ips = np.array(
            [ip_to_u32(p.ip) for p in sim.pods], dtype=np.uint32
        )
        out_ips = (
            np.uint64(ip_to_u32("52.40.0.0"))
            + 1
            + self.rng.permutation(1 << 22)[: self.n_names].astype(np.uint64)
        ).astype(np.uint32)
        t_base = int(traffic.deliveries[0].t0) if traffic.deliveries else 0
        w0 = t_base // _WINDOW_NS
        extra: List[Delivery] = []
        rows = 0
        for w in self.storm_windows:
            k = self.rows_per_window
            ev = make_l7_events(k)
            ev["pid"] = (
                1000 + self.rng.integers(0, len(sim.pods), k)
            ).astype(np.uint32)
            ev["fd"] = (900_000 + np.arange(k)).astype(np.uint64)
            ev["write_time_ns"] = (
                (w0 + w) * _WINDOW_NS + self.rng.integers(0, _WINDOW_NS, k)
            ).astype(np.uint64)
            ev["write_time_ns"].sort()
            ev["duration_ns"] = self.rng.integers(5_000, 80_000, k)
            ev["protocol"] = 0  # UNKNOWN: lookup traffic, no L7 enrichment
            ev["status"] = 0
            ev["saddr"] = pod_ips[self.rng.integers(0, pod_ips.shape[0], k)]
            ev["sport"] = 30_000
            ev["daddr"] = out_ips[self.rng.integers(0, out_ips.shape[0], k)]
            ev["dport"] = 53
            extra.append(Delivery(ev))
            rows += k
        traffic.deliveries = _insert_by_time(traffic.deliveries, extra)
        traffic.meta["dns_storm"] = {
            "unique_names": self.n_names,
            "rows": rows,
        }
        return traffic


class RetryStorm(Incident):
    """Correlated error-amplifying fan-out: a victim service starts
    5xx'ing inside ``storm_windows``; every request to it is retried
    ``amp``× (load multiplies on the victim edges), and the callers —
    now spending their budgets on retries — also push ``caller_amp``×
    extra load onto their OTHER dependencies (the cascade that turns
    one bad service into a map-wide brownout). The victim edges are the
    incident's labeled anomaly."""

    name = "retry_storm"

    def __init__(
        self,
        seed: int = 0,
        amp: int = 4,
        caller_amp: int = 2,
        storm_windows: Sequence[int] = (2, 3, 4),
    ):
        super().__init__(seed)
        self.amp = max(1, int(amp))
        self.caller_amp = max(1, int(caller_amp))
        self.storm_windows = tuple(storm_windows)

    def apply(self, sim: Simulator, traffic: Traffic) -> Traffic:
        keys, _svc_ip, pod_idx, svc_idx = _edge_key_table(sim)
        # victim: the service with the most incoming edges (the shared
        # dependency a real retry storm converges on), rng tie-broken
        counts = np.bincount(svc_idx, minlength=len(sim.services)).astype(float)
        counts += self.rng.random(counts.shape[0]) * 0.5
        victim = int(np.argmax(counts))
        victim_edge = svc_idx == victim
        caller_pods = np.unique(pod_idx[victim_edge])
        caller_other = np.isin(pod_idx, caller_pods) & ~victim_edge
        t_base = int(traffic.deliveries[0].t0) if traffic.deliveries else 0
        w0 = t_base // _WINDOW_NS
        span = (
            np.int64(min(self.storm_windows) + w0) * _WINDOW_NS,
            np.int64((max(self.storm_windows) + w0 + 1)) * _WINDOW_NS,
        )
        out: List[Delivery] = []
        amped = 0
        for d in traffic.deliveries:
            b = d.batch
            ts = b["write_time_ns"]
            in_span = (ts >= np.uint64(span[0])) & (ts < np.uint64(span[1]))
            if not in_span.any():
                out.append(d)
                continue
            eidx = _row_edge_lookup(b, keys)
            vic = in_span & (eidx >= 0)
            vic[vic] = victim_edge[eidx[vic]]
            cal = in_span & (eidx >= 0)
            cal[cal] = caller_other[eidx[cal]]
            b["status"][vic] = 503  # the victim is failing
            parts = [b]
            if vic.any():
                retries = np.repeat(b[vic], self.amp - 1) if self.amp > 1 else None
                if retries is not None and retries.shape[0]:
                    retries["write_time_ns"] += self.rng.integers(
                        1_000, 50_000_000, retries.shape[0]
                    ).astype(np.uint64)
                    parts.append(retries)
                    amped += retries.shape[0]
            if cal.any() and self.caller_amp > 1:
                fanout = np.repeat(b[cal], self.caller_amp - 1)
                if fanout.shape[0]:
                    fanout["write_time_ns"] += self.rng.integers(
                        1_000, 50_000_000, fanout.shape[0]
                    ).astype(np.uint64)
                    parts.append(fanout)
                    amped += fanout.shape[0]
            if len(parts) > 1:
                merged = np.concatenate(parts)
                merged = merged[np.argsort(merged["write_time_ns"], kind="stable")]
                out.append(Delivery(merged, pre=d.pre))
            else:
                out.append(d)
        traffic.deliveries = out
        # labeled anomaly: every (pod, victim) pair, over the storm span
        vuid = sim.interner.intern(sim.services[victim].uid)
        for e in sim.edges:
            if e.svc_idx == victim:
                traffic.label_pairs.add(
                    (sim.interner.intern(sim.pods[e.pod_idx].uid), vuid)
                )
        traffic.label_span_ms = (int(span[0] // 1_000_000), int(span[1] // 1_000_000))
        traffic.meta["retry_storm"] = {
            "victim_uid": sim.services[victim].uid,
            "amplified_rows": int(amped),
            "victim_edges": int(victim_edge.sum()),
        }
        return traffic


class BackpressureWave(Incident):
    """Bursty rate with stalls: every run of ``compress`` windows
    collapses into its first window (the agent buffered through a
    stall, then dumped), and runs of ``jumbo`` consecutive deliveries
    concatenate into one outsized batch — the shape that slams the
    scatter plane and the per-window accumulators at once."""

    name = "backpressure_wave"

    def __init__(self, seed: int = 0, compress: int = 2, jumbo: int = 4):
        super().__init__(seed)
        self.compress = max(1, int(compress))
        self.jumbo = max(1, int(jumbo))

    def apply(self, sim: Simulator, traffic: Traffic) -> Traffic:
        k = self.compress
        t_base = int(traffic.deliveries[0].t0) if traffic.deliveries else 0
        w0 = t_base // _WINDOW_NS
        for d in traffic.deliveries:
            ts = d.batch["write_time_ns"].astype(np.int64)
            w = ts // _WINDOW_NS - w0
            burst_w = np.maximum(w, 0) // k * k
            d.batch["write_time_ns"] = (
                (w0 + burst_w) * _WINDOW_NS + ts % _WINDOW_NS
            ).astype(np.uint64)
        merged: List[Delivery] = []
        for lo in range(0, len(traffic.deliveries), self.jumbo):
            group = traffic.deliveries[lo : lo + self.jumbo]
            pre = [p for d in group for p in d.pre]
            merged.append(
                Delivery(np.concatenate([d.batch for d in group]), pre=pre)
            )
        traffic.deliveries = merged
        traffic.meta["backpressure_wave"] = {
            "compress": k,
            "jumbo": self.jumbo,
            "deliveries": len(merged),
        }
        return traffic


def label_extra(batch, pairs: Set[Tuple[int, int]], span_ms: Tuple[int, int]) -> np.ndarray:
    """Oracle mask for incident-labeled pairs (the retry-storm victim
    edges): 1.0 where the batch edge's (src_uid, dst_uid) is in
    ``pairs`` and the window overlaps ``span_ms`` — composed with the
    fault plan's labels by max()."""
    labels = np.zeros(batch.e_pad, dtype=np.float32)
    if (
        batch.node_uids is None
        or not pairs
        or not (span_ms[0] <= batch.window_start_ms < span_ms[1])
    ):
        return labels
    keys = np.array(
        [(int(f) << 32) | int(t) for f, t in pairs], dtype=np.int64
    )
    uids = batch.node_uids
    edge_keys = (
        uids[batch.edge_src].astype(np.int64) << 32
    ) | uids[batch.edge_dst].astype(np.int64)
    hit = np.isin(edge_keys, keys)
    hit[batch.n_edges :] = False
    labels[hit] = 1.0
    return labels


# ---------------------------------------------------------------------------
# Scenario registry: name → incident factory per scale. "gate" is the
# fixed-seed acceptance scale (fast enough for tier-1 and the bench
# ride-along); "stress" is the acceptance BOUND scale (hot_key at 500k
# fan-in — bench --scenario / make scenarios --stress territory).
# ---------------------------------------------------------------------------

_GATE_SIM = dict(
    pod_count=40, service_count=10, edge_count=80, edge_rate=100,
    test_duration_s=6.0, chunk_size=4096,
)


def make_incident(name: str, seed: int = 0, scale: str = "gate") -> Incident:
    stress = scale == "stress"
    if name == "hot_key":
        return HotKey(
            seed,
            fan_in=500_000 if stress else 6_000,
            hot_windows=(2, 3),
        )
    if name == "deploy_rollout":
        return DeployRollout(seed, churn_frac=0.5, at_window=2)
    if name == "dns_storm":
        return DnsStorm(
            seed,
            n_names=20_000 if stress else 2_000,
            rows_per_window=40_000 if stress else 6_000,
        )
    if name == "retry_storm":
        return RetryStorm(seed, amp=6 if stress else 4)
    if name == "backpressure_wave":
        return BackpressureWave(seed, compress=2, jumbo=4)
    raise ValueError(f"unknown scenario {name!r}; pick one of {SCENARIO_NAMES}")


def scenario_degree_cap(name: str, scale: str = "gate") -> int:
    """The degree cap a scenario's host leg runs under: hot_key NEEDS
    one (that is the defense under test); the rest run capped too at a
    bound far above their honest fan-in, proving the cap is a no-op on
    non-pathological shapes."""
    if name == "hot_key":
        return 1_024 if scale == "stress" else 256
    return 4_096


# ---------------------------------------------------------------------------
# Host-plane leg: the REAL sharded pipeline under the scenario's traffic.
# ---------------------------------------------------------------------------


class _BuildTimer:
    """Per-window close instrumentation: wraps a GraphBuilder instance's
    build/build_from_partials and records (input rows, seconds) per
    call — the p99-close-latency / close-throughput gauges the eval
    record publishes. Runner-side only; production code is untouched."""

    def __init__(self, builder):
        self.records: List[Tuple[int, float]] = []
        self._build, self._bfp = builder.build, builder.build_from_partials

        def build(rows, *a, **k):
            t0 = time.perf_counter()
            out = self._build(rows, *a, **k)
            self.records.append((int(rows.shape[0]), time.perf_counter() - t0))
            return out

        def build_from_partials(parts, *a, **k):
            t0 = time.perf_counter()
            out = self._bfp(parts, *a, **k)
            self.records.append(
                (sum(int(p.rows) for p in parts), time.perf_counter() - t0)
            )
            return out

        builder.build = build
        builder.build_from_partials = build_from_partials

    def p99_s(self) -> float:
        if not self.records:
            return 0.0
        return float(np.percentile([s for _, s in self.records], 99))

    def min_close_rows_per_s(self, min_rows: int = 256) -> float:
        """Worst per-window close throughput over windows with at least
        ``min_rows`` input rows (tiny windows are all fixed overhead)."""
        rates = [r / s for r, s in self.records if r >= min_rows and s > 0]
        return float(min(rates)) if rates else float("inf")


def run_host_leg(
    name: str,
    seed: int = 0,
    scale: str = "gate",
    n_workers: int = 2,
    degree_cap: Optional[int] = None,
    chaos: Optional[ChaosConfig] = None,
    sim_cfg: Optional[SimulationConfig] = None,
    incident: Optional[Incident] = None,
    flush_timeout_s: float = 60.0,
    findings: Optional[List[str]] = None,
) -> dict:
    """Drive the scenario's traffic through the REAL sharded pipeline
    and gate the host-plane invariants: bounded flush/drain, exact
    ledger conservation (``sampled`` included), strictly-ascending
    exactly-once windows, and — when a cap is armed — per-dst fan-in
    bounded in every emitted batch. ``chaos`` arms the PR 6 seams on
    top (delivery perturbation + worker crashes): "hot-key during a
    degraded delivery" is this call with both args."""
    from alaz_tpu_torch.aggregator.cluster import ClusterInfo
    from alaz_tpu_torch.aggregator.sharded import ShardedIngest
    from alaz_tpu_torch.events.intern import Interner
    from alaz_tpu_torch.utils.ledger import DropLedger

    if findings is None:
        findings = []
    cap = scenario_degree_cap(name, scale) if degree_cap is None else int(degree_cap)
    interner = Interner()
    cfg = sim_cfg if sim_cfg is not None else SimulationConfig(seed=seed, **_GATE_SIM)
    sim = Simulator(cfg, interner=interner)
    kube = sim.setup()
    traffic = base_traffic(sim)
    inc = incident if incident is not None else make_incident(name, seed, scale)
    traffic = inc.apply(sim, traffic)

    cluster = ClusterInfo(interner)
    for m in kube:
        cluster.handle_msg(m)
    ledger = DropLedger()
    closed: List = []
    fault_hook = None
    bchaos = None
    if chaos is not None and chaos.enabled:
        from alaz_tpu_torch.chaos.injectors import BatchChaos, WorkerChaos

        fault_hook = WorkerChaos(
            seed=chaos.seed,
            crash_prob=chaos.worker_crash_prob,
            stall_prob=chaos.worker_stall_prob,
            stall_s=chaos.worker_stall_s,
            max_crashes=chaos.worker_max_crashes,
            ensure_crash=True,
        )
        bchaos = BatchChaos(
            seed=chaos.seed + 1,
            dup_prob=chaos.batch_dup_prob,
            reorder_prob=chaos.batch_reorder_prob,
            late_prob=chaos.batch_late_prob,
            min_each=True,
        )
    pipe = ShardedIngest(
        n_workers,
        interner=interner,
        cluster=cluster,
        window_s=1.0,
        on_batch=closed.append,
        ledger=ledger,
        degree_cap=cap,
        sample_seed=seed,
        fault_hook=fault_hook,
        shed_block_s=2.0,
    )
    timer = _BuildTimer(pipe.builder)
    deliveries, late = traffic.deliveries, []
    if bchaos is not None:
        deliveries, late = bchaos.perturb(deliveries)
    end_ns = 0
    t0 = time.perf_counter()
    try:
        pipe.process_tcp(traffic.tcp)
        for d in deliveries:
            end_ns = max(end_ns, replay_delivery(pipe, d))
        # drain the 2-rung retry ladder before sealing (run_replay's rule)
        for _ in range(3):
            pipe.flush_retries(end_ns + 10_000_000_000)
            if pipe.drain(timeout_s=10.0) and pipe.pending_retries == 0:
                break
        tf = time.perf_counter()
        if not pipe.flush(timeout_s=flush_timeout_s):
            findings.append(f"{name}: flush did not complete in {flush_timeout_s}s")
        flush_wall = time.perf_counter() - tf
        for d in late:  # held-back deliveries land past the sealed horizon
            replay_delivery(pipe, d, now_ns=end_ns)
        if late and not pipe.flush(timeout_s=flush_timeout_s):
            findings.append(f"{name}: post-late flush did not complete")
        if not pipe.drain(timeout_s=15.0):
            findings.append(f"{name}: drain did not settle in 15s")
        if pipe.pending_retries:
            findings.append(
                f"{name}: {pipe.pending_retries} rows stuck in the retry queue"
            )
        wall = time.perf_counter() - t0
    finally:
        pipe.stop()

    from alaz_tpu_torch.chaos.harness import emitted_rows

    delivered = sum(len(d) for d in deliveries) + sum(len(d) for d in late)
    emitted = emitted_rows(closed)
    stats = pipe.stats.as_dict()
    # semantic drops ride the ledger's `filtered` cause now —
    # the gate is exactly delivered == emitted + ledger.total, no second
    # bookkeeper. The stats counters stay as the per-reason breakdown
    # and the cross-check below pins them to the ledgered total.
    semantic = (
        stats["l7_dropped_no_socket"]
        + stats["l7_dropped_not_pod"]
        + stats["l7_rate_limited"]
    )
    gap = ledger.conservation_gap(delivered, emitted)
    if gap != 0:
        findings.append(
            f"{name}: row conservation broken — delivered={delivered} "
            f"emitted={emitted} semantic={semantic} "
            f"ledger={ledger.snapshot()} gap={gap}"
        )
    if ledger.count("filtered") != semantic:
        findings.append(
            f"{name}: filtered-ledger drift — stats say {semantic} "
            f"semantic drops, ledger says {ledger.count('filtered')}"
        )
    starts = [b.window_start_ms for b in closed]
    if any(b <= a for a, b in zip(starts, starts[1:])):
        findings.append(
            f"{name}: window emission not strictly ascending: {starts}"
        )
    max_indeg = 0
    for b in closed:
        if b.n_edges:
            deg = np.bincount(b.edge_dst[: b.n_edges])
            max_indeg = max(max_indeg, int(deg.max()))
    if cap and max_indeg > cap:
        findings.append(
            f"{name}: emitted in-degree {max_indeg} exceeds degree_cap {cap}"
        )
    hk = traffic.meta.get("hot_key")
    if hk is not None and cap and hk["fan_in"] > cap and ledger.count("sampled") == 0:
        findings.append(
            f"{name}: fan-in {hk['fan_in']} over cap {cap} but nothing "
            "ledgered as sampled (the defense never fired)"
        )
    # the "no wall-clock blowup" bound: with the cap armed, no single
    # window close may stall a wave — 5s is an order of magnitude above
    # the measured 500k-fan-in close (~0.6s) and two below an uncapped
    # hot window's downstream cost, so it trips on a real stall, not on
    # a slow CI box
    p99 = timer.p99_s()
    if cap and p99 > 5.0:
        findings.append(
            f"{name}: p99 window close took {p99:.2f}s with the cap armed "
            "(close wave stalling)"
        )
    score_plane = run_drift_leg(
        name, closed, findings=findings, gated=chaos is None, interner=interner
    )
    return {
        "score_plane": score_plane,
        "scenario": name,
        "seed": seed,
        "scale": scale,
        "degree_cap": cap,
        "delivered_rows": int(delivered),
        "emitted_rows": int(emitted),
        "semantic_drops": int(semantic),
        "windows": len(closed),
        "max_emitted_indegree": max_indeg,
        "rows_per_sec": round(delivered / wall) if wall > 0 else 0,
        "flush_wall_s": round(flush_wall, 3),
        "close_p99_s": round(timer.p99_s(), 4),
        "min_close_rows_per_s": round(timer.min_close_rows_per_s()),
        "ledger": ledger.snapshot(),
        "meta": traffic.meta,
        "chaos": None
        if bchaos is None
        else {
            "duplicated": bchaos.duplicated,
            "reordered": bchaos.reordered,
            "late": bchaos.delayed,
            "crashes": fault_hook.crashes,
            "worker_restarts": pipe.worker_restarts,
        },
    }


# ---------------------------------------------------------------------------
# Score-plane drift leg: the emitted windows through the
# drift monitor, with the deterministic feature-space scorer.
# ---------------------------------------------------------------------------

# scenarios whose score distribution MUST trip a drift event on clean
# fixed seeds (the shapes the monitor exists for: an error cascade and
# a composition-shifting fan-in); dns_storm in practice trips too but
# is reported, not gated — its drift is a side effect, not the point
DRIFT_TRIP_SCENARIOS = ("retry_storm", "hot_key")
# a drift event later than this many windows after the incident's first
# hot window is a detection failure, not a page (the gate's N)
DRIFT_MAX_LAG_WINDOWS = 2


def run_drift_leg(
    name: str,
    closed: List,
    findings: Optional[List[str]] = None,
    gated: bool = True,
    interner=None,
) -> dict:
    """Feed the host leg's emitted windows (emission order) through a
    :class:`~alaz_tpu.obs.scores.ScorePlane` driven by the deterministic
    feature-space scorer, and gate the drift contract:

    - ``retry_storm`` / ``hot_key`` must raise a drift event within
      ``DRIFT_MAX_LAG_WINDOWS`` of the incident's first hot window;
    - ``deploy_rollout`` must REBASELINE (node-churn detection) without
      a drift false alarm;
    - anything else is report-only (dns_storm legitimately drifts).

    ``gated=False`` (chaos-perturbed runs) records but never gates —
    duplicated/late delivery legitimately reshapes per-window
    distributions. On a gate failure the top-K attribution ledger of
    the newest windows is attached to the finding, the trail an
    operator would pull from ``/scores/top``."""
    from alaz_tpu_torch.obs.scores import ScorePlane, feature_scores

    if findings is None:
        findings = []
    plane = ScorePlane(
        enabled=True,
        model=name,
        # short fixed-seed runs (3-6 windows; a composed
        # backpressure_wave compresses to 3): a 2-window trailing
        # reference armed from the FIRST window, flip on the first
        # over-threshold compare — the production default (8, hysteresis
        # 2) would spend the whole run warming up
        drift_windows=2,
        min_ref=1,
        hysteresis=1,
        top_k=5,
        resolve=interner.lookup if interner is not None else None,
    )
    first_drift_window = None
    for i, b in enumerate(closed):
        plane.observe_window(b, feature_scores(b))
        if first_drift_window is None and plane.drift_events > 0:
            first_drift_window = i
    snap = plane.snapshot()
    out = {
        "windows": snap["windows"],
        "drift_events": snap["drift"]["events"],
        "rebaselines": snap["drift"]["rebaselines"],
        "first_drift_window": first_drift_window,
        "psi": snap["drift"]["psi"],
        "dist": snap["dist"],
    }
    if not gated:
        return out
    if name in DRIFT_TRIP_SCENARIOS:
        if plane.drift_events == 0:
            findings.append(
                f"{name}: score distribution never tripped the drift "
                f"monitor (psi last={snap['drift']['psi']}) — the plane "
                "missed the incident it exists for; top ledger: "
                f"{plane.top_snapshot(2)}"
            )
        else:
            # "within N windows": the incident's first hot window is 2
            # for every gated scenario (make_incident), and the drift
            # compare arms at window 2 — a first event past
            # 2 + DRIFT_MAX_LAG_WINDOWS means the monitor needed the
            # incident to persist unreasonably long before paging
            if first_drift_window > 2 + DRIFT_MAX_LAG_WINDOWS:
                findings.append(
                    f"{name}: drift event arrived at window "
                    f"{first_drift_window}, more than "
                    f"{DRIFT_MAX_LAG_WINDOWS} windows after the "
                    "incident onset"
                )
    if name == "deploy_rollout":
        if plane.rebaselines == 0:
            findings.append(
                f"{name}: node-table churn never rebaselined the drift "
                "reference — a real rollout would page as drift"
            )
        if plane.drift_events > 0:
            findings.append(
                f"{name}: drift false alarm across a rebaselining "
                f"rollout (events={plane.drift_events}); top ledger: "
                f"{plane.top_snapshot(2)}"
            )
    return out


# ---------------------------------------------------------------------------
# Detection leg: scenario-shaped traffic through the anomaly pipeline.
# ---------------------------------------------------------------------------

CLEAN_AUROC_GATE = 0.9  # test_train.py's clean gate
SCENARIO_AUROC_TOLERANCE = 0.05


def run_detection_leg(
    name: str,
    seed: int = 0,
    chaos=None,
    degree_cap: int = 0,
    findings: Optional[List[str]] = None,
    device=None,
) -> dict:
    """Train + evaluate the standard anomaly scenario over
    scenario-shaped traffic (incident-transformed simulator stream,
    optionally chaos-degraded delivery): blended AUROC must stay within
    ``SCENARIO_AUROC_TOLERANCE`` of the clean gate. Trains and scores on
    ``device`` (default ``cuda``). Imports torch/train lazily — the host
    leg stays importable on data-plane images."""
    from alaz_tpu_torch.config import ModelConfig
    from alaz_tpu_torch.replay.scenario import run_anomaly_scenario
    from alaz_tpu_torch.train import train_on_batches
    from alaz_tpu_torch.train.metrics import auroc
    from alaz_tpu_torch.train.trainstep import make_score_fn, score_batch

    if findings is None:
        findings = []
    sim_cfg = SimulationConfig(
        pod_count=50, service_count=20, edge_count=40, edge_rate=200, seed=seed
    )
    incident = make_detection_incident(name, seed)
    data = run_anomaly_scenario(
        sim_cfg,
        n_windows=8,
        fault_fraction=0.2,
        seed=seed + 1,
        chaos=chaos,
        incident=incident,
        degree_cap=degree_cap,
    )
    cfg = ModelConfig(model="graphsage", hidden_dim=64, use_pallas=False)
    state, losses = train_on_batches(cfg, data.train, epochs=25, lr=3e-3, device=device)
    fn = make_score_fn(cfg, device)
    scores, labels, masks = [], [], []
    for b in data.eval:
        out = score_batch(cfg, state.params, b, fn)
        scores.append(out["edge_logits"])
        labels.append(b.edge_label)
        masks.append(b.edge_mask)
    a = float(
        auroc(np.concatenate(scores), np.concatenate(labels), np.concatenate(masks))
    )
    floor = CLEAN_AUROC_GATE - SCENARIO_AUROC_TOLERANCE
    if a < floor:
        findings.append(
            f"{name}: blended AUROC {a:.3f} under the scenario fell past "
            f"the {floor:.2f} tolerance gate"
        )
    return {
        "scenario": name,
        "auroc": round(a, 4),
        "gate": floor,
        "train_windows": len(data.train),
        "eval_windows": len(data.eval),
        "final_loss": round(float(losses[-1]), 4),
    }


def make_detection_incident(name: str, seed: int = 0) -> Incident:
    """Detection-scale incidents: sized to the 50-pod standard scenario
    so training stays CI-cheap while the shape stress is still real."""
    if name == "hot_key":
        return HotKey(seed, fan_in=600, hot_windows=(3, 4))
    if name == "deploy_rollout":
        return DeployRollout(seed, churn_frac=0.4, at_window=3)
    if name == "dns_storm":
        return DnsStorm(seed, n_names=400, rows_per_window=1_500)
    if name == "retry_storm":
        return RetryStorm(seed, amp=3, storm_windows=(3, 4, 5))
    if name == "backpressure_wave":
        return BackpressureWave(seed, compress=2, jumbo=3)
    raise ValueError(f"unknown scenario {name!r}")


# ---------------------------------------------------------------------------
# Eval records + suite driver.
# ---------------------------------------------------------------------------


@dataclass
class ScenarioReport:
    name: str
    seed: int
    findings: List[str] = field(default_factory=list)
    host: dict = field(default_factory=dict)
    detection: dict = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.findings

    def as_dict(self) -> dict:
        return {
            "scenario": self.name,
            "seed": self.seed,
            "scenario_findings": len(self.findings),
            "findings": self.findings,
            "host": self.host,
            "detection": self.detection,
        }


def run_incident_scenario(
    name: str,
    seed: int = 0,
    n_workers: int = 2,
    scale: str = "gate",
    detection: bool = True,
    chaos: Optional[ChaosConfig] = None,
    degree_cap: Optional[int] = None,
    incident: Optional[Incident] = None,
    device=None,
) -> ScenarioReport:
    """One scenario's full eval record: host-plane gates (always) +
    the detection gate (skippable for ride-alongs — training is the
    expensive half), trained and scored on ``device`` (default
    ``cuda``). ``incident`` overrides the registry's default
    construction (how the suite drivers re-scale via ScenarioConfig)."""
    rep = ScenarioReport(name=name, seed=seed)
    rep.host = run_host_leg(
        name,
        seed=seed,
        scale=scale,
        n_workers=n_workers,
        degree_cap=degree_cap,
        chaos=chaos,
        incident=incident,
        findings=rep.findings,
    )
    if detection:
        from alaz_tpu_torch.chaos.injectors import BatchChaos

        det_chaos = None
        if chaos is not None and chaos.enabled:
            det_chaos = BatchChaos(
                seed=chaos.seed + 7,
                dup_prob=chaos.batch_dup_prob,
                reorder_prob=chaos.batch_reorder_prob,
                late_prob=chaos.batch_late_prob,
                min_each=True,
            )
        # same cap resolution as the host leg: the published record
        # pairs (degree_cap, blended_auroc), so the AUROC must be
        # measured with the cap ARMED, not the uncapped default
        rep.detection = run_detection_leg(
            name,
            seed=seed,
            chaos=det_chaos,
            degree_cap=(
                degree_cap
                if degree_cap is not None
                else scenario_degree_cap(name, scale)
            ),
            findings=rep.findings,
            device=device,
        )
    for f in rep.findings:
        log.warning(f"scenario finding: {f}")
    return rep


def run_scenario_suite(
    seed: int = 0,
    names: Sequence[str] = SCENARIO_NAMES,
    n_workers: int = 2,
    detection: bool = False,
    scale: str = "gate",
    device=None,
) -> List[ScenarioReport]:
    """The fixed-seed sweep: every scenario's gates at ``scale``, the
    detection legs on ``device`` (default ``cuda``). With
    ``detection=False`` this is the fast host-plane pass `bench.py
    --ingest` rides along with (scenario_findings, expected 0)."""
    return [
        run_incident_scenario(
            n, seed=seed, n_workers=n_workers, scale=scale, detection=detection,
            device=device,
        )
        for n in names
    ]
