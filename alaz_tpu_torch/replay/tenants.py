"""Multi-tenant replay + the isolation gate (ISSUE 14 proof leg): the
JAX package's ``replay/tenants.py``, copied (only its import lines differ).

K simulators — one per tenant, each with its own rate and protocol
mix — drive ONE :class:`~alaz_tpu_torch.runtime.service.Service` through its
tenancy plane (per-tenant partitions, shared scorer with cross-tenant
batching), optionally with one tenant running an incident
(replay/incidents.py) and/or chaos worker kills on its pool. The gate is
the ISSUE 14 isolation contract:

1. **Per-tenant conservation, exact.** For every tenant,
   ``pushed == scored-window rows + ledger.total`` — one tenant's
   losses can never hide in (or leak into) another's books.
2. **Clean tenants hold latency.** Each clean tenant's p99
   close→score latency in the combined run stays within 10% of its
   SOLO baseline (same traffic, alone on a single-tenant service) —
   with a small absolute floor (``LATENCY_FLOOR_S``): below macroscopic
   latencies, shared-CI scheduler jitter swamps a pure ratio, while a
   real head-of-line regression (tenant A's backlog stalling tenant B's
   windows) shows up in whole window-lengths and trips both terms.
3. **Clean tenants' drift detectors stay silent.** The perturbed
   tenant's score distribution may move (that is its incident doing its
   job — recorded, not gated); a clean tenant's per-tenant drift plane
   paging because of a NEIGHBOR's incident is the cross-contamination
   tenancy exists to prevent.
4. **Exactly-once ascending windows per tenant.**

Scoring runs the **deterministic host scorer** (the feature-space
logistic of obs/scores.py, in logit form) through the Service's real
scorer loop — queues → partitions → window queue → group batching →
``record_window`` — so the gate measures the serving plane, not XLA
compile jitter; the scores themselves are bit-reproducible.

``python -m alaz_tpu_torch.replay --isolation`` runs the K=3 fixed-seed
gate; :func:`tenant_serving_bench` is the unpaced throughput record.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from alaz_tpu_torch.config import ChaosConfig, RuntimeConfig, SimulationConfig, TraceConfig
from alaz_tpu_torch.logging import get_logger
from alaz_tpu_torch.replay.incidents import Traffic, base_traffic, make_incident
from alaz_tpu_torch.replay.simulator import Simulator

log = get_logger("alaz_tpu.tenants")

# isolation-gate latency terms (module docstring): ratio per the ISSUE
# acceptance bar, floor to keep sub-scheduler-quantum noise from
# flapping a gate that exists to catch whole-window head-of-line stalls
LATENCY_RATIO = 1.10
LATENCY_FLOOR_S = 0.5

# per-tenant traffic personalities: rate multipliers and protocol mixes
# cycle over these, so K fleets never look alike on the wire
_TENANT_MIXES = (
    {"HTTP": 1.0},
    {"HTTP": 0.5, "POSTGRES": 0.3, "REDIS": 0.2},
    {"HTTP": 0.4, "REDIS": 0.3, "MYSQL": 0.3},
    {"POSTGRES": 0.6, "MYSQL": 0.4},
)
_TENANT_RATES = (150, 250, 200, 350)


# ---------------------------------------------------------------------------
# Deterministic host scorer: obs.scores' feature read in logit form
# (ONE weight definition — record_window applies the sigmoid, so the
# per-tenant planes see EXACTLY feature_scores' distribution), over the
# scorer's graph dicts (serial) and stacked arenas (grouped). Both
# return FRESH arrays (the arithmetic copies), honoring the
# score_many_fn ownership contract (Service docstring): the stacked
# input is a reused double-buffered arena.
# ---------------------------------------------------------------------------


def host_score_fn(params, graph) -> dict:
    from alaz_tpu_torch.obs.scores import feature_logits

    return {"edge_logits": feature_logits(graph["edge_feats"])}


def host_score_many_fn(params, stacked) -> dict:
    from alaz_tpu_torch.obs.scores import feature_logits

    return {"edge_logits": feature_logits(stacked["edge_feats"])}


# ---------------------------------------------------------------------------
# Per-tenant traffic + delivery through the Service submit surface.
# ---------------------------------------------------------------------------


def make_tenant_traffic(
    tenant: int,
    seed: int,
    n_windows: int,
    incident: Optional[str] = None,
    scale: str = "gate",
    pods: int = 24,
    services: int = 6,
    edges: int = 40,
):
    """(kube msgs, Traffic) for one tenant: its own Simulator (own
    interner namespace — uids genuinely collide across tenants, which is
    the point), rate/mix personality by tenant index, optionally
    incident-transformed."""
    from alaz_tpu_torch.events.intern import Interner

    cfg = SimulationConfig(
        seed=seed * 1_000 + tenant,
        pod_count=pods,
        service_count=services,
        edge_count=edges,
        edge_rate=_TENANT_RATES[tenant % len(_TENANT_RATES)],
        test_duration_s=float(n_windows),
        chunk_size=2_048,
        protocol_mix=_TENANT_MIXES[tenant % len(_TENANT_MIXES)],
    )
    sim = Simulator(cfg, interner=Interner())
    kube = sim.setup()
    traffic = base_traffic(sim)
    if incident is not None:
        traffic = make_incident(incident, seed, scale).apply(sim, traffic)
    return kube, traffic


def _submit_k8s_all(svc, tenant: int, msgs, timeout_s: float = 30.0) -> None:
    """Submit control messages with BACKPRESSURE: the k8s queue is
    bounded (default 1000 events) and an incident's registration burst
    (hot_key ships thousands of pod ADDs) must not silently lose pods —
    a lost ADD turns the pod's whole stream into filtered/not_pod.
    Bounded retry: a wedged service degrades to misattributed (still
    ledgered) rows, never a hung driver."""
    deadline = time.monotonic() + timeout_s
    for m in msgs:
        while not svc.submit_k8s(m, tenant=tenant):
            if time.monotonic() > deadline:
                log.warning(f"tenant {tenant}: k8s submit backpressure timeout")
                return
            time.sleep(0.002)


def _drain_k8s(svc, tenant: int, timeout_s: float = 10.0) -> None:
    """Control events must attribute before the data rows they gate
    (the replay_delivery fidelity rule, across the queue hop): wait for
    the tenant's k8s queue to fold. Bounded — a wedged fold degrades to
    misattributed (ledgered) rows, never a hung driver."""
    part = svc.partitions[tenant]
    deadline = time.monotonic() + timeout_s
    while part.k8s_queue.unfinished and time.monotonic() < deadline:
        time.sleep(0.005)


def deliver_tenant(
    svc,
    tenant: int,
    kube,
    traffic: Traffic,
    pace_scale: float = 0.0,
    wall0: Optional[float] = None,
) -> int:
    """Replay one tenant's stream through the Service submit surface
    (tenant-tagged — the same routing a tenant-tagged wire frame takes).
    ``pace_scale`` > 0 maps event time to wall time (0.2 = 5× compressed
    replay) so close→score latency measures a LIVE cadence instead of a
    flood; 0 slams everything (throughput mode). Returns pushed L7 rows
    — the tenant's conservation numerator."""
    _submit_k8s_all(svc, tenant, kube)
    _drain_k8s(svc, tenant)
    if traffic.tcp is not None and len(traffic.tcp):
        svc.submit_tcp(traffic.tcp, tenant=tenant)
    t_base = traffic.deliveries[0].t0 if traffic.deliveries else 0
    if wall0 is None:
        wall0 = time.monotonic()
    pushed = 0
    for d in traffic.deliveries:
        if pace_scale > 0.0:
            target = wall0 + (d.t0 - t_base) * 1e-9 * pace_scale
            now = time.monotonic()
            if target > now:
                time.sleep(min(target - now, 2.0))
        for kind, payload in d.pre:
            if kind == "k8s":
                _submit_k8s_all(svc, tenant, payload)
                _drain_k8s(svc, tenant)
            else:
                svc.submit_tcp(payload, tenant=tenant)
        svc.submit_l7(d.batch, tenant=tenant)
        pushed += len(d)
    return pushed


def _settle(svc, timeout_s: float = 60.0) -> None:
    """Drain → flush every tenant's open windows → drain the scorer.
    Two flush rounds: the first may emit windows whose scoring reveals
    late retries the second sweeps."""
    svc.drain(timeout_s=timeout_s)
    svc.flush_windows()
    svc.drain(timeout_s=timeout_s)
    svc.flush_windows()
    svc.drain(timeout_s=timeout_s)


@dataclass
class _TenantRun:
    pushed: int = 0
    windows: List[int] = field(default_factory=list)  # window_start_ms, arrival order
    latencies: List[float] = field(default_factory=list)
    emitted_rows: int = 0


def _run_service(
    tenant_traffic: Dict[int, tuple],
    tenants: int,
    seed: int,
    pace_scale: float,
    ingest_workers: int = 1,
    chaos: Optional[ChaosConfig] = None,
    chaos_tenant: Optional[int] = None,
    batch_windows: int = 4,
    settle_timeout_s: float = 60.0,
):
    """One Service run over ``tenant_traffic`` ({tenant: (kube,
    traffic)}); returns ({tenant: _TenantRun}, service) with the service
    already stopped (its ledgers/planes stay readable).

    ``chaos`` + ``chaos_tenant`` arm worker kills on ONE tenant's shard
    pool only (the perturbed fleet) — installed post-construction, so
    the clean tenants' partitions run exactly the wiring the solo
    baselines ran and the isolation gates stay meaningful under chaos."""
    from alaz_tpu_torch.runtime.service import Service

    cfg = RuntimeConfig(
        tenants=tenants,
        ingest_workers=ingest_workers,
        score_batch_windows=batch_windows,
        # live drift detectors at replay scale: a 2-window trailing
        # reference so the perturbed tenant's incident is measurable
        # inside an 8-window run (the production default would spend
        # the whole run warming up); clean-traffic silence at this
        # setting is a tested property of the plane
        trace=TraceConfig(score_drift_windows=2),
    )
    svc = Service(
        config=cfg,
        model_state={"host": "feature_logits"},
        score_fn=host_score_fn,
        score_many_fn=host_score_many_fn,
        score_threshold=2.0,  # nothing annotates; no sink is wired anyway
    )
    if chaos is not None and chaos.enabled and chaos_tenant is not None:
        from alaz_tpu_torch.chaos.injectors import WorkerChaos

        part = svc.partitions[chaos_tenant]
        if part.sharded is None:
            raise ValueError(
                "chaos worker kills need ingest_workers > 1 (the worker "
                "seam lives in the sharded pool)"
            )
        hook = WorkerChaos(
            seed=chaos.seed,
            crash_prob=chaos.worker_crash_prob,
            stall_prob=chaos.worker_stall_prob,
            stall_s=chaos.worker_stall_s,
            max_crashes=chaos.worker_max_crashes,
            # ≥1 kill per run: a "conservation THROUGH kills" gate that
            # can pass with zero crashes proves nothing (the chaos
            # suite's never-vacuous rule)
            ensure_crash=True,
        )
        # attach-once before any traffic flows: the worker loop reads
        # the hook per item off the pipeline attribute
        part.fault_hook = hook
        part.sharded.fault_hook = hook
    runs = {t: _TenantRun() for t in tenant_traffic}

    def observe(batch, tenant, lat):
        r = runs[tenant]
        r.windows.append(int(batch.window_start_ms))
        r.latencies.append(float(lat))
        r.emitted_rows += batch.aggregated_rows()

    svc.score_observer = observe
    svc.start()
    try:
        wall0 = time.monotonic()
        threads = []
        results: Dict[int, int] = {}
        for t, (kube, traffic) in tenant_traffic.items():

            def run(t=t, kube=kube, traffic=traffic):
                results[t] = deliver_tenant(
                    svc, t, kube, traffic, pace_scale=pace_scale, wall0=wall0
                )

            th = threading.Thread(target=run, name=f"tenant-driver-{t}", daemon=True)
            th.start()
            threads.append(th)
        for th in threads:
            th.join(timeout=300.0)
        _settle(svc, timeout_s=settle_timeout_s)
    finally:
        svc.stop()
    for t, pushed in results.items():
        runs[t].pushed = pushed
    return runs, svc


def _p99(vals: List[float]) -> float:
    return float(np.percentile(vals, 99)) if vals else 0.0


# ---------------------------------------------------------------------------
# The isolation scenario + report.
# ---------------------------------------------------------------------------


@dataclass
class TenancyReport:
    tenants: int
    seed: int
    perturbed: int
    incident: str
    findings: List[str] = field(default_factory=list)
    per_tenant: dict = field(default_factory=dict)
    combined: dict = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.findings

    def as_dict(self) -> dict:
        return {
            "scenario": "multi_tenant_isolation",
            "tenants": self.tenants,
            "seed": self.seed,
            "perturbed": self.perturbed,
            "incident": self.incident,
            "scenario_findings": len(self.findings),
            "findings": self.findings,
            "per_tenant": self.per_tenant,
            "combined": self.combined,
        }


def run_isolation_scenario(
    tenants: int = 3,
    seed: int = 0,
    perturbed: Optional[int] = None,
    incident: str = "retry_storm",
    n_windows: int = 8,
    pace_scale: float = 0.2,
    ingest_workers: int = 1,
    chaos: Optional[ChaosConfig] = None,
) -> TenancyReport:
    """The ISSUE 14 isolation gate (module docstring): K tenants on one
    backend, one perturbed; clean tenants must hold latency vs their
    solo baselines, stay drift-silent, and conserve rows exactly.

    ``chaos`` arms worker kills on the PERTURBED tenant's shard pool
    only (requires ``ingest_workers > 1``) — incident + chaos on one
    fleet, with the clean fleets' latency/drift/conservation gates all
    STILL ON: the ISSUE 14 acceptance combination. The perturbed
    tenant's own latency, scores and drift may degrade freely
    (recorded, never gated)."""
    if perturbed is None:
        perturbed = tenants - 1
    rep = TenancyReport(
        tenants=tenants, seed=seed, perturbed=perturbed, incident=incident
    )

    tenant_traffic = {
        t: make_tenant_traffic(
            t, seed, n_windows,
            incident=incident if t == perturbed else None,
        )
        for t in range(tenants)
    }

    # solo baselines: each CLEAN tenant alone on a single-tenant service
    # with identical scorer config (and no chaos anywhere — the baseline
    # is the undisturbed fleet) — the latency reference the combined
    # run is judged against ("tenancy must not cost a clean fleet")
    solo_p99: Dict[int, float] = {}
    for t in range(tenants):
        if t == perturbed:
            continue
        kube, traffic = make_tenant_traffic(t, seed, n_windows)
        solo_runs, _ = _run_service(
            {0: (kube, traffic)}, 1, seed, pace_scale,
            ingest_workers=ingest_workers,
        )
        solo_p99[t] = _p99(solo_runs[0].latencies)

    runs, svc = _run_service(
        tenant_traffic, tenants, seed, pace_scale,
        ingest_workers=ingest_workers, chaos=chaos, chaos_tenant=perturbed,
    )

    crashes = sum(
        getattr(p.fault_hook, "crashes", 0) for p in svc.partitions
    )
    restarts = sum(
        p.sharded.worker_restarts
        for p in svc.partitions
        if p.sharded is not None
    )
    if chaos is not None and chaos.enabled and crashes and not restarts:
        rep.findings.append(
            f"isolation: {crashes} worker crashes injected but no restart "
            "observed — supervision dead under tenancy"
        )

    for t in range(tenants):
        r = runs[t]
        part = svc.partitions[t]
        ledger = part.ledger.snapshot()
        gap = r.pushed - r.emitted_rows - ledger["total"]
        plane = svc.tenant_scores(t)
        drift_events = plane.drift_events if plane is not None else 0
        p99 = _p99(r.latencies)
        entry = {
            "pushed": r.pushed,
            "emitted_rows": r.emitted_rows,
            "windows": len(r.windows),
            "ledger": ledger,
            "gap": int(gap),
            "p99_close_to_score_ms": round(p99 * 1e3, 2),
            "drift_events": drift_events,
            "perturbed": t == perturbed,
        }
        if t in solo_p99:
            entry["solo_p99_close_to_score_ms"] = round(solo_p99[t] * 1e3, 2)
        rep.per_tenant[str(t)] = entry
        if gap != 0:
            rep.findings.append(
                f"isolation: tenant {t} conservation broken — "
                f"pushed={r.pushed} emitted={r.emitted_rows} "
                f"ledger={ledger} gap={gap}"
            )
        if any(b <= a for a, b in zip(r.windows, r.windows[1:])):
            rep.findings.append(
                f"isolation: tenant {t} windows not strictly ascending: "
                f"{r.windows}"
            )
        if not r.windows:
            rep.findings.append(
                f"isolation: tenant {t} emitted no windows — vacuous run"
            )
        if t == perturbed:
            continue  # the perturbed tenant may degrade: recorded above
        if drift_events:
            rep.findings.append(
                f"isolation: clean tenant {t} drift detector paged "
                f"({drift_events} events) during a neighbor's incident — "
                "cross-tenant score contamination"
            )
        if t in solo_p99:
            bound = max(
                solo_p99[t] * LATENCY_RATIO, solo_p99[t] + LATENCY_FLOOR_S
            )
            if p99 > bound:
                rep.findings.append(
                    f"isolation: clean tenant {t} p99 close-to-score "
                    f"{p99*1e3:.1f}ms exceeds its solo baseline "
                    f"{solo_p99[t]*1e3:.1f}ms bound (+10% / +"
                    f"{LATENCY_FLOOR_S*1e3:.0f}ms floor) — head-of-line "
                    "interference from the perturbed tenant"
                )

    rep.combined = {
        "windows": svc.scored_batches,
        "dispatches": svc.score_dispatches,
        "multi_tenant_groups": svc.multi_tenant_groups,
        "group_occupancy": round(
            svc.scored_batches / svc.score_dispatches, 3
        )
        if svc.score_dispatches
        else 0.0,
        "worker_crashes": crashes,
        "worker_restarts": restarts,
    }
    for f in rep.findings:
        log.warning(f"isolation finding: {f}")
    return rep


# ---------------------------------------------------------------------------
# Bench leg (bench.py --ingest --tenants K): unpaced throughput record.
# ---------------------------------------------------------------------------


def tenant_serving_bench(
    tenants: int,
    n_rows: int = 262_144,
    windows: int = 8,
    seed: int = 0,
    batch_windows: int = 4,
) -> dict:
    """Unpaced K-tenant serving throughput: one synthetic trace split
    round-robin across K fleets (disjoint row slices, shared k8s
    topology folded into each tenant's own namespace), slammed through
    the tenancy plane. Reports aggregate windows/s and rows/s,
    per-tenant p99 close→score latency, and the cross-tenant batching
    occupancy (mean windows per scorer dispatch — K serial backends
    would sit at 1.0)."""
    from alaz_tpu_torch.replay.synth import make_ingest_trace
    from alaz_tpu_torch.runtime.service import Service

    ev, msgs = make_ingest_trace(n_rows, windows=windows, seed=seed)
    cfg = RuntimeConfig(
        tenants=tenants,
        score_batch_windows=batch_windows,
        trace=TraceConfig(score_drift_windows=4),
    )
    svc = Service(
        config=cfg,
        model_state={"host": "feature_logits"},
        score_fn=host_score_fn,
        score_many_fn=host_score_many_fn,
        score_threshold=2.0,
    )
    lat: Dict[int, List[float]] = {t: [] for t in range(tenants)}
    scored_rows = [0]

    def observe(batch, tenant, l):
        lat[tenant].append(float(l))
        scored_rows[0] += batch.aggregated_rows()

    svc.score_observer = observe
    svc.start()
    try:
        for t in range(tenants):
            _submit_k8s_all(svc, t, msgs)
        for t in range(tenants):
            _drain_k8s(svc, t)
        slices = [ev[t::tenants] for t in range(tenants)]
        chunk = 1 << 14
        t0 = time.perf_counter()
        # round-robin across tenants chunk by chunk: the interleaving a
        # real fleet of agents produces, and what fills cross-tenant
        # groups (K same-bucket windows close near-simultaneously)
        offsets = [0] * tenants
        live = True
        while live:
            live = False
            for t in range(tenants):
                sl = slices[t]
                o = offsets[t]
                if o < sl.shape[0]:
                    svc.submit_l7(sl[o : o + chunk], tenant=t)
                    offsets[t] = o + chunk
                    live = True
        _settle(svc, timeout_s=120.0)
        wall = time.perf_counter() - t0
    finally:
        svc.stop()
    windows_scored = svc.scored_batches
    return {
        "tenants": tenants,
        "rows": n_rows,
        "windows_scored": windows_scored,
        "windows_per_sec": round(windows_scored / wall, 2) if wall > 0 else 0.0,
        "rows_per_sec": round(n_rows / wall) if wall > 0 else 0,
        "scored_rows": scored_rows[0],
        "wall_s": round(wall, 3),
        "dispatches": svc.score_dispatches,
        "multi_tenant_groups": svc.multi_tenant_groups,
        # the cross-tenant batching headline: mean windows per dispatch
        # (K serial backends = 1.0; the shared backend packs K fleets'
        # same-bucket close waves into one arena fill)
        "group_occupancy": round(
            windows_scored / svc.score_dispatches, 3
        )
        if svc.score_dispatches
        else 0.0,
        "per_tenant_p99_ms": {
            str(t): round(_p99(v) * 1e3, 2) for t, v in lat.items()
        },
        "per_tenant_ledger": {
            str(p.tenant): p.ledger.snapshot()["total"] for p in svc.partitions
        },
    }
