"""Anomaly-detection scenarios: replay + fault injection + labeled windows.

Wires the full path of BASELINE.json configs 2-4: simulator traffic →
aggregator join → fault injector → windowed graph store → labeled
GraphBatches split into train/eval window ranges.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from alaz_tpu_torch.aggregator.engine import Aggregator
from alaz_tpu_torch.config import SimulationConfig
from alaz_tpu_torch.datastore.interface import BaseDataStore
from alaz_tpu_torch.events.intern import Interner
from alaz_tpu_torch.graph.builder import WindowedGraphStore
from alaz_tpu_torch.graph.snapshot import GraphBatch
from alaz_tpu_torch.replay import faults as faults_mod
from alaz_tpu_torch.replay.incidents import replay_delivery
from alaz_tpu_torch.replay.simulator import _BASE_TIME_NS, Simulator


class FaultInjectingStore(BaseDataStore):
    """Datastore shim: injects faults into request rows, then forwards to
    the windowed graph store — the seam where reality goes wrong."""

    def __init__(self, inner: WindowedGraphStore, plan: faults_mod.FaultPlan, rng: np.random.Generator):
        self.inner = inner
        self.plan = plan
        self.rng = rng

    def persist_requests(self, batch: np.ndarray) -> None:
        rows = batch.copy()
        labels = faults_mod.inject(rows, self.plan, self.rng)
        rows, labels = faults_mod.drop_zombie_rows(rows, labels, self.plan, self.rng)
        self.inner.persist_requests(rows)

    def persist_resource(self, rtype, event, obj) -> None:
        self.inner.persist_resource(rtype, event, obj)


@dataclass
class ScenarioData:
    train: List[GraphBatch]
    eval: List[GraphBatch]
    interner: Interner
    plan: faults_mod.FaultPlan
    # request rows cut by degree-capped sampling — lets the
    # sampling-parity gate assert the cap actually BIT, not that it was
    # vacuously within tolerance
    sampled_rows: int = 0

    @property
    def all_batches(self) -> List[GraphBatch]:
        return self.train + self.eval


def _run_scenario(
    sim_cfg: SimulationConfig,
    n_windows: int,
    window_s: float,
    train_frac: float,
    seed: int,
    plan_fn,
    label_fn,
    chaos=None,
    incident=None,
    degree_cap: int = 0,
) -> ScenarioData:
    """The shared scenario pipeline: simulate → inject per ``plan_fn(rng,
    uid_pairs)`` → aggregate into labeled windows via ``label_fn(batch,
    plan)`` → time-split. Both public scenarios are thin wrappers so the
    replay plumbing (flush timing, store wiring) can never diverge.

    ``chaos`` (a :class:`alaz_tpu.chaos.BatchChaos`) perturbs the L7
    delivery — duplicated/reordered/late batches — BEFORE the
    aggregator, replaying infrastructure faults under the semantic fault
    plan: the chaos-AUROC gate trains and evaluates on exactly this
    degraded stream (ISSUE 6 acceptance).

    ``incident`` (an :class:`alaz_tpu.replay.incidents.Incident`, or a
    list of them) reshapes the traffic itself — hot-key fan-in, deploy
    rollout churn, retry storms (ISSUE 7). Incidents compose with chaos:
    the incident shapes the stream, chaos degrades its delivery, so
    "hot-key during a degraded delivery" is one call with both args.
    Incident-labeled pairs (e.g. the retry storm's victim edges) fold
    into the oracle next to the fault plan's labels.

    ``degree_cap`` arms degree-capped reservoir sampling at window close
    (graph/builder.py) — the hot-key defense under detection test."""
    from alaz_tpu_torch.replay import incidents as incidents_mod

    rng = np.random.default_rng(seed)
    interner = Interner()
    sim = Simulator(
        SimulationConfig(
            **{
                **sim_cfg.__dict__,
                "test_duration_s": n_windows * window_s,
            }
        ),
        interner=interner,
    )
    kube_msgs = sim.setup()

    # fault plan over the simulator's edge set (uid-id pairs)
    pairs = [
        (
            interner.intern(sim.pods[e.pod_idx].uid),
            interner.intern(sim.services[e.svc_idx].uid),
        )
        for e in sim.edges
    ]
    plan = plan_fn(rng, pairs)

    store = WindowedGraphStore(
        interner, window_s=window_s, degree_cap=degree_cap, sample_seed=seed
    )
    injected = FaultInjectingStore(store, plan, rng)
    agg = Aggregator(injected, interner=interner)
    for m in kube_msgs:
        agg.process_k8s(m)
    agg.process_tcp(sim.tcp_events())

    traffic = incidents_mod.base_traffic(sim)
    if incident is not None:
        for inc in incident if isinstance(incident, (list, tuple)) else [incident]:
            traffic = inc.apply(sim, traffic)
    deliveries = traffic.deliveries
    if chaos is not None:
        # late batches re-deliver at the end of the stream — past their
        # windows' watermarks, so they exercise the late-drop path
        delivery, late = chaos.perturb(deliveries)
        deliveries = delivery + late
    for d in deliveries:
        replay_delivery(agg, d)
    agg.flush_retries(now_ns=_BASE_TIME_NS + int((n_windows + 10) * window_s * 1e9))
    store.flush()

    batches = store.batches
    for b in batches:
        label_fn(b, plan)
        if traffic.label_pairs:
            extra = incidents_mod.label_extra(
                b, traffic.label_pairs, traffic.label_span_ms
            )
            b.edge_label = np.maximum(b.edge_label, extra)

    n_train = max(1, int(len(batches) * train_frac))
    return ScenarioData(
        train=batches[:n_train],
        eval=batches[n_train:],
        interner=interner,
        plan=plan,
        sampled_rows=store.builder.sampled_rows,
    )


def run_anomaly_scenario(
    sim_cfg: SimulationConfig,
    n_windows: int = 10,
    window_s: float = 1.0,
    fault_fraction: float = 0.15,
    train_frac: float = 0.6,
    fault_kinds: tuple = faults_mod.FAULT_KINDS,
    seed: int = 0,
    chaos=None,
    incident=None,
    degree_cap: int = 0,
) -> ScenarioData:
    """Replay ``n_windows`` of traffic with a persistent fault plan, label
    every closed window with the oracle, and split train/eval by time.
    ``chaos`` (optional BatchChaos) degrades the delivery plane — the
    detection-under-chaos gate runs this with default intensities.
    ``incident`` (optional Incident(s), replay/incidents.py) reshapes
    the traffic itself and ``degree_cap`` arms close-time sampling, so
    "hot-key during a degraded delivery, capped" is one call."""

    def label(b, plan):
        b.edge_label = faults_mod.label_batch_edges(b, plan)
        # per-class oracle for kind-broken-out AUROC (metrics.auroc_by_kind)
        b.edge_fault_kind = faults_mod.label_batch_kinds(b, plan)

    return _run_scenario(
        sim_cfg, n_windows, window_s, train_frac, seed,
        plan_fn=lambda rng, pairs: faults_mod.make_plan(
            rng, pairs, fault_fraction, kinds=fault_kinds
        ),
        label_fn=label,
        chaos=chaos,
        incident=incident,
        degree_cap=degree_cap,
    )


def run_forecast_scenario(
    sim_cfg: SimulationConfig,
    n_windows: int = 20,
    window_s: float = 1.0,
    fault_fraction: float = 0.15,
    train_frac: float = 0.6,
    ramp_windows: int = 4,
    full_mult: float = 12.0,
    seed: int = 0,
) -> ScenarioData:
    """BASELINE config 4's FORECASTING task: latency faults RAMP over
    ``ramp_windows`` windows instead of stepping, and every batch carries
    ``edge_label_next`` — what the edge's spike label WILL be at the end
    of the NEXT window. A temporal model watching the sub-threshold
    drift (the leading indicator) can call the spike one window early;
    train on ``edge_label_next`` and evaluate AUROC against it
    (train/trainstep.py train_tgn_unrolled(label_attr=...)).

    Onsets are spread over the middle of the run so both the train and
    eval spans contain pre-onset, ramping, and spiking states."""
    window_ms = int(window_s * 1000)
    base_ms = _BASE_TIME_NS // 1_000_000

    def label(b, plan):
        b.edge_label = faults_mod.label_batch_edges(b, plan)
        b.edge_fault_kind = faults_mod.label_batch_kinds(b, plan)
        # the forecast target: this edge's spike state at the END of the
        # next window
        b.edge_label_next = faults_mod.label_batch_edges(
            b, plan, at_ms=int(b.window_end_ms) + window_ms
        )

    return _run_scenario(
        sim_cfg, n_windows, window_s, train_frac, seed,
        plan_fn=lambda rng, pairs: faults_mod.make_ramp_plan(
            rng,
            pairs,
            fault_fraction,
            onset_lo_ms=base_ms + window_ms,
            onset_hi_ms=base_ms + (n_windows - ramp_windows // 2) * window_ms,
            span_ms=ramp_windows * window_ms,
            full_mult=full_mult,
        ),
        label_fn=label,
    )
