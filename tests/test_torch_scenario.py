"""The port's labelled windows, incident suite and CLI against the JAX
package's, on the CPU.

Both packages replay the same traffic from one seed through their own
copies of the simulator, aggregator, fault plans, incidents and chaos
injectors. Held here:

- the anomaly and forecast scenarios' windows bit for bit (every
  ``GraphBatch`` array, ``edge_label``, ``edge_fault_kind``,
  ``edge_label_next``), the fault plan and the train/eval split, on the
  detection leg's traffic (50 pods, 20 services, 40 edges at 200 req/s,
  8 windows), plain, under a ``BatchChaos`` and under each detection-
  scale incident with chaos;
- ``save_trace``/``load_trace`` written by one package, read by the other;
- the incident host legs (``run_host_leg``, the real thread-sharded
  pipeline) of all five scenarios, with and without chaos: the reports
  are equal but for wall-clock fields, and neither has a finding. Under
  chaos the worker-crash count depends on thread interleaving (the
  injector fires on whichever worker reaches a seam first; the gates
  hold for every interleaving), so each side's is held to its own
  restarts instead of to the other's;
- ``_stream_tgn_eval`` on converted params, and five cosine-scheduled
  unrolled TGN updates against ``optax.cosine_decay_schedule`` with
  ``adamw``: f32, rtol/atol 1e-4 (the ROADMAP's oracle);
- a ``Service`` with ``ingest_workers=2`` (thread-sharded ingest)
  closes the same windows as the JAX package's, and as one worker's.
"""

from __future__ import annotations

import dataclasses
import json

import jax
import numpy as np
import optax
import pytest

import __graft_entry__ as jax_entry
from alaz_tpu import __main__ as jcli
from alaz_tpu.chaos.injectors import BatchChaos as JaxBatchChaos
from alaz_tpu.config import ChaosConfig as JaxChaosConfig
from alaz_tpu.config import ModelConfig as JaxModelConfig
from alaz_tpu.config import RuntimeConfig as JaxRuntimeConfig
from alaz_tpu.config import SimulationConfig as JaxSimulationConfig
from alaz_tpu.events.intern import Interner as JaxInterner
from alaz_tpu.models import tgn as jtgn
from alaz_tpu.replay import incidents as jinc
from alaz_tpu.replay import scenario as jscen
from alaz_tpu.replay import trace as jtrace
from alaz_tpu.replay.simulator import Simulator as JaxSimulator
from alaz_tpu.runtime.service import Service as JaxService
from alaz_tpu.train import trainstep as jtrain
from alaz_tpu_torch import __main__ as cli
from alaz_tpu_torch.chaos.injectors import BatchChaos
from alaz_tpu_torch.config import ChaosConfig, ModelConfig, RuntimeConfig, SimulationConfig
from alaz_tpu_torch.convert import params_from_jax
from alaz_tpu_torch.events.intern import Interner
from alaz_tpu_torch.models import tgn
from alaz_tpu_torch.replay import incidents, scenario, trace
from alaz_tpu_torch.replay.simulator import Simulator
from alaz_tpu_torch.runtime.service import Service
from alaz_tpu_torch.train import trainstep
from test_torch_train import labels_from_window

# the detection leg's traffic (replay/incidents.py run_detection_leg)
DET = dict(pod_count=50, service_count=20, edge_count=40, edge_rate=200)
ARRAYS = ("node_feats", "node_type", "node_mask", "edge_src", "edge_dst", "edge_type", "edge_feats",
          "edge_mask", "edge_label", "node_uids", "node_deg", "edge_block_starts")
LABELS = ("edge_fault_kind", "edge_label_next")
SCALARS = ("n_nodes", "n_edges", "window_start_ms", "window_end_ms", "bucket_key")
# report fields read off the wall clock
WALL = ("rows_per_sec", "flush_wall_s", "close_p99_s", "min_close_rows_per_s")


def _assert_array_equal(got, ref, what):
    if ref is None:
        assert got is None, what
        return
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape, what
    assert np.array_equal(got, ref), what


def assert_batches_equal(got: list, ref: list) -> None:
    """Every window's arrays, labels and scalars bit for bit."""
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        for k in SCALARS:
            assert getattr(g, k) == getattr(r, k), (i, k)
        for k in ARRAYS + LABELS:
            _assert_array_equal(getattr(g, k, None), getattr(r, k, None), (i, k))


def assert_data_equal(got, ref) -> None:
    """Two ``ScenarioData``: the split, every window, the plan, the rows
    cut by sampling and the interned strings."""
    assert (len(got.train), len(got.eval)) == (len(ref.train), len(ref.eval))
    assert len(ref.train) >= 1 and len(ref.eval) >= 1
    assert_batches_equal(got.train, ref.train)
    assert_batches_equal(got.eval, ref.eval)
    assert dataclasses.asdict(got.plan) == dataclasses.asdict(ref.plan)
    assert got.sampled_rows == ref.sampled_rows
    n = len(ref.interner)
    assert len(got.interner) == n
    assert [got.interner.lookup(i) for i in range(n)] == [ref.interner.lookup(i) for i in range(n)]


def _chaos(cls, seed: int):
    return cls(seed=seed, dup_prob=0.2, reorder_prob=0.2, late_prob=0.1, min_each=True)


def test_anomaly_windows_equal_bit_for_bit():
    ref = jscen.run_anomaly_scenario(JaxSimulationConfig(**DET), n_windows=8, fault_fraction=0.2, seed=1)
    got = scenario.run_anomaly_scenario(SimulationConfig(**DET), n_windows=8, fault_fraction=0.2, seed=1)
    assert_data_equal(got, ref)
    assert ref.plan.edges and any(b.edge_label.any() for b in ref.all_batches)


def test_forecast_windows_equal_bit_for_bit():
    ref = jscen.run_forecast_scenario(JaxSimulationConfig(**DET), n_windows=8, fault_fraction=0.2, seed=2)
    got = scenario.run_forecast_scenario(SimulationConfig(**DET), n_windows=8, fault_fraction=0.2, seed=2)
    assert_data_equal(got, ref)
    assert ref.plan.ramps and any(b.edge_label_next.any() for b in ref.all_batches)


def test_chaos_windows_equal_bit_for_bit():
    ref = jscen.run_anomaly_scenario(JaxSimulationConfig(**DET), n_windows=8, fault_fraction=0.2, seed=1,
                                     chaos=_chaos(JaxBatchChaos, 5))
    got = scenario.run_anomaly_scenario(SimulationConfig(**DET), n_windows=8, fault_fraction=0.2, seed=1,
                                        chaos=_chaos(BatchChaos, 5))
    assert_data_equal(got, ref)


@pytest.mark.parametrize("name", jinc.SCENARIO_NAMES)
def test_incident_windows_with_chaos_equal_bit_for_bit(name):
    """The detection leg's windows: the detection-scale incident, chaos
    and the scenario's degree cap, as ``run_incident_scenario`` arms
    them."""
    cap = jinc.scenario_degree_cap(name)
    kw = dict(n_windows=8, fault_fraction=0.2, seed=1, degree_cap=cap)
    ref = jscen.run_anomaly_scenario(JaxSimulationConfig(seed=0, **DET), chaos=_chaos(JaxBatchChaos, 7),
                                     incident=jinc.make_detection_incident(name, 0), **kw)
    got = scenario.run_anomaly_scenario(SimulationConfig(seed=0, **DET), chaos=_chaos(BatchChaos, 7),
                                        incident=incidents.make_detection_incident(name, 0), **kw)
    assert_data_equal(got, ref)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_trace_round_trip_across_packages(tmp_path, writer):
    cfg = dict(test_duration_s=2.0, seed=4, **DET)
    sims = {"jax": JaxSimulator(JaxSimulationConfig(**cfg), interner=JaxInterner()),
            "port": Simulator(SimulationConfig(**cfg), interner=Interner())}
    sim = sims[writer]
    kube, tcp, l7 = sim.setup(), sim.tcp_events(), list(sim.iter_l7_batches())
    path = tmp_path / "trace.npz"
    (jtrace if writer == "jax" else trace).save_trace(path, kube, tcp, iter(l7))
    for reader in (jtrace, trace):
        msgs, got_tcp, got_l7 = reader.load_trace(path)
        _assert_array_equal(got_tcp, tcp, "tcp")
        _assert_array_equal(got_l7, np.concatenate(l7), "l7")
        kept = [m for m in kube if type(m.object).__name__ in ("Pod", "Service")]
        assert [(m.resource_type.value, m.event_type.value, type(m.object).__name__, m.object.__dict__)
                for m in msgs] == [(m.resource_type.value, m.event_type.value, type(m.object).__name__,
                                    m.object.__dict__) for m in kept]


# -- the incident suite's host legs ----------------------------------------------------------


@pytest.mark.parametrize("chaos", [False, True], ids=["clean", "chaos"])
@pytest.mark.parametrize("name", jinc.SCENARIO_NAMES)
def test_host_leg_reports_agree(name, chaos):
    jf, pf = [], []
    ref = jinc.run_host_leg(name, seed=0, chaos=JaxChaosConfig(enabled=True, seed=0) if chaos else None,
                            findings=jf)
    got = incidents.run_host_leg(name, seed=0, chaos=ChaosConfig(enabled=True, seed=0) if chaos else None,
                                 findings=pf)
    assert jf == [] and pf == []
    assert ref["windows"] >= 3
    if chaos:
        for rep in (ref, got):
            c = rep.pop("chaos")
            assert c["crashes"] >= 1 and c["crashes"] == c["worker_restarts"]
            assert (c["duplicated"], c["reordered"], c["late"]) >= (1, 1, 1)
    for rep in (ref, got):
        for k in WALL:
            rep.pop(k)
    assert json.loads(json.dumps(got, sort_keys=True, default=str)) == json.loads(
        json.dumps(ref, sort_keys=True, default=str))


def test_suite_cli_host_legs(capsys):
    """``python -m alaz_tpu_torch.replay --no-detection``: one report
    line per scenario, no finding, exit 0."""
    from alaz_tpu_torch.replay.__main__ import main

    assert main(["--seeds", "0", "--no-detection", "--scenarios", "hot_key", "retry_storm"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["scenario"] for r in lines] == ["hot_key", "retry_storm"]
    assert all(r["scenario_findings"] == 0 and r["detection"] == {} for r in lines)


def test_detection_leg_runs_on_the_callers_device():
    rep = incidents.run_incident_scenario("deploy_rollout", seed=0, device="cpu")
    assert rep.ok, rep.findings
    assert rep.detection["auroc"] >= rep.detection["gate"] and rep.detection["eval_windows"] >= 1


# -- TGN: the streamed eval and the cosine schedule -------------------------------------------


def _tgn_pair(hidden: int = 32, max_nodes: int = 128, znorm: bool = False):
    jcfg = JaxModelConfig(model="tgn", hidden_dim=hidden, dtype="float32", use_pallas=False,
                          tgn_max_nodes=max_nodes, edge_feat_znorm=znorm)
    fields = {k: getattr(jcfg, k) for k in ModelConfig.__dataclass_fields__}
    cfg = ModelConfig(**fields)
    jparams = jtgn.init(jax.random.PRNGKey(0), jcfg)
    model = tgn.TGN(cfg)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)), strict=True)
    return jcfg, jparams, cfg, model


@pytest.fixture(scope="module")
def forecast_data():
    return scenario.run_forecast_scenario(SimulationConfig(**DET), n_windows=8, fault_fraction=0.2, seed=3)


def test_stream_tgn_eval_matches(forecast_data):
    """The held-out stream's scores, with the edge-stat z-norm off: the
    replay gives every edge one rate, and the 0/0 z-norm of a constant
    column carries each package's ulp of the mean to ~3e-3 in a score
    after eight windows of memory (ROADMAP §3, known differences)."""
    jcfg, jparams, cfg, model = _tgn_pair()
    ref = jcli._stream_tgn_eval(jcfg, jparams, forecast_data, collect_next=True)
    got = cli._stream_tgn_eval(cfg, model, forecast_data, collect_next=True, device="cpu")
    assert len(got) == len(ref) == 5 and len(got[0]) == len(forecast_data.eval)
    for g, r in zip(got[0], ref[0]):
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-4, atol=1e-4)
    for col in range(1, 5):
        for g, r in zip(got[col], ref[col]):
            _assert_array_equal(g, r, col)
    empty = dataclasses.replace(forecast_data, train=forecast_data.all_batches, eval=[])
    with pytest.raises(RuntimeError, match="increase --windows"):
        cli._stream_tgn_eval(cfg, model, empty, device="cpu")


def test_cosine_schedule_is_optax():
    sched, ref = trainstep.cosine_decay_schedule(3e-3, 7), optax.cosine_decay_schedule(3e-3, 7)
    for t in range(10):
        assert sched(t) == pytest.approx(float(ref(t)), rel=1e-6, abs=1e-12)
    assert sched(7) == sched(12) == 0.0


def test_cosine_scheduled_unrolled_updates_match_optax(monkeypatch):
    """Five ``train_tgn_unrolled`` updates over two window sequences, the
    rate cosine-decayed, from the same params: the losses and the final
    params against the JAX package's, whose update is optax's ``adamw``
    on ``optax.cosine_decay_schedule``. The windows are synthetic (normal
    features, as ``tests/test_torch_tgn.py``'s): on replayed windows some
    weights get gradients at rounding level, whose sign Adam turns into a
    whole step either way, on either package alike."""
    jcfg, _, cfg, model = _tgn_pair()
    windows = [jax_entry._example_batch(n_pods=180, n_svcs=20, n_edges=900 + 40 * s, seed=s) for s in range(3)]
    for b in windows:
        b.edge_label = labels_from_window(b)
    seqs = [windows, windows[1:]]
    jstate, jlosses = jtrain.train_tgn_unrolled(jcfg, seqs, epochs=5, lr=optax.cosine_decay_schedule(3e-3, 5),
                                                seed=0)
    monkeypatch.setattr(trainstep.tgn, "init", lambda seed, cfg, device=None: model)
    state, losses = trainstep.train_tgn_unrolled(cfg, seqs, epochs=5, lr=trainstep.cosine_decay_schedule(3e-3, 5),
                                                 device="cpu")
    assert state.params is model and state.step == jstate.step == 5
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=1e-4)
    got = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=1e-4, atol=1e-4, err_msg=k)
    # the schedule reached the optimizer: the last update ran at count 4
    assert state.opt_state.param_groups[0]["lr"] == pytest.approx(
        float(optax.cosine_decay_schedule(3e-3, 5)(4)))


# -- the thread-sharded Service ---------------------------------------------------------------


SVC_SIM = dict(pod_count=30, service_count=10, edge_count=15, edge_rate=200)


def _sharded_windows(kind: str, workers: int) -> list:
    """Feed the replayed traffic through a Service's ingestion surface
    (``ingest_workers`` shard workers), flush and return the closed
    windows in order."""
    sim_cfg = dict(test_duration_s=3.0, seed=3, **SVC_SIM)
    if kind == "jax":
        interner = JaxInterner()
        svc = JaxService(config=JaxRuntimeConfig(ingest_workers=workers,
                                                 model=JaxModelConfig(hidden_dim=32, use_pallas=False)),
                         interner=interner)
        sim = JaxSimulator(JaxSimulationConfig(**sim_cfg), interner=interner)
    else:
        interner = Interner()
        svc = Service(config=RuntimeConfig(ingest_workers=workers, model=ModelConfig(hidden_dim=32)),
                      interner=interner, device="cpu")
        sim = Simulator(SimulationConfig(**sim_cfg), interner=interner)
    try:
        agg = svc.aggregator
        for m in sim.setup():
            agg.process_k8s(m)
        agg.process_tcp(sim.tcp_events())
        if hasattr(agg, "drain"):
            assert agg.drain(timeout_s=30)
        for b in sim.iter_l7_batches():
            agg.process_l7(b)
        svc.flush_windows()
        return [item[0] for item in svc.window_queue.drain()]
    finally:
        svc.stop()


def test_thread_sharded_service_closes_the_same_windows():
    ref = _sharded_windows("jax", 2)
    got = _sharded_windows("port", 2)
    serial = _sharded_windows("port", 1)
    assert len(ref) >= 3
    for windows in (got, serial):
        assert len(windows) == len(ref)
        for g, r in zip(windows, ref):
            assert (g.window_start_ms, g.n_nodes, g.n_edges, g.bucket_key) == (
                r.window_start_ms, r.n_nodes, r.n_edges, r.bucket_key)
            ga, ra = g.device_arrays(), r.device_arrays()
            assert set(ga) == set(ra)
            for k in ra:
                _assert_array_equal(ga[k], ra[k], k)
