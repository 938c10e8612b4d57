"""The port's streaming ``Service`` against the JAX package's, on the CPU.

Both services take the same replayed traffic (each package's
``Simulator`` from one seed, 30 pods, 10 services, 15 edges at 200 req/s, as
``tests/test_runtime.py`` drives it), fed to their aggregators on the
test thread before the workers start, so window close is deterministic
and the closed windows wait in the window queue as a backlog: the serial
path scores them one by one, ``score_batch_windows=4`` groups them.
Params come from the JAX package's ``init`` (f32, hidden 32), carried
across with ``convert.params_from_jax``; the JAX side runs with
``use_pallas=False`` and the port's wrappers take their plain versions
on CPU tensors.

Held here:
- the closed windows' ``device_arrays`` bit for bit, COO and blocked,
  with and without ``renumber_nodes``;
- the per-uid score maps ``(window_start_ms, from_uid, to_uid,
  protocol) → score`` at rtol/atol 1e-4 (f32) for GraphSAGE, GAT
  (``src_gather="banded"``, renumbered), the experts and TGN;
- the group path (``score_batch_windows=4``: the block-diagonal stack)
  against the JAX package's vmapped path and against the port's serial
  path, ``edge_feat_znorm`` on, and GAT's saturation gauge equal;
- the same two holds with native ingest on both sides
  (``ENGINE_BACKEND=native``, ``use_native_ingest=True``: the C++ L7
  engine and window accumulator): the windows, and the scores of
  GraphSAGE over COO and GAT renumbered and blocked;
- TGN refusing the group path and ``renumber_nodes``; arena reuse in
  steady state; the metric names; no card, no service.
"""

from __future__ import annotations

import json
import re

import jax
import numpy as np
import pytest

from alaz_tpu.config import ModelConfig as JaxModelConfig
from alaz_tpu.config import RuntimeConfig as JaxRuntimeConfig
from alaz_tpu.config import SimulationConfig as JaxSimulationConfig
from alaz_tpu.events.intern import Interner as JaxInterner
from alaz_tpu.models.registry import get_model as jax_get_model
from alaz_tpu.replay.simulator import Simulator as JaxSimulator
from alaz_tpu.runtime.service import Service as JaxService
from alaz_tpu_torch.config import ModelConfig, RuntimeConfig, SimulationConfig
from alaz_tpu_torch.convert import params_from_jax
from alaz_tpu_torch.events.intern import Interner
from alaz_tpu_torch.models.registry import init_params
from alaz_tpu_torch.replay.simulator import Simulator
from alaz_tpu_torch.runtime.service import Service

SIM = dict(pod_count=30, service_count=10, edge_count=15, edge_rate=200)
HIDDEN = 32


def _cfgs(model="graphsage", layout="coo", renumber=False, batch_windows=1, engine_backend="python", **model_kw):
    kw = dict(model=model, hidden_dim=HIDDEN, dtype="float32", edge_layout=layout, **model_kw)
    out = []
    for runtime, mcfg, use_pallas in ((JaxRuntimeConfig, JaxModelConfig, False), (RuntimeConfig, ModelConfig, True)):
        cfg = runtime(model=mcfg(use_pallas=use_pallas, **kw), score_batch_windows=batch_windows,
                      edge_layout=layout, renumber_nodes=renumber, engine_backend=engine_backend)
        out.append(cfg)
    return out


def _params(jcfg, scale_attn: float = 1.0):
    """JAX params from seed 0 and the same params as the port's module.
    ``scale_attn`` multiplies GAT's attention vectors, to drive logits
    into the ±30 clamp."""
    init, _ = jax_get_model(jcfg.model.model)
    jparams = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0), jcfg.model))
    if scale_attn != 1.0:
        for layer in jparams["layers"]:
            layer["attn"] = layer["attn"] * np.float32(scale_attn)
    return jparams


def _port_params(pcfg, jparams):
    model = init_params(pcfg.model, key=0, device="cpu")
    model.load_state_dict(params_from_jax(jparams), strict=True)
    return model


def _ingest(svc, sim) -> None:
    """Feed the replayed traffic through the service's aggregator on this
    thread and close every window: they wait in the window queue."""
    for m in sim.setup():
        svc.aggregator.process_k8s(m)
    svc.aggregator.process_tcp(sim.tcp_events())
    for b in sim.iter_l7_batches():
        svc.aggregator.process_l7(b)
    svc.flush_windows()


def _serve(kind, cfg, params, duration_s=3.0, seed=11, native=False):
    """Build the JAX (``kind="jax"``) or the port's service, ingest the
    traffic, then start it so the scorer takes the backlog. Returns the
    service, its score records and the scored windows in order.
    ``native`` closes windows in the C++ window accumulator."""
    records, windows = [], []
    if kind == "jax":
        interner = JaxInterner()
        svc = JaxService(config=cfg, interner=interner, score_sink=records.extend,
                         model_state=params, score_threshold=0.0, use_native_ingest=native)
        sim = JaxSimulator(JaxSimulationConfig(test_duration_s=duration_s, seed=seed, **SIM), interner=interner)
    else:
        interner = Interner()
        svc = Service(config=cfg, interner=interner, score_sink=records.extend,
                      model_state=params, score_threshold=0.0, device="cpu", use_native_ingest=native)
        sim = Simulator(SimulationConfig(test_duration_s=duration_s, seed=seed, **SIM), interner=interner)
    svc.score_observer = lambda batch, tenant, lat: windows.append(batch)
    _ingest(svc, sim)
    svc.start()
    try:
        svc.drain(timeout_s=60)
    finally:
        svc.stop()
    return svc, records, windows


def _score_map(records) -> dict:
    return {(r.window_start_ms, r.from_uid, r.to_uid, r.protocol): r.score for r in records}


def _assert_maps_close(got: dict, ref: dict, tol: float = 1e-4) -> None:
    assert ref, "no scores"
    assert set(got) == set(ref)
    keys = sorted(ref)
    np.testing.assert_allclose([got[k] for k in keys], [ref[k] for k in keys], rtol=tol, atol=tol)


def _tol(kw: dict) -> float:
    return ZNORM_GAT_TOL if kw.get("model") == "gat" and kw.get("edge_feat_znorm", True) else 1e-4


def _closed_windows(svc, sim) -> list:
    _ingest(svc, sim)
    return [item[0] for item in svc.window_queue.drain()]


@pytest.mark.parametrize("layout", ["coo", "blocked"])
@pytest.mark.parametrize("renumber", [False, True])
def test_closed_windows_equal_bit_for_bit(layout, renumber):
    _hold_closed_windows(layout, renumber, native=False)


@pytest.mark.parametrize("layout", ["coo", "blocked"])
@pytest.mark.parametrize("renumber", [False, True])
def test_closed_windows_equal_bit_for_bit_native_ingest(layout, renumber):
    """Both services with ``ENGINE_BACKEND=native`` and
    ``use_native_ingest=True``: the C++ L7 engine and window accumulator."""
    _hold_closed_windows(layout, renumber, native=True)


def _hold_closed_windows(layout, renumber, native):
    backend = "native" if native else "python"
    jcfg, pcfg = _cfgs(layout=layout, renumber=renumber, engine_backend=backend)
    jint, pint = JaxInterner(), Interner()
    sim_cfg = JaxSimulationConfig(test_duration_s=3.0, seed=3, **SIM)
    jsvc = JaxService(config=jcfg, interner=jint, use_native_ingest=native)
    psvc = Service(config=pcfg, interner=pint, device="cpu", use_native_ingest=native)
    ref = _closed_windows(jsvc, JaxSimulator(sim_cfg, interner=jint))
    got = _closed_windows(psvc, Simulator(SimulationConfig(test_duration_s=3.0, seed=3, **SIM), interner=pint))
    assert (type(psvc.graph_store).__name__, type(jsvc.graph_store).__name__) == (
        ("NativeWindowedStore",) * 2 if native else ("WindowedGraphStore",) * 2)
    assert (psvc.aggregator._native_l7 is not None) == (jsvc.aggregator._native_l7 is not None) == native
    assert len(ref) >= 3 and len(got) == len(ref)
    for g, r in zip(got, ref):
        assert (g.window_start_ms, g.n_nodes, g.n_edges, g.bucket_key) == (r.window_start_ms, r.n_nodes, r.n_edges, r.bucket_key)
        ga, ra = g.device_arrays(layout), r.device_arrays(layout)
        assert set(ga) == set(ra)
        for k in ra:
            assert ga[k].dtype == ra[k].dtype and np.array_equal(ga[k], ra[k]), k
        np.testing.assert_array_equal(g.node_uids, r.node_uids)


FAMILIES = {
    "graphsage": dict(),
    "gat": dict(model="gat", src_gather="banded", renumber=True),
    "gat-no-znorm": dict(model="gat", src_gather="banded", renumber=True, edge_feat_znorm=False),
    "experts": dict(model="experts"),
    "tgn": dict(model="tgn", tgn_max_nodes=256),
}
# The replayed traffic gives every edge the same request rate, so the
# count and rate columns are constant over a window and their z-norm is
# 0/0: each package's f32 mean lands within an ulp of the value, and
# rsqrt(var + 1e-8) = 1e4 turns that ulp into z of order 1e-2, on either
# side of 0 depending on the order of the sum. GAT's attention carries it
# to ~5e-4 in a score (the same model with the z-norm off agrees to
# 2e-7), so GAT with the z-norm on is held at 1e-3; everything else at
# the f32 oracle's 1e-4.
ZNORM_GAT_TOL = 1e-3


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_serial_scores_match_the_jax_service(family):
    _hold_serial_scores(FAMILIES[family], native=False)


# native ingest: GraphSAGE over COO windows, GAT renumbered and blocked
NATIVE_FAMILIES = {
    "graphsage": dict(),
    "gat": dict(model="gat", src_gather="banded", renumber=True, layout="blocked"),
}


@pytest.mark.parametrize("family", sorted(NATIVE_FAMILIES))
def test_serial_scores_match_the_jax_service_native_ingest(family):
    """Both services with ``ENGINE_BACKEND=native`` and
    ``use_native_ingest=True``, at the tolerances above."""
    _hold_serial_scores(NATIVE_FAMILIES[family], native=True)


def _hold_serial_scores(kw, native):
    jcfg, pcfg = _cfgs(engine_backend="native" if native else "python", **kw)
    jparams = _params(jcfg)
    jsvc, jrec, jwin = _serve("jax", jcfg, jax.tree_util.tree_map(jax.numpy.asarray, jparams), native=native)
    psvc, prec, pwin = _serve("port", pcfg, _port_params(pcfg, jparams), native=native)
    assert psvc.scored_batches == psvc.metrics.counter("windows.closed").value == jsvc.scored_batches >= 3
    assert psvc.score_dispatches == psvc.scored_batches
    assert (type(psvc.graph_store).__name__ == "NativeWindowedStore") == native
    for g, r in zip(pwin, jwin):
        for k, v in r.device_arrays(jcfg.edge_layout).items():
            assert np.array_equal(g.device_arrays(pcfg.edge_layout)[k], v), k
    _assert_maps_close(_score_map(prec), _score_map(jrec), _tol(kw))


@pytest.mark.parametrize(
    "family,layout",
    [("graphsage", "coo"), ("graphsage", "blocked"), ("gat", "coo"), ("experts", "blocked")],
)
def test_group_path_matches_vmap_and_serial(family, layout):
    """Three or four backlogged windows in one dispatch (a group of 3 is
    padded to 4 by repeating the last window), against the JAX package's
    vmapped dispatch and the port's serial path on the same windows."""
    kw = dict(FAMILIES[family])
    scale = 300.0 if family == "gat" else 1.0
    jcfg, pcfg = _cfgs(layout=layout, batch_windows=4, **kw)
    _, pcfg_serial = _cfgs(layout=layout, batch_windows=1, **kw)
    assert jcfg.model.edge_feat_znorm and pcfg.model.edge_feat_znorm
    jparams = _params(jcfg, scale_attn=scale)
    jsvc, jrec, _ = _serve("jax", jcfg, jax.tree_util.tree_map(jax.numpy.asarray, jparams))
    psvc, prec, _ = _serve("port", pcfg, _port_params(pcfg, jparams))
    _, srec, _ = _serve("port", pcfg_serial, _port_params(pcfg_serial, jparams))
    n = psvc.metrics.counter("windows.closed").value
    assert psvc.scored_batches == n == jsvc.scored_batches >= 3
    assert psvc.score_dispatches == jsvc.score_dispatches == 1
    assert psvc._stage_arenas.fills == 1
    _assert_maps_close(_score_map(prec), _score_map(jrec), _tol(kw))
    _assert_maps_close(_score_map(prec), _score_map(srec), _tol(kw))
    if family == "gat":
        gauge = "model.attn_clamp_saturation"
        got, ref = psvc.metrics.gauge(gauge).value, jsvc.metrics.gauge(gauge).value
        assert ref > 0.0
        assert got == pytest.approx(ref, rel=1e-6, abs=1e-7)


@pytest.mark.parametrize("layout", ["coo", "blocked"])
@pytest.mark.parametrize("model", ["graphsage", "gat", "experts"])
def test_group_graph_gives_each_window_its_own_forward(model, layout):
    """The block-diagonal stack of ``models/common.py group_graph`` keeps
    ``jax.vmap``'s per-window semantics: three synthetic windows of one
    bucket with their own edge counts and edge statistics (so each
    window's z-norm has its own mean and variance) and, for GAT,
    attention scaled into the clamp so each window saturates its own
    fraction; the group's per-window outputs against each window's own
    forward, f32 at 1e-4, the saturation per window at 1e-6; under the
    blocked layout the stacked extents are each block's first edge."""
    import torch

    from alaz_tpu_torch.models.common import group_graph
    from alaz_tpu_torch.models.registry import get_model
    from alaz_tpu_torch.replay.synth import example_batch

    cfg = ModelConfig(model=model, hidden_dim=HIDDEN, dtype="float32", edge_layout=layout)
    windows = [example_batch(n_pods=180, n_svcs=20, n_edges=n, seed=s) for s, n in ((0, 1000), (1, 800), (2, 900))]
    for b in windows[1:]:
        b.edge_feats[: b.n_edges, :7] *= 1.0 + b.n_edges / 1000.0  # statistics of their own
    assert len({b.bucket_key for b in windows}) == 1
    params = init_params(cfg, key=0, device="cpu")
    if model == "gat":
        with torch.no_grad():
            for layer in params.layers:
                layer.attn.mul_(300.0)
    _, apply = get_model(model)
    arrays = [b.device_arrays(layout) for b in windows]
    stacked = {k: torch.from_numpy(np.stack([a[k] for a in arrays])) for k in arrays[0]}
    graph = group_graph(stacked, cfg)
    w = len(windows)
    if layout == "blocked":
        # the extents K1 reads on the card (its plain version reads only
        # the frontier): each block's first edge in the stacked dst order
        bounds = torch.arange(graph["node_feats"].shape[0] // 128, dtype=torch.int32) * 128
        want = torch.searchsorted(graph["edge_dst"], bounds).to(torch.int32)
        assert torch.equal(graph["edge_block_starts"][:-1], want)
        assert int(graph["edge_block_starts"][-1]) == (w - 1) * windows[0].e_pad + windows[-1].n_edges
    with torch.no_grad():
        group = apply(params, graph, cfg)
        own = [apply(params, {k: torch.from_numpy(v) for k, v in a.items()}, cfg) for a in arrays]
    for i, b in enumerate(windows):
        for key, n in (("edge_logits", b.n_edges), ("node_logits", b.n_nodes)):
            got = group[key].reshape(w, -1)[i, :n]
            np.testing.assert_allclose(got.numpy(), own[i][key][:n].numpy(), rtol=1e-4, atol=1e-4)
    if model == "gat":
        sats = [float(o["attn_clamp_saturation"]) for o in own]
        assert len(set(sats)) == w and min(sats) > 0.0
        np.testing.assert_allclose(group["attn_clamp_saturation"].numpy(), sats, rtol=1e-6, atol=1e-7)


def test_ragged_backlog_groups_then_scores_the_rest_serially():
    """Five backlogged windows at W=4: one group of 4, then the fifth on
    the serial path; each window's scores equal the serial path's."""
    jcfg, pcfg = _cfgs(batch_windows=4)
    _, pcfg_serial = _cfgs()
    jparams = _params(jcfg)
    psvc, prec, _ = _serve("port", pcfg, _port_params(pcfg, jparams), duration_s=5.0)
    ssvc, srec, _ = _serve("port", pcfg_serial, _port_params(pcfg_serial, jparams), duration_s=5.0)
    assert psvc.scored_batches == ssvc.scored_batches == 5
    assert psvc.score_dispatches == 2
    _assert_maps_close(_score_map(prec), _score_map(srec))


def test_arenas_reuse_in_steady_state():
    """Groups of two over a backlog of six same-bucket windows: the two
    buffers of the double buffer are allocated once, then reused, as the
    JAX package's arenas are."""
    jcfg, pcfg = _cfgs(batch_windows=2)
    jparams = _params(jcfg)
    jsvc, _, _ = _serve("jax", jcfg, jax.tree_util.tree_map(jax.numpy.asarray, jparams), duration_s=6.0)
    psvc, _, wins = _serve("port", pcfg, _port_params(pcfg, jparams), duration_s=6.0)
    assert len({w.bucket_key for w in wins}) == 1 and len(wins) == 6
    arenas = psvc._stage_arenas
    assert (arenas.fills, arenas.reuses) == (3, 1)
    assert (arenas.fills, arenas.reuses) == (jsvc._stage_arenas.fills, jsvc._stage_arenas.reuses)
    assert not arenas.pin  # page-locked only on a card


def test_tgn_refuses_grouping_and_renumbering():
    _, pcfg = _cfgs(model="tgn", batch_windows=4, tgn_max_nodes=256)
    params = init_params(pcfg.model, key=0, device="cpu")
    svc = Service(config=pcfg, interner=Interner(), model_state=params, device="cpu")
    assert svc._score_many_fn is None
    _, pcfg = _cfgs(model="tgn", renumber=True, tgn_max_nodes=256)
    with pytest.raises(ValueError, match="renumber_nodes"):
        Service(config=pcfg, interner=Interner(), model_state=params, device="cpu")


def test_metric_names_equal_the_jax_services():
    """Every metric the JAX service registers, the port registers too,
    under the same name, and no other; the JAX package's XLA compile
    plane (``compile.*``) has no counterpart. (Its TPU runtime gauges,
    ``runtime/tpu_env.py``, register only where a TPU runtime answers:
    not on the CPU, and the port has none.)"""
    jcfg, pcfg = _cfgs(batch_windows=2)
    jparams = _params(jcfg)
    jsvc, _, _ = _serve("jax", jcfg, jax.tree_util.tree_map(jax.numpy.asarray, jparams))
    psvc, _, _ = _serve("port", pcfg, _port_params(pcfg, jparams))

    def names(svc):
        # per-device series under one name: the JAX side sees the test
        # run's 8 virtual CPU devices, the port one CPU
        snap = set(svc.metrics.snapshot()) | set(svc.metrics.infos())
        return {re.sub(r"^device\d+\.", "device<i>.", n) for n in snap if not n.startswith("compile.")}

    jnames, pnames = names(jsvc), names(psvc)
    assert any(n.startswith("compile.") for n in jsvc.metrics.snapshot())
    assert pnames == jnames


def test_no_card_no_service():
    """With no card, the service and ``serve`` raise unless the CPU is
    asked for; ``serve --device cpu`` runs a replay config end to end."""
    import torch

    from alaz_tpu_torch.__main__ import main

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Service()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["serve", "--config", "testconfig/config1.json", "--debug-port", "0"])


def test_serve_cli_on_the_cpu(tmp_path, monkeypatch, capsys):
    from alaz_tpu_torch.__main__ import main
    from alaz_tpu_torch.train import checkpoint

    cfg = ModelConfig(hidden_dim=HIDDEN)
    checkpoint.save(tmp_path / "ckpt", 0, init_params(cfg, key=0, device="cpu"),
                    contract=checkpoint.feature_contract(cfg))
    traffic = tmp_path / "traffic.json"
    traffic.write_text(json.dumps({"testDuration": 3, "podCount": 30, "serviceCount": 10,
                                   "edgeCount": 15, "edgeRate": 200}))
    monkeypatch.setenv("HIDDEN_DIM", str(HIDDEN))
    assert main(["serve", "--config", str(traffic), "--flat-out", "--ckpt", str(tmp_path / "ckpt"),
                 "--device", "cpu", "--debug-port", "0"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["windows_closed"] == out["windows_scored"] >= 3
    assert out["edges_scored"] > 0
    monkeypatch.setenv("BACKEND_HOST", "http://localhost:1")
    with pytest.raises(ValueError, match="ROADMAP"):
        main(["serve", "--config", str(traffic), "--device", "cpu", "--debug-port", "0"])
