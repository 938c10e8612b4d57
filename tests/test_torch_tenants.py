"""Multi-tenant serving in the port against the JAX package, on the CPU.

- the isolation gate (``replay/tenants.py run_isolation_scenario``, the
  host scorer through the Service's real scorer loop) passes on the
  port, and ``python -m alaz_tpu_torch.replay --isolation`` exits 0;
- the host-scorer override (``Service(score_fn=, score_many_fn=)``): three
  tenants' traffic (``make_tenant_traffic``, one seed, each package's
  simulator) fed to each tenant's partition on the test thread before
  the scorer starts, so the closed windows wait as a backlog and group
  across tenants; each tenant's windows bit for bit and its scores
  exactly equal to the JAX Service's with the same ``host_score_fn``;
- a three-tenant group run of GraphSAGE on the plain versions, over the
  process backend (``score_batch_windows=8``): groups that mix tenants, exact books per tenant, and
  each tenant's scores equal to the same windows scored one at a time
  (rtol/atol 1e-4, f32).
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from alaz_tpu.config import RuntimeConfig as JaxRuntimeConfig
from alaz_tpu.config import TraceConfig as JaxTraceConfig
from alaz_tpu.replay import tenants as jax_tenants
from alaz_tpu.runtime.service import Service as JaxService
from alaz_tpu_torch.config import ModelConfig, RuntimeConfig, TraceConfig
from alaz_tpu_torch.models.registry import init_params
from alaz_tpu_torch.replay import tenants
from alaz_tpu_torch.runtime.scorer import WindowScorer
from alaz_tpu_torch.runtime.service import Service
from chip_smoke import _feed_tenants

REPO = Path(__file__).resolve().parent.parent
TENANTS = 3


def _serve(svc, tenant_traffic):
    """Feed (``chip_smoke._feed_tenants``: each tenant's deliveries
    round-robin into its partition, then every window closed), then
    start the scorer over the backlog; returns each
    tenant's pushed rows, its scored windows in order, and its scores by
    window (every edge annotated: the threshold is 0)."""
    wins = {t: [] for t in tenant_traffic}
    recs = []
    svc.score_sink = recs.append
    svc.score_observer = lambda batch, tenant, lat: wins[tenant].append(batch)
    try:
        pushed = _feed_tenants(svc, tenant_traffic)
        svc.start()
        svc.drain(timeout_s=60)
    finally:
        svc.stop()
    by_interner = {id(p.interner): p.tenant for p in svc.partitions}
    scores = {t: {} for t in tenant_traffic}
    for sb in recs:
        scores[by_interner[id(sb.interner)]][sb.window_start_ms] = sb.score
    return pushed, wins, scores


def test_isolation_gate_passes_on_the_port():
    rep = tenants.run_isolation_scenario(tenants=TENANTS, seed=0)
    assert rep.ok, rep.findings
    for t in range(TENANTS):
        entry = rep.per_tenant[str(t)]
        assert entry["gap"] == 0 and entry["windows"] >= 6
    assert rep.combined["windows"] == sum(rep.per_tenant[str(t)]["windows"] for t in range(TENANTS))


def test_isolation_cli_exits_zero():
    out = subprocess.run(
        [sys.executable, "-m", "alaz_tpu_torch.replay", "--isolation", "--no-detection",
         "--scenarios", "dns_storm", "--workers", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    reports = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    assert [r["scenario"] for r in reports][-1] == "multi_tenant_isolation"
    assert reports[-1]["scenario_findings"] == 0


@pytest.mark.parametrize("batch_windows", [1, 4])
def test_host_scorer_override_matches_the_jax_service(batch_windows):
    traffic = {t: tenants.make_tenant_traffic(t, 0, 4) for t in range(TENANTS)}
    jtraffic = {t: jax_tenants.make_tenant_traffic(t, 0, 4) for t in range(TENANTS)}
    for t in range(TENANTS):
        assert traffic[t][1].total_rows == jtraffic[t][1].total_rows
    kw = dict(model_state={"host": "feature_logits"}, score_fn=jax_tenants.host_score_fn,
              score_many_fn=jax_tenants.host_score_many_fn, score_threshold=0.0)
    jsvc = JaxService(config=JaxRuntimeConfig(tenants=TENANTS, score_batch_windows=batch_windows,
                                              trace=JaxTraceConfig(score_drift_windows=2)), **kw)
    psvc = Service(config=RuntimeConfig(tenants=TENANTS, score_batch_windows=batch_windows,
                                        trace=TraceConfig(score_drift_windows=2)), **kw)
    assert psvc.torch_device.type == "cpu"  # a host scorer needs no card
    jpushed, jwins, jscores = _serve(jsvc, jtraffic)
    ppushed, pwins, pscores = _serve(psvc, traffic)
    assert ppushed == jpushed
    for t in range(TENANTS):
        assert len(pwins[t]) == len(jwins[t]) >= 4
        for a, b in zip(jwins[t], pwins[t]):
            assert a.window_start_ms == b.window_start_ms
            ja, pa = a.device_arrays("coo"), b.device_arrays("coo")
            assert set(ja) == set(pa)
            for k in ja:
                assert np.asarray(ja[k]).tobytes() == pa[k].tobytes(), (t, a.window_start_ms, k)
        assert pscores[t] and {w: v.tobytes() for w, v in pscores[t].items()} == {
            w: v.tobytes() for w, v in jscores[t].items()}
        assert psvc.partitions[t].ledger.total == jsvc.partitions[t].ledger.total
    assert (psvc.score_dispatches, psvc.multi_tenant_groups) == (jsvc.score_dispatches, jsvc.multi_tenant_groups)
    if batch_windows > 1:
        assert psvc.multi_tenant_groups > 0 and psvc.score_dispatches < psvc.scored_batches


def test_three_tenant_groups_on_process_backend_equal_serial_scoring():
    cfg = ModelConfig(hidden_dim=32, dtype="float32")
    params = init_params(cfg, key=0, device="cpu")
    traffic = {t: tenants.make_tenant_traffic(t, 0, 4) for t in range(TENANTS)}
    # the process pools close windows on their own merge threads, so the
    # backlog's order across tenants varies from run to run; a group of 8
    # out of 3 tenants' 4 windows each always mixes tenants
    svc = Service(config=RuntimeConfig(model=cfg, tenants=TENANTS, score_batch_windows=8,
                                       ingest_backend="process", ingest_workers=1),
                  model_state=params, score_threshold=0.0, device="cpu")
    assert all(type(p.sharded).__name__ == "ProcessShardedIngest" for p in svc.partitions)
    pushed, wins, scores = _serve(svc, traffic)
    assert svc.multi_tenant_groups > 0 and svc.score_dispatches < svc.scored_batches
    serial = WindowScorer(cfg, params, device="cpu")
    for t in range(TENANTS):
        part = svc.partitions[t]
        assert wins[t] and part.ledger.conservation_gap(pushed[t], sum(b.aggregated_rows() for b in wins[t])) == 0
        assert sorted(scores[t]) == [b.window_start_ms for b in wins[t]]
        for b in wins[t]:
            np.testing.assert_allclose(scores[t][b.window_start_ms], serial.score(b), rtol=1e-4, atol=1e-4)


def test_host_scorer_takes_no_device():
    """A host scorer runs on the host: the Service takes no device with
    it, and needs no card without one."""
    kw = dict(model_state={"host": "feature_logits"}, score_fn=tenants.host_score_fn)
    with pytest.raises(ValueError, match="no device"):
        Service(device="cpu", **kw)
    svc = Service(config=RuntimeConfig(score_batch_windows=4), **kw)
    try:
        assert svc.torch_device.type == "cpu" and svc.model_state == kw["model_state"]
        assert svc._score_many_fn is None  # no stacked twin given: windows score serially
    finally:
        svc.stop()
