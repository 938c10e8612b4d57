"""The port's process backend (``alaz_tpu_torch/shm``) against the port's
serial path and the JAX package's process backend, on the CPU.

Traffic is ``replay.synth.make_ingest_trace`` from a seed (each
package's copy; the rows are the same bytes). Interned ids are local to
each worker process and are exchanged at the merge, so windows are
compared by name (``_canonical``: each edge as its endpoint strings,
protocol and feature bytes) where numbering may differ, and bit for bit,
every ``GraphBatch`` field and the interner's strings in order, where it
may not: on in-cluster traffic, where no outbound address is interned
inside a worker (outbound numbering follows each worker's set order, a
freedom of every backend, the JAX package's own runs included).

Every test stops its pools; every flush carries the JAX package's 60 s
timeout (``tests/test_process_ingest.py``), so a hung worker fails the
test instead of holding the run.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from alaz_tpu.events.intern import Interner as JaxInterner
from alaz_tpu.replay.synth import make_ingest_trace as jax_make_ingest_trace
from alaz_tpu.shm.process_pool import ProcessShardedIngest as JaxProcessShardedIngest
from alaz_tpu_torch.aggregator.cluster import ClusterInfo
from alaz_tpu_torch.aggregator.engine import Aggregator
from alaz_tpu_torch.chaos.harness import emitted_rows
from alaz_tpu_torch.config import RuntimeConfig
from alaz_tpu_torch.events.intern import Interner
from alaz_tpu_torch.graph.builder import WindowedGraphStore
from alaz_tpu_torch.replay.synth import make_ingest_trace
from alaz_tpu_torch.shm.process_pool import ProcessShardedIngest

REPO = Path(__file__).resolve().parent.parent
CHUNK = 1 << 13
NOW_NS = 10_000_000_000


def _run_serial(ev, msgs, **store_kw):
    interner = Interner()
    closed = []
    store = WindowedGraphStore(interner, window_s=1.0, on_batch=closed.append, **store_kw)
    cluster = ClusterInfo(interner)
    for m in msgs:
        cluster.handle_msg(m)
    agg = Aggregator(store, interner=interner, cluster=cluster)
    for i in range(0, ev.shape[0], CHUNK):
        agg.process_l7(ev[i : i + CHUNK], now_ns=NOW_NS)
    store.flush()
    return interner, closed, store


def _run_process(ev, msgs, n_workers, pool=ProcessShardedIngest, interner_cls=Interner, **kw):
    interner = interner_cls()
    closed = []
    pipe = pool(n_workers, interner=interner, window_s=1.0, on_batch=closed.append, **kw)
    try:
        for m in msgs:
            pipe.process_k8s(m)
        for i in range(0, ev.shape[0], CHUNK):
            pipe.process_l7(ev[i : i + CHUNK], now_ns=NOW_NS)
        assert pipe.flush(timeout_s=60.0), "process flush timed out"
    finally:
        pipe.stop()
    return interner, closed, pipe


def _canonical(interner, batches) -> dict:
    """Window → sorted [((from, to, protocol), edge feature bytes)]."""
    out = {}
    for b in batches:
        uids = b.node_uids
        edges = sorted(
            (
                (interner.lookup(int(uids[b.edge_src[i]])), interner.lookup(int(uids[b.edge_dst[i]])),
                 int(b.edge_type[i])),
                b.edge_feats[i].tobytes(),
            )
            for i in range(b.n_edges)
        )
        assert b.window_start_ms not in out, "window emitted twice"
        out[b.window_start_ms] = edges
    return out


def _node_stats(interner, batches) -> dict:
    """Window → {uid string: (type, node feature bytes)}."""
    return {
        b.window_start_ms: {
            interner.lookup(int(b.node_uids[s])): (int(b.node_type[s]), b.node_feats[s].tobytes())
            for s in range(b.n_nodes)
        }
        for b in batches
    }


def _strings(interner) -> list:
    return [interner.lookup(k) for k in range(len(interner))]


def _assert_batches_equal(ref, got) -> None:
    """Every ``GraphBatch`` field, arrays by dtype, shape and bytes."""
    assert len(got) == len(ref) and ref
    for a, b in zip(ref, got):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, np.ndarray):
                assert isinstance(y, np.ndarray), f.name
                assert (x.dtype, x.shape) == (y.dtype, y.shape), f.name
                assert x.tobytes() == y.tobytes(), f"window {a.window_start_ms}: {f.name} differs"
            else:
                assert x == y, f"window {a.window_start_ms}: {f.name} differs"


@pytest.mark.parametrize("n_workers", [1, 2, 4])
def test_process_windows_equal_serial_windows(n_workers):
    ev, msgs = make_ingest_trace(30_000, pods=80, svcs=12, windows=5, seed=3)
    si, sb, _ = _run_serial(ev, msgs)
    pi, pb, pipe = _run_process(ev, msgs, n_workers)
    assert _canonical(pi, pb) == _canonical(si, sb)
    assert _node_stats(pi, pb) == _node_stats(si, sb)
    assert pipe.ledger.total == 0 and pipe.request_count == ev.shape[0]


def test_process_windows_equal_jax_process_windows():
    """N=2: in-cluster traffic bit for bit (every field, the interner's
    strings in order); the whole trace, outbound destinations included,
    by name."""
    ev, msgs = make_ingest_trace(24_000, pods=60, svcs=10, windows=4, seed=7)
    jev, jmsgs = jax_make_ingest_trace(24_000, pods=60, svcs=10, windows=4, seed=7)
    assert ev.tobytes() == jev.tobytes()
    inc = ev["dport"] == 80
    ji, jb, _ = _run_process(jev[inc], jmsgs, 2, pool=JaxProcessShardedIngest, interner_cls=JaxInterner)
    pi, pb, _ = _run_process(ev[inc], msgs, 2)
    _assert_batches_equal(jb, pb)
    assert _strings(pi) == _strings(ji)
    ji, jb, _ = _run_process(jev, jmsgs, 2, pool=JaxProcessShardedIngest, interner_cls=JaxInterner)
    pi, pb, _ = _run_process(ev, msgs, 2)
    assert _canonical(pi, pb) == _canonical(ji, jb)
    assert _node_stats(pi, pb) == _node_stats(ji, jb)


@pytest.mark.parametrize("n_workers", [1, 2])
def test_degree_cap_parity_survives_id_exchange(n_workers):
    """The cap samples over the parent's shared-interner uids, numbered
    in the serial order for in-cluster destinations: a capped process
    run keeps the same edges as a capped serial run."""
    ev, msgs = make_ingest_trace(40_000, pods=40, svcs=6, windows=3, seed=11)
    ev = ev[ev["dport"] == 80]
    si, sb, store = _run_serial(ev, msgs, degree_cap=3, sample_seed=5)
    assert store.builder.sampled_edges > 0, "the cap never bit"
    pi, pb, pipe = _run_process(ev, msgs, n_workers, degree_cap=3, sample_seed=5)
    assert pipe.builder.sampled_edges == store.builder.sampled_edges
    assert _canonical(pi, pb) == _canonical(si, sb)


def test_sigkill_mid_wave_conserves_exactly():
    """Chaos kills (SIGKILL of a live worker mid-stream, twice at most):
    every pushed row is in an emitted window or in the ledger."""
    from alaz_tpu_torch.chaos.injectors import WorkerChaos

    ev, msgs = make_ingest_trace(24_000, pods=60, svcs=10, windows=4, seed=0)
    wchaos = WorkerChaos(seed=0, crash_prob=0.02, max_crashes=2, ensure_crash=True)
    interner = Interner()
    closed = []
    pipe = ProcessShardedIngest(2, interner=interner, window_s=1.0, on_batch=closed.append,
                                fault_hook=wchaos, shed_block_s=0.5)
    try:
        for m in msgs:
            pipe.process_k8s(m)
        for i in range(0, ev.shape[0], 2048):
            pipe.process_l7(ev[i : i + 2048], now_ns=NOW_NS)
        assert pipe.flush(timeout_s=60.0)
        assert pipe.flush(timeout_s=60.0)
    finally:
        pipe.stop()
    assert wchaos.crashes > 0 and pipe.worker_restarts > 0
    assert pipe.ledger.conservation_gap(ev.shape[0], emitted_rows(closed)) == 0, pipe.ledger.snapshot()
    starts = [b.window_start_ms for b in closed]
    assert starts == sorted(set(starts))


def test_sigkill_with_rows_pending_attributes_them():
    """A worker killed while rows sit in its store: the respawn books
    them as ``dropped/shm0_kill`` and the gap stays 0."""
    ev, msgs = make_ingest_trace(16_000, pods=40, svcs=6, windows=3, seed=4)
    closed = []
    pipe = ProcessShardedIngest(1, interner=Interner(), window_s=1.0, on_batch=closed.append)
    try:
        for m in msgs:
            pipe.process_k8s(m)
        for i in range(0, ev.shape[0], 2048):
            pipe.process_l7(ev[i : i + 2048], now_ns=NOW_NS)
        deadline = time.monotonic() + 20
        while pipe.request_count == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert pipe.request_count > 0
        os.kill(pipe.workers[0].proc.pid, signal.SIGKILL)
        deadline = time.monotonic() + 30
        while pipe.worker_restarts == 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert pipe.worker_restarts == 1
        assert pipe.flush(timeout_s=60.0)
    finally:
        pipe.stop()
    snap = pipe.ledger.snapshot()
    assert snap["reasons"].get("dropped/shm0_kill", 0) > 0, snap
    assert pipe.ledger.conservation_gap(ev.shape[0], emitted_rows(closed)) == 0, snap


def test_native_engine_runs_in_the_workers(capfd):
    """``engine_backend="native"`` reaches each spawned worker, which
    loads the port's library before it reports ready and says so in its
    log; the windows equal the serial Python engine's."""
    ev, msgs = make_ingest_trace(16_000, pods=40, svcs=6, windows=3, seed=2)
    si, sb, _ = _run_serial(ev, msgs)
    pi, pb, pipe = _run_process(ev, msgs, 2, config=RuntimeConfig(engine_backend="native"))
    err = capfd.readouterr().err
    for i in range(2):
        assert f"shm shard{i} L7 engine backend: native (loaded=True)" in err, err[-2000:]
    assert "falling back to the python L7 engine" not in err
    assert pipe.worker_restarts == 0
    assert _canonical(pi, pb) == _canonical(si, sb)


def test_shm_worker_imports_no_torch():
    """A spawned worker imports its target's modules and nothing of the
    model: the pool's modules load neither torch nor jax."""
    code = (
        "import json, sys\n"
        "import alaz_tpu_torch.shm.worker, alaz_tpu_torch.shm.process_pool\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'alaz_tpu'))))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("batch_windows,engine", [(1, "python"), (4, "python"), (1, "native")])
def test_service_on_process_backend_matches_jax_service(batch_windows, engine):
    """GraphSAGE (f32, hidden 32) served by both packages over the
    process backend (2 workers): the per-uid score maps at rtol/atol
    1e-4, serially and as a W=4 backlog group, and with each worker
    joining in C++ (the Service builds the library before the pool
    spawns)."""
    from tests.test_torch_service import _assert_maps_close, _cfgs, _params, _port_params, _score_map, _serve

    jcfg, pcfg = (dataclasses.replace(c, ingest_backend="process", ingest_workers=2)
                  for c in _cfgs(batch_windows=batch_windows, engine_backend=engine))
    jparams = _params(jcfg)
    jsvc, jrec, jwin = _serve("jax", jcfg, jparams)
    psvc, prec, pwin = _serve("port", pcfg, _port_params(pcfg, jparams))
    assert type(psvc.sharded).__name__ == "ProcessShardedIngest"
    assert len(pwin) == len(jwin) >= 3
    assert [b.window_start_ms for b in pwin] == [b.window_start_ms for b in jwin]
    assert psvc.score_dispatches == jsvc.score_dispatches
    if batch_windows > 1:
        assert psvc.score_dispatches < len(pwin)
    _assert_maps_close(_score_map(prec), _score_map(jrec))
    assert psvc.ledger.total == jsvc.ledger.total == 0


def test_chaos_pipeline_leg_on_process_backend():
    from alaz_tpu_torch.chaos.harness import run_chaos_suite
    from alaz_tpu_torch.config import ChaosConfig

    rep = run_chaos_suite(ChaosConfig(enabled=True, seed=0), n_workers=2, n_rows=16_000, n_windows=3,
                          legs=("pipeline",), ingest_backend="process")
    assert rep.ok, rep.findings
    assert rep.pipeline["backend"] == "process"
    assert rep.pipeline["crashes"] > 0 and rep.pipeline["worker_restarts"] > 0
