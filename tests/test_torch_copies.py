"""The port's copies of the JAX package's host modules are the JAX
package's code.

Each copy is held to its JAX source by syntax tree: both files are
parsed, the copy's imports of ``alaz_tpu_torch`` are renamed back to
``alaz_tpu``, and the two ``ast.dump``s must be equal. Comments do not
reach the tree; docstrings, names, strings and every statement do. The
only differences allowed are listed per module below:

- ``ported``: a definition written for torch or the card (the device
  gauges, the profiler endpoints, the incident suite's detection legs
  and CLI, which take ``device``), carrying the port's own docstring, or
  fixed (the simulator's 16-bit source ports wrap where the JAX source
  overflows under numpy 2).
- ``dropped``: a definition with no counterpart (the XLA compile event
  plane); ``added``: a definition only the port has.
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

COPIES = {
    "events/__init__.py": {},
    "events/net.py": {},
    "events/schema.py": {},
    "events/intern.py": {},
    "events/k8s.py": {},
    "protocols/__init__.py": {},
    "protocols/amqp.py": {},
    "protocols/compression.py": {},
    "protocols/hpack.py": {},
    "protocols/http.py": {},
    "protocols/http2.py": {},
    "protocols/kafka.py": {},
    "protocols/mongo.py": {},
    "protocols/mysql.py": {},
    "protocols/postgres.py": {},
    "protocols/redis.py": {},
    "protocols/sql.py": {},
    "utils/__init__.py": {},
    "utils/clock.py": {},
    "utils/ledger.py": {},
    "utils/queues.py": {},
    "utils/ratelimit.py": {},
    "logging.py": {},
    "datastore/interface.py": {},
    "datastore/dto.py": {},
    "datastore/inmem.py": {},
    "aggregator/__init__.py": {},
    "aggregator/cluster.py": {},
    "aggregator/dns.py": {},
    "aggregator/h2.py": {},
    "aggregator/sockline.py": {},
    "aggregator/procfs.py": {},
    "aggregator/engine.py": {},
    "aggregator/native_l7.py": {},
    "graph/builder.py": {},
    # built with g++ into build/alaz_tpu_torch/ from the port's own
    # native/ingest.cc, and raising where the JAX package falls back
    # (and native/agent_example.cc, stamped as the JAX Makefile stamps it)
    "graph/native.py": {
        "ported": {"<module docstring>", "_LIB_PATH", "build", "_load"},
        "added": {"BUILD_DIR", "CXXFLAGS", "_LOAD_LOCK", "_compile", "_source_digest", "build_agent"},
    },
    "config.py": {"ported": {"ModelConfig"}},
    "obs/histogram.py": {},
    "obs/recorder.py": {},
    "obs/spans.py": {},
    "obs/scores.py": {},
    "obs/device.py": {"dropped": {"CompileEventPlane", "_metric_safe"}},
    "runtime/tenancy.py": {},
    "runtime/metrics.py": {
        "ported": {"device_gauges", "_DEVICE_MEM_KEYS"},
        "added": {"_cuda_stat", "_cuda_total", "_cuda_free"},
    },
    "runtime/debug_http.py": {
        "ported": {"<module docstring>", "DebugServer._profile", "DebugServer._profiler_start",
                   "DebugServer._profiler_stop"},
        "added": {"_torch_profiler"},
    },
    # the 16-bit source port of the TCP establish events wraps: the JAX
    # source raises OverflowError under numpy 2 past edge 25,535 (config5)
    "replay/simulator.py": {"ported": {"Simulator.tcp_events"}},
    "sources/__init__.py": {},
    "sources/base.py": {},
    "sources/replay.py": {},
    "sources/ingest_server.py": {},
    "sources/containers.py": {},
    "sources/cri.py": {},
    "sources/k8s_client.py": {},
    "sources/k8s_watch.py": {},
    "sources/tlsattach.py": {},
    "sources/gotls.py": {},
    "sources/logstream.py": {},
    "datastore/backend.py": {},
    "runtime/health.py": {},
    "aggregator/dist_tracing.py": {},
    "aggregator/sharded.py": {},
    "chaos/__init__.py": {},
    "chaos/injectors.py": {},
    "chaos/harness.py": {},
    "chaos/__main__.py": {},
    "replay/__init__.py": {},
    "replay/faults.py": {},
    "replay/trace.py": {},
    "replay/scenario.py": {},
    # the detection legs train and score on the caller's device
    "replay/incidents.py": {"ported": {"run_detection_leg", "run_incident_scenario", "run_scenario_suite"}},
    # --device for the detection legs
    "replay/__main__.py": {"ported": {"main"}},
    "train/__init__.py": {},
    "shm/__init__.py": {},
    "shm/ring.py": {},
    "shm/codec.py": {},
    "shm/worker.py": {},
    "shm/process_pool.py": {},
    # the module docstring names the port's CLI
    "replay/tenants.py": {"ported": {"<module docstring>"}},
}


class _Normalize(ast.NodeTransformer):
    """Rename the port's imports and strip the allowed definitions,
    recording which of them it met."""

    def __init__(self, spec: dict, port: bool):
        self.port = port
        self.remove = set(spec.get("ported", ())) | set(spec.get("dropped", ()))
        if port:
            self.remove |= set(spec.get("added", ()))
        self.scope: list[str] = []
        self.met: set = set()

    def _qual(self, name: str) -> str:
        return ".".join(self.scope + [name])

    def visit_Import(self, node):
        if self.port:
            for a in node.names:
                a.name = a.name.replace("alaz_tpu_torch", "alaz_tpu", 1)
        return node

    def visit_ImportFrom(self, node):
        if self.port and node.module and node.module.startswith("alaz_tpu_torch"):
            node.module = node.module.replace("alaz_tpu_torch", "alaz_tpu", 1)
        return node

    def _scoped(self, node):
        q = self._qual(node.name)
        if q in self.remove:
            self.met.add(q)
            return None
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()
        return node

    visit_FunctionDef = visit_ClassDef = _scoped

    def visit_Assign(self, node):
        names = [t.id for t in node.targets if isinstance(t, ast.Name)]
        for n in names:
            if self._qual(n) in self.remove:
                self.met.add(self._qual(n))
                return None
        return node


def _normalized(path: Path, spec: dict, port: bool):
    tree = ast.parse(path.read_text(), filename=str(path))
    if "<module docstring>" in spec.get("ported", ()):
        first = tree.body[0]
        if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant):
            tree.body = tree.body[1:]
    norm = _Normalize(spec, port)
    tree = norm.visit(tree)
    return ast.dump(tree, include_attributes=False), norm


@pytest.mark.parametrize("rel", sorted(COPIES))
def test_copy_equals_its_jax_source(rel):
    spec = COPIES[rel]
    port_dump, port = _normalized(REPO / "alaz_tpu_torch" / rel, spec, port=True)
    jax_dump, ref = _normalized(REPO / "alaz_tpu" / rel, spec, port=False)
    listed = set(spec.get("ported", ())) - {"<module docstring>"}
    assert listed <= port.met and listed <= ref.met, "a listed definition is missing"
    assert set(spec.get("dropped", ())) <= ref.met
    assert set(spec.get("added", ())) <= port.met
    assert port_dump == jax_dump


def test_make_ingest_trace_is_a_copy():
    """``replay/synth.py`` is the port's own module; its
    ``make_ingest_trace`` is the JAX package's, held like the copies."""

    def fn_dump(path: Path) -> str:
        tree = _Normalize({}, port=True).visit(ast.parse(path.read_text()))
        (fn,) = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "make_ingest_trace"]
        return ast.dump(fn, include_attributes=False)

    assert fn_dump(REPO / "alaz_tpu_torch/replay/synth.py") == fn_dump(REPO / "alaz_tpu/replay/synth.py")


def test_left_out_ingest_planes_raise():
    """Every ingest plane is ported now: the process backend (at one
    worker and at two), the thread backend and native ingest each build
    their pipeline."""
    from alaz_tpu_torch.aggregator.sharded import ShardedIngest
    from alaz_tpu_torch.config import RuntimeConfig
    from alaz_tpu_torch.graph.native import NativeWindowedStore
    from alaz_tpu_torch.runtime.tenancy import TenantPartition
    from alaz_tpu_torch.shm.process_pool import ProcessShardedIngest

    for n in (1, 2):
        part = TenantPartition(0, RuntimeConfig(ingest_workers=n, ingest_backend="process"), on_batch=lambda b: None)
        try:
            assert isinstance(part.sharded, ProcessShardedIngest) and part.sharded.n == n
            assert part.graph_store is part.sharded and part.aggregator is part.sharded
        finally:
            part.sharded.stop()
    # the thread backend is ported: two workers build the sharded pipeline
    part = TenantPartition(0, RuntimeConfig(ingest_workers=2), on_batch=lambda b: None)
    try:
        assert isinstance(part.sharded, ShardedIngest) and part.graph_store is part.sharded
        assert part.aggregator is part.sharded and part.sharded.n == 2
    finally:
        part.sharded.stop()
    # and so is native ingest: the C++ window accumulator is the store
    part = TenantPartition(0, RuntimeConfig(), on_batch=lambda b: None, use_native_ingest=True)
    try:
        assert isinstance(part.graph_store, NativeWindowedStore) and part.sharded is None
        assert part.datastore.sinks == [part.graph_store]
    finally:
        part.graph_store.close()


def test_left_out_chaos_legs_and_isolation_raise(capsys):
    """Every leg of the chaos suite is ported: the frame leg (the ingest
    socket) and the export leg (the batching backend) run clean beside
    the isolation gate (one scenario, host legs only)."""
    import json

    from alaz_tpu_torch.chaos.harness import run_chaos_suite
    from alaz_tpu_torch.replay.__main__ import main as suite_main

    rep = run_chaos_suite(seed=0, legs=("frames", "backend"))
    assert rep.ok and rep.findings == []
    assert rep.frames["rows_sent"] > rep.frames["rows_accepted"] > 0
    assert rep.backend["breaker_opens"] >= 1 and rep.backend["breaker_state"] == "closed"
    assert suite_main(["--isolation", "--no-detection", "--scenarios", "retry_storm", "--workers", "1"]) == 0
    reports = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    (iso,) = [r for r in reports if r.get("scenario") == "multi_tenant_isolation"]
    assert iso["scenario_findings"] == 0 and iso["tenants"] == 3


def test_native_grouping_and_engine_raise(tmp_path, monkeypatch):
    """Where the library cannot be built (the compiler path pointed at a
    missing binary, an empty build directory), each explicit request for
    native code raises with the compiler's failure, where the JAX package
    warns and falls back to Python or numpy."""
    import numpy as np

    from alaz_tpu_torch.aggregator import engine
    from alaz_tpu_torch.aggregator.engine import Aggregator
    from alaz_tpu_torch.config import RuntimeConfig
    from alaz_tpu_torch.datastore.inmem import InMemDataStore
    from alaz_tpu_torch.events.schema import make_l7_events
    from alaz_tpu_torch.graph import builder, native
    from alaz_tpu_torch.runtime.tenancy import TenantPartition

    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    missing = "no-such-g\\+\\+"
    builder.set_native_grouping(True)
    try:
        with pytest.raises(RuntimeError, match=missing):
            builder.group_reduce(np.arange(3, dtype=np.int64), [], [])
        with pytest.raises(RuntimeError, match=missing):
            builder.degree_cap_select(np.zeros(3, np.int32), np.arange(3, dtype=np.uint64), 1)
    finally:
        builder.set_native_grouping(None)
    agg = Aggregator(InMemDataStore(), config=RuntimeConfig(engine_backend="native"))
    with pytest.raises(RuntimeError, match=missing):
        agg.process_l7(make_l7_events(4))
    engine.set_native_engine(True)
    try:
        with pytest.raises(RuntimeError, match=missing):
            Aggregator(InMemDataStore())._native_l7_engine()
    finally:
        engine.set_native_engine(None)
    with pytest.raises(RuntimeError, match=missing):
        TenantPartition(0, RuntimeConfig(), on_batch=lambda b: None, use_native_ingest=True)
    assert native._lib is None
    # and so does the reference agent's build
    with pytest.raises(RuntimeError, match=missing):
        native.build_agent()


def test_ingest_cc_is_its_source_byte_for_byte():
    """The port builds its own copy of the C++ ingest core; its bytes, and
    so its ``ALZ_SOURCE_HASH`` stamp, are the JAX package's."""
    assert (REPO / "alaz_tpu_torch/native/ingest.cc").read_bytes() == (REPO / "alaz_tpu/native/ingest.cc").read_bytes()


def test_agent_example_is_its_source_byte_for_byte():
    """The port builds its own copy of the reference agent; its bytes, and
    so its ``ALZ_SOURCE_STAMP``, are the JAX package's."""
    assert (REPO / "alaz_tpu_torch/native/agent_example.cc").read_bytes() == (
        REPO / "alaz_tpu/native/agent_example.cc").read_bytes()
