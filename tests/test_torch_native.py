"""The port's native ingest against the JAX package's, on the CPU.

The port builds its own copy of ``native/ingest.cc`` with g++ into
``build/alaz_tpu_torch/``; the JAX package builds its source with its
own ``make``. Inputs come from numpy seeds. Held here:

- the build: the library lies under ``build/alaz_tpu_torch/`` and both
  libraries report the same source hash;
- ``NativeIngest``/``NativeWindowedStore``: the same REQUEST rows through
  both packages' (window roll, late rows, ring overflow, renumbering, the
  degree cap, the blocked layout) give every ``GraphBatch`` field bit for
  bit, and equal drop counters and ledgers; the port's native store
  against its numpy ``WindowedGraphStore`` (uid-keyed edge and node
  features at atol 1e-6, the JAX package's own bound for that pair);
- ``group_edges``/``sample_degree_cap`` against the port's numpy
  ``group_reduce``/``degree_cap_select`` and the JAX package's native
  ones, with a hub destination over the cap: exact;
- the native L7 engine: the same ``make_ingest_trace`` events through
  both packages' ``Aggregator`` (``engine_backend="native"``) give the
  same REQUEST rows bit for bit, stats and drop ledger, also against the
  port's Python engine; through the thread-sharded ingest at 2 and 4
  workers, the same windows;
- the grouping auto-detect falls back to numpy where the library cannot
  be built, and a ``Service`` asked for the native engine raises from
  ``start()`` there.
"""

from __future__ import annotations

import dataclasses
import hashlib
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from alaz_tpu.aggregator.cluster import ClusterInfo as JaxClusterInfo
from alaz_tpu.aggregator.engine import Aggregator as JaxAggregator
from alaz_tpu.aggregator.engine import set_native_engine as jax_set_native_engine
from alaz_tpu.aggregator.sharded import ShardedIngest as JaxShardedIngest
from alaz_tpu.config import RuntimeConfig as JaxRuntimeConfig
from alaz_tpu.datastore.inmem import InMemDataStore as JaxInMemDataStore
from alaz_tpu.events.intern import Interner as JaxInterner
from alaz_tpu.graph import builder as jbuilder
from alaz_tpu.graph import native as jnative
from alaz_tpu.utils.ledger import DropLedger as JaxDropLedger
from alaz_tpu_torch.aggregator.cluster import ClusterInfo
from alaz_tpu_torch.aggregator.engine import Aggregator, set_native_engine
from alaz_tpu_torch.aggregator.sharded import ShardedIngest
from alaz_tpu_torch.config import RuntimeConfig
from alaz_tpu_torch.datastore.dto import EP_POD, EP_SERVICE, make_requests
from alaz_tpu_torch.datastore.inmem import InMemDataStore
from alaz_tpu_torch.events.intern import Interner
from alaz_tpu_torch.events.net import ip_to_u32
from alaz_tpu_torch.events.schema import TcpEventType, make_tcp_events
from alaz_tpu_torch.graph import builder
from alaz_tpu_torch.graph import native
from alaz_tpu_torch.graph.snapshot import GraphBatch
from alaz_tpu_torch.replay.synth import make_ingest_trace
from alaz_tpu_torch.utils.ledger import DropLedger

REPO = Path(__file__).resolve().parent.parent
SOURCE_HASH = hashlib.sha256((REPO / "alaz_tpu_torch/native/ingest.cc").read_bytes()).hexdigest()[:16]
NOW_NS = 10_000_000_000

JAX = SimpleNamespace(Aggregator=JaxAggregator, ClusterInfo=JaxClusterInfo, InMemDataStore=JaxInMemDataStore,
                      Interner=JaxInterner, RuntimeConfig=JaxRuntimeConfig, ShardedIngest=JaxShardedIngest,
                      set_native_engine=jax_set_native_engine, native=jnative, DropLedger=JaxDropLedger)
PORT = SimpleNamespace(Aggregator=Aggregator, ClusterInfo=ClusterInfo, InMemDataStore=InMemDataStore,
                       Interner=Interner, RuntimeConfig=RuntimeConfig, ShardedIngest=ShardedIngest,
                       set_native_engine=set_native_engine, native=native, DropLedger=DropLedger)


@pytest.fixture(autouse=True)
def _reset_switches():
    yield
    set_native_engine(None)
    jax_set_native_engine(None)
    builder.set_native_grouping(None)
    jbuilder.set_native_grouping(None)


def _rows(n=500, window_ms=1000, seed=0):
    """REQUEST rows over 14 pods calling 7 services, 10% of them 5xx, all
    in the window starting at ``window_ms``."""
    rng = np.random.default_rng(seed)
    rows = make_requests(n)
    rows["from_uid"] = rng.integers(1, 15, n)
    rows["to_uid"] = rng.integers(15, 22, n)
    rows["from_type"], rows["to_type"] = EP_POD, EP_SERVICE
    rows["protocol"] = rng.integers(1, 4, n)
    rows["latency_ns"] = rng.integers(10, 1000, n)
    rows["status_code"] = np.where(rng.random(n) < 0.1, 500, 200)
    rows["completed"] = rng.random(n) < 0.95
    rows["tls"] = rng.random(n) < 0.3
    rows["start_time_ms"] = window_ms + rng.integers(0, 1000, n)
    return rows


def _assert_batches_equal(got: list, ref: list) -> None:
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        for f in dataclasses.fields(GraphBatch):
            a, b = getattr(g, f.name), getattr(r, f.name)
            if b is None or a is None:
                assert a is None and b is None, f.name
            elif isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), f.name
            else:
                assert a == b, f.name


def _edge_map(b) -> dict:
    uids = b.node_uids
    return {(int(uids[b.edge_src[i]]), int(uids[b.edge_dst[i]]), int(b.edge_type[i])): b.edge_feats[i]
            for i in range(b.n_edges)}


def _node_map(b) -> dict:
    return {int(b.node_uids[i]): b.node_feats[i] for i in range(b.n_nodes)}


# -- source and build ---------------------------------------------------------


def test_library_is_the_ports_own_build():
    assert native.available()
    assert native._LIB_PATH.parent == native.BUILD_DIR == REPO / "build" / "alaz_tpu_torch"
    assert native._LIB_PATH.name == f"libalaz_ingest-{SOURCE_HASH}.so"
    assert native._lib is not jnative._load()
    assert native.loaded_source_hash() == SOURCE_HASH == jnative.loaded_source_hash()


def test_layout_contracts_equal_the_jax_packages():
    assert native.export_signatures() == jnative.export_signatures()
    for fn in ("record_layout_string", "l7_event_layout_string", "request_layout_string"):
        assert getattr(native, fn)() == getattr(jnative, fn)()
    assert native.L7_ENGINE_DROP_CAUSES == jnative.L7_ENGINE_DROP_CAUSES


# -- the windowed store -------------------------------------------------------

PARTS = [(80, 1000, 1), (60, 2500, 2), (40, 1300, 3), (20, 3600, 4), (30, 3100, 5)]
STORE_CASES = {
    # window roll, stragglers that merge into open windows and late rows
    "roll_and_late": dict(kw={}, parts=PARTS),
    "renumber": dict(kw={"renumber": True}, parts=PARTS),
    "degree_cap": dict(kw={"degree_cap": 2, "sample_seed": 11}, parts=[(400, 1000, 1), (300, 2500, 2)]),
    "blocked": dict(kw={"edge_layout": "blocked"}, parts=PARTS),
    # a ring of 256 records: every persist above it drops at the mouth
    "ring_overflow": dict(kw={"ring_capacity": 256}, parts=[(1000, 1000, 1), (200, 2500, 2)]),
    # open windows past the core's bound force the oldest to close
    "many_windows": dict(kw={}, parts=[(10, w * 1000, w) for w in range(1, 11)]),
}


def _store_run(pkg, kw: dict, parts: list):
    ledger = pkg.DropLedger()
    store = pkg.native.NativeWindowedStore(window_s=1.0, ledger=ledger, **kw)
    for n, wms, seed in parts:
        store.persist_requests(_rows(n, wms, seed))
    store.flush()
    counters = (store.late_dropped, store.ring_dropped, store.acc_dropped, store.sampled_edges,
                store.sampled_rows, store.request_count, store.ingest.dropped)
    store.close()
    return store.batches, counters, ledger.snapshot()


@pytest.mark.parametrize("case", sorted(STORE_CASES))
def test_native_store_equals_the_jax_packages(case):
    kw, parts = STORE_CASES[case]["kw"], STORE_CASES[case]["parts"]
    got, got_counters, got_ledger = _store_run(PORT, kw, parts)
    ref, ref_counters, ref_ledger = _store_run(JAX, kw, parts)
    _assert_batches_equal(got, ref)
    assert got_counters == ref_counters and got_ledger == ref_ledger
    late, ring, _, sampled, *_ = got_counters
    # each case reaches what it is named for
    if case == "roll_and_late":
        assert late > 0
    if case == "ring_overflow":
        assert ring > 0
    if case == "degree_cap":
        assert sampled > 0
    if case == "blocked":
        assert all(b.edge_block_starts is not None for b in got)
    if case == "renumber":
        plain, _, _ = _store_run(PORT, {}, parts)
        assert not np.array_equal(plain[0].node_uids[: plain[0].n_nodes], got[0].node_uids[: got[0].n_nodes])


@pytest.mark.parametrize("case", ["roll_and_late", "degree_cap"])
def test_native_store_agrees_with_the_numpy_store(case):
    kw, parts = STORE_CASES[case]["kw"], STORE_CASES[case]["parts"]
    nled, pled = DropLedger(), DropLedger()
    ns = native.NativeWindowedStore(window_s=1.0, ledger=nled, **kw)
    ps = builder.WindowedGraphStore(Interner(), window_s=1.0, ledger=pled, **kw)
    for n, wms, seed in parts:
        rows = _rows(n, wms, seed)
        ns.persist_requests(rows.copy())
        ps.persist_requests(rows.copy())
    ns.flush()
    ps.flush()
    assert [b.window_start_ms for b in ns.batches] == [b.window_start_ms for b in ps.batches]
    for nb, pb in zip(ns.batches, ps.batches):
        for maps in ((_edge_map(nb), _edge_map(pb)), (_node_map(nb), _node_map(pb))):
            assert set(maps[0]) == set(maps[1])
            for k in maps[0]:
                np.testing.assert_allclose(maps[0][k], maps[1][k], atol=1e-6)
    assert ns.late_dropped == ps.late_dropped
    assert (ns.sampled_edges, ns.sampled_rows) == (ps.builder.sampled_edges, ps.builder.sampled_rows)
    # late rows: the native store counts them itself and leaves the
    # ledger alone, in both packages; the sampled rows reach the ledger
    assert nled.count("sampled") == pled.count("sampled")
    ns.close()


def test_push_records_and_poll_equal_the_jax_packages():
    """The raw-record path: ``push_records`` of packed ``AlzRecord`` rows
    and ``poll`` between pushes, window by window."""
    out = []
    for pkg in (PORT, JAX):
        ni = pkg.native.NativeIngest(window_s=1.0)
        polled = []
        for n, wms, seed in PARTS:
            ni.push_records(ni.to_records(_rows(n, wms, seed)))
            b = ni.poll()
            if b is not None:
                polled.append(b)
        polled += ni.flush()
        out.append((polled, ni.late_dropped, ni.dropped))
        ni.close()
    _assert_batches_equal(out[0][0], out[1][0])
    assert out[0][1:] == out[1][1:]


# -- the grouping core --------------------------------------------------------


def _hub_edges(seed: int):
    """Aggregated-edge inputs with destination 7 a hub of 300 sources."""
    rng = np.random.default_rng(seed)
    n = 2_000
    src = rng.integers(0, 500, n)
    dst = np.where(rng.random(n) < 0.15, 7, rng.integers(0, 60, n))
    proto = rng.integers(1, 4, n)
    keys = builder.pack_group_key(src.astype(np.int64), dst.astype(np.int64), proto.astype(np.int64))
    sums = [rng.integers(0, 1000, n).astype(np.float64) for _ in range(4)]
    maxes = [rng.integers(0, 10**6, n).astype(np.float64)]
    return keys, sums, maxes


@pytest.mark.parametrize("seed", [0, 1])
def test_group_edges_equals_numpy_and_the_jax_packages(seed):
    keys, sums, maxes = _hub_edges(seed)
    got = native.group_edges(keys, sums, maxes)
    ref = jnative.group_edges(keys, sums, maxes)
    builder.set_native_grouping(False)
    plain = builder.group_reduce(keys, sums, maxes)
    builder.set_native_grouping(True)
    routed = builder.group_reduce(keys, sums, maxes)
    for other in (ref, plain, routed):
        for a, b in zip(got[:3], other[:3]):
            assert a.dtype == b.dtype
        assert np.array_equal(got[0], other[0]) and np.array_equal(got[1], other[1])
        # a group's representative is any of its rows: C++ and numpy may
        # pick different ones of the same key
        assert np.array_equal(keys[got[2]], keys[other[2]])
        for la, lb in zip(got[3:], other[3:]):
            assert all(x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(la, lb))
    assert np.array_equal(got[2], ref[2]) and np.array_equal(got[2], routed[2])
    assert got[1].max() > 1  # keys repeat: the groups are not all singletons


@pytest.mark.parametrize("cap", [1, 3, 50])
def test_sample_degree_cap_equals_numpy_and_the_jax_packages(cap):
    rng = np.random.default_rng(cap)
    dst = np.sort(np.where(rng.random(3_000) < 0.2, 7, rng.integers(0, 200, 3_000))).astype(np.int32)
    # few distinct priorities: ties resolve by row index on every path
    prio = rng.integers(0, 64, dst.shape[0]).astype(np.uint64)
    got = native.sample_degree_cap(dst, prio, cap)
    ref = jnative.sample_degree_cap(dst, prio, cap)
    builder.set_native_grouping(False)
    plain = builder.degree_cap_select(dst, prio, cap)
    builder.set_native_grouping(True)
    routed = builder.degree_cap_select(dst, prio, cap)
    for other in (ref, plain, routed):
        assert got.dtype == other.dtype and np.array_equal(got, other)
    assert (dst == 7).sum() > cap and (dst[got] == 7).sum() == cap  # the hub is cut to the cap


# -- the native L7 engine -----------------------------------------------------


def _v1ify(ev, frac=0.5, seed=0, orphan_frac=0.0):
    """Blank the embedded addresses on ``frac`` of the rows and return the
    TCP events that establish the (pid, fd) socket lines the join
    re-derives them from; ``orphan_frac`` of those rows get a pid with no
    socket line (the retry, then ``no_socket``, path)."""
    rng = np.random.default_rng(seed)
    ev = ev.copy()
    idx = np.flatnonzero(rng.random(ev.shape[0]) < frac)
    orphans = idx[rng.random(idx.shape[0]) < orphan_frac]
    ev["pid"][orphans] = 999_999
    keys = (ev["pid"][idx].astype(np.uint64) << np.uint64(32)) | ev["fd"][idx].astype(np.uint64)
    _, first = np.unique(keys, return_index=True)
    first = first[ev["pid"][idx[first]] != 999_999]
    tcp = make_tcp_events(first.shape[0])
    for col in ("pid", "fd", "saddr", "sport", "daddr", "dport"):
        tcp[col] = ev[col][idx[first]]
    tcp["timestamp_ns"] = 1
    tcp["type"] = TcpEventType.ESTABLISHED
    for col in ("saddr", "sport", "daddr", "dport"):
        ev[col][idx] = 0
    return ev, tcp


def _trace(seed: int, n_rows: int = 12_000, pods: int = 60, svcs: int = 10, windows: int = 4):
    rng = np.random.default_rng(100 + seed)
    ev, msgs = make_ingest_trace(n_rows, pods=pods, svcs=svcs, windows=windows, seed=seed)
    notpod = rng.random(n_rows) < 0.05  # sources outside the cluster: not_pod
    ev["saddr"][notpod] = np.uint32(ip_to_u32("8.8.8.8")) + rng.integers(0, 64, int(notpod.sum()), dtype=np.uint32)
    ev, tcp = _v1ify(ev, frac=0.7, seed=seed, orphan_frac=0.05)
    chunks = np.sort(rng.integers(0, n_rows, 6)).tolist()
    return ev, tcp, msgs, chunks


def _serial_rows(pkg, ev, tcp, msgs, chunks, backend: str):
    """One serial ``Aggregator`` run with the given engine backend: its
    REQUEST rows (retry flushes included), stats and ledger."""
    interner = pkg.Interner()
    ds = pkg.InMemDataStore(retain=True)
    cluster = pkg.ClusterInfo(interner)
    for m in msgs:
        cluster.handle_msg(m)
    agg = pkg.Aggregator(ds, interner=interner, cluster=cluster,
                         config=pkg.RuntimeConfig(engine_backend=backend))
    agg.process_tcp(tcp, now_ns=NOW_NS)
    outs, lo = [], 0
    for hi in list(chunks) + [ev.shape[0]]:
        if hi > lo:
            outs.append(agg.process_l7(ev[lo:hi], now_ns=NOW_NS))
            lo = hi
    for dt in (25_000_000, 75_000_000, 200_000_000):  # past the retry limit
        r = agg.flush_retries(NOW_NS + dt)
        if r is not None:
            outs.append(r)
    assert (agg._native_l7 is not None) == (backend == "native")
    return np.concatenate(outs), agg.stats.as_dict(), agg.ledger.snapshot()


@pytest.mark.parametrize("seed", [0, 1])
def test_native_engine_rows_equal_the_jax_packages(seed):
    ev, tcp, msgs, chunks = _trace(seed)
    got_rows, got_stats, got_led = _serial_rows(PORT, ev, tcp, msgs, chunks, "native")
    ref_rows, ref_stats, ref_led = _serial_rows(JAX, ev, tcp, msgs, chunks, "native")
    py_rows, py_stats, py_led = _serial_rows(PORT, ev, tcp, msgs, chunks, "python")
    assert got_rows.dtype == ref_rows.dtype
    assert np.array_equal(got_rows, ref_rows) and np.array_equal(got_rows, py_rows)
    assert got_stats == ref_stats == py_stats
    assert got_led == ref_led == py_led
    assert got_stats["l7_requeued"] > 0
    for cause in ("filtered/no_socket", "filtered/not_pod"):
        assert got_led["reasons"].get(cause, 0) > 0, cause


def _canonical(interner, batches) -> dict:
    """Window → sorted ((from, to, protocol), edge features) by uid
    string, and the node features by uid string."""
    out = {}
    for b in batches:
        look = [interner.lookup(int(u)) for u in b.node_uids[: b.n_nodes]]
        edges = sorted(((look[b.edge_src[i]], look[b.edge_dst[i]], int(b.edge_type[i])),
                        b.edge_feats[i].tobytes()) for i in range(b.n_edges))
        nodes = {look[s]: (int(b.node_type[s]), b.node_feats[s].tobytes()) for s in range(b.n_nodes)}
        assert b.window_start_ms not in out, "window emitted twice"
        out[b.window_start_ms] = (edges, nodes)
    return out


def _sharded(pkg, ev, tcp, msgs, workers: int):
    interner = pkg.Interner()
    closed = []
    cluster = pkg.ClusterInfo(interner)
    for m in msgs:
        cluster.handle_msg(m)
    pipe = pkg.ShardedIngest(workers, interner=interner, cluster=cluster, window_s=1.0, on_batch=closed.append,
                             config=pkg.RuntimeConfig(engine_backend="native"))
    try:
        pipe.process_tcp(tcp, now_ns=NOW_NS)
        for i in range(0, ev.shape[0], 1 << 12):
            pipe.process_l7(ev[i: i + (1 << 12)], now_ns=NOW_NS)
        assert pipe.flush(timeout_s=60.0)
        assert all(w._native_l7 is not None for w in pipe.workers)
    finally:
        pipe.stop()
    return _canonical(interner, closed), pipe.stats.as_dict()


@pytest.mark.parametrize("workers", [2, 4])
def test_sharded_native_engine_equals_the_jax_packages(workers):
    ev, tcp, msgs, _ = _trace(3, n_rows=16_000, pods=50, svcs=8)
    got, got_stats = _sharded(PORT, ev, tcp, msgs, workers)
    ref, ref_stats = _sharded(JAX, ev, tcp, msgs, workers)
    assert len(got) >= 3 and got == ref
    assert got_stats == ref_stats


# -- no build, no native code -------------------------------------------------


@pytest.fixture
def no_compiler(tmp_path, monkeypatch):
    """The compiler path pointed at a missing binary and an empty build
    directory: the library cannot be built in this process."""
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    builder.set_native_grouping(None)
    yield
    builder.set_native_grouping(None)


def test_grouping_auto_detect_falls_back_to_numpy(no_compiler):
    keys, sums, maxes = _hub_edges(0)
    assert builder._use_native_grouping() is False
    builder.set_native_grouping(False)
    ref = builder.group_reduce(keys, sums, maxes)
    builder.set_native_grouping(None)
    got = builder.group_reduce(keys, sums, maxes)
    assert all(np.array_equal(a, b) for a, b in zip(got[:3], ref[:3]))
    assert native._lib is None


def test_service_asked_for_the_native_engine_raises_at_start(no_compiler):
    from alaz_tpu_torch.runtime.service import Service

    svc = Service(config=RuntimeConfig(engine_backend="native"), interner=Interner(), device="cpu")
    with pytest.raises(RuntimeError, match="no-such-g\\+\\+"):
        svc.start()
    assert svc._threads == []
    with pytest.raises(RuntimeError, match="no-such-g\\+\\+"):
        Service(config=RuntimeConfig(), interner=Interner(), use_native_ingest=True, device="cpu")
