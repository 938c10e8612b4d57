"""The port's sanitizers (``alaz_tpu_torch/sanitize``) on the CPU.

- The lock-order monitor (``sanitize/lockorder.py``, a copy of the JAX
  package's) over the port's host plane: the counterparts of
  ``tests/test_sanitize.py``'s ``TestLockOrderMonitor``,
  ``TestHostPipelineLockOrder`` and ``TestShardedPipelineLockOrder``,
  over the port's Service, native store, thread pool and ``shm/``
  process pool; the monitor's own cases run on both packages' monitors.
- The ThreadSanitizer harness (``native/tsan_test.cc``), built by
  ``graph/native.py build_tsan`` and run clean.
- The build and launch budgets (``sanitize/retrace.py``) and the compile
  event plane (``obs/device.py CompileEventPlane``, a copy) over them:
  a build event and a launch-count change each raise with attribution
  (launches are faked on the CPU by moving the kernels' counters, which
  only a launch on the card moves).
"""

from __future__ import annotations

import importlib
import subprocess
import threading

import numpy as np
import pytest

from alaz_tpu_torch.graph import native
from alaz_tpu_torch.ops import segment_kernels as K
from alaz_tpu_torch.sanitize import lockorder
from alaz_tpu_torch.sanitize.retrace import (
    STEADY_STATE_BUDGETS,
    CompileWatcher,
    RetraceBudgetExceeded,
    build_event,
    dispatch,
    explicit_transfer,
    no_implicit_transfers,
    retrace_budget,
)


@pytest.fixture
def lock_sanitizer():
    """Instrumented-lock window + acyclicity gate at teardown."""
    with lockorder.instrument() as monitor:
        yield monitor
    monitor.assert_acyclic()


def _lockorder(pkg: str):
    return importlib.import_module(f"{pkg}.sanitize.lockorder")


PACKAGES = ("alaz_tpu", "alaz_tpu_torch")


class TestLockOrderMonitor:
    @pytest.mark.parametrize("pkg", PACKAGES)
    def test_opposite_orders_on_two_threads_reported_as_cycle(self, pkg):
        """Two wrapped locks acquired A→B on one thread and B→A on
        another IS a cycle, even though the threads ran at different
        times and nothing deadlocked — in both packages' monitors."""
        lo = _lockorder(pkg)
        with lo.instrument() as mon:
            a = threading.Lock()
            b = threading.Lock()

        def order_ab():
            with a:
                with b:
                    pass

        def order_ba():
            with b:
                with a:
                    pass

        t1 = threading.Thread(target=order_ab)
        t1.start()
        t1.join()
        assert mon.cycles() == []
        t2 = threading.Thread(target=order_ba)
        t2.start()
        t2.join()
        cycles = mon.cycles()
        assert len(cycles) == 1 and len(cycles[0]) == 2
        assert mon.violations
        with pytest.raises(lo.LockOrderViolation):
            mon.assert_acyclic()

    @pytest.mark.parametrize("pkg", PACKAGES)
    def test_consistent_order_is_acyclic_and_reentrant_is_no_self_edge(self, pkg):
        lo = _lockorder(pkg)
        with lo.instrument() as mon:
            outer = threading.Lock()
            inner = threading.Lock()
            r = threading.RLock()

        def nest():
            with outer:
                with inner:
                    pass
            with r:
                with r:
                    pass

        threads = [threading.Thread(target=nest) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        mon.assert_acyclic()
        s = mon.graph_summary()
        assert s["edges"] == 1
        assert (s["locks"], s["acquisitions"]) == (3, 4 * 4)

    def test_condition_wait_releases_and_reacquires(self, lock_sanitizer):
        """The queues' pattern: Condition(self._lock) aliases onto the lock
        node; wait() drops the hold."""
        lock = threading.Lock()
        cond = threading.Condition(lock)
        state = {"ready": False}

        def waiter():
            with cond:
                while not state["ready"]:
                    cond.wait(timeout=5)

        t = threading.Thread(target=waiter)
        t.start()
        with cond:
            state["ready"] = True
            cond.notify()
        t.join(timeout=5)
        assert not t.is_alive()


class TestHostPipelineLockOrder:
    def test_ingest_to_staging_stress_is_acyclic(self, lock_sanitizer, monkeypatch):
        """The port's host pipeline — ingest server → service queues →
        aggregator/interner → staging sets (stacked fills split over four
        threads) — under instrumented locks: acyclic, and a real
        multi-lock graph was exercised."""
        mon = lock_sanitizer
        from alaz_tpu_torch.events.schema import make_l7_events
        from alaz_tpu_torch.runtime import pipeline
        from alaz_tpu_torch.runtime.service import Service
        from alaz_tpu_torch.sources.ingest_server import KIND_L7, IngestServer, send_batches

        monkeypatch.setattr(pipeline, "fill_threads", lambda: 4)  # a fill splits on any host
        svc = Service(device="cpu")  # no model: the host pipeline
        server = IngestServer(svc, port=0)
        svc.start()
        server.start()
        try:
            ev = make_l7_events(64)
            ev["write_time_ns"] = 1_000_000_000
            ev["protocol"] = 1

            def agent(n_frames: int) -> None:
                send_batches(server.address, [(KIND_L7, ev)] * n_frames)

            # two windows of 1 MiB, stacked: each fill splits four ways
            stack = {"x": [np.zeros((4096, 64), np.float32) for _ in range(2)]}

            def stager() -> None:
                sets = pipeline.PinnedSets(pin=False)  # one filling thread per sets
                for _ in range(50):
                    sets.fill(stack)

            threads = [threading.Thread(target=agent, args=(20,)) for _ in range(4)]
            threads += [threading.Thread(target=stager) for _ in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            svc.drain(timeout_s=15)
        finally:
            server.stop()
            svc.stop()
        mon.assert_acyclic()
        summary = mon.graph_summary()
        assert summary["locks"] >= 8, summary
        assert summary["acquisitions"] > 100, summary
        assert server.records == 4 * 20 * 64

    def test_native_ingest_store_stress_is_acyclic(self, lock_sanitizer):
        """The port's native store (the C++ core behind one Python lock):
        concurrent pushers and a flusher leave the order graph acyclic,
        and every pushed row is in a batch or in one drop counter."""
        mon = lock_sanitizer
        store = native.NativeWindowedStore(window_s=0.001)
        try:
            recs = np.zeros(256, dtype=native.NATIVE_RECORD_DTYPE)
            recs["from_uid"] = np.arange(256) % 16
            recs["to_uid"] = np.arange(256) % 8 + 16
            recs["protocol"] = np.arange(256) % 9

            def pusher(tid: int) -> None:
                for i in range(30):
                    rows = recs.copy()
                    rows["start_time_ms"] = (tid * 30 + i) * 2
                    store.push_records(rows)

            def flusher() -> None:
                for _ in range(10):
                    store.flush()

            threads = [threading.Thread(target=pusher, args=(t,)) for t in range(3)]
            threads += [threading.Thread(target=flusher)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
                assert not t.is_alive(), "stress thread wedged (deadlock?)"
            store.flush()
            total_in = 3 * 30 * 256
            emitted_rows = sum(
                int(np.rint(np.expm1(b.edge_feats[: b.n_edges, 0])).sum()) for b in store.batches
            )
            dropped = store.ring_dropped + store.late_dropped + store.acc_dropped
            assert store.request_count == total_in
            assert emitted_rows + dropped == total_in
            assert emitted_rows > 0, "stress closed no windows"
        finally:
            store.close()
        mon.assert_acyclic()
        assert mon.graph_summary()["acquisitions"] >= 3 * 30


def _trace(seed: int, n_rows: int = 24_000):
    from alaz_tpu_torch.aggregator.cluster import ClusterInfo
    from alaz_tpu_torch.events.intern import Interner
    from alaz_tpu_torch.replay.synth import make_ingest_trace

    ev, msgs = make_ingest_trace(n_rows, pods=40, svcs=8, windows=4, seed=seed)
    interner = Interner()
    cluster = ClusterInfo(interner)
    for m in msgs:
        cluster.handle_msg(m)
    return ev, msgs, interner, cluster


def _hammer(pipe, ev, flushes: int, flush_timeout_s: float, join_s: float) -> None:
    """Four pusher threads and a flusher over ``pipe``; a thread still
    alive after ``join_s`` fails the test (a deadlock must not hang)."""
    chunks = [ev[i : i + 2_000] for i in range(0, ev.shape[0], 2_000)]

    def pusher(tid: int) -> None:
        for c in chunks[tid::4]:
            pipe.process_l7(c, now_ns=10_000_000_000)

    def flusher() -> None:
        for _ in range(flushes):
            pipe.flush(timeout_s=flush_timeout_s)

    threads = [threading.Thread(target=pusher, args=(t,)) for t in range(4)]
    threads += [threading.Thread(target=flusher)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=join_s)
        assert not t.is_alive(), "stress thread wedged (deadlock?)"


class TestShardedPipelineLockOrder:
    def test_worker_pool_stress_is_acyclic_and_conserves_rows(self, lock_sanitizer):
        """The port's thread-sharded pool: pushers × shard workers × the
        merge/flusher under instrumented locks; acyclic, and every row in
        a batch or late."""
        mon = lock_sanitizer
        from alaz_tpu_torch.aggregator.sharded import ShardedIngest

        n_rows = 24_000
        ev, _, interner, cluster = _trace(11, n_rows)
        closed = []
        pipe = ShardedIngest(3, interner=interner, cluster=cluster, window_s=1.0, on_batch=closed.append)
        try:
            _hammer(pipe, ev, flushes=5, flush_timeout_s=10, join_s=60)
            pipe.flush(timeout_s=20)
            stats = pipe.stats.as_dict()
            emitted = sum(int(np.rint(np.expm1(b.edge_feats[: b.n_edges, 0])).sum()) for b in closed)
            assert stats["l7_in"] == n_rows
            assert stats["l7_dropped_no_socket"] == 0
            assert stats["l7_dropped_not_pod"] == 0
            assert pipe.request_count == n_rows
            assert emitted + pipe.late_dropped == n_rows
            assert emitted > 0 and len(closed) >= 4
        finally:
            pipe.stop()
        mon.assert_acyclic()
        summary = mon.graph_summary()
        assert summary["locks"] >= 8, summary
        assert summary["acquisitions"] > 200, summary

    def test_worker_pool_chaos_stress_is_acyclic_and_conserves_rows(self, lock_sanitizer):
        """The same pool with workers killed mid-wave and restarted by the
        supervisor: acyclic, no thread wedged, every row emitted or in
        exactly one ledger cause."""
        mon = lock_sanitizer
        from alaz_tpu_torch.aggregator.sharded import ShardedIngest
        from alaz_tpu_torch.chaos import DropLedger, WorkerChaos, emitted_rows

        n_rows = 24_000
        ev, _, interner, cluster = _trace(13, n_rows)
        closed = []
        ledger = DropLedger()
        wchaos = WorkerChaos(
            seed=5, crash_prob=1.0, max_crashes=2, kinds=("close",), stall_prob=0.2, stall_s=0.005,
        )
        pipe = ShardedIngest(
            3, interner=interner, cluster=cluster, window_s=1.0, on_batch=closed.append,
            ledger=ledger, fault_hook=wchaos,
        )
        try:
            _hammer(pipe, ev, flushes=3, flush_timeout_s=20, join_s=90)
            assert pipe.flush(timeout_s=30)
            assert pipe.drain(timeout_s=10)
            stats = pipe.stats.as_dict()
            emitted = emitted_rows(closed)
            assert stats["l7_dropped_no_socket"] == 0
            assert stats["l7_dropped_not_pod"] == 0
            assert emitted + ledger.total == n_rows, (emitted, ledger.snapshot())
            assert wchaos.crashes == 2
            assert pipe.worker_restarts >= 2
            assert emitted > 0 and len(closed) >= 4
        finally:
            pipe.stop()
        mon.assert_acyclic()
        summary = mon.graph_summary()
        assert summary["locks"] >= 8, summary
        assert summary["acquisitions"] > 200, summary

    def test_process_pool_stress_is_acyclic_and_conserves_rows(self, lock_sanitizer):
        """The ``shm/`` process pool: pushers and a flusher in this process
        over two spawned shard workers. The parent's locks (scatter,
        rings, merger, interner) stay acyclic and every row is in a batch
        or late."""
        mon = lock_sanitizer
        from alaz_tpu_torch.shm.process_pool import ProcessShardedIngest

        n_rows = 24_000
        ev, msgs, interner, _ = _trace(11, n_rows)
        closed = []
        pipe = ProcessShardedIngest(2, interner=interner, window_s=1.0, on_batch=closed.append)
        try:
            for m in msgs:
                pipe.process_k8s(m)
            _hammer(pipe, ev, flushes=3, flush_timeout_s=60, join_s=120)
            assert pipe.flush(timeout_s=60.0), "process flush timed out"
            emitted = sum(int(np.rint(np.expm1(b.edge_feats[: b.n_edges, 0])).sum()) for b in closed)
            assert pipe.request_count == n_rows
            assert emitted + pipe.late_dropped == n_rows
            assert emitted > 0 and len(closed) >= 4
        finally:
            pipe.stop()
        mon.assert_acyclic()
        summary = mon.graph_summary()
        assert summary["locks"] >= 4, summary
        assert summary["acquisitions"] > 50, summary


class TestTsan:
    def test_tsan_harness_clean(self):
        """The harness built from the checkout's sources runs clean under
        ThreadSanitizer, as ``tests/test_native.py`` holds the JAX
        package's: exit 0, no report, ``OK``."""
        path = native.build_tsan()
        assert path.parent == native.BUILD_DIR
        assert native._source_digest(native._LIB_DIR / "ingest.cc", native._LIB_DIR / "tsan_test.cc") in path.name
        stamp = b"ALZ_SOURCE_STAMP:" + path.name.rsplit("-", 1)[1].encode()
        assert stamp in path.read_bytes()
        run = subprocess.run(
            [str(path)], capture_output=True, timeout=300, text=True,
            env={"TSAN_OPTIONS": "halt_on_error=0", "PATH": "/usr/bin:/bin"},
        )
        assert run.returncode == 0, run.stdout + run.stderr
        assert "WARNING: ThreadSanitizer" not in run.stderr
        assert "OK" in run.stdout

    def test_build_tsan_raises_without_a_compiler(self, tmp_path, monkeypatch):
        monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
        monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
        with CompileWatcher() as w:
            with pytest.raises(RuntimeError, match="no-such-g\\+\\+"):
                native.build_tsan()
        # the build started and never finished
        assert w.count("tsan_test") == 1 and list(w.finished) == []


class TestBuildBudget:
    def test_each_build_site_is_one_event_with_its_seconds(self):
        seen = []
        with CompileWatcher(on_event=lambda *e: seen.append(e)) as w:
            native.build()
            native.build_agent()
            native.build_tsan()
        assert [n for n, _ in w.events] == ["libalaz_ingest", "agent_example", "tsan_test"]
        assert [n for n, _ in w.finished] == ["libalaz_ingest", "agent_example", "tsan_test"]
        assert all(secs >= 0.0 for _, secs in w.finished)
        assert [(k, n) for k, n, _ in seen] == [
            ("compiling", "libalaz_ingest"), ("finished", "libalaz_ingest"),
            ("compiling", "agent_example"), ("finished", "agent_example"),
            ("compiling", "tsan_test"), ("finished", "tsan_test"),
        ]
        assert w.total == 3 and w.count("tsan_test") == 1
        assert set(STEADY_STATE_BUDGETS) == {"segment", "libalaz_ingest", "agent_example", "tsan_test"}

    def test_a_build_in_steady_state_raises_with_attribution(self):
        with CompileWatcher() as w:
            native.build_agent()  # warmup: outside the budget
            with retrace_budget(STEADY_STATE_BUDGETS, watcher=w):
                pass
            with pytest.raises(RetraceBudgetExceeded, match=r"tsan_test: 1 build\(s\) > budget 0"):
                with retrace_budget(STEADY_STATE_BUDGETS, watcher=w):
                    native.build_tsan()
        # a budget of one allows the warmup build, in its own watcher
        with retrace_budget({"agent_example": 1}) as own:
            native.build_agent()
        assert own.count("agent_example") == 1

    def test_watchers_nest_and_close(self):
        with CompileWatcher() as outer:
            with CompileWatcher() as inner:
                with build_event("segment", "test"):
                    pass
            with build_event("segment", "test"):
                pass
        with build_event("segment", "test"):
            pass
        assert (outer.count("segment"), inner.count("segment")) == (2, 1)

    def test_a_raising_callback_is_swallowed_and_rings_are_bounded(self):
        def boom(*_):
            raise ValueError("callback")

        with CompileWatcher(on_event=boom, max_events=2) as w:
            for _ in range(3):
                with build_event("segment", "test"):
                    pass
        assert w.total == 2 and len(w.finished) == 2


def _fake_dispatch(entry, graph, k1=0, k2=0, k3=0, k4=0):
    """One dispatch of ``entry`` whose launches are faked by moving the
    kernels' counters, as a launch on the card would."""
    with dispatch(entry, graph):
        K.scatter_sum_sorted.launches += k1
        K.segment_expand_sorted.launches += k2
        K.gather_rows_banded.launches += k3
        K.pallas_gather_scatter_sum.launches += k4


_GRAPH = {"node_feats": np.zeros((4096, 8), np.float32), "edge_src": np.zeros(65536, np.int32)}
_STACKED = {"node_feats": np.zeros((4, 256, 8), np.float32), "edge_src": np.zeros((4, 512), np.int32)}
SAGE = {"score_apply": {"scatter_sum_sorted": 2, "segment_expand_sorted": 1}}


class TestLaunchBudget:
    def test_dispatches_record_their_launches_and_bucket(self):
        with CompileWatcher() as w:
            _fake_dispatch("score_apply", _GRAPH, k1=2, k2=1)
            _fake_dispatch("batched_score_apply", _STACKED, k1=2, k2=3, k3=3)
        assert w.dispatch_total == 2
        (e1, b1, l1), (e2, b2, l2) = w.dispatches
        assert (e1, b1) == ("score_apply", "n4096xe65536")
        assert (e2, b2) == ("batched_score_apply", "n256xe512")
        assert l1 == {"scatter_sum_sorted": 2, "segment_expand_sorted": 1, "gather_rows_banded": 0,
                      "pallas_gather_scatter_sum": 0}
        assert l2["gather_rows_banded"] == 3
        # no watcher open: nothing recorded, nothing read
        _fake_dispatch("score_apply", _GRAPH, k1=2, k2=1)
        assert w.dispatch_total == 2

    def test_steady_launches_hold(self):
        with retrace_budget(STEADY_STATE_BUDGETS, launches=SAGE) as w:
            for _ in range(3):
                _fake_dispatch("score_apply", _GRAPH, k1=2, k2=1)
            _fake_dispatch("train_step", _GRAPH, k1=9)  # not held
        assert w.dispatch_total == 4

    def test_a_launch_change_raises_naming_entry_bucket_and_kernels(self):
        with pytest.raises(RetraceBudgetExceeded) as exc:
            with retrace_budget(STEADY_STATE_BUDGETS, launches=SAGE):
                _fake_dispatch("score_apply", _GRAPH, k1=2, k2=1)
                _fake_dispatch("score_apply", _GRAPH, k1=3, k2=1)
        msg = str(exc.value)
        assert "score_apply [n4096xe65536] dispatch 2 of 2" in msg
        assert "scatter_sum_sorted 3 launch(es) != budget 2" in msg
        assert "segment_expand_sorted 1 launch(es) == budget 1" in msg
        assert "dispatch 1 of" not in msg
        # a kernel the budget leaves out must not launch
        with pytest.raises(RetraceBudgetExceeded, match="gather_rows_banded 1 launch"):
            with retrace_budget({}, launches=SAGE):
                _fake_dispatch("score_apply", _GRAPH, k1=2, k2=1, k3=1)

    def test_only_the_blocks_dispatches_are_held(self):
        with CompileWatcher() as w:
            _fake_dispatch("score_apply", _GRAPH, k1=5)  # before the block
            with retrace_budget({}, watcher=w, launches=SAGE):
                _fake_dispatch("score_apply", _GRAPH, k1=2, k2=1)

    def test_entry_points_report_their_dispatches(self):
        """``make_score_fn``'s ``score_apply`` records one dispatch per call,
        with the window's bucket; on CPU tensors the plain versions run and
        no kernel launches."""
        from alaz_tpu_torch.config import ModelConfig
        from alaz_tpu_torch.models.registry import init_params
        from alaz_tpu_torch.replay.synth import example_batch
        from alaz_tpu_torch.train.trainstep import make_score_fn

        cfg = ModelConfig(hidden_dim=16)
        params = init_params(cfg, key=0, device="cpu")
        batch = example_batch(n_pods=60, n_svcs=6, n_edges=300, seed=0)
        fn = make_score_fn(cfg, "cpu")
        zero = {"score_apply": {}}
        with retrace_budget(STEADY_STATE_BUDGETS, launches=zero) as w:
            fn(params, batch.device_arrays())
            fn(params, batch.device_arrays())
        assert [(e, b) for e, b, _ in w.dispatches] == [("score_apply", batch.bucket_key)] * 2

    def test_train_tgn_and_group_entry_points_report_their_dispatches(self):
        from alaz_tpu_torch.config import ModelConfig
        from alaz_tpu_torch.convert import graph_to_torch
        from alaz_tpu_torch.models import tgn
        from alaz_tpu_torch.models.registry import init_params
        from alaz_tpu_torch.replay.synth import example_batch
        from alaz_tpu_torch.runtime.service import _batched_score_fn
        from alaz_tpu_torch.train.trainstep import _adamw, make_train_step

        batch = example_batch(n_pods=60, n_svcs=6, n_edges=300, seed=0)
        arrays = batch.device_arrays()
        cfg = ModelConfig(hidden_dim=16)
        params = init_params(cfg, key=0, device="cpu")
        tcfg = ModelConfig(model="tgn", hidden_dim=16, tgn_max_nodes=batch.n_pad)
        tparams = init_params(tcfg, key=0, device="cpu")
        stacked = {k: np.stack([v, v]) for k, v in arrays.items()}
        with CompileWatcher() as w:
            make_train_step(cfg, device="cpu")(params, _adamw(params, 1e-3), arrays, batch.edge_label)
            tgn.make_step_fn(tcfg)(tparams, graph_to_torch(arrays, "cpu"), tgn.init_memory(tcfg, batch.n_pad, device="cpu"))
            _batched_score_fn(cfg)(params, graph_to_torch(stacked, "cpu"))
        assert [(e, b) for e, b, _ in w.dispatches] == [
            ("train_step", batch.bucket_key), ("tgn_step", batch.bucket_key),
            ("batched_score_apply", batch.bucket_key),
        ]

    def test_transfer_guard_without_a_card_guards_nothing(self):
        import torch

        with no_implicit_transfers():
            with explicit_transfer():
                assert float(torch.ones(2).sum()) == 2.0


class TestCompileEventPlane:
    @pytest.mark.parametrize("pkg", PACKAGES)
    def test_plane_counts_and_records_as_the_jax_package_does(self, pkg):
        """Both packages' planes (one source, held by the copy test) fed
        the same events give the same counters and recorder events."""
        device = importlib.import_module(f"{pkg}.obs.device")
        metrics_mod = importlib.import_module(f"{pkg}.runtime.metrics")
        recorder_mod = importlib.import_module(f"{pkg}.obs.recorder")
        metrics = metrics_mod.Metrics()
        rec = recorder_mod.FlightRecorder(capacity=64, metrics=metrics)
        plane = device.CompileEventPlane(metrics=metrics, recorder=rec)
        with plane.bucket("n256xe512"):
            plane._on_event("compiling", "segment", None)
            plane._on_event("finished", "segment", 0.25)
        plane._on_event("compiling", "<lambda>", None)
        assert plane.snapshot() == {"events": 2, "by_fn": {"segment": 1, "<lambda>": 1}}
        snap = metrics.snapshot()
        assert (snap["compile.events"], snap["compile.segment"], snap["compile._lambda_"]) == (2, 1, 1)
        (ev,) = [e for e in rec.events() if e["kind"] == "compile"]
        assert (ev["fn"], ev["bucket"], ev["duration_ms"]) == ("segment", "n256xe512", 250.0)

    def test_service_plane_hears_builds_until_stop(self):
        """A scoring Service's plane (on the CPU: no kernel build at
        start) counts a native build made while it runs into
        ``compile.*`` and the recorder, and hears nothing after stop."""
        from alaz_tpu_torch.config import ModelConfig, RuntimeConfig
        from alaz_tpu_torch.events.intern import Interner
        from alaz_tpu_torch.models.registry import init_params
        from alaz_tpu_torch.runtime.service import Service

        cfg = RuntimeConfig(model=ModelConfig(hidden_dim=16))
        params = init_params(cfg.model, key=0, device="cpu")
        svc = Service(config=cfg, interner=Interner(), model_state=params, device="cpu")
        assert svc.compile_plane is not None
        svc.start()
        try:
            assert svc.metrics.snapshot()["compile.events"] == 0
            native.build_agent()
        finally:
            svc.stop()
        native.build_agent()
        snap = svc.metrics.snapshot()
        assert (snap["compile.events"], snap["compile.agent_example"]) == (1, 1)
        (ev,) = [e for e in svc.recorder.events() if e["kind"] == "compile"]
        assert ev["fn"] == "agent_example" and ev["duration_ms"] >= 0.0
        # a non-scoring service has no plane
        assert Service(device="cpu").compile_plane is None
