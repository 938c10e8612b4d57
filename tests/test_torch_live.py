"""The port's live plane against the JAX package's, on the CPU.

Every test feeds both packages the same inputs, made from a numpy seed,
and holds the port's result to the JAX package's:

- the ingest socket (``sources/ingest_server.py``): the same wire bytes
  (clean L7/TCP/PROC frames, frames corrupted, garbled and truncated by
  ``FrameChaos``, unknown kinds, tenant-tagged frames, native AlzRecord
  frames) over one unix-socket connection into a Service that is not
  started; the server's counters, the queues' ``put_total``s and the
  ledgers equal, then the queues handed to the aggregators in one order
  on the test thread, and the closed ``GraphBatch``es equal bit for bit;
- ``BatchingBackend`` under one fake clock and one scripted transport
  (retries, a 4xx, an outage that opens the breaker, the recovery): the
  payloads (idempotency keys aside), the backoff sleeps, the breaker's
  opens and sheds and ``stats()`` equal;
- ``HealthChecker``: the same states, callbacks and payloads;
- ``K8sWatchSource`` against a fake API server (LIST, WATCH, an in-stream
  410 and the re-LIST that follows): the same messages;
- the CRI lister against a fake CRI socket: the same ``ContainerInfo``s;
- ``dist_tracing``, ``gotls``, ``tlsattach`` and ``logstream`` on
  ``tests/test_sources.py``'s inputs;
- the slice: each package's Service behind an ``IngestServer``, K8s
  messages through ``K8sWatchSource.inject``, request rows and scores
  exported through a ``BatchingBackend``, GraphSAGE at hidden 32 and 2
  layers (f32, params carried across with ``convert.params_from_jax``):
  the windows bit for bit, the scores at rtol/atol 1e-4 (the f32 oracle),
  the exported request rows equal;
- the chaos suite's frame and backend legs: the same result dicts.

The fake API server that serves a cluster's LIST and the recording HTTP
backend come from ``chip_smoke.py`` (``FakeApiServer``, ``BackendSink``),
which drives the same plane on the card.
"""

from __future__ import annotations

import json
import random
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlsplit

import numpy as np
import pytest

from alaz_tpu.config import BackendConfig as JaxBackendConfig
from alaz_tpu.config import RuntimeConfig as JaxRuntimeConfig
from alaz_tpu.config import SimulationConfig as JaxSimulationConfig
from alaz_tpu.datastore import backend as jbackend
from alaz_tpu.events.intern import Interner as JaxInterner
from alaz_tpu.events.k8s import EventType as JaxEventType
from alaz_tpu.events.k8s import Pod as JaxPod
from alaz_tpu.events.k8s import ResourceType as JaxResourceType
from alaz_tpu.replay.simulator import Simulator as JaxSimulator
from alaz_tpu.runtime import health as jhealth
from alaz_tpu.runtime.service import Service as JaxService
from alaz_tpu.sources import ingest_server as jingest
from alaz_tpu.sources.k8s_watch import K8sWatchSource as JaxK8sWatchSource
from alaz_tpu_torch.aggregator.engine import RETRY_ATTEMPT_LIMIT
from alaz_tpu_torch.config import BackendConfig, RuntimeConfig, SimulationConfig
from alaz_tpu_torch.datastore import backend as pbackend
from alaz_tpu_torch.events.intern import Interner
from alaz_tpu_torch.events.k8s import EventType, Pod, ResourceType
from alaz_tpu_torch.replay.simulator import Simulator
from alaz_tpu_torch.runtime import health as phealth
from alaz_tpu_torch.runtime.service import Service
from alaz_tpu_torch.sources import ingest_server as pingest
from alaz_tpu_torch.sources.k8s_watch import K8sWatchSource

SIM = dict(pod_count=30, service_count=10, edge_count=15, edge_rate=200)
TIMEOUT_S = 10.0
L7_FRAME_ROWS = 250


def _wait(pred, what: str, timeout_s: float = TIMEOUT_S) -> None:
    deadline = time.monotonic() + timeout_s
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.01)


# -- the ingest socket --------------------------------------------------------


def _traffic(seed: int = 3, duration_s: float = 2.0):
    """Each package's simulator over one config and seed: its K8s
    messages, and (from the port's) the TCP establishes and the L7
    batches cut to frames of ``L7_FRAME_ROWS``, which carry no interned
    ids and so are one wire for both."""
    jsim = JaxSimulator(JaxSimulationConfig(test_duration_s=duration_s, seed=seed, **SIM), interner=JaxInterner())
    psim = Simulator(SimulationConfig(test_duration_s=duration_s, seed=seed, **SIM), interner=Interner())
    jk8s, pk8s = jsim.setup(), psim.setup()
    l7 = [b[i:i + L7_FRAME_ROWS] for b in psim.iter_l7_batches() for i in range(0, b.shape[0], L7_FRAME_ROWS)]
    return jk8s, pk8s, psim.tcp_events(), l7


def _proc_events(rng, n: int) -> np.ndarray:
    """Process events of pids the simulator's traffic does not use: an
    EXIT of a pid with live sockets would let the wall clock (the
    aggregator's reaper) decide which of its requests still join."""
    from alaz_tpu_torch.events.schema import make_proc_events

    ev = make_proc_events(n)
    ev["pid"] = rng.integers(90_000, 90_030, n)
    ev["type"] = rng.integers(1, 3, n)
    ev["timestamp_ns"] = np.sort(rng.integers(0, 10**9, n))
    return ev


def _native_rows(rng, n: int, t0_ms: int = 1000, windows: int = 3) -> np.ndarray:
    from alaz_tpu_torch.graph.native import NATIVE_RECORD_DTYPE

    rows = np.zeros(n, dtype=NATIVE_RECORD_DTYPE)
    rows["start_time_ms"] = t0_ms + np.sort(rng.integers(0, 1000 * windows, n))
    rows["latency_ns"] = rng.integers(1_000, 5_000_000, n)
    rows["from_uid"] = rng.integers(0, 20, n)
    rows["to_uid"] = 20 + rng.integers(0, 8, n)
    rows["status"] = rng.choice([200, 404, 500], n)
    rows["from_type"], rows["to_type"] = 1, 2
    rows["protocol"] = rng.integers(1, 4, n)
    rows["flags"] = rng.integers(0, 4, n)
    return rows


def _wire(case: str, tcp, l7, seed: int = 0) -> bytes:
    """One connection's bytes for ``case``, built with the port's
    ``pack_frame`` (the JAX package's gives the same bytes, held below)."""
    from alaz_tpu_torch.chaos.injectors import FrameChaos

    rng = np.random.default_rng(seed)
    P = pingest
    frames = [P.pack_frame(P.KIND_TCP, tcp), P.pack_frame(P.KIND_PROC, _proc_events(rng, 16))]
    if case == "clean":
        frames += [P.pack_frame(P.KIND_L7, b) for b in l7]
    elif case == "chaos":
        fchaos = FrameChaos(seed=seed + 2, corrupt_prob=0.1, truncate_prob=0.05, garble_prob=0.1,
                            min_each=True, expect_frames=len(l7))
        frames += [fchaos.perturb(P.pack_frame(P.KIND_L7, b), len(b)) for b in l7]
        # a well-framed frame of an unknown kind, one whose length is absurd,
        # and one cut short (the next header read lands mid-payload)
        frames.insert(3, P.FRAME_HEADER.pack(P.MAGIC, 9, 0, 2, 8) + bytes(8))
        frames.insert(5, P.FRAME_HEADER.pack(P.MAGIC, P.KIND_L7, 0, 1, P.MAX_FRAME_BYTES + 1))
        frames.insert(9, P.pack_frame(P.KIND_L7, l7[0])[: 16 + 7 * l7[0].dtype.itemsize + 5])
        # a native frame where the service runs the numpy store
        frames.append(P.pack_frame(P.KIND_NATIVE, _native_rows(rng, 5)))
    elif case == "tenants":
        for i, b in enumerate(l7):
            frames.append(P.pack_frame(P.KIND_L7, b, tenant=i % 2))
        frames.insert(1, P.pack_frame(P.KIND_TCP, tcp, tenant=1))
        frames.append(P.pack_frame(P.KIND_L7, l7[0], tenant=3))  # no partition 3: refused
        frames.append(P.pack_frame(P.KIND_NATIVE, _native_rows(rng, 4), tenant=1))  # native is single-tenant
    elif case == "native":
        rows = _native_rows(rng, 600)
        frames += [P.pack_frame(P.KIND_NATIVE, rows[i:i + 150]) for i in range(0, 600, 150)]
        frames += [P.pack_frame(P.KIND_L7, b) for b in l7[:2]]
    return b"".join(frames)


def _send(address: str, wire: bytes) -> None:
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(TIMEOUT_S)
    try:
        s.connect(address)
        s.sendall(wire)
    finally:
        s.close()


def _conn_done(srv) -> bool:
    """The server took a connection and its serving thread has ended."""
    with srv._state_lock:
        conns = [t for t in srv._threads if t.name == "alaz-ingest-conn"]
    return bool(conns) and not any(t.is_alive() for t in conns)


SERVER_COUNTERS = ("frames", "records", "bad_frames", "unsupported_frames", "quarantined_frames", "resyncs",
                   "resync_bytes")


def _through_socket(svc, server_mod, path: Path, wire: bytes, take_windows: bool = True) -> dict:
    """``wire`` through an ``IngestServer`` in front of ``svc`` (not
    started): the server's counters, then each partition's queues handed
    to its aggregator on this thread (K8s, TCP, PROC, L7), every window
    closed. Returns the counters, the queues' put totals, the ledgers and
    (``take_windows``) the closed windows, taken off the window queue."""
    srv = server_mod.IngestServer(svc, path=path)
    srv.start()
    try:
        _send(str(path), wire)
        _wait(lambda: _conn_done(srv), "the connection to be served")
    finally:
        srv.stop()
    out = {k: getattr(srv, k) for k in SERVER_COUNTERS}
    out["put_total"] = [[q.put_total for q in p.queues] for p in svc.partitions]
    for p in svc.partitions:
        for item in p.k8s_queue.drain():
            for m in item:
                p.aggregator.process_k8s(m)
        for b in p.tcp_queue.drain():
            p.aggregator.process_tcp(b)
        for b in p.proc_queue.drain():
            p.aggregator.process_proc(b)
        for b in p.l7_queue.drain():
            p.aggregator.process_l7(b)
        # rows the join could not place retry on the wall clock: run them
        # to the end of their attempts now, as the housekeeping ticker would
        # (a second apart, past every backoff)
        for k in range(RETRY_ATTEMPT_LIMIT):
            p.aggregator.flush_retries((1 << 62) + k * 10**9)
    svc.flush_windows()
    if take_windows:
        out["windows"] = [item[0] for item in svc.window_queue.drain()]
    out["ledgers"] = [p.ledger.snapshot() for p in svc.partitions]
    out["refused"] = svc.refused_ledger.snapshot()
    out["unknown_tenant"] = svc.metrics.counter("ingest.unknown_tenant").value
    return out


def _assert_windows_equal(got: list, ref: list) -> None:
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert (g.window_start_ms, g.n_nodes, g.n_edges, g.bucket_key, getattr(g, "tenant", 0)) == (
            r.window_start_ms, r.n_nodes, r.n_edges, r.bucket_key, getattr(r, "tenant", 0))
        ga, ra = g.device_arrays(), r.device_arrays()
        assert set(ga) == set(ra)
        for k in ra:
            assert ga[k].dtype == ra[k].dtype and np.array_equal(ga[k], ra[k]), k
        np.testing.assert_array_equal(g.node_uids, r.node_uids)


@pytest.mark.parametrize("case", ["clean", "chaos", "tenants", "native"])
def test_ingest_server_matches(case, tmp_path):
    jk8s, pk8s, tcp, l7 = _traffic()
    wire = _wire(case, tcp, l7)
    tenants = 2 if case == "tenants" else 1
    native = case == "native"
    jsvc = JaxService(config=JaxRuntimeConfig(tenants=tenants), interner=JaxInterner(), use_native_ingest=native)
    psvc = Service(config=RuntimeConfig(tenants=tenants), interner=Interner(), device="cpu",
                   use_native_ingest=native)
    try:
        for svc, msgs in ((jsvc, jk8s), (psvc, pk8s)):
            for p in svc.partitions:
                for m in msgs:
                    p.aggregator.process_k8s(m)
        ref = _through_socket(jsvc, jingest, tmp_path / "j.sock", wire)
        got = _through_socket(psvc, pingest, tmp_path / "p.sock", wire)
    finally:
        for svc in (jsvc, psvc):
            if native:
                svc.graph_store.close()
    ref_windows, got_windows = ref.pop("windows"), got.pop("windows")
    assert got == ref
    _assert_windows_equal(got_windows, ref_windows)
    # what each case must exercise
    assert ref["records"] > 0 and ref_windows
    if case == "chaos":
        assert ref["quarantined_frames"] >= 4 and ref["resyncs"] >= 3 and ref["unsupported_frames"] == 1
        assert ref["ledgers"][0]["quarantined"] > 0
    if case == "tenants":
        assert ref["unknown_tenant"] == 1 and ref["refused"]["total"] == l7[0].shape[0]
        assert ref["unsupported_frames"] == 1 and {getattr(w, "tenant", 0) for w in ref_windows} == {0, 1}
    if case == "native":
        assert ref["records"] == tcp.shape[0] + 16 + 600 + sum(b.shape[0] for b in l7[:2])
        assert len(ref_windows) >= 3


def test_pack_frame_and_send_batches_match(tmp_path):
    rng = np.random.default_rng(1)
    rows = _proc_events(rng, 7)
    for kind, tenant in ((pingest.KIND_PROC, 0), (pingest.KIND_PROC, 5)):
        assert pingest.pack_frame(kind, rows, tenant=tenant) == jingest.pack_frame(kind, rows, tenant=tenant)
    with pytest.raises(ValueError):
        pingest.pack_frame(pingest.KIND_PROC, rows, tenant=999)
    # send_batches against a raw listener: the same bytes on the wire
    got = {}
    for name, mod in (("jax", jingest), ("port", pingest)):
        path = str(tmp_path / f"{name}.sock")
        lst = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        lst.bind(path)
        lst.listen(1)
        lst.settimeout(TIMEOUT_S)
        try:
            mod.send_batches(path, [(mod.KIND_PROC, rows), (mod.KIND_PROC, rows[:2])])
            conn, _ = lst.accept()
            conn.settimeout(TIMEOUT_S)
            buf = b""
            while chunk := conn.recv(65536):
                buf += chunk
            conn.close()
        finally:
            lst.close()
        got[name] = buf
    assert got["port"] == got["jax"] and len(got["jax"]) == 2 * 16 + 9 * rows.itemsize


# -- the export backend and health ---------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 0.0
        self.sleeps: list = []

    def time(self):
        return self.t

    def sleep(self, s):
        self.sleeps.append(s)
        self.t += s


class ScriptedTransport:
    """Answers each call with the next scripted status (200 when the
    script is out); ``"raise"`` raises as a dead socket would. Records
    each call's endpoint and JSON (idempotency key dropped, keys sorted)."""

    def __init__(self, script):
        self.script = list(script)
        self.calls: list = []

    def __call__(self, endpoint, payload):
        body = json.loads(json.dumps(payload))
        body.get("metadata", {}).pop("idempotency_key", None)
        self.calls.append((endpoint, json.dumps(body, sort_keys=True)))
        status = self.script.pop(0) if self.script else 200
        if status == "raise":
            raise ConnectionError("backend unreachable")
        return status


def _request_rows(dto, rng, n: int, n_names: int) -> np.ndarray:
    rows = dto.make_requests(n)
    rows["start_time_ms"] = 1_700_000_000_000 + rng.integers(0, 10_000, n)
    rows["latency_ns"] = rng.integers(1_000, 10**9, n)
    for side in ("from", "to"):
        rows[f"{side}_ip"] = rng.integers(0, 2**32, n, dtype=np.uint64)
        rows[f"{side}_type"] = rng.integers(1, 4, n)
        rows[f"{side}_uid"] = rng.integers(0, n_names, n)
        rows[f"{side}_port"] = rng.integers(1, 65535, n)
    rows["protocol"] = 1
    rows["tls"] = rng.random(n) < 0.3
    rows["completed"] = True
    rows["status_code"] = rng.choice([200, 201, 404, 503], n)
    rows["fail_reason"] = rng.integers(0, n_names, n)
    rows["method"] = rng.integers(0, 3, n)
    rows["path"] = rng.integers(0, n_names, n)
    return rows


def _drive_backend(mod, dto, k8s, interner_cls, cfg_cls, score_record, seed: int = 0) -> dict:
    """One package's ``BatchingBackend`` through a degraded, a dark and a
    recovered stretch, under a fake clock and a scripted transport."""
    rng = np.random.default_rng(seed)
    random.seed(seed)  # the backoff's full jitter
    interner = interner_cls()
    names = [interner.intern(f"name-{i}") for i in range(12)]
    clock = FakeClock()
    transport = ScriptedTransport([200, 503, 200, 404, 429, "raise", 200] + ["raise"] * 30)
    be = mod.BatchingBackend(transport, interner, cfg_cls(batch_size=25, max_retries=2, backoff_min_s=0.5,
                                                          backoff_max_s=2.0, breaker_threshold=3,
                                                          breaker_cooldown_s=10.0),
                             time_fn=clock.time, sleep_fn=clock.sleep)
    be.persist_requests(_request_rows(dto, rng, 60, len(names)))
    be.persist_resource(k8s.ResourceType.POD, k8s.EventType.ADD,
                        k8s.Pod(uid="u1", name="p1", namespace="ns", ip="10.0.0.1", image="img"))
    be.persist_scores([score_record(1000, "a", "b", "HTTP", 0.25), score_record(1000, "b", "c", "REDIS", 0.75)])
    be.pump()  # requests (60 >= 25) go now
    clock.t += 6.0
    be.pump()  # the rest on their cadence
    stages = [be.stats()]
    for _ in range(5):  # dark: the breaker opens and sheds
        be.persist_requests(_request_rows(dto, rng, 25, len(names)))
        be.pump(force=True)
        clock.t += 1.0
    stages.append(be.stats())
    transport.script = []  # healed; after the cooldown one probe closes the circuit
    clock.t += 11.0
    be.persist_requests(_request_rows(dto, rng, 10, len(names)))
    be.pump(force=True)
    stages.append(be.stats())
    return {"calls": transport.calls, "sleeps": clock.sleeps, "stats": stages,
            "breaker": (be.breaker.opens, be.breaker.shorted, be.breaker.state)}


def test_batching_backend_matches():
    from alaz_tpu.datastore import dto as jdto
    from alaz_tpu.events import k8s as jk8s
    from alaz_tpu.runtime.service import ScoreRecord as JaxScoreRecord
    from alaz_tpu_torch.datastore import dto as pdto
    from alaz_tpu_torch.events import k8s as pk8s
    from alaz_tpu_torch.runtime.service import ScoreRecord

    ref = _drive_backend(jbackend, jdto, jk8s, JaxInterner, JaxBackendConfig, JaxScoreRecord)
    got = _drive_backend(pbackend, pdto, pk8s, Interner, BackendConfig, ScoreRecord)
    assert got == ref
    opens, shorted, state = ref["breaker"]
    assert opens >= 1 and shorted >= 1 and state == "closed"
    assert {ep for ep, _ in ref["calls"]} >= {"/requests/", "/pod/", "/anomalies/"}
    assert ref["stats"][1]["requests"]["shed"] > 0


def test_backend_payload_carries_the_same_version():
    import alaz_tpu
    import alaz_tpu_torch

    assert alaz_tpu_torch.__version__ == alaz_tpu.__version__


def test_http_transport_matches():
    from chip_smoke import BackendSink

    sink = BackendSink()
    try:
        for mod in (jbackend, pbackend):
            send = mod.http_transport(sink.url)
            assert send("/requests/", {"data": [[1, 2], [3, 4]]}) == 200
            sink.set_health(402)
            assert send(mod.EP_HEALTHCHECK, {"state": "running"}) == 402
            sink.set_health(200)
        posted = sink.snapshot()
    finally:
        sink.close()
    assert posted["rows"] == {"/requests/": 4} and posted["health_puts"] == 2


def _drive_health(mod) -> dict:
    statuses = [200, 402, 402, "raise", 500, 200, 200, 402, 204]
    seen, calls = [], []

    def transport(ep, payload):
        calls.append((ep, json.dumps(payload, sort_keys=True)))
        status = statuses[len(calls) - 1]
        if status == "raise":
            raise ConnectionError("down")
        return status

    hc = mod.HealthChecker(transport, on_stop=lambda: seen.append("stop"), on_resume=lambda: seen.append("resume"),
                           metrics_snapshot=lambda: {"windows.closed": 3},
                           degraded_snapshot=lambda: {"ledger": {"total": 0}})
    states = [hc.check_once().value for _ in statuses]
    return {"states": states, "callbacks": seen, "calls": calls, "checks": hc.checks, "failures": hc.failures}


def test_health_checker_matches():
    ref, got = _drive_health(jhealth), _drive_health(phealth)
    assert got == ref
    assert ref["callbacks"] == ["stop", "resume", "stop", "resume"] and ref["failures"] == 1
    # and its thread: a short interval, stopped within its join
    hc = phealth.HealthChecker(lambda ep, p: 200, interval_s=0.01)
    hc.start()
    _wait(lambda: hc.checks >= 2, "two health checks")
    hc.stop()
    assert hc._thread is None


# -- the Kubernetes watch -----------------------------------------------------


def _pod_json(uid, rv, ns="app", ip="10.0.0.1", image="nginx:1"):
    return {
        "metadata": {"uid": uid, "name": uid, "namespace": ns, "resourceVersion": rv},
        "status": {"podIP": ip},
        "spec": {"containers": [{"image": image}]},
    }


def _list_body(items, rv):
    return {"kind": "List", "metadata": {"resourceVersion": rv}, "items": items}


class FakeApiserver:
    """Scripted apiserver (tests/test_k8s_apiserver.py's): per-path queues
    of LIST and WATCH responses. When a queue runs dry, LIST serves an
    empty list and WATCH blocks on ``release`` (a quiet stream)."""

    def __init__(self):
        self.lists: dict = {}  # path -> [("json", body) | ("status", code)]
        self.watches: dict = {}  # path -> [("events", [...]) | ("status", code)]
        self.requests: list = []  # (path, {param: value}, headers)
        self.release = threading.Event()
        self._lock = threading.Lock()

        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                parts = urlsplit(self.path)
                params = {k: v[0] for k, v in parse_qs(parts.query).items()}
                with outer._lock:
                    outer.requests.append((parts.path, params, dict(self.headers)))
                    if params.get("watch") == "1":
                        script = outer.watches.get(parts.path) or []
                        step = script.pop(0) if script else ("block",)
                    else:
                        script = outer.lists.get(parts.path) or []
                        step = script.pop(0) if script else ("json", _list_body([], "1"))
                kind, *payload = step
                if kind == "status":
                    self.send_response(payload[0])
                    self.end_headers()
                elif kind == "json":
                    body = json.dumps(payload[0]).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif kind == "events":
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.end_headers()
                    for event in payload[0]:
                        self.wfile.write(json.dumps(event).encode() + b"\n")
                        self.wfile.flush()
                else:  # block: a quiet stream until teardown
                    self.send_response(200)
                    self.end_headers()
                    self.wfile.flush()
                    outer.release.wait(30)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.server.server_port}"
        self._thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self._thread.start()

    def close(self):
        self.release.set()
        self.server.shutdown()
        self.server.server_close()


class CollectingService:
    def __init__(self):
        self.k8s: list = []
        self._lock = threading.Lock()

    def submit_k8s(self, msg):
        with self._lock:
            self.k8s.append(msg)
        return True

    def snapshot(self) -> list:
        with self._lock:
            return list(self.k8s)


def _msg_key(m) -> tuple:
    obj = dict(vars(m.object))
    return (m.resource_type.value, m.event_type.value, json.dumps(obj, sort_keys=True, default=str))


def _watch_script(api: FakeApiserver) -> None:
    pods, svcs = "/api/v1/pods", "/api/v1/services"
    api.lists[pods] = [
        ("json", _list_body([_pod_json("pod-a", "5"), _pod_json("pod-b", "6", ip="10.0.0.2")], "100")),
        ("json", _list_body([_pod_json("pod-a", "5"), _pod_json("pod-c", "150", ip="10.0.0.3")], "200")),
    ]
    api.watches[pods] = [
        ("events", [{"type": "ADDED", "object": _pod_json("pod-c", "101", ip="10.0.0.3")},
                    {"type": "MODIFIED", "object": _pod_json("pod-a", "102", image="nginx:2")}]),
        ("events", [{"type": "ERROR", "object": {"kind": "Status", "code": 410, "message": "Expired"}}]),
    ]
    api.lists[svcs] = [("json", _list_body([{
        "metadata": {"uid": "svc-1", "name": "web", "namespace": "app", "resourceVersion": "7"},
        "spec": {"type": "ClusterIP", "clusterIP": "10.96.0.10", "clusterIPs": ["10.96.0.10"],
                 "ports": [{"name": "http", "port": 80, "targetPort": 8080, "protocol": "TCP"}]},
    }], "100"))]
    api.watches[svcs] = [("events", [{"type": "DELETED", "object": {
        "metadata": {"uid": "svc-1", "name": "web", "namespace": "app", "resourceVersion": "8"},
        "spec": {"type": "ClusterIP", "clusterIP": "10.96.0.10"}}}])]


def _watch_once(source_cls, resource_type) -> list:
    api = FakeApiserver()
    _watch_script(api)
    svc = CollectingService()
    src = source_cls(api_server=api.url, token="t", resync_interval_s=60.0, error_backoff_s=0.05,
                     exclude_namespaces=["kube-system"])
    src.start(svc)
    try:
        assert src.live

        def relisted():
            return any(m.resource_type == resource_type.POD and m.event_type.name == "DELETE"
                       for m in svc.snapshot()) and sum(m.resource_type == resource_type.SERVICE
                                                        for m in svc.snapshot()) >= 2
        _wait(relisted, "the 410 re-LIST and the service watch")
    finally:
        src.stop()
        api.close()
    by_kind: dict = {}
    for m in svc.snapshot():
        by_kind.setdefault(m.resource_type.value, []).append(_msg_key(m))
    return by_kind


def test_k8s_watch_source_matches():
    ref = _watch_once(JaxK8sWatchSource, JaxResourceType)
    got = _watch_once(K8sWatchSource, ResourceType)
    # kinds are watched on threads of their own: each kind's stream in order
    assert got == ref
    pods = [(k[1], json.loads(k[2])["uid"]) for k in ref["Pod"]]
    assert pods[:4] == [("Update", "pod-a"), ("Update", "pod-b"), ("Add", "pod-c"), ("Update", "pod-a")]
    assert ("Delete", "pod-b") in pods and "Container" in ref and len(ref["Service"]) == 2


def test_k8s_injected_mode_matches():
    """No API server and no in-cluster config: both sources serve in
    injected mode, filtering excluded namespaces and fanning pods out."""
    out = []
    for cls, pod_cls, rt, et in ((JaxK8sWatchSource, JaxPod, JaxResourceType, JaxEventType),
                                 (K8sWatchSource, Pod, ResourceType, EventType)):
        from alaz_tpu_torch.events.k8s import K8sResourceMessage as PMsg
        from alaz_tpu.events.k8s import K8sResourceMessage as JMsg

        msg_cls = JMsg if cls is JaxK8sWatchSource else PMsg
        svc = CollectingService()
        src = cls(in_cluster=False, exclude_namespaces=["kube-system"])
        src.start(svc)
        assert not src.live
        src.inject(msg_cls(rt.POD, et.ADD, pod_cls(uid="u1", name="p", namespace="app", ip="10.0.0.9",
                                                   image="img")))
        src.inject(msg_cls(rt.POD, et.ADD, pod_cls(uid="u2", name="q", namespace="kube-system")))
        src.stop()
        out.append([_msg_key(m) for m in svc.snapshot()])
    assert out[1] == out[0] and len(out[0]) == 2


# -- CRI, TLS attach, Go TLS, log streaming, distributed tracing ---------------


def test_cri_lister_matches(tmp_path):
    from alaz_tpu.sources.containers import ContainerIndex as JaxContainerIndex
    from alaz_tpu.sources.cri import CriContainerLister as JaxLister
    from alaz_tpu.sources.cri import probe_runtime_socket as jax_probe
    from alaz_tpu_torch.sources.containers import ContainerIndex
    from alaz_tpu_torch.sources.cri import CriContainerLister, probe_runtime_socket
    from tests.test_sources import FakeCriServer, TestCriClient

    host = tmp_path / "hostroot"
    (host / "proc" / "4321").mkdir(parents=True)
    (host / "proc" / "4321" / "cgroup").write_text("0::/kubepods/pod9\n")
    cg = host / "sys" / "fs" / "cgroup" / "kubepods" / "pod9"
    cg.mkdir(parents=True)
    (cg / "cgroup.procs").write_text("4321\n4322\n")
    # a server for each probe: the fake serves one connection at a time
    for name, fn in (("jax", jax_probe), ("port", probe_runtime_socket)):
        probe = FakeCriServer(tmp_path / f"{name}.sock", TestCriClient()._responses())
        try:
            socks = [str(tmp_path / "none.sock"), str(tmp_path / f"{name}.sock")]
            assert fn(socks, timeout_s=5) == socks[1] and fn(socks[:1], timeout_s=5) is None
        finally:
            probe.close()
    infos = []
    for lister_cls, index_cls in ((JaxLister, JaxContainerIndex), (CriContainerLister, ContainerIndex)):
        sock = tmp_path / f"cri-{lister_cls.__module__}.sock"
        srv = FakeCriServer(sock, TestCriClient()._responses())
        lister = lister_cls(str(sock), host_root=str(host), timeout_s=5)
        try:
            index = index_cls(lister=lister, exclude_namespaces=("kube-system",))
            index.sync_once()
            infos.append(({k: vars(v) for k, v in index.containers.items()},
                          index.get_pids_running_on_containers()))
        finally:
            lister.close()
            srv.close()
    assert infos[1] == infos[0] and infos[0][1] == {4321, 4322}


def test_container_index_proc_events_match():
    from alaz_tpu.sources.containers import ContainerIndex as JaxIndex
    from alaz_tpu.sources.containers import ContainerInfo as JaxInfo
    from alaz_tpu_torch.sources.containers import ContainerIndex, ContainerInfo
    from tests.test_sources import FakeService

    out = []
    for index_cls, info_cls in ((JaxIndex, JaxInfo), (ContainerIndex, ContainerInfo)):
        svc = FakeService()
        idx = index_cls(sync_interval_s=999)
        idx._service = svc
        idx.register(info_cls("c1", pids={100, 101}))
        idx.register(info_cls("sys", namespace="kube-system", pids={1}))
        first = idx.sync_once()
        idx.remove("c1")
        second = idx.sync_once()
        out.append((first, second, [(p["pid"].tolist(), p["type"].tolist()) for p in svc.proc]))
    assert out[1] == out[0]


def test_tls_attach_and_go_tls_match(tmp_path):
    import shutil

    from alaz_tpu.sources import gotls as jgotls
    from alaz_tpu.sources import tlsattach as jtls
    from alaz_tpu_torch.sources import gotls as pgotls
    from alaz_tpu_torch.sources import tlsattach as ptls
    from tests.test_sources import _build_go_fixture, TestTlsAttach

    maps = TestTlsAttach.MAPS
    deleted = "7f-80 r-xp 0 0 1 /usr/lib/libssl.so.3 (deleted)\n"
    for text in (maps, deleted, ""):
        assert ptls.find_ssl_lib(text) == jtls.find_ssl_lib(text)
    for v in ("1.1.1", "3.0.2", "1.0.2", "9"):
        assert ptls.ssl_version_family(v) == jtls.ssl_version_family(v)
    (tmp_path / "55").mkdir()
    (tmp_path / "55" / "maps").write_text(maps)
    exe = _build_go_fixture(tmp_path)
    pid_dir = tmp_path / "321"
    pid_dir.mkdir()
    (pid_dir / "maps").write_text("00400000-00452000 r-xp 0 08:02 1 /usr/bin/app\n")
    shutil.copy(exe, pid_dir / "exe")
    results = []
    for tls, gotls in ((jtls, jgotls), (ptls, pgotls)):
        attached = []
        tr = tls.TlsAttachTracker(on_attach=lambda pid, info: attached.append((pid, info)), proc_root=tmp_path)
        calls = [tr.signal(55), tr.signal(55), tr.signal(321), tr.signal(999)]
        tr.detach(55)
        calls.append(tr.signal(55))
        plan = gotls.discover_go_tls(exe)
        results.append({
            "calls": calls,
            "attached": [(pid, {k: (vars(v) if hasattr(v, "__dict__") else v) for k, v in info.items()})
                         for pid, info in attached],
            "plan": (plan.go_version, vars(plan.write), vars(plan.read), plan.read_ret_offsets),
            "version": gotls.go_build_version(exe),
        })
    assert json.dumps(results[1], sort_keys=True, default=str) == json.dumps(results[0], sort_keys=True,
                                                                               default=str)
    assert results[0]["calls"][:2] == [True, False] and len(results[0]["plan"][3]) == 2


def test_logstream_matches(tmp_path):
    from alaz_tpu.sources import logstream as jlog
    from alaz_tpu_torch.sources import logstream as plog

    out = []
    for mod in (jlog, plog):
        sent = []

        class Conn(mod.Connection):
            dead = False

            def send(self, data):
                sent.append(data)

            def alive(self):
                return not self.dead

        pool = mod.ConnectionPool(Conn)
        ls = mod.LogStreamer(pool)
        d = tmp_path / mod.__name__
        d.mkdir()
        f, g = d / "c1.log", d / "c2.log"
        f.write_text("old line\n")
        g.write_text("aaaa")
        ls.watch("c1", f, metadata={"pod": "p1"})
        ls.watch("c2", g)
        pumped = [ls.pump_once()]
        with open(f, "a") as fh:
            fh.write("new line\nand another\n")
        g.write_text("b")  # rotated: smaller than the last position
        pumped.append(ls.pump_once())
        c = pool.get()
        pool.put(c)
        c.dead = True
        c2 = pool.get()
        out.append((pumped, sent, c2 is not c, pool.discarded, pool.created))
    assert out[1] == out[0] and out[0][1]


def test_dist_tracing_matches():
    from alaz_tpu.aggregator.dist_tracing import DistTracingCorrelator as JaxCorrelator
    from alaz_tpu_torch.aggregator.dist_tracing import DistTracingCorrelator
    from alaz_tpu_torch.events.schema import make_l7_events

    rng = np.random.default_rng(4)
    n = 200
    ev = make_l7_events(n)
    ev["pid"] = rng.integers(1, 4, n)
    ev["tid"] = rng.integers(1, 6, n)
    ev["seq"] = np.arange(n)
    ev["write_time_ns"] = np.sort(rng.integers(0, 5_000_000, n))
    ingress = rng.random(n) < 0.3
    out = []
    for cls in (JaxCorrelator, DistTracingCorrelator):
        c = cls(window_ns=400_000)
        links = c.observe(ev[:120], ingress[:120]) + c.observe(ev[120:], ingress[120:])
        out.append(([vars(x) for x in links], [list(map(int, r)) for r in c.export_rows()], c.dropped_unmatched))
    assert json.dumps(out[1], default=int) == json.dumps(out[0], default=int) and out[0][0]


# -- the chaos suite's live legs ------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_chaos_frame_and_backend_legs_match(seed):
    from alaz_tpu.chaos.harness import run_chaos_suite as jax_suite
    from alaz_tpu.config import ChaosConfig as JaxChaosConfig
    from alaz_tpu_torch.chaos.harness import run_chaos_suite
    from alaz_tpu_torch.config import ChaosConfig

    random.seed(seed)
    ref = jax_suite(JaxChaosConfig(enabled=True, seed=seed), legs=("frames", "backend")).as_dict()
    random.seed(seed)
    got = run_chaos_suite(ChaosConfig(enabled=True, seed=seed), legs=("frames", "backend")).as_dict()
    assert got == ref and ref["findings"] == []
    assert ref["frames"]["quarantined_frames"] >= 1 and ref["backend"]["breaker_opens"] >= 1


# -- the slice ----------------------------------------------------------------


def _live_service(kind, cfg, params, tmp_path: Path, k8s_msgs, wire: bytes):
    """One package's live slice on the CPU: Service (GraphSAGE) with a
    ``BatchingBackend`` (scripted transport, fake clock) as its export
    backend, K8s messages through ``K8sWatchSource.inject``, the wire
    through an ``IngestServer``; the queues handed to the aggregator on
    this thread, every window closed, then the service started to score
    them and stopped, and the backend flushed."""
    if kind == "jax":
        svc_cls, backend_mod, ingest_mod, src_cls, interner = JaxService, jbackend, jingest, JaxK8sWatchSource, \
            JaxInterner()
        bcfg = JaxBackendConfig(batch_size=500)
        kw = {}
    else:
        svc_cls, backend_mod, ingest_mod, src_cls, interner = Service, pbackend, pingest, K8sWatchSource, Interner()
        bcfg = BackendConfig(batch_size=500)
        kw = {"device": "cpu"}
    clock = FakeClock()
    transport = ScriptedTransport([])
    backend = backend_mod.BatchingBackend(transport, interner, bcfg, time_fn=clock.time, sleep_fn=clock.sleep)
    windows = []
    svc = svc_cls(config=cfg, interner=interner, model_state=params, export_backend=backend,
                  score_threshold=0.0, **kw)
    svc.score_observer = lambda batch, tenant, lat: windows.append(batch)
    src = src_cls(in_cluster=False)
    src.start(svc)
    for m in k8s_msgs:
        src.inject(m)
    src.stop()
    counters = _through_socket(svc, ingest_mod, tmp_path / f"{kind}.sock", wire, take_windows=False)
    svc.start()
    try:
        svc.drain(timeout_s=60)
    finally:
        svc.stop()
    backend.stop(flush=True)
    posts: dict = {}
    for ep, body in transport.calls:
        posts.setdefault(ep, []).extend(json.loads(body)["data"])
    return svc, counters, windows, posts


def test_live_slice_matches_the_jax_service(tmp_path):
    from tests.test_torch_service import _cfgs, _params, _port_params

    jcfg, pcfg = _cfgs()
    assert (jcfg.model.hidden_dim, jcfg.model.num_layers, jcfg.model.model) == (32, 2, "graphsage")
    jparams = _params(jcfg)
    pparams = _port_params(pcfg, jparams)
    jk8s, pk8s, tcp, l7 = _traffic(seed=5, duration_s=3.0)
    wire = _wire("clean", tcp, l7)
    jsvc, jc, jwin, jposts = _live_service("jax", jcfg, jparams, tmp_path, jk8s, wire)
    psvc, pc, pwin, pposts = _live_service("port", pcfg, pparams, tmp_path, pk8s, wire)
    assert pc == jc
    assert psvc.ledger.snapshot() == jsvc.ledger.snapshot()
    assert len(jwin) >= 3 and psvc.scored_batches == jsvc.scored_batches == len(jwin)
    _assert_windows_equal(pwin, jwin)
    # the exported request rows and resources equal; the scores at the f32 oracle
    assert set(pposts) == set(jposts) >= {"/requests/", "/anomalies/", "/pod/", "/svc/"}
    for ep in jposts:
        if ep != "/anomalies/":
            assert pposts[ep] == jposts[ep], ep
    ja, pa = jposts["/anomalies/"], pposts["/anomalies/"]
    assert [r[:4] for r in pa] == [r[:4] for r in ja] and len(ja) == sum(w.n_edges for w in jwin)
    np.testing.assert_allclose([r[4] for r in pa], [r[4] for r in ja], rtol=1e-4, atol=1e-4)
