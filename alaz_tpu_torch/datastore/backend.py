"""Batching export backend — the datastore/backend.go analog (G17).

Buffers columnar batches per stream and flushes on batch-size or cadence
(reqs ≤1000/5s, conns ≤500/30s, kafka ≤500/5s, resources ≤1000/5s;
backend.go:280-338,591-765) through a pluggable ``Transport`` with retries
and exponential backoff (2 retries, 1-5s, retry on 400/429/5xx;
backend.go:210-278). Every flush carries ``Metadata`` with a fresh
idempotency key (payload.go:3-8).

The Transport is the process boundary: an HTTP client in production, an
in-process recorder in tests, or the TPU scoring service's feed queue.
"""

from __future__ import annotations

import json
import random
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

import numpy as np

from alaz_tpu_torch import __version__
from alaz_tpu_torch.config import BackendConfig
from alaz_tpu_torch.datastore.dto import _EP_NAMES, request_rows_to_payload
from alaz_tpu_torch.events.net import u32_to_ip
from alaz_tpu_torch.datastore.interface import BaseDataStore
from alaz_tpu_torch.events.intern import Interner
from alaz_tpu_torch.events.k8s import EventType, ResourceType
from alaz_tpu_torch.logging import get_logger

log = get_logger("alaz_tpu.datastore")

# endpoint paths mirror backend.go:171-187 (+ the new anomaly-score leg)
EP_REQUESTS = "/requests/"
EP_CONNECTIONS = "/connections/"
EP_KAFKA = "/events/kafka/"
EP_HEALTHCHECK = "/healthcheck/"
EP_ANOMALIES = "/anomalies/"
EP_METRICS = "/metrics/scrape/"  # backend.go:504
_RESOURCE_EP = {
    ResourceType.POD: "/pod/",
    ResourceType.SERVICE: "/svc/",
    ResourceType.REPLICASET: "/rs/",
    ResourceType.DEPLOYMENT: "/deployment/",
    ResourceType.ENDPOINTS: "/endpoint/",
    ResourceType.CONTAINER: "/container/",
    ResourceType.DAEMONSET: "/daemonset/",
    ResourceType.STATEFULSET: "/statefulset/",
}

Transport = Callable[[str, dict], int]
"""(endpoint, json-able payload) -> HTTP-like status code."""


class CircuitBreaker:
    """Consecutive-failure circuit breaker for the export leg (ISSUE 6).

    closed --(threshold consecutive send failures)--> open
    open   --(cooldown elapses)--> half-open: ONE probe send passes
    half-open --probe success--> closed / --probe failure--> open again

    While open, sends short-circuit without touching the wire — a dead
    or drowning backend costs one counter bump per batch instead of a
    full retry ladder (max_retries × backoff) per batch, which is what
    turns a backend brownout into an agent-side CPU/latency incident.
    Thread-safe; ``time_fn`` injectable for tests."""

    def __init__(
        self,
        threshold: int = 5,
        cooldown_s: float = 30.0,
        time_fn: Callable[[], float] = time.monotonic,
    ):
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self.time_fn = time_fn
        self._lock = threading.Lock()
        self._failures = 0  # consecutive  # guarded-by: self._lock
        self._opened_at: Optional[float] = None  # guarded-by: self._lock
        self._probe_out = False  # a half-open probe is in flight  # guarded-by: self._lock
        self.opens = 0  # guarded-by: self._lock
        self.shorted = 0  # sends skipped while open  # guarded-by: self._lock
        # optional flight recorder (ISSUE 9): open/close flips become
        # structured ring events, so a post-incident dump shows WHEN the
        # export leg went dark relative to the windows it was shedding
        self.recorder = None  # lockless-ok: attach-once wiring before traffic flows; readers null-check an atomic reference swap

    def allow(self) -> bool:
        """May a send go to the wire right now?"""
        with self._lock:
            if self._opened_at is None:
                return True
            if self.time_fn() - self._opened_at >= self.cooldown_s:
                if not self._probe_out:
                    self._probe_out = True  # exactly one probe through
                    return True
            self.shorted += 1
            return False

    def record(self, ok: bool) -> None:
        flip: Optional[str] = None
        with self._lock:
            probe = self._probe_out
            self._probe_out = False
            if ok:
                self._failures = 0
                if self._opened_at is not None:
                    flip = "closed"
                self._opened_at = None
            elif self._opened_at is not None:
                if probe:
                    # failed half-open probe: restart the cooldown window
                    self._opened_at = self.time_fn()
                    self.opens += 1
                    flip = "reopened"
                # else: a STRAGGLER failure — a send that departed before
                # the circuit opened (concurrent pump threads). The
                # outage is already accounted; re-counting it would
                # inflate `opens` and push recovery out a full cooldown.
            else:
                self._failures += 1
                if self._failures >= self.threshold:
                    self._opened_at = self.time_fn()
                    self.opens += 1
                    flip = "opened"
            opens = self.opens
        rec = self.recorder
        if flip is not None and rec is not None:
            # outside the breaker lock: the recorder has its own ring
            # lock and never calls back in
            rec.record("breaker_flip", state=flip, opens=opens)

    @property
    def state(self) -> str:
        with self._lock:
            if self._opened_at is None:
                return "closed"
            if self.time_fn() - self._opened_at >= self.cooldown_s:
                return "half-open"
            return "open"


def http_transport(host: str, timeout_s: float = 10.0) -> Transport:
    """Real HTTP POST transport over urllib (the retryablehttp client's
    wire role, backend.go:210-278; retries/backoff live in
    BatchingBackend)."""
    import urllib.error
    import urllib.request

    base = host.rstrip("/")

    def send(endpoint: str, payload: dict) -> int:
        req = urllib.request.Request(
            base + endpoint,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
            method="POST" if endpoint != EP_HEALTHCHECK else "PUT",
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                return resp.status
        except urllib.error.HTTPError as e:
            return e.code

    return send


@dataclass
class _Stream:
    """Per-endpoint buffer + delivery accounting. Every field is
    guarded by the owning ``BatchingBackend._lock`` — the backend is
    the only holder of ``_Stream`` references, and alazrace's golden
    concurrency map pins that ownership (the pump thread and the
    caller's flush/stop both account through the one lock; the
    off-lock ``sent += len(chunk)`` this replaced was an ALZ051 lost
    update whenever ``stop(flush=True)`` overlapped a pump tick)."""

    name: str
    endpoint: str
    batch_size: int
    interval_s: float
    pending: List[Any] = field(default_factory=list)
    last_flush: float = 0.0
    sent: int = 0
    failed: int = 0  # exhausted the retry ladder (or non-retryable 4xx)
    shed: int = 0  # short-circuited by the open breaker, never wired


class BatchingBackend(BaseDataStore):
    """Thread-safe; ``pump()`` drives cadence (call from a runtime loop or
    use ``start()`` for a daemon thread)."""

    def __init__(
        self,
        transport: Transport,
        interner: Interner,
        config: Optional[BackendConfig] = None,
        time_fn: Callable[[], float] = time.monotonic,
        sleep_fn: Callable[[float], None] = time.sleep,
        ledger=None,
    ):
        cfg = config if config is not None else BackendConfig()
        self.cfg = cfg
        self.transport = transport
        self.interner = interner
        self.time_fn = time_fn
        self.sleep_fn = sleep_fn
        now = time_fn()
        self._streams = {
            "requests": _Stream("requests", EP_REQUESTS, cfg.batch_size, cfg.req_flush_interval_s, last_flush=now),
            "connections": _Stream("connections", EP_CONNECTIONS, cfg.conn_batch_size, cfg.conn_flush_interval_s, last_flush=now),
            "kafka": _Stream("kafka", EP_KAFKA, cfg.kafka_batch_size, cfg.kafka_flush_interval_s, last_flush=now),
            "anomalies": _Stream("anomalies", EP_ANOMALIES, cfg.batch_size, cfg.req_flush_interval_s, last_flush=now),
        }
        self._resource_streams: dict[ResourceType, _Stream] = {
            rt: _Stream(rt.value, ep, cfg.batch_size, cfg.resource_flush_interval_s, last_flush=now)
            for rt, ep in _RESOURCE_EP.items()
        }
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._warned_endpoints: set = set()  # guarded-by: self._lock
        # flapping-backend protection (ISSUE 6): consecutive failed sends
        # open the circuit; sends shed fast until a cooldown probe heals
        self.breaker = CircuitBreaker(
            threshold=cfg.breaker_threshold,
            cooldown_s=cfg.breaker_cooldown_s,
            time_fn=time_fn,
        )
        # metrics scrape-and-push leg (backend.go:340-392): a render
        # function (Prometheus text) polled every metrics_export_interval_s
        self._metrics_render: Optional[Callable[[], str]] = None  # lockless-ok: attach-once reference swap at wiring; the pump thread may already be live (cmd_serve starts the backend before Service attaches), but readers null-check and an unattached tick merely skips the scrape — nothing is lost or torn
        self._metrics_last_push = now  # guarded-by: self._lock
        self.metrics_pushed = 0  # guarded-by: self._lock
        # drop-ledger hookup (ISSUE 12 satellite): rows the OPEN breaker
        # sheds attribute to the closed `shed` cause, so the export leg
        # joins the conservation equation instead of hiding loss in
        # `stream.failed`; attach-once at wiring (Service adopts the
        # backend into its ledger, the chaos harness passes its own)
        self.ledger = ledger  # lockless-ok: attach-once reference swap at wiring; the pump thread may already be live (cmd_serve starts the backend before Service adopts it), but no rows are appended until wiring completes, so no shed can precede the swap — readers null-check

    # -- DataStore surface -------------------------------------------------

    def persist_requests(self, batch: np.ndarray) -> None:
        rows = request_rows_to_payload(batch, self.interner)
        self._append("requests", rows)

    def persist_kafka_events(self, batch: np.ndarray) -> None:
        """KafkaEventInfo[16] arity (payload.go:163-180): StartTime, Latency,
        SrcIP, SrcType, SrcID, SrcPort, DstIP, DstType, DstID, DstPort,
        Topic, Partition, Key, Value, Type, Tls."""
        lookup = self.interner.lookup
        rows = [
            [
                int(r["start_time_ms"]), int(r["latency_ns"]),
                u32_to_ip(int(r["from_ip"])) if r["from_ip"] else "",
                _EP_NAMES[int(r["from_type"])], lookup(int(r["from_uid"])),
                int(r["from_port"]),
                u32_to_ip(int(r["to_ip"])) if r["to_ip"] else "",
                _EP_NAMES[int(r["to_type"])], lookup(int(r["to_uid"])),
                int(r["to_port"]),
                lookup(int(r["topic"])), int(r["partition"]),
                lookup(int(r["key"])), lookup(int(r["value"])),
                "PUBLISH" if int(r["type"]) == 1 else "CONSUME", bool(r["tls"]),
            ]
            for r in batch
        ]
        self._append("kafka", rows)

    def persist_alive_connections(self, batch: np.ndarray) -> None:
        """ConnInfo[9] arity (payload.go:137-150): CheckTime, SrcIP, SrcType,
        SrcID, SrcPort, DstIP, DstType, DstID, DstPort."""
        lookup = self.interner.lookup
        rows = [
            [
                int(r["check_time_ms"]),
                u32_to_ip(int(r["from_ip"])) if r["from_ip"] else "",
                _EP_NAMES[int(r["from_type"])], lookup(int(r["from_uid"])),
                int(r["from_port"]),
                u32_to_ip(int(r["to_ip"])) if r["to_ip"] else "",
                _EP_NAMES[int(r["to_type"])], lookup(int(r["to_uid"])),
                int(r["to_port"]),
            ]
            for r in batch
        ]
        self._append("connections", rows)

    def persist_scores(self, records) -> None:
        """Anomaly-score edge annotations → /anomalies/ (the BASELINE.json
        return leg: scores flow back through the dto path) with the
        fixed-arity row discipline of backend.go:819-877. Accepts a
        runtime.ScoreBatch (whose iteration resolves uid strings once per
        unique node using the batch's own interner) or any iterable of
        ScoreRecord-shaped objects."""
        rows = [
            [r.window_start_ms, r.from_uid, r.to_uid, r.protocol, r.score]
            for r in records
        ]
        self._append("anomalies", rows)

    def persist_resource(self, rtype: ResourceType, event: EventType, obj: Any) -> None:
        stream = self._resource_streams[rtype]
        body = dict(obj.__dict__) if hasattr(obj, "__dict__") else obj
        with self._lock:
            stream.pending.append({"event": event.value, "body": _jsonable(body)})

    # -- batching ----------------------------------------------------------

    def _append(self, name: str, rows: List[Any]) -> None:
        stream = self._streams[name]
        with self._lock:
            stream.pending.extend(rows)

    def attach_metrics(self, render_fn: Callable[[], str]) -> None:
        """Register the metrics source for the scrape-and-push leg — the
        reference scrapes its embedded exporters and POSTs the Prometheus
        text to /metrics/scrape/ on a ticker (backend.go:355-392,503-530)."""
        self._metrics_render = render_fn

    def _push_metrics(self) -> None:
        endpoint = (
            f"{EP_METRICS}?instance={self.cfg.node_id}"
            f"&monitoring_id={self.cfg.monitoring_id}"
        )
        try:
            text = self._metrics_render()
            status = self.transport(endpoint, {"text": text})
        except Exception as exc:
            log.warning(f"metrics push failed: {exc}")
            return
        if status < 400:
            with self._lock:
                self.metrics_pushed += 1
        else:
            log.warning(f"metrics push not success: {status}")

    def pump(self, force: bool = False) -> None:
        """Flush every stream that hit its batch size or cadence; push the
        metrics scrape when its interval elapses. Concurrency-safe
        against itself: the pump thread and a caller's ``stop(flush=True)``
        / manual pump both run this, so ALL accounting happens under
        ``self._lock`` (alazrace ALZ050/051: the cadence stamp and the
        sent/failed tallies used to race exactly that overlap)."""
        now = self.time_fn()
        push_due = False
        if self._metrics_render is not None and self.cfg.metrics_export:
            with self._lock:
                push_due = (
                    force
                    or now - self._metrics_last_push
                    >= self.cfg.metrics_export_interval_s
                )
                if push_due:
                    # stamp INSIDE the lock: two racing pumps must not
                    # both see "due" and double-push the scrape
                    self._metrics_last_push = now
        if push_due:
            self._push_metrics()
        for stream in list(self._streams.values()) + list(self._resource_streams.values()):
            with self._lock:
                due = (
                    force
                    or len(stream.pending) >= stream.batch_size
                    or (stream.pending and now - stream.last_flush >= stream.interval_s)
                )
                if not due or not stream.pending:
                    if due:
                        stream.last_flush = now
                    continue
                todo = stream.pending
                stream.pending = []
                stream.last_flush = now
            # send outside the lock, chunked to batch_size
            for i in range(0, len(todo), stream.batch_size):
                chunk = todo[i : i + stream.batch_size]
                outcome = self._send(stream.endpoint, chunk)
                with self._lock:
                    if outcome == "sent":
                        stream.sent += len(chunk)
                    elif outcome == "shed":
                        stream.shed += len(chunk)
                    else:
                        stream.failed += len(chunk)
                if outcome == "shed" and self.ledger is not None:
                    # outside the backend lock: the ledger has its own
                    self.ledger.add(
                        "shed", len(chunk), reason="breaker_open"
                    )

    def _send(self, endpoint: str, rows: List[Any]) -> str:
        """One chunk's delivery fate: ``"sent"`` | ``"failed"`` (retry
        ladder exhausted, or non-retryable 4xx) | ``"shed"`` (open
        breaker short-circuit — attributed to the drop ledger by the
        caller)."""
        if not self.breaker.allow():
            # circuit open: shed without touching the wire — one counter
            # bump + a ledger attribution instead of a retry ladder
            return "shed"
        payload = {
            "metadata": {
                "monitoring_id": self.cfg.monitoring_id,
                "idempotency_key": str(uuid.uuid4()),
                "node_id": self.cfg.node_id,
                "alaz_version": __version__,
            },
            "data": rows,
        }
        backoff = self.cfg.backoff_min_s
        for attempt in range(self.cfg.max_retries + 1):
            try:
                status = self.transport(endpoint, payload)
            except Exception as exc:  # transport failure == retryable
                log.warning(f"transport error on {endpoint}: {exc}")
                status = 599
            if status < 400:
                self.breaker.record(True)
                return "sent"
            if status not in (400, 429) and status < 500:
                # non-retryable 4xx: drop loudly (once per endpoint) so a
                # backend without this endpoint doesn't silently eat data.
                # The backend ANSWERED — availability-wise that's a
                # success, so the breaker doesn't count it.
                with self._lock:  # warn-once latch is check-then-act
                    first_drop = endpoint not in self._warned_endpoints
                    if first_drop:
                        self._warned_endpoints.add(endpoint)
                if first_drop:
                    log.warning(
                        f"dropping batch for {endpoint}: non-retryable HTTP {status}"
                    )
                self.breaker.record(True)
                return "failed"
            if attempt < self.cfg.max_retries:
                # exponential backoff with FULL jitter (not a fixed 0.1s
                # additive fuzz): N agents retrying a recovered backend
                # spread over the whole window instead of stampeding at
                # backoff-aligned instants
                self.sleep_fn(
                    random.uniform(0, min(backoff, self.cfg.backoff_max_s))
                )
                backoff *= 2
        self.breaker.record(False)
        return "failed"

    # -- lifecycle ---------------------------------------------------------

    def start(self, poll_interval_s: float = 0.5) -> None:
        """Daemon flusher thread (sendReqsInBatch-style tickers)."""
        if self._thread is not None:
            return
        self._stop.clear()

        def run() -> None:
            while not self._stop.is_set():
                self.pump()
                self._stop.wait(poll_interval_s)

        self._thread = threading.Thread(target=run, name="alaz-backend-pump", daemon=True)
        self._thread.start()

    def stop(self, flush: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if flush:
            self.pump(force=True)

    def stats(self) -> dict:
        out = {}
        with self._lock:
            for s in list(self._streams.values()) + list(self._resource_streams.values()):
                out[s.name] = {
                    "pending": len(s.pending),
                    "sent": s.sent,
                    "failed": s.failed,
                    "shed": s.shed,
                }
        out["breaker"] = {
            "state": self.breaker.state,
            "opens": self.breaker.opens,
            "shorted": self.breaker.shorted,
        }
        return out


def _jsonable(obj: Any) -> Any:
    try:
        json.dumps(obj)
        return obj
    except (TypeError, ValueError):
        return json.loads(json.dumps(obj, default=lambda o: getattr(o, "__dict__", str(o))))
