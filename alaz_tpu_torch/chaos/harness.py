"""The chaos suite: drive the REAL pipeline through all four fault
seams and check invariants, not vibes.

Three legs, each wrapping production code with an injector from
``chaos.injectors`` (nothing under test is mocked):

1. **pipeline** — ``ShardedIngest`` fed a perturbed delivery (duplicated
   / reordered / late batches) with crash+stall injection on the worker
   threads and bounded-block shedding on the scatter. Gates:
   - *bounded*: ``flush``/``drain`` return within their timeouts with
     workers killed mid-run (the supervisor restarts them);
   - *conservation*: delivered rows == emitted rows + drop-ledger total
     — EXACT (semantic aggregator drops ride the ledger's ``filtered``
     cause since ISSUE 8, and must equal the stats counters);
   - *monotonic*: emitted windows strictly ascend; duplicate delivery
     never re-emits a window;
   - *self-healing*: injected crashes imply observed restarts.
2. **frames** — a real ``IngestServer`` on a loopback socket fed
   chaos-mutated wire frames over ONE connection. Gates: the connection
   survives corruption (resync), every clean frame's rows arrive, and
   accepted == sent − destroyed (exact when truncation is off — the
   default — because only header/count corruption is then in play and
   neither can eat a neighboring frame).
3. **backend** — a ``BatchingBackend`` over a ``FlakyTransport``
   (5xx + timeouts) on a fake clock. Gates: every appended row settles
   as sent or failed (no row stuck or double-counted), the breaker
   opens under sustained failure, and it closes again after ``heal()``.

``run_chaos_suite`` returns a :class:`ChaosReport`; ``findings`` empty
means every gate held. ``python -m alaz_tpu.chaos`` (= ``make chaos``)
sweeps fixed seeds and exits nonzero on any finding; ``bench.py
--ingest`` runs a short suite every round and reports
``chaos_findings`` (expected 0) next to ``ingest_rows_per_sec``.
"""

from __future__ import annotations

import dataclasses
import socket
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from alaz_tpu_torch.aggregator.cluster import ClusterInfo
from alaz_tpu_torch.aggregator.sharded import ShardedIngest
from alaz_tpu_torch.chaos.injectors import (
    BatchChaos,
    FlakyTransport,
    FrameChaos,
    WorkerChaos,
    WorkerCrash,
)
from alaz_tpu_torch.config import BackendConfig, ChaosConfig
from alaz_tpu_torch.events.intern import Interner
from alaz_tpu_torch.logging import get_logger
from alaz_tpu_torch.obs.device import batch_pad_waste_pct
from alaz_tpu_torch.obs.recorder import FlightRecorder
from alaz_tpu_torch.replay.synth import make_ingest_trace
from alaz_tpu_torch.utils.ledger import DropLedger

log = get_logger("alaz_tpu.chaos")


@dataclass
class ChaosReport:
    seed: int
    n_workers: int
    findings: List[str] = field(default_factory=list)
    pipeline: dict = field(default_factory=dict)
    frames: dict = field(default_factory=dict)
    backend: dict = field(default_factory=dict)
    # flight-recorder trail: attached by run_chaos_suite when
    # any gate failed — the last-N structured events (chaos injections,
    # worker crashes/restarts, ledger decisions, window spans) so the
    # failure replays as a story instead of a bare assertion
    recorder_dump: Optional[dict] = None

    @property
    def ok(self) -> bool:
        return not self.findings

    def as_dict(self) -> dict:
        out = {
            "seed": self.seed,
            "n_workers": self.n_workers,
            "chaos_findings": len(self.findings),
            "findings": self.findings,
            "pipeline": self.pipeline,
            "frames": self.frames,
            "backend": self.backend,
        }
        if self.recorder_dump is not None:
            out["recorder_dump"] = self.recorder_dump
        return out


def emitted_rows(batches) -> int:
    """Rows aggregated into emitted GraphBatches — the shared
    ``GraphBatch.aggregated_rows`` inverse-log1p measure, summed (the
    sanitize suite's accounting trick)."""
    return sum(b.aggregated_rows() for b in batches)


def _run_pipeline_leg(
    cfg: ChaosConfig,
    n_workers: int,
    n_rows: int,
    n_windows: int,
    findings: List[str],
    recorder: Optional[FlightRecorder] = None,
    backend: str = "thread",
) -> dict:
    ev, msgs = make_ingest_trace(
        n_rows, pods=60, svcs=10, windows=n_windows, seed=cfg.seed
    )
    interner = Interner()
    ledger = DropLedger()
    closed: List = []
    wchaos = WorkerChaos(
        seed=cfg.seed,
        crash_prob=cfg.worker_crash_prob,
        stall_prob=cfg.worker_stall_prob,
        stall_s=cfg.worker_stall_s,
        max_crashes=cfg.worker_max_crashes,
        ensure_crash=True,  # ≥1 mid-wave kill per run, never vacuous
    )
    bchaos = BatchChaos(
        seed=cfg.seed + 1,
        dup_prob=cfg.batch_dup_prob,
        reorder_prob=cfg.batch_reorder_prob,
        late_prob=cfg.batch_late_prob,
        min_each=True,  # every enabled delivery fault fires ≥ once
    )
    chunk = max(2048, n_rows // 32)
    chunks = [ev[i : i + chunk] for i in range(0, n_rows, chunk)]
    delivery, late = bchaos.perturb(chunks)
    fault_hook = wchaos
    if recorder is not None:
        # delivery-seam injections land in the trail once, as a summary
        recorder.record(
            "chaos_inject", seam="batch",
            duplicated=bchaos.duplicated, reordered=bchaos.reordered,
            late=bchaos.delayed,
        )

        def fault_hook(i: int, kind: str) -> None:
            # worker-seam injections: record only when the injector
            # actually fired ON THIS CALL (the hook runs at every item
            # boundary). Attribution comes from the raise/return, never
            # from diffing wchaos's shared totals — concurrent workers
            # racing between a peer's read and its increment would
            # record phantom/duplicate injections
            try:
                effect = wchaos(i, kind)
            except WorkerCrash:
                recorder.record(
                    "chaos_inject", seam="worker", worker=i,
                    item_kind=kind, effect="crash",
                )
                raise
            if effect is not None:
                recorder.record(
                    "chaos_inject", seam="worker", worker=i,
                    item_kind=kind, effect=effect,
                )

    if backend == "process":
        # process-mode pipeline (ISSUE 15): SAME seams, SAME gates. The
        # worker seam's WorkerCrash verdicts become SIGKILLs of real
        # shard processes mid-wave — conservation must hold through a
        # kill that freezes the worker's books mid-flight. Topology goes
        # through process_k8s (the ring broadcast): a pre-folded shared
        # ClusterInfo cannot cross the spawn boundary.
        from alaz_tpu_torch.shm.process_pool import ProcessShardedIngest

        pipe = ProcessShardedIngest(
            n_workers,
            interner=interner,
            window_s=1.0,
            on_batch=closed.append,
            ledger=ledger,
            fault_hook=fault_hook,
            shed_block_s=0.5,
            recorder=recorder,
        )
        for m in msgs:
            pipe.process_k8s(m)
    else:
        cluster = ClusterInfo(interner)
        for m in msgs:
            cluster.handle_msg(m)
        pipe = ShardedIngest(
            n_workers,
            interner=interner,
            cluster=cluster,
            window_s=1.0,
            on_batch=closed.append,
            ledger=ledger,
            fault_hook=fault_hook,
            shed_block_s=0.5,
            recorder=recorder,
        )
    t0 = time.perf_counter()
    try:
        for c in delivery:
            pipe.process_l7(c, now_ns=10_000_000_000)
        tf = time.perf_counter()
        if not pipe.flush(timeout_s=30.0):
            findings.append("pipeline: flush #1 did not complete in 30s")
        flush_wall = time.perf_counter() - tf
        if flush_wall > 35.0:
            findings.append(
                f"pipeline: flush #1 overran its timeout ({flush_wall:.1f}s)"
            )
        # partial agent outage replay: the held-back batches arrive after
        # the horizon sealed — every row must drop as LATE, none vanish
        for c in late:
            pipe.process_l7(c, now_ns=10_000_000_000)
        if not pipe.flush(timeout_s=30.0):
            findings.append("pipeline: flush #2 did not complete in 30s")
        td = time.perf_counter()
        if not pipe.drain(timeout_s=10.0):
            findings.append("pipeline: drain did not settle in 10s")
        drain_wall = time.perf_counter() - td
        if drain_wall > 12.0:
            findings.append(
                f"pipeline: drain overran its timeout ({drain_wall:.1f}s)"
            )
        wall = time.perf_counter() - t0
    finally:
        pipe.stop()

    delivered = int(sum(c.shape[0] for c in delivery)) + int(
        sum(c.shape[0] for c in late)
    )
    emitted = emitted_rows(closed)
    stats = pipe.stats.as_dict()
    # semantic drops are ledgered as `filtered` now: the gate
    # is exactly delivered == emitted + ledger.total, and the stats
    # counters must agree with the ledgered cause (both gates below)
    semantic = (
        stats["l7_dropped_no_socket"]
        + stats["l7_dropped_not_pod"]
        + stats["l7_rate_limited"]
    )
    gap = ledger.conservation_gap(delivered, emitted)
    if gap != 0:
        findings.append(
            f"pipeline: row conservation broken — delivered={delivered} "
            f"emitted={emitted} semantic={semantic} "
            f"ledger={ledger.snapshot()} gap={gap}"
        )
    if ledger.count("filtered") != semantic:
        findings.append(
            f"pipeline: filtered-ledger drift — stats say {semantic} "
            f"semantic drops, ledger says {ledger.count('filtered')}"
        )
    starts = [b.window_start_ms for b in closed]
    if any(b <= a for a, b in zip(starts, starts[1:])):
        findings.append(
            "pipeline: window emission not strictly ascending "
            f"(duplicate or reordered emit): {starts}"
        )
    if wchaos.crashes > 0 and pipe.worker_restarts == 0:
        findings.append(
            f"pipeline: {wchaos.crashes} crashes injected but no worker restart observed"
        )
    if late and ledger.count("late") == 0:
        findings.append(
            "pipeline: late delivery injected but nothing ledgered as late"
        )
    return {
        "backend": backend,
        "delivered_rows": delivered,
        "emitted_rows": emitted,
        "windows": len(closed),
        "rows_per_sec": round(delivered / wall) if wall > 0 else 0,
        "flush_wall_s": round(flush_wall, 3),
        # bucket-padding waste over the degraded run: chaos
        # fragments windows (dup/reorder/late redelivery), which shows
        # up here as occupancy loss — the number rides the report so a
        # defense that "passes" by emitting near-empty buckets is visible
        "pad_waste_pct": round(batch_pad_waste_pct(closed), 2),
        "ledger": ledger.snapshot(),
        "worker_restarts": pipe.worker_restarts,
        "crashes": wchaos.crashes,
        "stalls": wchaos.stalls,
        "duplicated_batches": bchaos.duplicated,
        "reordered_batches": bchaos.reordered,
        "late_batches": bchaos.delayed,
    }


class _CountingSink:
    """Minimal service duck-type for the frame leg: counts submitted
    rows; no pipeline behind it (the pipeline leg covers that)."""

    graph_store = None
    metrics = None

    def __init__(self, ledger: DropLedger):
        self.ledger = ledger
        self.rows = 0

    def submit_l7(self, batch, tenant: int = 0) -> bool:
        self.rows += int(batch.shape[0])
        return True

    def submit_tcp(self, batch, tenant: int = 0) -> bool:
        return True

    def submit_proc(self, batch, tenant: int = 0) -> bool:
        return True


def _run_frame_leg(
    cfg: ChaosConfig,
    findings: List[str],
    recorder: Optional[FlightRecorder] = None,
) -> dict:
    from alaz_tpu_torch.sources.ingest_server import KIND_L7, IngestServer, pack_frame

    n_frames, rows_per_frame = 48, 256
    ev, _ = make_ingest_trace(
        n_frames * rows_per_frame, pods=20, svcs=4, windows=2, seed=cfg.seed
    )
    fchaos = FrameChaos(
        seed=cfg.seed + 2,
        corrupt_prob=cfg.frame_corrupt_prob,
        truncate_prob=cfg.frame_truncate_prob,
        garble_prob=cfg.frame_garble_prob,
        min_each=True,
        expect_frames=n_frames,
    )
    ledger = DropLedger()
    # quarantine decisions land in the suite ring (the ledger hook):
    # a failing frame gate ships the per-frame drop trail with it
    ledger.recorder = recorder
    sink = _CountingSink(ledger)
    server = IngestServer(sink, port=0)
    server.start()
    try:
        wire = b"".join(
            fchaos.perturb(
                pack_frame(KIND_L7, ev[k * rows_per_frame : (k + 1) * rows_per_frame]),
                rows_per_frame,
            )
            for k in range(n_frames)
        )
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.connect(server.address)
        try:
            s.sendall(wire)
        finally:
            s.close()
        # one connection carried everything; wait for the serve thread to
        # drain it (EOF after the last byte)
        deadline = time.monotonic() + 10.0
        sent_rows = n_frames * rows_per_frame
        expect = sent_rows - fchaos.destroyed_rows
        while time.monotonic() < deadline and sink.rows < expect:
            time.sleep(0.02)
    finally:
        server.stop()

    mutated = fchaos.corrupted + fchaos.garbled + fchaos.truncated
    if fchaos.truncate_prob == 0.0:
        # exact contract: header/count corruption destroys only its own
        # frame — every clean frame survives the resyncs around it
        if sink.rows != expect:
            findings.append(
                f"frames: accepted {sink.rows} rows, expected {expect} "
                f"(sent {sent_rows}, destroyed {fchaos.destroyed_rows})"
            )
    elif sink.rows > expect:
        findings.append(
            f"frames: accepted {sink.rows} rows > conservable {expect}"
        )
    if mutated and server.quarantined_frames == 0:
        findings.append(
            f"frames: {mutated} frames mutated but none quarantined"
        )
    if fchaos.corrupted and server.resyncs == 0:
        findings.append(
            f"frames: {fchaos.corrupted} headers corrupted but no resync ran"
        )
    return {
        "frames_sent": n_frames,
        "rows_sent": sent_rows,
        "rows_accepted": sink.rows,
        "destroyed_rows": fchaos.destroyed_rows,
        "corrupted": fchaos.corrupted,
        "garbled": fchaos.garbled,
        "truncated": fchaos.truncated,
        "quarantined_frames": server.quarantined_frames,
        "resyncs": server.resyncs,
        "resync_bytes": server.resync_bytes,
        "ledger": ledger.snapshot(),
    }


def _run_backend_leg(
    cfg: ChaosConfig,
    findings: List[str],
    recorder: Optional[FlightRecorder] = None,
) -> dict:
    from alaz_tpu_torch.datastore.backend import BatchingBackend
    from alaz_tpu_torch.datastore.dto import make_requests

    clock = [0.0]

    def time_fn() -> float:
        return clock[0]

    def sleep_fn(s: float) -> None:
        clock[0] += s

    calls = [0]

    def ok_transport(endpoint, payload) -> int:
        calls[0] += 1
        return 200

    flaky = FlakyTransport(
        ok_transport,
        seed=cfg.seed + 3,
        error_prob=cfg.backend_error_prob,
        timeout_prob=cfg.backend_timeout_prob,
    )
    ledger = DropLedger()
    be = BatchingBackend(
        flaky,
        Interner(),
        BackendConfig(
            batch_size=40,
            max_retries=1,
            backoff_min_s=0.05,
            backoff_max_s=0.2,
            breaker_threshold=3,
            breaker_cooldown_s=5.0,
        ),
        time_fn=time_fn,
        sleep_fn=sleep_fn,
        ledger=ledger,
    )
    # breaker open/close flips land in the suite ring, so a failing
    # backend gate replays WHEN the export leg went dark
    be.breaker.recorder = recorder
    appended = 0
    # phase 1 — DEGRADED: cfg-intensity flapping (some sends fail, some
    # land; the breaker may or may not trip — either is legal here)
    for _ in range(6):
        be.persist_requests(make_requests(40))
        appended += 40
        be.pump(force=True)
        sleep_fn(0.5)
    # phase 2 — OUTAGE: the backend goes fully dark; the breaker MUST
    # open within threshold sends and then short the rest (the failure
    # cost becomes a counter bump, not retries×backoff per batch)
    flaky.error_prob, flaky.timeout_prob = 1.0, 0.0
    for _ in range(6):
        be.persist_requests(make_requests(40))
        appended += 40
        be.pump(force=True)
        sleep_fn(0.5)
    if be.breaker.opens == 0:
        findings.append("backend: full outage never opened the circuit breaker")
    if be.breaker.shorted == 0:
        findings.append("backend: open breaker never short-circuited a send")
    # phase 3 — RECOVERY: faults off, cooldown elapses; the half-open
    # probe must close the circuit and deliveries must resume
    flaky.heal()
    sleep_fn(6.0)
    be.persist_requests(make_requests(40))
    appended += 40
    be.pump(force=True)
    st = be.stats()
    req = st["requests"]
    # EXACT conservation through the export leg (ISSUE 12 satellite):
    # every appended row is sent, still pending, failed on the wire, or
    # shed by the open breaker — and every shed row is attributed to the
    # drop ledger's closed `shed` cause, exactly once. The old gate let
    # breaker sheds hide inside `stream.failed`; now the ledger is the
    # bookkeeper the rest of the pipeline already answers to.
    settled = req["sent"] + req["failed"] + req["shed"]
    if settled + req["pending"] != appended:
        findings.append(
            f"backend: rows unaccounted — appended={appended} "
            f"sent={req['sent']} failed={req['failed']} "
            f"shed={req['shed']} pending={req['pending']}"
        )
    shed_ledgered = ledger.count("shed")
    if shed_ledgered != req["shed"]:
        findings.append(
            f"backend: ledger drift — stream shed {req['shed']} rows but "
            f"the ledger holds {shed_ledgered} under `shed` (every "
            "breaker short must attribute exactly once)"
        )
    if be.breaker.state != "closed":
        findings.append(
            f"backend: breaker stuck {be.breaker.state} after recovery"
        )
    return {
        "appended_rows": appended,
        "sent": req["sent"],
        "failed": req["failed"],
        "shed": req["shed"],
        "ledger_shed": shed_ledgered,
        "breaker_opens": be.breaker.opens,
        "breaker_shorted": be.breaker.shorted,
        "breaker_state": be.breaker.state,
        "transport_errors": flaky.errors,
        "transport_timeouts": flaky.timeouts,
    }


def run_chaos_suite(
    cfg: Optional[ChaosConfig] = None,
    *,
    seed: Optional[int] = None,
    n_workers: int = 2,
    n_rows: int = 48_000,
    n_windows: int = 5,
    legs: tuple = ("pipeline", "frames", "backend"),
    ingest_backend: str = "thread",
) -> ChaosReport:
    """One full chaos run at ``cfg`` intensity (default intensities with
    ``seed`` when only a seed is given). Deterministic per (cfg, seed)
    up to thread interleaving; the GATES hold for every interleaving.

    ``cfg.enabled`` is honored: a disabled config zeroes every
    intensity, so the same gates run over a CLEAN pipeline — conservation
    with an all-zero ledger (what the no-chaos bench ride-along checks)."""
    if cfg is None:
        cfg = ChaosConfig(enabled=True, seed=seed if seed is not None else 0)
    elif seed is not None:
        # never mutate the caller's config object (it may be the live
        # service's config.chaos, whose seed a soak consumer reads later)
        cfg = dataclasses.replace(cfg, seed=seed)
    if not cfg.enabled:
        cfg = ChaosConfig(
            seed=cfg.seed,
            frame_corrupt_prob=0.0, frame_truncate_prob=0.0,
            frame_garble_prob=0.0,
            batch_dup_prob=0.0, batch_reorder_prob=0.0, batch_late_prob=0.0,
            worker_crash_prob=0.0, worker_stall_prob=0.0,
            backend_error_prob=0.0, backend_timeout_prob=0.0,
        )
    report = ChaosReport(seed=cfg.seed, n_workers=n_workers)
    # the suite's flight recorder: chaos injections, worker
    # crashes/restarts, ledger decisions and window spans all land in
    # one ring; a failing gate ships the trail WITH the report
    recorder = FlightRecorder(capacity=1024)
    if "pipeline" in legs:
        report.pipeline = _run_pipeline_leg(
            cfg, n_workers, n_rows, n_windows, report.findings,
            recorder=recorder, backend=ingest_backend,
        )
    if "frames" in legs:
        report.frames = _run_frame_leg(cfg, report.findings, recorder=recorder)
    if "backend" in legs:
        report.backend = _run_backend_leg(cfg, report.findings, recorder=recorder)
    if report.findings:
        report.recorder_dump = recorder.dump()
        log.warning(
            "chaos gates failed — flight recorder trail: "
            f"{recorder.tail_summary(last=64)}"
        )
    for f in report.findings:
        log.warning(f"chaos finding: {f}")
    return report
