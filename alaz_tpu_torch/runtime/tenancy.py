"""Per-tenant host-plane partitions (ISSUE 14 tentpole).

The production shape of "heavy traffic from millions of users" is
hundreds of agent fleets multiplexed onto ONE scoring backend. The unit
of isolation is the :class:`TenantPartition`: everything a tenant's rows
touch between the ingest socket and the shared window queue —

- an **Interner namespace** of its own (tenant A's pod uids can never
  collide with, or leak into, tenant B's node table),
- a **DropLedger** of its own, so ``pushed == emitted + ledger.total``
  is a PER-TENANT conservation invariant (the isolation gate's exact
  equation; one shared ledger would let tenant A's sheds hide tenant
  B's losses),
- its own bounded **source queues** (l7/tcp/proc/k8s) — one tenant's
  backlog fills its own queues and sheds its own rows; it cannot
  head-of-line block another fleet's stream,
- its own **windowed pipeline** with private watermarks: the serial
  ``Aggregator`` + ``WindowedGraphStore`` pair, or a full
  ``ShardedIngest`` pool per tenant when ``ingest_workers > 1`` — a
  malformed stream or hot key perturbs only its own windows,
- its own **SpanTracer**: spans are keyed by window_start_ms, and two
  tenants legitimately close the same wall-clock window — per-tenant
  tracers keep their lifecycles apart while the stage histograms merge
  into the one fleet-wide ``latency.*`` ladder.

What partitions do NOT own is the device plane: every partition's
``on_batch`` feeds the service's ONE window queue, where the scorer's
micro-batch group path packs same-bucket close waves from many tenants
into the shared bucketed staging arenas (continuous cross-tenant
batching — the device never waits on any single tenant's window
cadence). Tenant attribution rides the emitted batch (``batch.tenant``)
so score sketches, drift state and top-K attribution stay per-tenant
downstream.

``tenants == 1`` constructs exactly the objects the pre-tenancy Service
constructed, wired identically — the K=1 parity contract
(tests/test_tenancy.py proves bit-identical windows against the raw
pipelines).
"""

from __future__ import annotations

from typing import Callable, List, Optional

from alaz_tpu_torch.config import RuntimeConfig
from alaz_tpu_torch.events.intern import Interner
from alaz_tpu_torch.graph.builder import WindowedGraphStore
from alaz_tpu_torch.graph.snapshot import GraphBatch
from alaz_tpu_torch.logging import get_logger
from alaz_tpu_torch.obs.recorder import FlightRecorder
from alaz_tpu_torch.obs.spans import SpanTracer
from alaz_tpu_torch.utils.ledger import DropLedger
from alaz_tpu_torch.utils.queues import BatchQueue

log = get_logger("alaz_tpu.tenancy")


class TenantPartition:
    """One tenant's host plane: interner namespace, drop ledger, source
    queues, aggregation pipeline and watermarks (module docstring).

    Construction mirrors the pre-tenancy Service wiring exactly when the
    caller passes its own interner/ledger/tracer (partition 0 does);
    later partitions get fresh namespaces. ``on_batch`` is the service's
    window enqueue, already bound to this partition's tenant id.
    """

    def __init__(
        self,
        tenant: int,
        config: RuntimeConfig,
        *,
        on_batch: Callable[[GraphBatch], None],
        interner: Optional[Interner] = None,
        ledger: Optional[DropLedger] = None,
        tracer: Optional[SpanTracer] = None,
        recorder: Optional[FlightRecorder] = None,
        export_backend=None,
        use_native_ingest: bool = False,
        scoring: bool = False,
        metrics=None,
    ):
        self.tenant = int(tenant)
        self.config = config
        self.interner = interner if interner is not None else Interner()
        self.ledger = ledger if ledger is not None else DropLedger()
        if recorder is not None and self.ledger.recorder is None:
            self.ledger.recorder = recorder
        self.recorder = recorder
        if tracer is None:
            # fresh per-tenant span plane: stage histograms merge into
            # the shared fleet ladder via the metrics registry; the
            # live-span maps stay apart (window ids collide across
            # tenants by design — same wall clock, different fleets)
            tcfg = getattr(config, "trace", None)
            tracer = SpanTracer(
                metrics=metrics,
                recorder=recorder,
                enabled=tcfg.enabled if tcfg is not None else True,
                max_live=tcfg.max_live if tcfg is not None else 4096,
                complete_at_emit=not scoring,
            )
        self.tracer = tracer

        suffix = f"-t{self.tenant}" if self.tenant else ""
        q = config.queues
        self.l7_queue = BatchQueue(q.l7_events, f"l7{suffix}", ledger=self.ledger)
        self.tcp_queue = BatchQueue(q.tcp_events, f"tcp{suffix}", ledger=self.ledger)
        self.proc_queue = BatchQueue(
            q.proc_events, f"proc{suffix}", ledger=self.ledger
        )
        # the k8s queue is CONTROL plane, not row plane: a dropped
        # resource message is not a lost data row, and ledgering it
        # would break the per-tenant conservation equation (pushed ==
        # emitted + ledger.total counts L7 rows) with phantom entries —
        # the queue's own dropped gauge keeps the loss visible
        self.k8s_queue = BatchQueue(q.kube_events, f"k8s{suffix}")

        renumber = getattr(config, "renumber_nodes", False)
        ingest_workers = max(1, int(getattr(config, "ingest_workers", 1)))
        ingest_backend = str(
            getattr(config, "ingest_backend", "thread") or "thread"
        ).lower()
        if ingest_backend not in ("thread", "process"):
            raise ValueError(
                f"ingest_backend must be 'thread' or 'process', got "
                f"{ingest_backend!r} (INGEST_BACKEND)"
            )
        degree_cap = max(0, int(getattr(config, "degree_cap", 0)))
        sample_seed = int(getattr(config, "sample_seed", 0))

        self.graph_store = None
        self.sharded = None
        self.fault_hook = None
        if use_native_ingest:
            from alaz_tpu_torch.graph import native as native_mod

            if native_mod.available():
                if ingest_workers > 1:
                    log.warning(
                        "ingest_workers > 1 ignored with use_native_ingest: "
                        "the C++ window accumulator is its own ingest plane"
                    )
                # degree_cap rides the C++ close pass itself now
                # (alz_close_window_feats selects bottom-k priorities per
                # hot dst, bit-identical to degree_cap_select) — cut rows
                # land in the shared ledger under sampled/degree_cap, same
                # as the GraphBuilder paths
                self.graph_store = native_mod.NativeWindowedStore(
                    window_s=config.window_s,
                    on_batch=on_batch,
                    renumber=renumber,
                    degree_cap=degree_cap,
                    sample_seed=sample_seed,
                    ledger=self.ledger,
                )
            else:
                log.warning(
                    "native ingest requested but library unavailable; "
                    "using numpy store"
                )
        if self.graph_store is None and (
            ingest_workers > 1 or ingest_backend == "process"
        ):
            # sharded multi-worker ingest: the pipeline IS both the
            # aggregator (ingestion surface) and the windowed store —
            # one object plays both roles. Each tenant gets its OWN
            # pool: shard workers, queues/rings and close waves are
            # never shared across fleets. Backend per config:
            # "thread" = aggregator/sharded.py over the
            # shared interner; "process" = alaz_tpu/shm spawn workers
            # over shared-memory rings with id-exchange at merge (the
            # out-of-GIL path; applies even at ingest_workers == 1 so
            # ingest leaves the serving process's GIL).
            from alaz_tpu_torch.aggregator.sharded import ShardedIngest

            # soak mode (CHAOS_ENABLED=1): per-partition injector so
            # every tenant's pool proves its self-healing independently
            # (tenant-offset seed: partitions draw independent streams)
            ccfg = getattr(config, "chaos", None)
            if ccfg is not None and ccfg.enabled:
                from alaz_tpu_torch.chaos.injectors import WorkerChaos

                self.fault_hook = WorkerChaos(
                    seed=ccfg.seed + self.tenant,
                    crash_prob=ccfg.worker_crash_prob,
                    stall_prob=ccfg.worker_stall_prob,
                    stall_s=ccfg.worker_stall_s,
                    max_crashes=ccfg.worker_max_crashes,
                )
                log.warning(
                    "chaos soak enabled: worker-seam fault injection live"
                )
            if ingest_backend == "process":
                from alaz_tpu_torch.shm.process_pool import ProcessShardedIngest

                if export_backend is not None:
                    # worker REQUEST rows carry process-LOCAL interner
                    # ids — an export tee would resolve them against the
                    # wrong table and ship another fleet's names. Refuse
                    # loudly; the thread backend keeps the tee.
                    raise ValueError(
                        "ingest_backend=process cannot drive the export "
                        "backend tee (worker rows carry process-local "
                        "interner ids); use INGEST_BACKEND=thread with "
                        "the export backend, or export from scores"
                    )
                self.sharded = ProcessShardedIngest(
                    ingest_workers,
                    interner=self.interner,
                    config=config,
                    window_s=config.window_s,
                    on_batch=on_batch,
                    renumber=renumber,
                    ledger=self.ledger,
                    shed_block_s=config.shed_block_s,
                    fault_hook=self.fault_hook,
                    degree_cap=degree_cap,
                    sample_seed=sample_seed,
                    tracer=self.tracer,
                    recorder=recorder,
                )
            else:
                self.sharded = ShardedIngest(
                    ingest_workers,
                    interner=self.interner,
                    config=config,
                    window_s=config.window_s,
                    on_batch=on_batch,
                    renumber=renumber,
                    tee=export_backend,
                    ledger=self.ledger,
                    shed_block_s=config.shed_block_s,
                    fault_hook=self.fault_hook,
                    degree_cap=degree_cap,
                    sample_seed=sample_seed,
                    tracer=self.tracer,
                    recorder=recorder,
                )
            self.graph_store = self.sharded
        if self.graph_store is None:
            self.graph_store = WindowedGraphStore(
                self.interner,
                window_s=config.window_s,
                on_batch=on_batch,
                renumber=renumber,
                ledger=self.ledger,
                degree_cap=degree_cap,
                sample_seed=sample_seed,
                tracer=self.tracer,
            )
        if self.sharded is not None:
            self.datastore = None  # worker sinks fan out inside the pipeline
            self.aggregator = self.sharded
        else:
            from alaz_tpu_torch.aggregator.engine import Aggregator
            from alaz_tpu_torch.runtime.service import FanoutDataStore

            sinks: List = [self.graph_store]
            if export_backend is not None:
                sinks.append(export_backend)
            self.datastore = FanoutDataStore(sinks)
            self.aggregator = Aggregator(
                self.datastore,
                interner=self.interner,
                config=config,
                # semantic (filtered) drops join the tenant ledger so
                # per-tenant conservation needs no side-channel term
                ledger=self.ledger,
                recorder=recorder,
            )

        # windows this partition emitted (written only by the partition's
        # closing thread — the l7 worker for serial stores, the merge
        # thread for sharded pools)
        self.windows_closed = 0  # lockless-ok: single-writer counter (the partition's closing thread); racy reads are stats gauges
        # edges.out convergence baseline for the sharded path: each
        # partition's l7 worker syncs ITS delta into the fleet counter
        self.edges_out_synced = 0  # role-private: touched only by this partition's l7 worker thread
        # idle-flush bookkeeping (housekeeping thread only)
        self.idle_flushed_for: Optional[float] = None  # role-private: housekeeping thread only
        # per-tenant gauge registration latch: first-window, idempotent,
        # single-writer (the partition's closing thread)
        self._gauges_done = False  # lockless-ok: single-writer latch (closing thread); Metrics.gauge is itself idempotent under its own lock

    # -- observability --------------------------------------------------------

    @property
    def queues(self) -> tuple:
        return (self.l7_queue, self.tcp_queue, self.proc_queue, self.k8s_queue)

    def register_tenant_gauges(self, metrics) -> None:
        """Register this tenant's ``ledger.*.t<k>`` series — called at
        the tenant's FIRST window, never at wiring time, so an idle
        tenant is absent from the scrape instead of rendering zeros
        (the sparse-series discipline, ISSUE 11)."""
        if self._gauges_done or metrics is None:
            return
        self._gauges_done = True
        ledger = self.ledger
        t = self.tenant
        for cause in ledger.CAUSES:
            metrics.gauge(f"ledger.{cause}.t{t}", lambda c=cause: ledger.count(c))
        metrics.gauge(f"ledger.total.t{t}", lambda: ledger.total)
        metrics.gauge(
            f"ingest.windows_closed.t{t}", lambda: self.windows_closed
        )

    def snapshot(self) -> dict:
        """One tenant's /stats entry: queue lag, ledger breakdown,
        aggregator stats, window count."""
        out = {
            "queues": {q.name: q.stats() for q in self.queues},
            "ledger": self.ledger.snapshot(),
            "windows_closed": self.windows_closed,
            "aggregator": self.aggregator.stats.as_dict(),
            "interned_strings": len(self.interner),
        }
        if self.sharded is not None:
            out["worker_restarts"] = self.sharded.worker_restarts
            out["shard_backlog"] = self.sharded.unfinished
        return out

    # -- lifecycle ------------------------------------------------------------

    def stop(self) -> None:
        if self.sharded is not None:
            self.sharded.stop()


def validate_tenants(config: RuntimeConfig, model_state, use_native: bool) -> int:
    """Resolve and validate the partition count for a Service build.

    Raises on combinations that would silently corrupt a tenant's data:
    the C++ native ring is a single-tenant plane, and the temporal
    model's node memory is slot-indexed across windows — K fleets
    interleaving through one memory would cross-contaminate state."""
    from alaz_tpu_torch.events.schema import MAX_TENANTS

    tenants = max(1, int(getattr(config, "tenants", 1)))
    if tenants > MAX_TENANTS:
        raise ValueError(
            f"tenants={tenants} exceeds the wire header's MAX_TENANTS "
            f"({MAX_TENANTS}); the frame tenant id is one byte"
        )
    if tenants > 1 and use_native:
        raise ValueError(
            "use_native_ingest is incompatible with tenants > 1: the C++ "
            "window accumulator is a single-tenant plane"
        )
    if tenants > 1 and model_state is not None and config.model.model == "tgn":
        raise ValueError(
            "model=tgn is incompatible with tenants > 1: the temporal "
            "memory is slot-indexed across windows and would interleave "
            "tenants' node state; score each fleet on its own backend or "
            "pick a window-independent model"
        )
    return tenants
