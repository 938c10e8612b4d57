"""The streaming scoring service on the card: the JAX package's
``runtime/service.py``, with the device plane written for torch.

Pipeline (every arrow a bounded queue; drop-not-block at the source edge):

    sources → [l7 | tcp | proc | k8s queues] → aggregator workers
            → fanout datastore (graph store [+ export backend])
            → window queue → scorer thread (the model through the
              hand-written kernels) → score sink (edge annotations back
              through the dto path)

The host plane (queues, aggregator, window close, spans, score plane,
tenancy) is the JAX package's, copied. What differs is the device leg:

- a window reaches the card by an asynchronous copy from page-locked
  staging buffers (``runtime/pipeline.py PinnedSets``, as the train
  step's feed does), the counterpart of ``jax.device_put``'s
  asynchronous transfer: window N+1's copy is issued before window N's
  result is read;
- the backlog group path stacks W windows into ONE block-diagonal graph
  (``models/common.py group_graph``), where the JAX package vmaps the
  model: the kernels cannot run under ``jax.vmap``, and one launch per
  kernel for the whole group is what vmap bought;
- the compile event plane (``obs/device.py CompileEventPlane``) hears
  the port's builds, not XLA compiles: nothing is traced or compiled per
  bucket, and ``start()`` builds the kernels' library (or finds this
  source's build) once, before the workers start, as the ``segment``
  build event (``compile.events``, ``compile.segment``, a ``compile``
  recorder event with its ``duration_ms``). Each entry point's dispatch
  reports its kernel launches to the open compile watchers
  (``sanitize/retrace.py``), where launch budgets hold them.

With a host scorer (``score_fn``, and ``score_many_fn`` for groups) the
model, the card and the kernels are left out: windows stay numpy and
the callables score them on the host, as in the JAX package.

Pause/resume hooks match the health checker's stop/resume protocol.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time as time_module
from dataclasses import dataclass
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from alaz_tpu_torch.config import RuntimeConfig
from alaz_tpu_torch.datastore.interface import BaseDataStore, DataStore
from alaz_tpu_torch.device import resolve_device
from alaz_tpu_torch.events.intern import Interner
from alaz_tpu_torch.graph.builder import WindowedGraphStore, src_locality_gauges
from alaz_tpu_torch.graph.snapshot import GraphBatch
from alaz_tpu_torch.logging import get_logger
from alaz_tpu_torch.obs.device import CompileEventPlane, DeviceTelemetry, bucket_key
from alaz_tpu_torch.obs.recorder import FlightRecorder
from alaz_tpu_torch.obs.scores import ScorePlane
from alaz_tpu_torch.obs.spans import SpanTracer
from alaz_tpu_torch.ops.gru_kernels import gru_update
from alaz_tpu_torch.ops.segment_kernels import k1_split_counts
from alaz_tpu_torch.runtime.metrics import Metrics, device_gauges, host_gauges, ledger_gauges
from alaz_tpu_torch.runtime.pipeline import PinnedSets
from alaz_tpu_torch.runtime.tenancy import TenantPartition, validate_tenants
from alaz_tpu_torch.utils.ledger import DropLedger
from alaz_tpu_torch.utils.queues import BatchQueue

log = get_logger("alaz_tpu.service")


@dataclass
class ScoreRecord:
    """One anomaly-score edge annotation (dto.go leg) — the *view* type;
    the hot path moves ScoreBatch columns and only materializes records
    when a consumer iterates."""

    window_start_ms: int
    from_uid: str
    to_uid: str
    protocol: str
    score: float


@dataclass
class ScoreBatch:
    """Columnar anomaly scores for one window (above-threshold edges only).
    uid columns hold interned ids; string resolution is deferred to the
    consumer (the backend amortizes it per unique node). Iterating yields
    ScoreRecords for tests/debug sinks — the export leg never iterates."""

    window_start_ms: int
    from_uid: np.ndarray  # interned node uid ids [K]
    to_uid: np.ndarray  # [K]
    protocol: np.ndarray  # wire protocol codes [K]
    score: np.ndarray  # sigmoid scores [K], float32
    interner: Interner

    def __len__(self) -> int:
        return int(self.score.shape[0])

    def __iter__(self):
        from alaz_tpu_torch.events.schema import _PROTOCOL_NAMES as proto

        lookup = self.interner.lookup
        names: dict[int, str] = {}
        for i in range(len(self)):
            f, t = int(self.from_uid[i]), int(self.to_uid[i])
            for u in (f, t):
                if u not in names:
                    names[u] = lookup(u)
            yield ScoreRecord(
                window_start_ms=self.window_start_ms,
                from_uid=names[f],
                to_uid=names[t],
                protocol=proto[int(self.protocol[i])],
                score=float(self.score[i]),
            )


class ScoreClock:
    """The score step's device time on a card: a pair of CUDA timing
    events recorded on the current stream just before the score fn's
    first launch and just after its last, read once the logits' read has
    synchronised past them (no sync of its own). Pairs come from a free
    list, so it holds no more pairs than are ever in flight at once (two
    with the group path's double buffering). Scorer thread only."""

    def __init__(self) -> None:
        self.free: list = []

    def start(self) -> tuple:
        if self.free:
            pair = self.free.pop()
        else:
            pair = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        pair[0].record()
        return pair

    @staticmethod
    def stop(pair: tuple) -> None:
        pair[1].record()

    def read(self, pair: tuple) -> float:
        """Seconds from ``pair``'s start to its end; the pair returns to
        the free list."""
        dur_s = pair[0].elapsed_time(pair[1]) * 1e-3
        self.free.append(pair)
        return dur_s


def _to_numpy(x) -> np.ndarray:
    """A score output read back to the host (waits for the device: an
    explicit transfer under ``sanitize.no_implicit_transfers``); a host
    scorer's output as it is."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    from alaz_tpu_torch.sanitize.retrace import explicit_transfer

    with explicit_transfer():
        return x.float().cpu().numpy()


def _batched_score_fn(cfg):
    """The group score fn: ``(params, stacked) -> outputs`` over W
    windows of one bucket stacked on a leading axis (tensors on the
    params' device), run as one
    block-diagonal graph (``models/common.py group_graph``). Outputs come
    back with the leading window axis, as ``jax.vmap`` gives them:
    ``edge_logits [W, E_pad]``, ``node_logits [W, N_pad]``, ``node_h
    [W, N_pad, H]``, GAT's ``attn_clamp_saturation [W]``."""
    from alaz_tpu_torch.models.common import group_graph
    from alaz_tpu_torch.models.registry import get_model
    from alaz_tpu_torch.sanitize.retrace import dispatch

    _, apply = get_model(cfg.model)

    def batched_score_apply(params, stacked: dict) -> dict:
        w = stacked["node_feats"].shape[0]
        with torch.inference_mode(), dispatch("batched_score_apply", stacked):
            out = apply(params, group_graph(stacked, cfg), cfg)
        return {
            k: v if k == "attn_clamp_saturation" else v.reshape(w, -1, *v.shape[1:])
            for k, v in out.items()
        }

    return batched_score_apply


class FanoutDataStore(BaseDataStore):
    """Tee persisted data to several sinks (graph store + export backend)."""

    def __init__(self, sinks: List[DataStore]):
        self.sinks = sinks

    def persist_requests(self, batch: np.ndarray) -> None:
        for s in self.sinks:
            s.persist_requests(batch)

    def persist_kafka_events(self, batch: np.ndarray) -> None:
        for s in self.sinks:
            s.persist_kafka_events(batch)

    def persist_alive_connections(self, batch: np.ndarray) -> None:
        for s in self.sinks:
            s.persist_alive_connections(batch)

    def persist_resource(self, rtype, event, obj) -> None:
        for s in self.sinks:
            s.persist_resource(rtype, event, obj)


class Service:
    def __init__(
        self,
        config: Optional[RuntimeConfig] = None,
        interner: Optional[Interner] = None,
        export_backend: Optional[DataStore] = None,
        score_sink: Optional[Callable[[ScoreBatch], None]] = None,
        model_state: Any = None,  # params; None = scoring disabled
        score_threshold: float = 0.5,  # only annotate edges scoring above
        use_native_ingest: bool = False,  # C++ window accumulator when built
        score_fn: Optional[Callable] = None,  # host scorer override (see below)
        score_many_fn: Optional[Callable] = None,  # its stacked-group twin
        device=None,  # the card scoring runs on; default cuda
    ):
        self.score_threshold = score_threshold
        self.use_native_ingest = use_native_ingest
        # host scorer override: ``score_fn(params, graph) ->
        # {"edge_logits": ...}`` replaces the model — the tenancy
        # replay harness drives the WHOLE service plane (queues →
        # partitions → window queue → scorer → per-tenant score planes)
        # with a deterministic numpy scorer, so isolation gates measure
        # the plane, not the device. When set, graphs stay numpy (no
        # copy to a card, no kernel build) and ``score_many_fn(params,
        # stacked)`` — if given — serves the micro-batch group path over
        # the stacked windows as numpy arrays.
        # OWNERSHIP: ``stacked`` is a REUSED staging set — score_many_fn
        # must return arrays it owns (any arithmetic copies; a bare view
        # would be clobbered by a later group's fill).
        self._host_score = score_fn is not None
        if self._host_score and device is not None:
            raise ValueError("score_fn scores on the host: pass no device with it")
        # with no card and no device given this raises: a silent CPU run
        # would be read as the card's result
        self.torch_device = resolve_device("cpu" if self._host_score else device)
        self.config = config if config is not None else RuntimeConfig()
        self.interner = interner if interner is not None else Interner()
        self.tenants = validate_tenants(self.config, model_state, use_native_ingest)
        self.score_observer: Optional[Callable] = None  # (batch, tenant, latency_s)  # lockless-ok: attach-once harness hook published before windows flow; the scorer null-checks an atomic reference read
        self.metrics = Metrics()
        device_gauges(self.metrics, self.torch_device)
        host_gauges(self.metrics)
        # observability plane (alaz_tpu/obs): a bounded ring of
        # structured runtime events (window spans, worker restarts,
        # breaker flips, every ledger decision) + the per-window span
        # tracer whose stage durations feed the latency.* histograms.
        # Tracing is ON by default (TraceConfig / TRACE_ENABLED=0 to
        # kill); the bench's trace_overhead_pct A/B bounds its cost.
        tcfg = getattr(self.config, "trace", None)
        if tcfg is None:
            from alaz_tpu_torch.config import TraceConfig

            tcfg = TraceConfig()
        self.recorder = FlightRecorder(
            capacity=tcfg.recorder_capacity,
            metrics=self.metrics,
            dump_on_crash=tcfg.recorder_dump_on_crash,
        )
        # unified loss accounting: every row this service
        # loses — queue-mouth drop, late straggler, quarantined frame,
        # deliberate shed — lands in exactly one ledger cause (and, via
        # the recorder hook, in the flight-recorder trail)
        self.ledger = DropLedger()
        self.ledger.recorder = self.recorder
        ledger_gauges(self.metrics, self.ledger)
        # rows refused at the door for an UNKNOWN tenant id
        # get their own ledger: they belong to no partition, and folding
        # them into tenant 0's books (self.ledger aliases partition 0)
        # would break that tenant's exact conservation equation with
        # rows it never saw. Reported apart in degraded_snapshot.
        self.refused_ledger = DropLedger()
        self.refused_ledger.recorder = self.recorder
        # warn-once latch per refused tenant id (the _warned_no_native
        # pattern): a hostile/misconfigured agent streaming thousands of
        # mis-tagged frames per second must cost a counter bump, not an
        # unbounded log flood. Bounded: wire ids fit a byte; API callers
        # past the cap stay silent (the counter carries the signal).
        # the check-then-act (membership probe + cap + add) is locked:
        # alazrace's v1.1 lockset walk counts the `.add(...)` as a
        # structural write, and the old lockless-ok sanction cannot
        # bless an unlocked container mutation (ALZ053)
        self._warn_lock = threading.Lock()
        self._warned_tenants: set = set()  # guarded-by: self._warn_lock
        # spans complete at emit when no scorer runs behind the store;
        # with a model they stay open through stage/score/export
        self.tracer = SpanTracer(
            metrics=self.metrics,
            recorder=self.recorder,
            enabled=tcfg.enabled,
            max_live=tcfg.max_live,
            complete_at_emit=model_state is None,
        )
        # device-side telemetry (obs/device.py): per-bucket
        # score latency + occupancy at staging time, the stage
        # arena/transfer decomposition (+ byte ledger), pad-waste — the
        # numbers the Pallas/mixed-precision/multi-tenant work will be
        # judged by. DEVICE_TRACE_ENABLED=0 kills it independently.
        self.device = DeviceTelemetry(
            metrics=self.metrics,
            recorder=self.recorder,
            enabled=tcfg.enabled and tcfg.device_enabled,
        )
        # always-on compile event plane: the port's builds (the kernels'
        # nvcc build or cache lookup in start(), the g++ builds) count
        # into compile.* on /metrics and land in crash dumps. Same gate
        # as the JAX package's: TRACE_ENABLED=0 is the master obs kill
        # switch, and a host-score service builds no kernels.
        self.compile_plane: Optional[CompileEventPlane] = None
        if (
            model_state is not None
            and not self._host_score
            and tcfg.enabled
            and tcfg.device_enabled
        ):
            self.compile_plane = CompileEventPlane(
                metrics=self.metrics, recorder=self.recorder
            ).start()
        # score-plane observability (obs/scores.py): per-model
        # distribution sketch, drift detection, top-K attribution —
        # rides model_state like the compile plane (a non-scoring
        # service has no scores to watch) and registers NOTHING when
        # disabled (absent-not-zero). Serial + ShardedIngest paths share
        # one accounting: both feed through record_window.
        #
        # Tenancy: with one tenant the plane is the eager
        # singleton it always was. With K > 1, sketches/drift/top-K must
        # stay PER-TENANT (one fleet's incident must not page — or
        # mask — another's), so planes are created lazily at each
        # tenant's first scored window under a ``.t<k>`` metric suffix:
        # an idle tenant is absent from the scrape, never a zero render.
        self._scores_enabled = (
            model_state is not None and tcfg.enabled and tcfg.score_enabled
        )
        self._trace_cfg = tcfg
        # per-tenant plane map: inserts happen on the scorer thread only
        # but under a lock (dict resize is not GIL-atomic against the
        # read side); readers (/scores handlers, snapshots) take a
        # dict() copy without the lock — the blessed locked-writes +
        # lockless-reads shape
        self._planes_lock = threading.Lock()
        self._score_planes: dict = {}  # tenant -> ScorePlane  # lockless-ok: locked writes (scorer thread under _planes_lock) + lockless dict-copy reads
        self.scores: Optional[ScorePlane] = None
        if self.tenants == 1:
            self.scores = ScorePlane(
                metrics=self.metrics,
                recorder=self.recorder,
                enabled=self._scores_enabled,
                model=self.config.model.model,
                drift_windows=tcfg.score_drift_windows,
                top_k=tcfg.score_top_k,
                resolve=self.interner.lookup,
            )
            self._score_planes[0] = self.scores
        self._export_backend = export_backend
        if export_backend is not None and getattr(
            export_backend, "ledger", None
        ) is None:
            # wire the export leg its OWN ledger:
            # breaker sheds attribute as the closed `shed` cause. A
            # SEPARATE instance, not self.ledger — the export tee sees
            # rows the graph path also emits, so folding its sheds into
            # the pipeline ledger would double-count against
            # pushed == emitted + ledger.total (the exact equation the
            # chaos gates check); degraded_snapshot surfaces it apart.
            export_backend.ledger = DropLedger()

        # the window queue is interior backpressure, not a source edge —
        # a drop there is the pipeline choosing to shed. NOT ledger-wired
        # at the queue mouth: its items are [GraphBatch] lists (size 1),
        # and the ledger's contract is ROWS — _enqueue_window attributes
        # the batch's true aggregated row count on drop instead. ONE
        # queue for all tenants: this is where cross-tenant batching
        # happens — close waves from every partition interleave here and
        # the scorer packs same-bucket windows into one stacked fill.
        self.window_queue = BatchQueue(10_000_000, "windows")

        renumber = getattr(self.config, "renumber_nodes", False)
        if renumber and self.config.model.model == "tgn":
            # per-window renumbering scrambles node SLOTS between windows;
            # the temporal model's memory is slot-indexed across windows
            raise ValueError(
                "renumber_nodes is incompatible with model=tgn "
                "(cross-window slot-indexed memory); disable one of the two"
            )
        # per-tenant host-plane partitions (runtime/tenancy.py):
        # partition 0 owns the service-level interner/ledger/tracer (the
        # K=1 wiring is bit-identical to the pre-tenancy service); later
        # partitions get fresh namespaces. Every partition's on_batch
        # lands in the ONE window queue, tenant-stamped.
        if export_backend is not None and self.tenants > 1:
            # the export tee resolves interned uids against the ONE
            # interner the backend was built with (partition 0's):
            # teeing other fleets' rows through it would resolve their
            # uids in the WRONG namespace and export tenant A's traffic
            # under tenant B's service names. Until the per-tenant
            # export leg lands (ROADMAP follow-on), only the primary
            # tenant exports — loudly, not silently.
            log.warning(
                "export backend attached with tenants > 1: only tenant "
                "0 (the primary) exports — the backend resolves uids in "
                "one interner namespace; per-tenant export is a roadmap "
                "follow-on"
            )
        if self.config.engine_backend == "native":
            # build and load the native library here, once, before any
            # worker runs: a process pool spawns its workers while the
            # partitions are built below and each worker loads the same
            # file, and a build that fails raises from this constructor,
            # not inside an l7 worker or as worker crashes
            from alaz_tpu_torch.graph import native

            native._load()
        self.partitions: List[TenantPartition] = []
        for t in range(self.tenants):
            self.partitions.append(
                TenantPartition(
                    t,
                    self.config,
                    on_batch=functools.partial(self._enqueue_window, tenant=t),
                    interner=self.interner if t == 0 else None,
                    ledger=self.ledger if t == 0 else None,
                    tracer=self.tracer if t == 0 else None,
                    recorder=self.recorder,
                    export_backend=export_backend if t == 0 else None,
                    use_native_ingest=use_native_ingest and t == 0,
                    scoring=model_state is not None,
                    metrics=self.metrics,
                )
            )
        p0 = self.partitions[0]
        # partition-0 aliases: the single-tenant surface every existing
        # consumer (gauges below, /stats, tests, the ingest socket's
        # native-store probe) keys on. With K > 1 the unsuffixed series
        # describe tenant 0 — the primary/legacy tenant — and the
        # ``.t<k>`` series carry the per-tenant breakdown.
        self.l7_queue = p0.l7_queue
        self.tcp_queue = p0.tcp_queue
        self.proc_queue = p0.proc_queue
        self.k8s_queue = p0.k8s_queue
        self.graph_store = p0.graph_store
        self.sharded = p0.sharded
        self.aggregator = p0.aggregator
        self.datastore = p0.datastore
        if self.tenants > 1:
            # trace.live: each partition's SpanTracer registered the
            # gauge in turn (last write wins) — rebind it to the fleet
            # sum so the scrape reads live spans across ALL tenants
            parts = list(self.partitions)
            self.metrics.gauge(
                "trace.live", lambda: sum(p.tracer.live_count for p in parts)
            )

        self.score_sink = score_sink
        if self.score_sink is None and export_backend is not None and hasattr(export_backend, "persist_scores"):
            # scores flow back to the backend's /anomalies/ stream by default
            self.score_sink = export_backend.persist_scores
        if model_state is not None and not self._host_score:
            model_state = model_state.to(self.torch_device)
        self.model_state = model_state
        self._score_fn = None
        self._tgn_memory = None  # temporal model node memory (tgn only)
        # the staged windows' live edges counted by expert (experts only)
        self._count_routes: Optional[Callable[[list], None]] = None
        if model_state is not None and score_fn is not None:
            # host scorer override: no model, no kernels — the scorer
            # loop runs the callable over numpy graphs
            self._score_fn = score_fn
        elif model_state is not None:
            if self.config.model.model == "tgn":
                from alaz_tpu_torch.models import tgn

                # pre-size memory to the largest configured bucket so a
                # growing fleet never pays a serving-time recompile for a
                # new (bucket, memory-shape) pair (tgn.step still
                # zero-extends as a fallback if the bucket outgrows it)
                self._tgn_memory = tgn.init_memory(
                    self.config.model, self.config.model.tgn_max_nodes, device=self.torch_device
                )
                self._score_fn = self._tgn_score_fn(tgn.make_step_fn(self.config.model))
            else:
                from alaz_tpu_torch.train.trainstep import make_score_fn

                self._score_fn = make_score_fn(self.config.model, self.torch_device)
                if self.config.model.model == "experts":
                    self._score_fn = self._experts_score_fn(self._score_fn)
        # backlog micro-batching (config.score_batch_windows): stacked
        # twin of the score fn for window-independent models. TGN is
        # excluded — its memory threads sequentially through windows.
        self._score_many_fn = None
        # the scorer's staging buffers, serial windows' and groups':
        # page-locked on a card, so the copies to it are asynchronous
        self._staging_sets = PinnedSets(pin=self.torch_device.type == "cuda")
        self._batch_windows = max(1, int(self.config.score_batch_windows))
        # the device time each score step reports to the device plane
        # (latency.score_s.<bucket>); the host's time is the score span
        self._score_clock = ScoreClock() if self.torch_device.type == "cuda" else None
        if (
            self._score_fn is not None
            and self._batch_windows > 1
            and self.config.model.model != "tgn"
        ):
            if self._host_score:
                # group scoring only when the override supplies its
                # stacked twin; otherwise windows score serially
                self._score_many_fn = score_many_fn
            else:
                self._score_many_fn = _batched_score_fn(self.config.model)
        # cross-tenant batching accounting: dispatches vs
        # windows is the group-occupancy number `bench.py --tenants`
        # publishes (K fleets on one backend should fill groups that K
        # serial backends would dispatch one window at a time). Scorer
        # thread only.
        self.score_dispatches = 0  # role-private: scorer thread only
        self.multi_tenant_groups = 0  # role-private: scorer thread only

        self.housekeeping_interval_s = 120.0  # reference ticker cadence
        self.scored_batches = 0  # lockless-ok: single-writer GIL-atomic counter (scorer thread); racy reads are stats gauges
        self.scored_edges = 0  # lockless-ok: single-writer GIL-atomic counter (scorer thread); racy reads are stats gauges
        self._paused = threading.Event()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

        self.metrics.gauge("l7.pending", lambda: self.l7_queue.pending_events)
        self.metrics.gauge("l7.dropped", lambda: self.l7_queue.dropped)
        self.metrics.gauge("tcp.pending", lambda: self.tcp_queue.pending_events)
        self.metrics.gauge("windows.pending", lambda: len(self.window_queue))
        self.metrics.gauge("windows.late_dropped", lambda: self.graph_store.late_dropped)
        # native path only: backpressure (ring-full) drops and node/edge
        # table-capacity drops, each distinct from lateness
        self.metrics.gauge(
            "ingest.ring_dropped", lambda: getattr(self.graph_store, "ring_dropped", 0)
        )
        self.metrics.gauge(
            "ingest.acc_dropped", lambda: getattr(self.graph_store, "acc_dropped", 0)
        )
        # sharded path only: pool width, in-flight shard backlog and the
        # merge-stage share of the pipeline (ARCHITECTURE §3f)
        if self.sharded is not None:
            self.metrics.gauge("ingest.workers", lambda: self.sharded.n)
            self.metrics.gauge(
                "ingest.shard_unfinished", lambda: self.sharded.unfinished
            )
            self.metrics.gauge("ingest.merge_s", lambda: self.sharded.merge_s)
            # self-healing plane: restarts say workers are
            # dying; a climbing last-wave age says the merge thread is
            # stalled — the failure that used to be perfectly silent
            self.metrics.gauge(
                "ingest.worker_restarts", lambda: self.sharded.worker_restarts
            )
            self.metrics.gauge(
                "ingest.last_wave_age_s", lambda: self.sharded.last_wave_age_s
            )
            # degree-cap activity: nonzero means a hot key is
            # live RIGHT NOW and the sampler is what's absorbing it —
            # rows cut ride the ledger.sampled gauge, this one counts
            # aggregated edges so fan-in magnitude is readable directly
            self.metrics.gauge(
                "ingest.sampled_edges",
                lambda: self.sharded.builder.sampled_edges,
            )
            # process backend only (alaz_tpu/shm): shared-
            # memory ring occupancy — slots committed but not yet
            # consumed, summed across workers per direction. A climbing
            # request-side number is a worker falling behind; a climbing
            # response side is the merge thread falling behind.
            if hasattr(self.sharded, "shm_req_pending"):
                # lock-free cursor reads per scrape (never the per-ring
                # put_lock the scatter path contends on)
                self.metrics.gauge(
                    "ingest.shm_req_pending_slots",
                    lambda: self.sharded.shm_req_pending(),
                )
                self.metrics.gauge(
                    "ingest.shm_resp_pending_slots",
                    lambda: self.sharded.shm_resp_pending(),
                )
        elif isinstance(self.graph_store, WindowedGraphStore):
            self.metrics.gauge(
                "ingest.sampled_edges",
                lambda: self.graph_store.builder.sampled_edges,
            )
        if export_backend is not None and hasattr(export_backend, "breaker"):
            # 0 closed / 1 half-open / 2 open — numeric for dashboards
            self.metrics.gauge(
                "backend.breaker_state",
                lambda: {"closed": 0.0, "half-open": 1.0, "open": 2.0}[
                    export_backend.breaker.state
                ],
            )
            # breaker flips land in the flight-recorder trail
            export_backend.breaker.recorder = self.recorder
        # the NVML gpu_utz analog: fraction of wall time the scorer
        # spends in device compute (includes the host→device feed)
        self._scorer_busy_s = 0.0
        self.metrics.gauge(
            "scorer.duty_cycle_pct",
            lambda: 100.0
            * self._scorer_busy_s
            / max(time_module.time() - self.metrics.started_at, 1e-9),
        )
        # K1's rows split across chunk warps on this Service's card, and
        # their edges, since the kernels were loaded: each read is a small
        # copy from the card and a sync, so only a scrape reads them (0 on
        # the CPU, whose plain version splits nothing)
        self.metrics.gauge("k1.split_rows", lambda: k1_split_counts(self.torch_device)[0])
        self.metrics.gauge("k1.split_edges", lambda: k1_split_counts(self.torch_device)[1])
        # metrics scrape-and-push leg (backend.go:340-392,1038-1105)
        if export_backend is not None and hasattr(export_backend, "attach_metrics"):
            export_backend.attach_metrics(self.metrics.render_prometheus)

    # -- ingestion surface (what sources call) ------------------------------

    def _tenant_known(self, tenant: int, rows: int) -> bool:
        """True iff this service has a partition for ``tenant``. A
        mis-tagged or hostile frame is refused at the door (accounted
        below) — routing it into another tenant's stream would corrupt
        that tenant's windows, which is the exact failure tenancy
        exists to prevent."""
        if 0 <= tenant < self.tenants:
            return True
        self._refuse_unknown_tenant(tenant, rows)
        return False

    def _refuse_unknown_tenant(self, tenant: int, rows: int) -> None:
        """Account rows refused for an unknown tenant id: attributed to
        the service's REFUSED ledger (the rows belong to no partition —
        inventing one per hostile byte would be an allocation DoS, and
        folding them into any tenant's books would corrupt that
        tenant's exact conservation equation)."""
        if rows:
            self.refused_ledger.add("filtered", rows, reason="unknown_tenant")
        # one unit, always: the counter counts refusal EVENTS (frames /
        # submits — row-less k8s refusals included); lost ROWS ride the
        # refused ledger, so the two series never mix units
        self.metrics.counter("ingest.unknown_tenant").inc()
        with self._warn_lock:  # warn-once latch is check-then-act
            first_refusal = (
                tenant not in self._warned_tenants
                and len(self._warned_tenants) < 300
            )
            if first_refusal:
                self._warned_tenants.add(tenant)
        if first_refusal:
            log.warning(
                f"refused frame for unknown tenant {tenant} "
                f"(service runs {self.tenants}); further refusals for this "
                "id count silently into ingest.unknown_tenant"
            )

    def submit_l7(self, batch: np.ndarray, tenant: int = 0) -> bool:
        if self._paused.is_set():
            return False
        if not self._tenant_known(tenant, int(batch.shape[0])):
            return False
        ok = self.partitions[tenant].l7_queue.put_nowait_drop(batch)
        self.metrics.counter("l7.in").inc(batch.shape[0])
        return ok

    def submit_tcp(self, batch: np.ndarray, tenant: int = 0) -> bool:
        if self._paused.is_set():
            return False
        if not self._tenant_known(tenant, int(batch.shape[0])):
            return False
        return self.partitions[tenant].tcp_queue.put_nowait_drop(batch)

    def submit_proc(self, batch: np.ndarray, tenant: int = 0) -> bool:
        if self._paused.is_set():
            return False
        if not self._tenant_known(tenant, int(batch.shape[0])):
            return False
        return self.partitions[tenant].proc_queue.put_nowait_drop(batch)

    def submit_k8s(self, msg, tenant: int = 0) -> bool:
        if self._paused.is_set():
            return False
        if not self._tenant_known(tenant, 0):
            return False
        return self.partitions[tenant].k8s_queue.put_nowait_drop([msg])

    # -- workers -------------------------------------------------------------

    def _enqueue_window(self, batch: GraphBatch, tenant: int = 0) -> None:
        part = self.partitions[tenant]
        # the hand-off, on the closing thread: windowless, since it runs
        # on after the put, when the scorer may already have completed
        # this window's span
        with part.tracer.span("handoff"):
            # tenant attribution rides the batch through the SHARED window
            # queue: record_window routes sketches/drift/top-K to
            # the right per-tenant plane, and the close→score latency stamp
            # is what the per-tenant p99 gate measures
            batch.tenant = tenant
            batch.closed_monotonic = time_module.monotonic()
            part.windows_closed += 1
            if self.tenants > 1:
                # first-window gauge registration: per-tenant ledger series
                # appear when the tenant first produces, never before
                part.register_tenant_gauges(self.metrics)
            if not self.window_queue.put_nowait_drop([batch]):
                # ledger in ROWS, not batches (GraphBatch.aggregated_rows —
                # the one conservation row measure). The shed attributes to
                # the EMITTING tenant's ledger — per-tenant conservation is
                # the isolation gate's invariant.
                part.ledger.add("shed", batch.aggregated_rows(), reason="windows")
                # a shed window never reaches the scorer: drop its live span
                # (an eviction tick, not a leak) instead of leaving it open
                part.tracer.discard(batch.window_start_ms)
            self.metrics.counter("windows.closed").inc()
            # the banded src-gather's cost models on live traffic: lets an
            # operator read off whether SRC_GATHER=banded would pay here.
            # The decisive gauge is the straggler fraction (<0.125, the
            # kernel's fix-up budget → banded pays; →1.0 → keep the XLA
            # gather); the [min,max] band width rides along for context.
            # Multi-tenant: K closing threads would race these shared
            # set-style gauges into whichever-tenant-closed-last noise, so
            # only the PRIMARY tenant's windows feed them (the series keeps
            # one deterministic meaning; per-tenant locality is a follow-on)
            if tenant == 0:
                with part.tracer.span("gauges"):
                    band_w, strag = src_locality_gauges(
                        batch.edge_src[: batch.n_edges], n_nodes=batch.n_nodes
                    )
                    self.metrics.gauge("windows.src_band_windows").set(band_w)
                    self.metrics.gauge("windows.src_straggler_fraction").set(strag)

    def _consume(self, queue: BatchQueue, fn: Callable[[Any], None]) -> None:
        """Worker loop: every successfully-gotten batch is matched with a
        task_done (drain() hangs otherwise)."""
        while not self._stop.is_set():
            batch = queue.get(timeout=0.1)
            if batch is None:
                continue
            try:
                fn(batch)
            finally:
                queue.task_done()

    def _l7_worker(self, part: TenantPartition) -> None:
        def handle(batch):
            out = part.aggregator.process_l7(batch)
            if out is not None:
                self.metrics.counter("edges.out").inc(int(out.shape[0]))
            elif part.sharded is not None:
                # sharded pipeline processes async and returns None —
                # converge the counter onto the pipeline's authoritative
                # emitted total so edges.out dashboards keep reading the
                # truth (lag: at most the in-flight shard backlog). Per
                # partition: only THIS partition's l7 worker syncs its
                # delta (tracked on the partition), so K workers never
                # race a shared read-inc pair.
                delta = part.sharded.stats.edges_out - part.edges_out_synced
                if delta > 0:
                    part.edges_out_synced += delta
                    self.metrics.counter("edges.out").inc(delta)

        self._consume(part.l7_queue, handle)

    def _tcp_worker(self, part: TenantPartition) -> None:
        self._consume(part.tcp_queue, part.aggregator.process_tcp)

    def _proc_worker(self, part: TenantPartition) -> None:
        self._consume(part.proc_queue, part.aggregator.process_proc)

    def _k8s_worker(self, part: TenantPartition) -> None:
        def handle(msgs):
            for m in msgs:
                part.aggregator.process_k8s(m)

        self._consume(part.k8s_queue, handle)

    def _housekeeping_worker(self) -> None:
        """Periodic gc: socket lines, h2 stream reaping, DNS purge — the
        reference's 2-minute ticker loops (data.go:177-219,1688)."""
        while not self._stop.wait(self.housekeeping_interval_s):
            try:
                for part in self.partitions:
                    part.aggregator.gc()
                # timer-driven retry flush: requeued events must not wait
                # for the next L7 batch to arrive (input lulls)
                self._flush_retries_counted()
                # zombie reaper: processes that died without an EXIT event
                # (data.go:192-219; probes <proc_root>/<pid> existence, NOT
                # kill(pid,0) — see engine.reap_zombies). Valid ONLY when
                # tracked pids belong to this node — replayed/remote pids
                # would all look dead and lose their join state.
                if self.config.local_pids:
                    for part in self.partitions:
                        part.aggregator.reap_zombies()
                # traffic-lull liveness: with no newer event the watermark
                # never advances, so the last window would sit open
                # forever. Ingest idleness (not event time — replay clocks
                # are synthetic) triggers the flush, PER TENANT: one
                # fleet going quiet must flush its last window even while
                # another fleet streams on. The grace knob trades
                # staleness against upstream delivery stalls: rows that
                # arrive after their window was idle-flushed drop as late.
                grace_s = max(self.config.idle_flush_grace_s, 2 * self.config.window_s)
                for part in self.partitions:
                    last = getattr(part.graph_store, "last_persist_monotonic", None)
                    if (
                        last is not None
                        and last != part.idle_flushed_for
                        and time_module.monotonic() - last > grace_s
                    ):
                        part.graph_store.flush()
                        # one flush per idle period: until a new persist
                        # moves the timestamp there is nothing more to
                        # drain, so don't re-take the store lock per tick
                        part.idle_flushed_for = last
                # channel-lag log (data.go:177-186 cadence)
                lag = {
                    q.name: q.stats()
                    for q in (self.l7_queue, self.tcp_queue, self.window_queue)
                }
                log.info(f"queue lag: {lag}")
            except Exception as exc:
                log.warning(f"housekeeping failed: {exc}")

    def _stage(self, tracer: SpanTracer, key, batches: list, width: int = 0) -> dict:
        """One dispatch's span ``stage`` on ``tracer`` under ``key`` (a
        window, or a group's members): the windows' columns (with
        ``width``, each name's stacked ``[width, ...]``, padded with the
        last window), filled into the scorer's staging sets and copied to
        the device. On a card the copy is asynchronous (it returns before
        the copy ends, as ``jax.device_put`` does), and an event recorded
        after it guards the set's refill, as in the train step's feed. On
        the CPU one window's arrays are used in place and a group's stack
        is the set's buffers, numpy for a host scorer. The span's time
        goes to the scorer's busy time; the windows, the bytes and the
        fill/copy split to the device plane."""
        on_card = self.torch_device.type == "cuda"
        with self._bucket_ctx(batches[0]), tracer.span("stage", key) as stage:
            cols = [b.device_arrays(self.config.model.edge_layout) for b in batches]
            arrays = cols[0]
            if width:
                cols += [cols[-1]] * (width - len(cols))
                arrays = {k: [c[k] for c in cols] for k in arrays}
            if on_card or width:
                slot, arrays = self._staging_sets.fill(arrays)
            fill_s = time_module.perf_counter() - stage.t0
            if on_card:
                arrays = {k: v.to(self.torch_device, non_blocking=True) for k, v in arrays.items()}
                done = torch.cuda.Event()
                done.record()
                self._staging_sets.copied(slot, done)
            elif self._host_score:
                arrays = {k: np.asarray(v) for k, v in arrays.items()}
            else:
                arrays = {k: torch.as_tensor(v) for k, v in arrays.items()}
        if self._count_routes is not None:
            self._count_routes(batches)
        self._scorer_busy_s += stage.wall_s
        for b in batches:
            # occupancy per REAL window: a group's padding re-ships its
            # last member's columns, a dispatch artifact whose logits are
            # discarded
            self.device.observe_staged(b)
        self.device.observe_transfer(sum(v.nbytes for v in arrays.values()), fill_s, stage.wall_s - fill_s)
        return arrays

    def _scorer_worker(self) -> None:
        # double buffering (SURVEY §2.3 P3): window N+1's host→device
        # copy is issued (asynchronous, from pinned buffers) before
        # window N is scored, so the feed overlaps the compute. FIFO order
        # is kept — the temporal model's memory threading depends on it.
        # The same discipline covers the GROUP path: a group is staged
        # (stacked fill + copy + dispatch) and only finished (its result
        # read) after the next work is staged, so host stacking of group
        # k+1 overlaps device compute of group k.
        # staged: ("one", batch, device arrays) | ("group", batches, out,
        # its device clock or None)
        staged: Optional[tuple] = None

        def owed(entry: Optional[tuple]) -> int:
            """Windows a staged entry still owes task_done for."""
            if entry is None:
                return 0
            return 1 if entry[0] == "one" else len(entry[1])

        def record_window(batch, logits) -> None:
            """Per-window accounting + export — the ONE definition both
            the serial and batched paths share (their score parity is a
            tested invariant; two copies of this block could drift).
            Computes the sigmoid ONCE for the score plane and the export
            leg, times the export-ack leg and COMPLETES the window's
            span — the last lifecycle stage, so completion lives here
            and only here. Tenancy (ISSUE 14): the batch's tenant stamp
            routes sketches/drift/top-K to the tenant's OWN plane and
            feeds the per-tenant close→score latency series — the
            isolation gate's p99."""
            t = int(getattr(batch, "tenant", 0))
            part = self.partitions[t]
            w = batch.window_start_ms
            with part.tracer.span("record", w):
                self.scored_batches += 1
                self.scored_edges += batch.n_edges
                self.metrics.counter("scored.edges").inc(batch.n_edges)
                plane = self._scores_for(t)
                scores = None
                with part.tracer.span("plane", w):
                    if plane.enabled or self.score_sink is not None:
                        n = batch.n_edges
                        scores = (1.0 / (1.0 + np.exp(-logits[:n]))).astype(np.float32)
                    # score plane: sketch + drift compare + top-K
                    # attribution, one vectorized pass per window — BOTH scorer
                    # paths (serial and stacked group) land here, so the plane's
                    # accounting is identical under serial and sharded ingest
                    if scores is not None and plane.enabled:
                        plane.observe_window(batch, scores)
                closed = getattr(batch, "closed_monotonic", None)
                if closed is not None:
                    # close→score latency, attributed per tenant (sparse —
                    # the series appears with the tenant's first window)
                    lat = time_module.monotonic() - closed
                    self.metrics.histogram(
                        f"latency.close_to_score_s.t{t}", sparse=True
                    ).observe(lat)
                    if self.score_observer is not None:
                        # harness hook (replay/tenants.py): exact per-window
                        # latencies — histogram rungs are factor-2 banded,
                        # too coarse for a ±10% isolation gate
                        try:
                            self.score_observer(batch, t, lat)
                        except Exception as exc:  # alazlint: disable=ALZ043 -- telemetry hook, not a row holder: the window's rows continue to the export leg below; a raising observer costs its own sample only
                            log.warning(f"score observer failed: {exc!r}")
                with part.tracer.span("export", w):
                    if self.score_sink is not None:
                        annotated = self._annotate(batch, scores, part.interner)
                        if len(annotated):
                            self.score_sink(annotated)
            part.tracer.complete(w)

        def score_one(batch, graph) -> None:
            """Score one window; always settles its task_done."""
            try:
                tracer, w = self._tracer_for(batch), batch.window_start_ms
                with tracer.span("score", w) as score:
                    self.score_dispatches += 1
                    with self._bucket_ctx(batch):
                        with tracer.span("dispatch", w):
                            clock = self._score_clock.start() if self._score_clock is not None else None
                            out = self._score_fn(self.model_state, graph)
                            if clock is not None:
                                self._score_clock.stop(clock)
                        with tracer.span("wait", w):
                            logits = _to_numpy(out["edge_logits"])
                    if "attn_clamp_saturation" in out:
                        # GAT logit-clamp saturation (models/gat.py layer_fn):
                        # nonzero means trained logits are hitting ±30 and the
                        # softmax is flattening — the fixed-clamp assumption
                        # needs revisiting if this climbs
                        self.metrics.gauge("model.attn_clamp_saturation").set(
                            float(_to_numpy(out["attn_clamp_saturation"]))
                        )
                self._scorer_busy_s += score.wall_s
                # device plane, per bucket: the step's device time on a
                # card, the host's score time on the CPU
                self.device.observe_score(batch, self._score_clock.read(clock) if clock is not None else score.wall_s)
                record_window(batch, logits)
            finally:
                self.window_queue.task_done()

        def stage_group(batches) -> tuple:
            """Stage same-bucket windows for ONE stacked dispatch: stack
            them into the scorer's reused staging sets (no per-group
            allocation), start the host→device copy and dispatch the
            group score fn WITHOUT reading its result — the caller
            holds the returned staged entry and finishes it after the
            next work is staged, so the device computes this group while
            the host stacks the next one. Only ever fed an
            already-queued backlog, so it adds no latency over scoring
            serially — it removes per-dispatch overhead (ARCHITECTURE
            §3e). Partial groups are PADDED to the next power of two,
            CLAMPED to batch_windows (duplicating the last window, its
            logits discarded): compiled shapes per bucket are the powers
            of two up to the cap plus the cap itself when it isn't one
            (W=6 → {2,4,6}) — never a serving-time recompile per backlog
            size (the TGN memory pre-sizing policy) — while padding
            waste stays under 2×. On failure it settles every window's
            task_done itself (the accounting guarantee the serial path's
            try/except gives a single window)."""
            try:
                self.score_dispatches += 1
                # cross-tenant batching: the group was packed
                # purely by bucket shape — windows from different fleets
                # share one fill and one dispatch
                if len({int(getattr(b, "tenant", 0)) for b in batches}) > 1:
                    self.multi_tenant_groups += 1
                # the whole group staged in one fill + transfer and
                # dispatched once: each member's span carries the shared
                # times (critical-path semantics — observe keeps the max)
                members = [(self._tracer_for(b), b.window_start_ms) for b in batches]
                target = 1
                while target < len(batches):
                    target *= 2
                # never exceed the operator's cap: batch_windows may be
                # sized to device memory at the largest bucket, and a
                # non-power-of-two cap must not round up past itself
                stacked = self._stage(self.tracer, members, batches, min(target, self._batch_windows))
                # the group's dispatch runs here, at staging, ahead of its
                # score stage (finish_group's read): no parent stage
                with self._bucket_ctx(batches[0]), self.tracer.span("dispatch", members) as dispatch:
                    clock = self._score_clock.start() if self._score_clock is not None else None
                    out = self._score_many_fn(self.model_state, stacked)
                    if clock is not None:
                        self._score_clock.stop(clock)
                self._scorer_busy_s += dispatch.wall_s
                return ("group", batches, out, clock)
            except BaseException:
                for _ in batches:
                    self.window_queue.task_done()
                raise

        def finish_group(batches, out, clock) -> None:
            """Block on a staged group's logits, record every window;
            always settles the group's task_dones."""
            try:
                # shared times for the stacked group — each window's
                # `score` stage carries the group's read
                members = [(self._tracer_for(b), b.window_start_ms) for b in batches]
                with self.tracer.span("score", members) as score:
                    with self.tracer.span("wait", members):
                        logits = _to_numpy(out["edge_logits"])
                    if "attn_clamp_saturation" in out:
                        self.metrics.gauge("model.attn_clamp_saturation").set(
                            float(np.max(_to_numpy(out["attn_clamp_saturation"])))
                        )
                self._scorer_busy_s += score.wall_s
                device_s = self._score_clock.read(clock) if clock is not None else score.wall_s
                for i, batch in enumerate(batches):
                    self.device.observe_score(batch, device_s)
                    record_window(batch, logits[i])
            finally:
                for _ in batches:
                    self.window_queue.task_done()

        def finish(entry: tuple) -> None:
            """Finish any staged entry (serial window or stacked group).
            Settles the entry's own accounting in all cases."""
            if entry[0] == "one":
                score_one(entry[1], entry[2])
            else:
                finish_group(entry[1], entry[2], entry[3])

        # carry: a popped window whose bucket broke a micro-batch group;
        # it owes a task_done until scored or the worker dies
        carry: Optional[GraphBatch] = None
        try:
            while not self._stop.is_set():
                if carry is not None:
                    batch, carry = carry, None
                else:
                    # the wait for work: a poll that takes no window
                    # observes nothing
                    with self.tracer.span("take") as take:
                        item = self.window_queue.get(timeout=0.05)
                        if item is None:
                            take.drop()
                    if item is None:
                        if staged is not None:  # idle: don't hold work
                            prev, staged = staged, None
                            finish(prev)
                        continue
                    (batch,) = item
                if self._score_fn is None or self.model_state is None:
                    # scoring disabled ⟺ no model_state ⟺ the tracer
                    # completes spans at emit, on the CLOSING thread —
                    # which may still be between on_batch and emit for
                    # this very window. Do NOT discard here: the drive
                    # test caught that racing it destroys the span
                    # before emit can complete it.
                    self.window_queue.task_done()
                    continue
                # backlog micro-batching (config.score_batch_windows):
                # drain ALREADY-QUEUED same-bucket windows — a current
                # scorer finds none (group of 1) and keeps the serial
                # path's double-buffered staging; a backlog collapses
                # into one stacked dispatch
                group = [batch]
                if self._score_many_fn is not None:
                    key = (batch.n_pad, batch.e_pad)
                    while len(group) < self._batch_windows:
                        nxt = self.window_queue.get(timeout=0)
                        if nxt is None:
                            break
                        (b2,) = nxt
                        if (b2.n_pad, b2.e_pad) != key:
                            carry = b2  # scored next iteration
                            break
                        group.append(b2)
                if len(group) > 1:
                    # stage the group (its dispatch runs on device while
                    # we drain the older staged work), THEN finish the
                    # older entry — sink/record order stays FIFO because
                    # finishing happens in stage order. stage_group
                    # settles the group's accounting itself on failure;
                    # if finishing the older entry raises instead, the
                    # worker's finally settles the newly staged group.
                    new = stage_group(group)
                    prev, staged = staged, new
                    if prev is not None:
                        finish(prev)
                    continue
                try:
                    graph = self._stage(self._tracer_for(batch), batch.window_start_ms, [batch])
                except Exception:
                    # the popped window still owes its accounting
                    self.window_queue.task_done()
                    raise
                prev, staged = staged, ("one", batch, graph)
                if prev is not None:
                    finish(prev)  # finishes N; N+1's transfer in flight
            if staged is not None:
                prev, staged = staged, None
                finish(prev)
        finally:
            # worker dying (or stopping) with work still staged or
            # carried: settle its accounting so drain() doesn't burn its
            # timeout
            for _ in range(owed(staged)):
                self.window_queue.task_done()
            if carry is not None:
                self.window_queue.task_done()

    def _timed_stage(self, name: str, histogram: str) -> tuple:
        """A model stage's span and device time, registered here: the span
        stage ``name`` and, on a card, the histogram ``histogram``.
        Returns ``(around, settle)``. ``around(then=None)`` is a context
        manager: the span ``name``, inside it on a card a CUDA event pair
        (``ScoreClock``) around the body, then ``then()``. ``settle()``
        observes the summed device time of the pairs entered since the
        last settle, as one observation; call it once the scorer's read
        of the logits has synchronised past them, so it needs no sync of
        its own."""
        self.tracer.add_stage(name)
        on_card = self.torch_device.type == "cuda"
        clock = ScoreClock() if on_card else None
        device_s = self.metrics.histogram(histogram) if on_card else None
        pairs: list = []  # entered since the last settle

        @contextlib.contextmanager
        def around(then=None):
            with self.tracer.span(name):
                pair = clock.start() if on_card else None
                yield
                if on_card:
                    clock.stop(pair)
                    pairs.append(pair)
                if then is not None:
                    then()

        def settle() -> None:
            if pairs:
                device_s.observe(sum(clock.read(pair) for pair in pairs))
                pairs.clear()

        return around, settle

    def _tgn_score_fn(self, step) -> Callable:
        """The score fn that threads ``_tgn_memory`` through ``step``
        (``tgn.make_step_fn``) window by window, and the memory update's
        own series, registered here alone (tgn only): the span stage
        ``memory`` and on a card ``latency.memory_device_s`` around the
        update's launches (``_timed_stage``); the gauges
        ``tgn.memory_rows`` and ``tgn.memory_update_kernel`` (the GRU
        kernel's launches in the process, ``gru_update.launches``: one a
        window scored on a card, 0 on the CPU); the counters
        ``tgn.memory_grows`` (each zero-extension reallocates the
        memory: size ``tgn_max_nodes`` to the largest bucket) and
        ``tgn.memory_rows_updated`` (live rows, summed over windows,
        counted on the device and copied back without a wait). On a
        card a window's device time and rows are
        read when the next window is scored: the scorer read the
        window's logits in between, which synchronised past both, so
        reading them needs no sync of its own."""
        around, settle_device = self._timed_stage("memory", "latency.memory_device_s")
        self.metrics.gauge("tgn.memory_rows", lambda: self._tgn_memory.shape[0])
        self.metrics.gauge("tgn.memory_update_kernel", lambda: gru_update.launches)
        grows = self.metrics.counter("tgn.memory_grows")
        rows_updated = self.metrics.counter("tgn.memory_rows_updated")
        on_card = self.torch_device.type == "cuda"
        rows = torch.zeros((), dtype=torch.int64, pin_memory=on_card)  # the last window's, copied back
        unread = [False]  # the last window's rows, until they are read

        def copy_rows(mask) -> None:
            rows.copy_(mask.sum(), non_blocking=True)
            unread[0] = True

        def settle() -> None:
            settle_device()
            if unread[0]:
                rows_updated.inc(int(rows))
                unread[0] = False

        def tgn_score(params, graph):
            settle()  # the previous window's: its logits were read
            if self._tgn_memory.shape[0] < graph["node_feats"].shape[0]:
                grows.inc()
            mask = graph["node_mask"]
            with torch.inference_mode():
                out, self._tgn_memory = step(
                    params, graph, self._tgn_memory, lambda: around(lambda: copy_rows(mask))
                )
            if not on_card:
                settle()  # on the host the count is already there
            return out

        return tgn_score

    def _experts_score_fn(self, score_apply) -> Callable:
        """The experts' score fn: ``score_apply`` (``make_score_fn``) with
        the expert dispatch's own series, registered here alone (experts
        only): the span stage ``experts`` around each layer's dispatch
        and on a card ``latency.experts_device_s``, its device time
        summed over a window's layers (``_timed_stage``), read when the
        next window is scored; the counters
        ``experts.edges_routed.e<t>``, a staged window's live edges of
        type ``t`` summed over windows, and the gauge ``experts.live``,
        the experts that got an edge in the last staged window, both
        counted on the host from the hand-off's ``edge_type`` at staging
        (``_stage``; a stacked group's windows too), so the card does no
        work for them. Codes outside ``[0, T)`` route to no expert. The
        stacked group path dispatches without the span and the clock."""
        t = self.config.model.num_edge_types
        around, settle = self._timed_stage("experts", "latency.experts_device_s")
        routed = [self.metrics.counter(f"experts.edges_routed.e{i}") for i in range(t)]
        live = self.metrics.gauge("experts.live")

        def count_routes(batches: list) -> None:
            for b in batches:
                types = b.edge_type[: b.n_edges]
                counts = np.bincount(types[(types >= 0) & (types < t)], minlength=t)
                for c, n in zip(routed, counts.tolist()):
                    if n:
                        c.inc(n)
                live.set(int(np.count_nonzero(counts)))

        def experts_score(params, graph):
            settle()  # the previous window's: its logits were read
            return score_apply(params, graph, around_dispatch=around)

        self._count_routes = count_routes
        return experts_score

    def _tracer_for(self, batch: GraphBatch):
        """The span tracer owning this batch's window: its emitting
        partition's (window ids collide across tenants — same wall
        clock, different fleets — so spans must stay partitioned)."""
        return self.partitions[int(getattr(batch, "tenant", 0))].tracer

    def _scores_for(self, tenant: int) -> ScorePlane:
        """The tenant's score plane, created lazily at its first scored
        window (scorer thread only — the single writer of the plane
        map). Per-tenant planes register under a ``.t<k>`` suffix so an
        idle tenant never renders zeros; K=1 keeps the eager unsuffixed
        singleton, bit-identical to the pre-tenancy plane."""
        plane = self._score_planes.get(tenant)
        if plane is None:
            tcfg = self._trace_cfg
            plane = ScorePlane(
                metrics=self.metrics,
                recorder=self.recorder,
                enabled=self._scores_enabled,
                model=self.config.model.model,
                metric_suffix=f".t{tenant}",
                drift_windows=tcfg.score_drift_windows,
                top_k=tcfg.score_top_k,
                resolve=self.partitions[tenant].interner.lookup,
            )
            with self._planes_lock:
                self._score_planes[tenant] = plane
        return plane

    def tenant_scores(self, tenant: int) -> Optional[ScorePlane]:
        """Read-side accessor: the tenant's plane if it has scored at
        least one window (None before — absent, not empty)."""
        return self._score_planes.get(tenant)

    def score_planes(self) -> dict:
        """Read-side copy of the per-tenant plane map ({tenant id →
        ScorePlane}) — the /scores surface for K > 1; tenants that
        have not scored are absent."""
        return dict(self._score_planes)

    def _bucket_ctx(self, batch: GraphBatch):
        """Build attribution: a build fired while staging/scoring
        ``batch`` — synchronously, on this thread — tags the recorder's
        ``compile`` event with its shape bucket."""
        if self.compile_plane is None:
            return contextlib.nullcontext()
        return self.compile_plane.bucket(bucket_key(batch))

    def _annotate(
        self,
        batch: GraphBatch,
        scores: np.ndarray,
        interner: Optional[Interner] = None,
    ) -> ScoreBatch:
        """Columnar edge annotation: no per-edge Python objects on the
        return leg — the annotate path must sustain bench-rate edge
        throughput (the export backend resolves strings per unique node
        at serialization time). ``scores`` are the window's [0,1] edge
        scores, computed ONCE in record_window and shared with the
        score plane. ``interner`` is the EMITTING tenant's namespace —
        resolving one fleet's uids against another's table would
        annotate the wrong services."""
        keep = np.flatnonzero(scores >= self.score_threshold)
        uids = batch.node_uids
        return ScoreBatch(
            window_start_ms=batch.window_start_ms,
            from_uid=uids[batch.edge_src[keep]],
            to_uid=uids[batch.edge_dst[keep]],
            protocol=batch.edge_type[keep],
            score=scores[keep],
            interner=interner if interner is not None else self.interner,
        )

    def degraded_snapshot(self) -> dict:
        """One dict answering "what is this node losing and why": the
        per-cause drop ledger, worker restarts, merge-wave age and the
        export circuit state. Wire it to HealthChecker(degraded_snapshot=)
        so every health PUT carries it — the observable that turns
        "windows stopped arriving" from a mystery into a diagnosis."""
        out: dict = {"ledger": self.ledger.snapshot()}
        if self.scores is not None and self.scores.enabled:
            # drift state rides the health payload: a node
            # whose score distribution moved says so in every PUT, next
            # to what it is losing
            s = self.scores.snapshot()
            out["scores"] = {
                "drift_state": s["drift"]["state"],
                "psi": s["drift"]["psi"],
                "drift_events": s["drift"]["events"],
                "rebaselines": s["drift"]["rebaselines"],
                "windows": s["windows"],
            }
        if self.refused_ledger.total:
            # frames refused for unknown tenant ids — kept OUT of every
            # tenant's conservation books, surfaced on their own
            out["refused"] = self.refused_ledger.snapshot()
        if self.tenants > 1:
            # per-tenant breakdown: which FLEET is losing
            # rows / drifting — the isolation diagnosis, in every PUT
            out["tenants"] = self.tenants_snapshot(full=False)
        if self.sharded is not None:
            out["worker_restarts"] = self.sharded.worker_restarts
            out["last_wave_age_s"] = round(self.sharded.last_wave_age_s, 3)
            out["shard_backlog"] = self.sharded.unfinished
            if hasattr(self.sharded, "ring_stats"):
                # process backend: per-worker ring occupancy
                # and respawn generations — which shard is behind, and
                # whether its process has been dying
                out["shm_rings"] = self.sharded.ring_stats()
        be = self._export_backend
        if be is not None and getattr(be, "ledger", None) is not None:
            # the export leg's OWN ledger (breaker sheds) — reported
            # beside, never summed into, the pipeline ledger above
            out["export_ledger"] = be.ledger.snapshot()
        if be is not None and hasattr(be, "breaker"):
            out["breaker"] = {
                "state": be.breaker.state,
                "opens": be.breaker.opens,
                "shorted": be.breaker.shorted,
            }
        return out

    def tenants_snapshot(self, full: bool = True) -> dict:
        """Per-tenant breakdown (ISSUE 14): ledger, windows, queue lag
        (``full``) and — for tenants that have scored — drift state.
        Keys are tenant ids as strings (JSON-stable)."""
        out: dict = {}
        planes = dict(self._score_planes)  # GIL-atomic copy; scorer writes
        for part in self.partitions:
            if full:
                entry = part.snapshot()
            else:
                entry = {
                    "ledger": part.ledger.snapshot(),
                    "windows_closed": part.windows_closed,
                }
            plane = planes.get(part.tenant)
            if plane is not None and plane.enabled:
                s = plane.snapshot()
                entry["scores"] = {
                    "drift_state": s["drift"]["state"],
                    "psi": s["drift"]["psi"],
                    "drift_events": s["drift"]["events"],
                    "rebaselines": s["drift"]["rebaselines"],
                    "windows": s["windows"],
                }
            out[str(part.tenant)] = entry
        return out

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._stop.clear()
        if (
            self.torch_device.type == "cuda"
            and self._score_fn is not None
            and self.config.model.use_pallas
        ):
            # build (or find this source's build of) the kernels and load
            # them here, on the calling thread: a first-use nvcc build must
            # not run inside the scorer thread. One ``segment`` build event
            # for the compile plane, per start
            from alaz_tpu_torch.ops import _build

            _build.library(_build.build())
        # the window close groups in C++ where the native library builds
        # and in numpy otherwise (the auto-detect), and says once which
        # serves
        from alaz_tpu_torch.graph import builder as graph_builder

        log.info(
            "window close grouping: "
            + ("C++ (libalaz_ingest)" if graph_builder._use_native_grouping() else "numpy")
        )
        # one consumer set per tenant partition (isolation: tenant A's
        # queue backlog stalls only tenant A's workers), ONE scorer and
        # ONE housekeeping thread for the fleet
        workers = []
        for part in self.partitions:
            sfx = f"-t{part.tenant}" if part.tenant else ""
            workers += [
                (f"alaz-l7{sfx}", self._l7_worker, (part,)),
                (f"alaz-tcp{sfx}", self._tcp_worker, (part,)),
                (f"alaz-proc{sfx}", self._proc_worker, (part,)),
                (f"alaz-k8s{sfx}", self._k8s_worker, (part,)),
            ]
        workers += [
            ("alaz-scorer", self._scorer_worker, ()),
            ("alaz-housekeeping", self._housekeeping_worker, ()),
        ]
        for name, fn, args in workers:
            t = threading.Thread(target=fn, args=args, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        log.info("service started")

    def pause(self) -> None:
        """Backend-commanded stop (the payment-required protocol)."""
        self._paused.set()

    def resume(self) -> None:
        self._paused.clear()

    def drain(self, timeout_s: float = 10.0) -> None:
        """Wait until every submitted batch is fully processed, including
        batches a worker has popped but not finished (``unfinished`` counts
        those; plain queue-emptiness would race ``flush_windows``)."""
        import time

        deadline = time.monotonic() + timeout_s
        queues = [self.window_queue]
        for part in self.partitions:
            queues.extend(part.queues)
        while time.monotonic() < deadline:
            if all(q.unfinished == 0 for q in queues):
                # the sharded pipelines have their own in-flight queues
                # behind the partition queues; they must drain too
                if any(
                    getattr(p.aggregator, "unfinished", 0)
                    for p in self.partitions
                ):
                    time.sleep(0.02)
                    continue
                if all(
                    p.aggregator.pending_retries == 0 for p in self.partitions
                ):
                    return
                # flush due retries so the final window sees them; not-due
                # entries come due within a few 20ms backoff periods
                self._flush_retries_counted()
            time.sleep(0.02)

    def _flush_retries_counted(self) -> None:
        import time

        for part in self.partitions:
            out = part.aggregator.flush_retries(time.time_ns())
            if out is not None and out.shape[0]:
                self.metrics.counter("edges.out").inc(int(out.shape[0]))

    def flush_windows(self) -> None:
        for part in self.partitions:
            part.graph_store.flush()

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2)
        self._threads.clear()
        for part in self.partitions:
            part.stop()
        if self.compile_plane is not None:
            # detach the plane's watcher from the build and dispatch sites
            self.compile_plane.stop()
        log.info(f"service stopped; metrics={self.metrics.snapshot()}")
