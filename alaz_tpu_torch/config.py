"""Environment-driven configuration.

The reference configures everything through environment variables read in
``main.go:28-188`` and tiny structs in ``config/`` (SURVEY §2.2 G1/G24).
We keep that contract — every knob has an ``ALAZ_TPU_*`` env var — but
centralize it in typed dataclasses so programmatic use (tests, replay
configs) doesn't go through the environment at all.

Simulation configs are JSON files with the same keys as the reference's
``testconfig/config1.json`` (camelCase accepted verbatim).
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Mapping

_PREFIX = "ALAZ_TPU_"


def lookup_env(name: str, default: str | None = None, env=None) -> str | None:
    """The prefix-aware lookup (ALAZ_TPU_NAME wins over NAME) against an
    arbitrary mapping — for modules that take an injectable env."""
    if env is None:
        env = os.environ
    return env.get(_PREFIX + name, env.get(name, default))


def _env(name: str, default: str | None = None) -> str | None:
    return lookup_env(name, default)


def parse_bool(v: str | None, default: bool = False) -> bool:
    """One accepted-token set for every boolean knob. An unrecognized
    token keeps the DEFAULT rather than reading as False — a typo in a
    default-True security knob (LOG_BACKEND_TLS) must not silently
    disable it."""
    if v is None:
        return default
    t = v.strip().lower()
    if t in ("1", "true", "yes", "on"):
        return True
    if t in ("0", "false", "no", "off"):
        return False
    return default


def env_bool(name: str, default: bool = False) -> bool:
    return parse_bool(_env(name), default)


def env_int(name: str, default: int) -> int:
    v = _env(name)
    return default if v is None else int(v)


def env_float(name: str, default: float) -> float:
    v = _env(name)
    return default if v is None else float(v)


def env_str(name: str, default: str) -> str:
    v = _env(name)
    return default if v is None else v


@dataclass
class QueueConfig:
    """Bounded-queue capacities, mirroring the reference's channel sizes
    (ebpf/collector.go:79-81, main.go:82-90): drop-not-block at the source
    boundary, exactly like l7.go:764-770."""

    l7_events: int = 200_000
    tcp_events: int = 100_000
    proc_events: int = 20_000
    kube_events: int = 1_000
    ds_requests: int = 40_000
    ds_connections: int = 1_000
    ds_kafka: int = 2_000

    @classmethod
    def from_env(cls) -> "QueueConfig":
        return cls(
            l7_events=env_int("EVENTS_BUFFER_SIZE", 200_000),
            tcp_events=env_int("EBPF_TCP_EVENTS_BUFFER_SIZE", 100_000),
            proc_events=env_int("EBPF_PROC_EVENTS_BUFFER_SIZE", 20_000),
            kube_events=env_int("KUBE_EVENTS_BUFFER_SIZE", 1_000),
            ds_requests=env_int("DS_REQ_BUFFER_SIZE", 40_000),
            ds_connections=env_int("DS_CONN_BUFFER_SIZE", 1_000),
            ds_kafka=env_int("DS_KAFKA_BUFFER_SIZE", 2_000),
        )


@dataclass
class BackendConfig:
    """Batching/export cadence of the datastore backend
    (datastore/backend.go:280-338,591-765 and the HTTP client 210-278)."""

    host: str = ""
    monitoring_id: str = "test"
    node_id: str = "node-0"
    batch_size: int = 1_000
    req_flush_interval_s: float = 5.0
    conn_flush_interval_s: float = 30.0
    conn_batch_size: int = 500
    kafka_flush_interval_s: float = 5.0
    kafka_batch_size: int = 500
    resource_flush_interval_s: float = 5.0
    max_retries: int = 2
    backoff_min_s: float = 1.0
    backoff_max_s: float = 5.0
    timeout_s: float = 10.0
    metrics_export: bool = False
    metrics_export_interval_s: float = 10.0
    # circuit breaker on the send path (datastore/backend.py):
    # this many CONSECUTIVE failed sends (retry ladders included) open
    # the circuit; sends then shed instantly until a cooldown-gated
    # half-open probe succeeds. Sized so one flaky batch never trips it
    # but a down backend trips within seconds at default cadence.
    breaker_threshold: int = 5
    breaker_cooldown_s: float = 30.0

    @classmethod
    def from_env(cls) -> "BackendConfig":
        return cls(
            host=env_str("BACKEND_HOST", ""),
            monitoring_id=env_str("MONITORING_ID", "test"),
            node_id=env_str("NODE_NAME", "node-0"),
            batch_size=env_int("BATCH_SIZE", 1_000),
            metrics_export=env_bool("METRICS_ENABLED", False),
            breaker_threshold=env_int("BREAKER_THRESHOLD", 5),
            breaker_cooldown_s=env_float("BREAKER_COOLDOWN_S", 30.0),
        )


@dataclass
class SimulationConfig:
    """Replay-harness knobs; JSON-compatible with testconfig/config1.json
    (main_benchmark_test.go:40-80)."""

    test_duration_s: float = 15.0
    mem_prof_interval_s: float = 5.0
    pod_count: int = 100
    service_count: int = 50
    edge_count: int = 20
    edge_rate: int = 10_000  # events/sec/edge
    chunk_size: int = 8_192  # events per columnar batch emitted by the simulator
    seed: int = 0
    protocol_mix: Mapping[str, float] = field(default_factory=lambda: {"HTTP": 1.0})
    ds_req_buffer_size: int = 150_000
    mock_backend_min_latency_ms: float = 5.0
    mock_backend_max_latency_ms: float = 20.0

    @classmethod
    def from_json(cls, path_or_dict: str | Mapping[str, Any]) -> "SimulationConfig":
        if isinstance(path_or_dict, (str, os.PathLike)):
            with open(path_or_dict) as f:
                raw = json.load(f)
        else:
            raw = dict(path_or_dict)
        camel = {
            "testDuration": "test_duration_s",
            "memProfInterval": "mem_prof_interval_s",
            "podCount": "pod_count",
            "serviceCount": "service_count",
            "edgeCount": "edge_count",
            "edgeRate": "edge_rate",
            "dsReqBufferSize": "ds_req_buffer_size",
            "mockBackendMinLatency": "mock_backend_min_latency_ms",
            "mockBackendMaxLatency": "mock_backend_max_latency_ms",
            "chunkSize": "chunk_size",
            "seed": "seed",
            "protocolMix": "protocol_mix",
        }
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs: dict[str, Any] = {}
        for k, v in raw.items():
            key = camel.get(k, k)
            if key in known:
                kwargs[key] = v
        return cls(**kwargs)


@dataclass
class ChaosConfig:
    """Deterministic fault-injection intensities (alaz_tpu/chaos).

    OFF by default — ``enabled`` gates the whole plane; the chaos
    harness / ``bench.py --ingest --chaos <seed>`` / ``make chaos`` flip
    it on with a seed. The default intensities are the "default
    intensity" the acceptance gates run at: every seam active, faults
    frequent enough to exercise each degradation path in a short run,
    rare enough that detection quality must survive them."""

    enabled: bool = False
    seed: int = 0
    # frame seam (sources/ingest_server.py)
    frame_corrupt_prob: float = 0.02  # header magic garbled → resync
    frame_truncate_prob: float = 0.0  # payload cut short → resync
    frame_garble_prob: float = 0.02  # count field off → quarantine
    # delivery seam (batches between source and ingestion surface)
    batch_dup_prob: float = 0.05
    batch_reorder_prob: float = 0.05
    batch_late_prob: float = 0.03
    # worker seam (aggregator/sharded.py shard threads)
    worker_crash_prob: float = 0.01
    worker_stall_prob: float = 0.02
    worker_stall_s: float = 0.02
    worker_max_crashes: int = 4
    # backend seam (datastore/backend.py transport)
    backend_error_prob: float = 0.3
    backend_timeout_prob: float = 0.1

    @classmethod
    def from_env(cls) -> "ChaosConfig":
        return cls(
            enabled=env_bool("CHAOS_ENABLED", False),
            seed=env_int("CHAOS_SEED", 0),
            frame_corrupt_prob=env_float("CHAOS_FRAME_CORRUPT_PROB", 0.02),
            frame_truncate_prob=env_float("CHAOS_FRAME_TRUNCATE_PROB", 0.0),
            frame_garble_prob=env_float("CHAOS_FRAME_GARBLE_PROB", 0.02),
            batch_dup_prob=env_float("CHAOS_BATCH_DUP_PROB", 0.05),
            batch_reorder_prob=env_float("CHAOS_BATCH_REORDER_PROB", 0.05),
            batch_late_prob=env_float("CHAOS_BATCH_LATE_PROB", 0.03),
            worker_crash_prob=env_float("CHAOS_WORKER_CRASH_PROB", 0.01),
            worker_stall_prob=env_float("CHAOS_WORKER_STALL_PROB", 0.02),
            worker_stall_s=env_float("CHAOS_WORKER_STALL_S", 0.02),
            worker_max_crashes=env_int("CHAOS_WORKER_MAX_CRASHES", 4),
            backend_error_prob=env_float("CHAOS_BACKEND_ERROR_PROB", 0.3),
            backend_timeout_prob=env_float("CHAOS_BACKEND_TIMEOUT_PROB", 0.1),
        )


@dataclass
class TraceConfig:
    """Window-lifecycle span plane + flight recorder (ISSUE 9,
    alaz_tpu/obs). Tracing is ON by default — the measured cost is per
    window×stage, bounded ≤2% rows/s on the 1M-row ingest bench (the
    ``trace_overhead_pct`` A/B re-measures it every round)."""

    enabled: bool = True
    # live-span map bound: windows that never complete (scoring disabled
    # mid-run, shed window queue) evict LRU with a counter, never leak
    max_live: int = 4096
    # flight-recorder ring size (structured events, not rows)
    recorder_capacity: int = 512
    # dump the recorder tail to the log when a shard worker dies
    recorder_dump_on_crash: bool = True
    # device-side telemetry plane (obs/device.py): per-bucket
    # score latency + occupancy histograms, the stage arena/transfer
    # decomposition with its byte ledger, pad-waste accounting, and the
    # always-on compile event hookup. ON by default — cost is per
    # window×dispatch, inside the same ≤2% bench bound as the spans.
    device_enabled: bool = True
    # /profile endpoint bound (runtime/debug_http.py): a requested trace
    # longer than this is clamped — the endpoint must never wedge a
    # debug-port thread (or fill a disk) for an unbounded stretch
    profile_max_s: float = 30.0
    # score-plane observability (obs/scores.py): per-model
    # score-distribution sketches, PSI/L∞ drift detection with
    # churn-triggered rebaselining, and the top-K attribution ledger
    # (/scores, /scores/top). ON by default — cost is one vectorized
    # pass per scored window, inside the ≤2% bench bound
    # (score_plane_overhead_pct re-measures it every round).
    score_enabled: bool = True
    # rolling drift reference: the trailing K windows the current
    # window's score distribution is compared against (PSI + L∞-on-CDF
    # with hysteresis). Size to several multiples of the deploy cadence
    # you want paged on; a rebaseline refills it before judging resumes.
    score_drift_windows: int = 8
    # attribution ledger width: the K highest-scoring nodes kept per
    # window with feature z-scores + top contributing in-edges —
    # bounded cardinality by construction, never a per-node series
    score_top_k: int = 10

    @classmethod
    def from_env(cls) -> "TraceConfig":
        return cls(
            enabled=env_bool("TRACE_ENABLED", True),
            max_live=env_int("TRACE_MAX_LIVE", 4096),
            recorder_capacity=env_int("RECORDER_CAPACITY", 512),
            recorder_dump_on_crash=env_bool("RECORDER_DUMP_ON_CRASH", True),
            device_enabled=env_bool("DEVICE_TRACE_ENABLED", True),
            profile_max_s=env_float("PROFILE_MAX_SECONDS", 30.0),
            score_enabled=env_bool("SCORE_TRACE_ENABLED", True),
            score_drift_windows=env_int("SCORE_DRIFT_WINDOWS", 8),
            score_top_k=env_int("SCORE_TOP_K", 10),
        )


@dataclass
class ScenarioConfig:
    """Incident-scenario suite knobs (alaz_tpu/replay/incidents.py).

    The scenario library itself is parameterized per call; these are the
    defaults the suite drivers (``make scenarios``, ``bench.py
    --scenario`` and the ``--ingest`` ride-along) read, so a deployment
    can re-scale the fixed-seed sweep without touching code."""

    seed: int = 0
    n_workers: int = 2
    # hot_key stress fan-in (the acceptance bound); gate-scale runs use
    # the per-scenario defaults in incidents.py
    hot_key_fanin: int = 500_000
    # degree cap the hot_key scenario survives under (0 would disable
    # the defense and let the fan-in through — never the suite default)
    degree_cap: int = 1_024

    @classmethod
    def from_env(cls) -> "ScenarioConfig":
        return cls(
            seed=env_int("SCENARIO_SEED", 0),
            n_workers=env_int("SCENARIO_WORKERS", 2),
            hot_key_fanin=env_int("SCENARIO_HOT_KEY_FANIN", 500_000),
            degree_cap=env_int("SCENARIO_DEGREE_CAP", 1_024),
        )


@dataclass(frozen=True)
class ModelConfig:
    """Flagship model hyperparameters (BASELINE.json configs 2-4).
    ``use_pallas`` keeps its name so a config means the same in both
    packages: here it selects the hand-written CUDA kernels
    (``ops/segment.py kernels_enabled``)."""

    model: str = "graphsage"  # graphsage | gat | tgn
    hidden_dim: int = 128
    num_layers: int = 2
    num_heads: int = 4  # gat only
    num_edge_types: int = 9  # one per L7 protocol enum slot
    # experts model routing form: "table" computes per-expert node tables
    # (T cheap N-row matmuls) then ONE (type,src) row gather — the
    # single-chip fast path (kills the T·E·H mask traffic of the masked
    # sum); "masked" is the Σ_t 1[type=t]·(h_src@W_t) form whose T axis
    # shards cleanly over the ep mesh axis (the sharded train/score steps
    # force it when ep>1)
    expert_dispatch: str = "table"
    node_feature_dim: int = 32
    edge_feature_dim: int = 16
    # append per-window z-scored copies of the leading stat columns
    # (count/latency/error rates) to the edge features inside the model:
    # each edge seen RELATIVE to the window's fleet baseline. Absolute
    # log-latency shifts of a ramping-but-not-yet-spiking edge are ~1e-2
    # of the feature scale (invisible next to node-embedding variance);
    # the z-scored copy puts the same drift tens of σ out — the input
    # representation that makes next-window forecasting learnable
    # (replay/scenario.py run_forecast_scenario).
    edge_feat_znorm: bool = True
    dropout: float = 0.1
    dtype: str = "bfloat16"
    use_pallas: bool = True
    # src-side gather strategy: "xla" row gather (uniform-random layouts)
    # or "banded" Pallas windowed kernel (after graph/builder.py's
    # cluster_renumber pass narrows per-chunk src id bands — §3b residual)
    src_gather: str = "xla"
    # edge-buffer layout the aggregation ops consume
    # (ARCHITECTURE §3v): "coo" is the flat dst-sorted edge list scored
    # as-is; "blocked" additionally ships per-128-dst-row block extents
    # (blocked-CSR row starts computed at window close over the REAL
    # edge prefix) and routes segment reductions through the extent-
    # aware paths — the Pallas kernel skips its on-device binary search
    # and the XLA fallback reduces tile-trimmed instead of rung-padded.
    # Bit-exact vs "coo" by construction (pad edges contribute exactly
    # 0.0); selection is a Python-level branch, so no retraces.
    edge_layout: str = "coo"
    remat: bool = False  # jax.checkpoint each GNN layer (FLOPs for memory)
    # tgn only: pre-size node memory to the largest expected bucket so a
    # growing fleet doesn't pay a serving-time recompile per
    # (bucket, memory-shape) pair
    tgn_max_nodes: int = 4096

    @property
    def edge_feat_dim_in(self) -> int:
        """Edge-feature width as the model layers see it: the raw
        builder features plus the z-scored stat columns when
        ``edge_feat_znorm`` is on (models/common.py znorm_edge_feats)."""
        from alaz_tpu_torch.models.common import EDGE_STAT_COLS

        return self.edge_feature_dim + (EDGE_STAT_COLS if self.edge_feat_znorm else 0)

    @classmethod
    def from_env(cls) -> "ModelConfig":
        return cls(
            model=env_str("MODEL", "graphsage"),
            hidden_dim=env_int("HIDDEN_DIM", 128),
            num_layers=env_int("NUM_LAYERS", 2),
            use_pallas=env_bool("USE_PALLAS", True),
            src_gather=env_str("SRC_GATHER", "xla"),
            edge_layout=env_str("EDGE_LAYOUT", "coo"),
            expert_dispatch=env_str("EXPERT_DISPATCH", "table"),
            edge_feat_znorm=env_bool("EDGE_FEAT_ZNORM", True),
            remat=env_bool("REMAT", False),
            tgn_max_nodes=env_int("TGN_MAX_NODES", 4096),
        )


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh axes for the sharded model (SURVEY §2.3 P1-P7).

    Axis sizes of 1 collapse; the product must divide the device count.
    """

    dp: int = 1  # data parallel: edge-batch shards
    tp: int = 1  # tensor parallel: feature-dim shards
    ep: int = 1  # expert parallel: per-edge-type experts
    sp: int = 1  # sequence/temporal parallel: time-window shards

    @classmethod
    def from_env(cls) -> "MeshConfig":
        return cls(
            dp=env_int("MESH_DP", 1),
            tp=env_int("MESH_TP", 1),
            ep=env_int("MESH_EP", 1),
            sp=env_int("MESH_SP", 1),
        )


def mesh_axis_names() -> tuple:
    """The project mesh vocabulary — MeshConfig's axes, in field order.
    The single source of truth the ALZ024 axis-name rule, the ALZ022
    parity check, and the golden specfiles are verified against
    (tools/alazspec). Lives here (not parallel/sharding.py) so the
    checkers stay importable on jax-less data-plane images."""
    return tuple(f.name for f in dataclasses.fields(MeshConfig))


@dataclass
class RuntimeConfig:
    """Top-level wiring config — the main.go:28-188 analog."""

    queues: QueueConfig = field(default_factory=QueueConfig)
    backend: BackendConfig = field(default_factory=BackendConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    window_s: float = 1.0  # graph snapshot window
    k8s_enabled: bool = True
    # explicit apiserver URL (tests / out-of-cluster); empty = in-cluster
    # serviceaccount discovery (KUBERNETES_SERVICE_HOST + mounted token).
    # Token/CA for the override: the token file is re-read per request
    # (bound tokens rotate on disk)
    k8s_api_server: str = ""
    k8s_token_file: str = ""
    k8s_ca_file: str = ""
    exclude_namespaces: str = ""
    send_alive_tcp_connections: bool = False
    # True only when tracked pids are processes of THIS node (live-agent
    # mode): gates the zombie reaper's <proc_root>/<pid> existence probe
    # and the cold-start backfill — replayed/remote pids must never be
    # probed against this node's procfs
    local_pids: bool = False
    # procfs root for pid liveness probes and cold-start backfill:
    # /host/proc when containerized with the host procfs mounted
    proc_root: str = "/proc"
    # per-window cluster_renumber locality pass (pairs with
    # ModelConfig.src_gather="banded"); incompatible with the temporal
    # model's cross-window node memory — Service refuses the combination
    renumber_nodes: bool = False
    # ingest-idle grace before open windows flush (traffic-lull liveness).
    # Deliberately much larger than a window: a flush during an upstream
    # delivery STALL (agent buffering through a network hiccup) drops the
    # stalled rows as late when they arrive — size this above the longest
    # stall worth riding out, not at the window length.
    idle_flush_grace_s: float = 30.0
    # sharded host ingest (aggregator/sharded.py): >1 partitions L7/TCP
    # traffic by connection key across this many shard workers with a
    # merge thread recombining per-window partials — the serial
    # Aggregator+WindowedGraphStore pair otherwise. Scaling is bounded
    # by cores and the GIL-held fraction of process_l7 (ARCHITECTURE
    # §3f); size to physical cores, not hyperthreads.
    ingest_workers: int = 1
    # sharded-ingest backend (ARCHITECTURE §3r): "thread" runs
    # the shard workers as threads over the shared interner (GIL-bound —
    # measured 1.22× at 2 workers); "process" runs them as spawned
    # PROCESSES over shared-memory rings (alaz_tpu/shm) with a
    # per-process interner and id-exchange at merge — the out-of-GIL
    # path. Bit-identical output either way (property-tested); process
    # mode refuses an export tee (worker rows carry local interner ids)
    # and needs a picklable label_fn. "process" also applies at
    # ingest_workers == 1 (ingest leaves the serving process's GIL).
    ingest_backend: str = "thread"
    # L7 engine body backend (ARCHITECTURE §3s): "python" runs
    # _process_l7_inner's join/attribution/row-fill as the numpy stage;
    # "native" routes it through alz_process_l7 in libalaz_ingest.so —
    # one C++ pass per batch, GIL held only for the block handoff.
    # Bit-identical output (parity-tested); falls back to "python" with
    # a warning when the .so is unavailable. env-reading DEFAULT (not
    # just from_env) so spawned shard processes and chaos pipelines that
    # build a plain RuntimeConfig() still honor ENGINE_BACKEND=native.
    engine_backend: str = field(
        default_factory=lambda: env_str("ENGINE_BACKEND", "python")
    )
    # edge-buffer layout at window close (ARCHITECTURE §3v):
    # "coo" ships the flat dst-sorted list; "blocked" additionally
    # emits per-128-dst-row block extents consumed by the extent-aware
    # aggregation paths. Must match ModelConfig.edge_layout on the
    # scorer side. env-reading DEFAULT (not just from_env) so spawned
    # shard processes and chaos pipelines that build a plain
    # RuntimeConfig() still honor EDGE_LAYOUT=blocked.
    edge_layout: str = field(
        default_factory=lambda: env_str("EDGE_LAYOUT", "coo")
    )
    # shm ring geometry (process backend only; alazspec pins the layout
    # in wire_layouts.json `shm_ring`): bytes per fixed slot and slots
    # per ring. A scattered chunk must fit in ring_slots - 1 slots;
    # per-worker cost is 2 rings × slot_bytes × ring_slots of /dev/shm.
    shm_slot_bytes: int = 65_536
    shm_ring_slots: int = 512
    # multi-tenant serving plane (runtime/tenancy.py): >1
    # partitions the HOST plane per tenant — each tenant gets its own
    # interner namespace, drop ledger, source queues, watermarks and
    # windowed pipeline (serial or sharded per ingest_workers), so one
    # tenant's backlog, malformed stream or hot key cannot stall or
    # corrupt another's windows — while all tenants' close waves share
    # ONE scorer: same-bucket windows from different tenants pack into
    # the bucketed staging arenas (score_batch_windows groups), so the
    # device never idles between tenants. Frames carry the tenant id in
    # the header (sources/ingest_server.py); legacy frames are tenant 0.
    # 1 = today's single-tenant wiring, bit-identical (the K=1 parity
    # contract). Bounded by the header byte: ≤ events.schema.MAX_TENANTS.
    tenants: int = 1
    # scatter backpressure bound (aggregator/sharded.py): a
    # producer blocks at most this long on a backlogged shard queue
    # before the rows SHED to the drop ledger — a stalled or dead worker
    # costs attributed data, never a wedged submitter. Size above the
    # longest GC-or-merge pause a healthy worker takes, well below any
    # upstream socket timeout.
    shed_block_s: float = 5.0
    # degree-capped reservoir sampling at window close
    # (graph/builder.py): bound every dst's aggregated fan-in to this
    # many edges — the hot-key defense (one service with in-degree ~N
    # otherwise turns each window into an N-row batch). 0 = unlimited
    # (bit-identical to the uncapped path). Deterministic per
    # (sample_seed, window, dst-uid, src-uid); cut rows attribute to the
    # ledger's `sampled` cause. Size well above the fleet's honest
    # fan-in (p99.9 of per-service callers), well below the bucket
    # ladder's top rung.
    degree_cap: int = 0
    sample_seed: int = 0
    # deterministic fault injection (alaz_tpu/chaos) — off unless the
    # chaos harness / bench / env flips it
    chaos: ChaosConfig = field(default_factory=ChaosConfig)
    # window-lifecycle tracing + flight recorder (alaz_tpu/obs)
    # — ON by default; the bench overhead A/B keeps it honest
    trace: TraceConfig = field(default_factory=TraceConfig)
    # scorer backlog micro-batching: when >1 and the model is
    # window-independent (not tgn), up to this many ALREADY-QUEUED
    # same-bucket windows are stacked and scored through one vmapped
    # dispatch — zero added latency when current (only a backlog
    # batches), amortized dispatch overhead when behind
    # (ARCHITECTURE §3e's measured ~190 ms/dispatch through the relay)
    score_batch_windows: int = 1

    @classmethod
    def from_env(cls) -> "RuntimeConfig":
        return cls(
            queues=QueueConfig.from_env(),
            backend=BackendConfig.from_env(),
            model=ModelConfig.from_env(),
            mesh=MeshConfig.from_env(),
            window_s=env_float("WINDOW_S", 1.0),
            k8s_enabled=env_bool("K8S_COLLECTOR_ENABLED", True),
            k8s_api_server=env_str("K8S_API_SERVER", ""),
            k8s_token_file=env_str("K8S_TOKEN_FILE", ""),
            k8s_ca_file=env_str("K8S_CA_FILE", ""),
            exclude_namespaces=env_str("EXCLUDE_NAMESPACES", ""),
            send_alive_tcp_connections=env_bool("SEND_ALIVE_TCP_CONNECTIONS", False),
            local_pids=env_bool("LOCAL_PIDS", False),
            proc_root=env_str("PROC_ROOT", "/proc"),
            renumber_nodes=env_bool("RENUMBER_NODES", False),
            idle_flush_grace_s=env_float("IDLE_FLUSH_GRACE_S", 30.0),
            ingest_workers=env_int("INGEST_WORKERS", 1),
            ingest_backend=env_str("INGEST_BACKEND", "thread"),
            engine_backend=env_str("ENGINE_BACKEND", "python"),
            edge_layout=env_str("EDGE_LAYOUT", "coo"),
            shm_slot_bytes=env_int("SHM_SLOT_BYTES", 65_536),
            shm_ring_slots=env_int("SHM_RING_SLOTS", 512),
            tenants=env_int("TENANTS", 1),
            shed_block_s=env_float("SHED_BLOCK_S", 5.0),
            degree_cap=env_int("DEGREE_CAP", 0),
            sample_seed=env_int("SAMPLE_SEED", 0),
            chaos=ChaosConfig.from_env(),
            trace=TraceConfig.from_env(),
            score_batch_windows=env_int("SCORE_BATCH_WINDOWS", 1),
        )
