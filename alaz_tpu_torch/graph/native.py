"""ctypes binding for the C++ ingest core (native/ingest.cc).

``NativeIngest`` is the high-throughput path of the windowed graph builder:
REQUEST_DTYPE rows are converted (vectorized) into the 32-byte wire record,
pushed into the native ring, and closed windows come back as aggregated
COO columns from which GraphBatches are assembled with the same feature
schema as the pure-numpy ``GraphBuilder``.

The library is compiled from ``alaz_tpu_torch/native/ingest.cc`` with g++
(``$CXX``) at first use, into ``build/alaz_tpu_torch/`` at the root of the
checkout, under a name that carries the source's hash. Where it cannot be
built or loaded, ``_load`` raises with the compiler's output: an explicit
request for native code (``ENGINE_BACKEND=native``,
``use_native_ingest=True``, ``set_native_grouping(True)``) never falls
back. Only the grouping auto-detect (``graph/builder.py``) catches that
and groups in numpy.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

from alaz_tpu_torch.graph.builder import EDGE_FEATURE_DIM, NODE_FEATURE_DIM
from alaz_tpu_torch.graph.snapshot import GraphBatch

_LIB_DIR = Path(__file__).resolve().parent.parent / "native"
# the library this process loaded (set by _load); it lies in BUILD_DIR
_LIB_PATH = None
BUILD_DIR = _LIB_DIR.parent.parent / "build" / "alaz_tpu_torch"
# the JAX package's native/Makefile flags; -shared and the source-hash
# stamp are added by build()
CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra")
_LOAD_LOCK = threading.Lock()

# mirrors struct AlzRecord (ingest.cc); flags: bit0 tls, bit1 failed
NATIVE_RECORD_DTYPE = np.dtype(
    {
        "names": [
            "start_time_ms", "latency_ns", "from_uid", "to_uid",
            "status", "from_type", "to_type", "protocol", "flags",
        ],
        "formats": [
            np.int64, np.uint64, np.int32, np.int32,
            np.uint32, np.uint8, np.uint8, np.uint8, np.uint8,
        ],
        "offsets": [0, 8, 16, 20, 24, 28, 29, 30, 31],
        "itemsize": 32,
    }
)

_lib: Optional[ctypes.CDLL] = None

# ---------------------------------------------------------------------------
# Declarative export table — the single source both `_register` (ctypes
# restype/argtypes) and tools/alazspec (`export_signatures`, pinned in the
# golden wire table) read, so the binding and the spec can never drift
# apart. Type vocabulary: ptr (void*), pptr (void**), i32/u32/i64/u64,
# f32, cstr (const char*), void (no return).
# ---------------------------------------------------------------------------

NATIVE_EXPORTS: dict = {
    "alz_create": ("ptr", ("i64", "u32", "u32", "u32")),
    "alz_destroy": ("void", ("ptr",)),
    "alz_push": ("u32", ("ptr", "ptr", "u32")),
    "alz_drain": ("i64", ("ptr",)),
    "alz_dropped": ("u64", ("ptr",)),
    "alz_ring_dropped": ("u64", ("ptr",)),
    "alz_late_dropped": ("u64", ("ptr",)),
    "alz_acc_dropped": ("u64", ("ptr",)),
    "alz_current_window": ("i64", ("ptr",)),
    "alz_node_count": ("u32", ("ptr",)),
    "alz_close_window": ("i32", ("ptr", "u32") + ("ptr",) * 10),
    "alz_export_nodes": ("u32", ("ptr", "u32", "ptr", "ptr")),
    "alz_current_edge_count": ("i64", ("ptr",)),
    "alz_close_window_feats": (
        "i32",
        ("ptr", "u32", "u32", "ptr", "f32", "u32", "u64") + ("ptr",) * 7,
    ),
    "alz_process_l7": (
        "i64",
        ("ptr", "i64", "u64",  # events, n, now_ns
         "ptr", "ptr", "ptr", "i64",  # sl_pid, sl_fd, sl_off, n_lines
         "ptr", "ptr", "ptr", "ptr", "ptr", "ptr",  # ts/open/saddr/sport/daddr/dport
         "ptr",  # sl_touched (out)
         "ptr", "ptr", "i64",  # pod ips/uids/n
         "ptr", "ptr", "i64",  # svc ips/uids/n
         "ptr", "ptr", "ptr", "ptr"),  # out rows, kept_idx, unmatched_idx, counts
    ),
    "alz_group_edges": (
        "i64",
        ("ptr", "u64", "pptr", "u32", "pptr", "u32", "u64", "ptr", "ptr",
         "ptr", "pptr", "pptr"),
    ),
    "alz_sample_degree_cap": (
        "i64",
        ("ptr", "ptr", "i64", "u32", "ptr", "u64"),
    ),
    "alz_edge_feat_dim": ("u32", ()),
    "alz_node_feat_dim": ("u32", ()),
    "alz_abi_record_layout": ("cstr", ()),
    "alz_abi_l7_event_layout": ("cstr", ()),
    "alz_abi_request_layout": ("cstr", ()),
    "alz_source_hash": ("cstr", ()),
}

# Drop/retry cause order of alz_process_l7's `counts` output vector —
# counts[0] is requeue-or-no_socket (unmatched join), counts[1] is the
# not_pod attribution drop. Pinned in the alazspec l7_engine wire table;
# the aggregator maps them onto DropLedger "filtered" reasons, so a
# reorder here without a spec regen fails tier-1.
L7_ENGINE_DROP_CAUSES = ("no_socket", "not_pod")

# The per-column meaning of alz_close_window's 10 output pointers and
# alz_export_nodes' 2 — every aggregate column after window_start_ms must
# be an EdgeSlot (resp. NodeSlot) field, which tools/alazspec cross-checks
# against the parsed C structs so a renamed/dropped accumulator field
# fails tier-1 instead of silently exporting garbage.
CLOSE_WINDOW_COLUMNS = (
    "window_start_ms", "src_slot", "dst_slot", "protocol", "count",
    "lat_sum", "lat_max", "err5", "err4", "tls_cnt",
)
EXPORT_NODES_COLUMNS = ("uid", "type")

_CTYPE_OF = {
    "ptr": ctypes.c_void_p,
    "pptr": ctypes.POINTER(ctypes.c_void_p),
    "i32": ctypes.c_int32,
    "u32": ctypes.c_uint32,
    "i64": ctypes.c_int64,
    "u64": ctypes.c_uint64,
    "f32": ctypes.c_float,
    "cstr": ctypes.c_char_p,
    "void": None,
}


def export_signatures() -> dict:
    """{export name: "ret(arg, ...)"} — the binding-side half of the
    native-export contract tools/alazspec pins in the golden wire table."""
    return {
        name: f"{ret}({', '.join(args)})"
        for name, (ret, args) in NATIVE_EXPORTS.items()
    }


def record_layout_string() -> str:
    """NATIVE_RECORD_DTYPE rendered in the shared layout-string format
    (events/schema.py dtype_layout) — the Python half of the AlzRecord
    ABI contract the loaded .so must byte-match."""
    from alaz_tpu_torch.events.schema import dtype_layout

    return dtype_layout(NATIVE_RECORD_DTYPE, "AlzRecord")


def l7_event_layout_string() -> str:
    """L7_EVENT_DTYPE's layout string — the input half of the
    alz_process_l7 wire contract (AlzL7Event mirror in ingest.cc)."""
    from alaz_tpu_torch.events.schema import L7_EVENT_DTYPE, dtype_layout

    return dtype_layout(L7_EVENT_DTYPE, "AlzL7Event")


def request_layout_string() -> str:
    """REQUEST_DTYPE's layout string — the output half of the
    alz_process_l7 wire contract (AlzRequest mirror in ingest.cc)."""
    from alaz_tpu_torch.datastore.dto import REQUEST_DTYPE
    from alaz_tpu_torch.events.schema import dtype_layout

    return dtype_layout(REQUEST_DTYPE, "AlzRequest")


def loaded_source_hash() -> Optional[str]:
    """``alz_source_hash()`` of the loaded .so ("unstamped" for
    out-of-band builds), or None when the library is unavailable — the
    staleness-guard input for tools/alazspec."""
    lib = _load()
    if lib is None:
        return None
    return lib.alz_source_hash().decode()


def build(force: bool = False) -> Path:
    """Compile ``native/ingest.cc`` into ``BUILD_DIR`` unless this source
    was built already; returns the library's path. The file name and the
    ``ALZ_SOURCE_HASH`` stamp carry the first 16 hex digits of the
    source's sha256, so an edited source is never shadowed by a stale
    build. The compiler writes a temporary file that replaces the target
    in one step, so processes building at once do not race. Raises
    RuntimeError, with the compiler's output, when the build fails."""
    import hashlib

    src = _LIB_DIR / "ingest.cc"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"libalaz_ingest-{digest}.so"
    if out.exists() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [os.environ.get("CXX") or "g++", *CXXFLAGS,
           f'-DALZ_SOURCE_HASH="{digest}"', "-shared", "-o", str(tmp), str(src)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise RuntimeError(f"cannot build {src.name}: {' '.join(cmd)}: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building {src.name} failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    """The library, built at first use and loaded once per process.
    Unlike the JAX package's, this never returns None: a library that
    cannot be built or loaded raises RuntimeError, so no caller falls
    back to Python or numpy without being told."""
    global _lib, _LIB_PATH
    if _lib is not None:
        return _lib
    with _LOAD_LOCK:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
                _register(lib)
            except (OSError, AttributeError) as exc:
                raise RuntimeError(f"cannot load {path}: {exc}") from exc
            _LIB_PATH = path
            _lib = lib
    return _lib


def _register(lib: ctypes.CDLL) -> None:
    # every export's restype/argtypes come from the declarative table —
    # the same table alazspec pins in the golden wire table, so a binding
    # edit without a `make specs` fails tier-1
    for name, (ret, args) in NATIVE_EXPORTS.items():
        fn = getattr(lib, name)  # AttributeError on a stale .so → fallback
        fn.restype = _CTYPE_OF[ret]
        fn.argtypes = [_CTYPE_OF[a] for a in args]
    # feature-layout contract: the C++ pass writes ef/nf rows with these
    # strides — a drifted constant would silently misalign every feature.
    # RuntimeError on purpose: _load's except clause swallows
    # OSError/AttributeError (stale-.so fallback), but THIS condition must
    # surface loudly, not degrade to the numpy path without a signal.
    if (lib.alz_edge_feat_dim(), lib.alz_node_feat_dim()) != (
        EDGE_FEATURE_DIM, NODE_FEATURE_DIM,
    ):
        raise RuntimeError(
            "libalaz_ingest.so feature dims drifted from graph/builder.py; "
            "rebuild with make -C alaz_tpu/native -B"
        )
    # record-layout contract: the binary's own offsetof/sizeof table must
    # byte-match NATIVE_RECORD_DTYPE — same loud-failure rationale. The
    # source↔binary↔dtype triangle is closed by tools/alazspec (ALZ020).
    compiled = lib.alz_abi_record_layout().decode()
    if compiled != record_layout_string():
        raise RuntimeError(
            "libalaz_ingest.so AlzRecord layout drifted from "
            f"NATIVE_RECORD_DTYPE:\n  .so:   {compiled}\n"
            f"  dtype: {record_layout_string()}\n"
            "rebuild with make -C alaz_tpu/native -B"
        )
    # L7 engine wire mirrors: alz_process_l7 reads L7_EVENT_DTYPE
    # bytes and writes REQUEST_DTYPE bytes directly — same loud-failure
    # rationale as AlzRecord, for both directions of the handoff.
    for fn_name, want in (
        ("alz_abi_l7_event_layout", l7_event_layout_string()),
        ("alz_abi_request_layout", request_layout_string()),
    ):
        compiled = getattr(lib, fn_name)().decode()
        if compiled != want:
            raise RuntimeError(
                f"libalaz_ingest.so {fn_name} drifted from the pinned "
                f"dtype:\n  .so:   {compiled}\n  dtype: {want}\n"
                "rebuild with make -C alaz_tpu/native -B"
            )


def available() -> bool:
    return _load() is not None


def _ptr_array(arrays) -> "ctypes.Array":
    """numpy float64 arrays → C `double*[]` (void** at the ctypes level)."""
    return (ctypes.c_void_p * max(len(arrays), 1))(
        *[a.ctypes.data_as(ctypes.c_void_p).value for a in arrays] or [None]
    )


def group_edges(keys, sum_cols, max_cols):
    """Grouped reduction through the C++ core (``alz_group_edges``):
    group rows by int64 key, per-group count + SUMs over ``sum_cols`` +
    MAXes over ``max_cols``. Returns ``(uniq_keys, count, rep, sums,
    maxes)`` in ascending key order, or None when the library is
    unavailable (callers fall back to the numpy argsort+reduceat path —
    graph/builder.group_reduce). Stateless and thread-safe: the sharded
    ingest workers call it concurrently."""
    lib = _load()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    n = keys.shape[0]
    sc = [np.ascontiguousarray(c, dtype=np.float64) for c in sum_cols]
    mc = [np.ascontiguousarray(c, dtype=np.float64) for c in max_cols]
    out_keys = np.empty(n, dtype=np.int64)
    out_count = np.empty(n, dtype=np.float64)
    out_rep = np.empty(n, dtype=np.int64)
    out_sums = [np.empty(n, dtype=np.float64) for _ in sc]
    out_maxes = [np.empty(n, dtype=np.float64) for _ in mc]
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    pptr = lambda arrs: ctypes.cast(_ptr_array(arrs), ctypes.POINTER(ctypes.c_void_p))  # noqa: E731
    e = int(
        lib.alz_group_edges(
            ptr(keys), n, pptr(sc), len(sc), pptr(mc), len(mc), n,
            ptr(out_keys), ptr(out_count), ptr(out_rep),
            pptr(out_sums), pptr(out_maxes),
        )
    )
    if e < 0:  # can't happen with out_cap == n; belt and braces
        return None
    return (
        out_keys[:e], out_count[:e], out_rep[:e],
        [s[:e] for s in out_sums], [m[:e] for m in out_maxes],
    )


def sample_degree_cap(dst, prio, cap: int):
    """Degree-capped bottom-k selection through the C++ core
    (``alz_sample_degree_cap``): over DST-SORTED aggregated edges, keep
    at most ``cap`` edges per dst — the ones with the smallest 64-bit
    priorities (ties by ascending row index, matching the numpy
    fallback's stable lexsort bit for bit). Returns kept indices in
    ascending order, or None when the library is unavailable (callers
    fall back to graph/builder.py's numpy path). Stateless and
    thread-safe like ``alz_group_edges``."""
    lib = _load()
    if lib is None:
        return None
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    prio = np.ascontiguousarray(prio, dtype=np.uint64)
    n = int(dst.shape[0])
    out = np.empty(n, dtype=np.int64)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    k = int(
        lib.alz_sample_degree_cap(
            ptr(dst), ptr(prio), n, int(cap), ptr(out), n
        )
    )
    if k < 0:  # cap==0 or short buffer: both are caller bugs — fall back
        return None
    return out[:k]


_INT64_MIN = -(2**63)


class NativeWindowedStore:
    """DataStore adapter over NativeIngest — drop-in for
    WindowedGraphStore when the C++ core is available: persist_requests
    pushes into the ring and polls closed windows to ``on_batch``."""

    def __init__(self, window_s: float = 1.0, on_batch=None, **kwargs):
        self.ingest = NativeIngest(window_s=window_s, **kwargs)
        self.on_batch = on_batch
        self.batches: list[GraphBatch] = []
        self.request_count = 0
        self.last_persist_monotonic: float | None = None
        # the C++ side is single-consumer (alz_drain/alz_close_window share
        # ring tail + export buffers); serialize like WindowedGraphStore does
        self._lock = threading.Lock()

    @property
    def late_dropped(self) -> int:
        return self.ingest.late_dropped

    @property
    def ring_dropped(self) -> int:
        return self.ingest.ring_dropped

    @property
    def acc_dropped(self) -> int:
        return self.ingest.acc_dropped

    @property
    def sampled_edges(self) -> int:
        return self.ingest.sampled_edges

    @property
    def sampled_rows(self) -> int:
        return self.ingest.sampled_rows

    def persist_requests(self, batch: np.ndarray) -> None:
        with self._lock:
            self.last_persist_monotonic = time.monotonic()
            self.request_count += batch.shape[0]
            self.ingest.push(batch)
            while True:
                out = self.ingest.poll()
                if out is None:
                    break
                self._emit(out)

    def push_records(self, rows: np.ndarray) -> int:
        """Pre-packed NATIVE_RECORD_DTYPE rows (the socket fast path:
        agents ship AlzRecord wire bytes, no REQUEST_DTYPE conversion).
        Returns accepted count; closed windows emit as usual."""
        with self._lock:
            self.last_persist_monotonic = time.monotonic()
            self.request_count += rows.shape[0]
            accepted = self.ingest.push_records(rows)
            while True:
                out = self.ingest.poll()
                if out is None:
                    break
                self._emit(out)
            return accepted

    def persist_kafka_events(self, batch: np.ndarray) -> None:
        pass

    def persist_alive_connections(self, batch: np.ndarray) -> None:
        pass

    def persist_resource(self, rtype, event, obj) -> None:
        pass

    def flush(self) -> None:
        with self._lock:
            for out in self.ingest.flush():
                self._emit(out)

    def _emit(self, batch: GraphBatch) -> None:
        if self.on_batch is not None:
            self.on_batch(batch)
        else:
            self.batches.append(batch)

    def close(self) -> None:
        with self._lock:
            self.ingest.close()


class NativeIngest:
    """Windowed edge aggregation backed by the C++ core.

    Usage: ``push(request_rows)`` (drop-not-block), then ``poll()`` which
    returns a GraphBatch whenever a window closed.
    """

    def __init__(
        self,
        window_s: float = 1.0,
        ring_capacity: int = 1 << 18,
        max_edges: int = 1 << 20,
        max_nodes: int = 1 << 20,
        renumber: bool = False,
        degree_cap: int = 0,
        sample_seed: int = 0,
        ledger=None,
        edge_layout: Optional[str] = None,
    ):
        lib = _load()
        if lib is None:
            raise RuntimeError("libalaz_ingest.so unavailable; run make -C alaz_tpu/native")
        self._lib = lib
        self.window_ms = int(window_s * 1000)
        self.window_s = window_s
        self.max_edges = max_edges
        self.max_nodes = max_nodes
        # the locality pass runs host-side on the exported arrays — the
        # C++ core's internal slot assignment is untouched
        self.renumber = renumber
        # per-dst fan-in cap folded into the close pass: the
        # C++ side draws the SAME sample_priorities(seed, window, uids,
        # proto) bottom-k as graph/builder.py degree_cap_select, so the
        # native close and the numpy builder select identical survivors
        self.degree_cap = int(degree_cap)
        self.sample_seed = int(sample_seed)
        self.ledger = ledger
        # blocked-extent REFUSAL surface (pinned in
        # resources/specs/wire_layouts.json `edge_blocks`): the C export
        # does NOT ship block extents — alz_close_window_feats' signature
        # is frozen (ALZ030 offsets golden) and the extents are a pure
        # function of the dst-sorted columns it already emits, so the
        # python side derives them instead: one np.searchsorted over the
        # int32 dst prefix (~µs/window, next to the close pass's ms).
        # Growing the C ABI for a value the host recomputes for free
        # would buy nothing and cost an offsets/parity churn.
        from alaz_tpu_torch.config import env_str

        self.edge_layout = (
            edge_layout if edge_layout is not None
            else env_str("EDGE_LAYOUT", "coo")
        )
        self.sampled_edges = 0
        self.sampled_rows = 0
        self._h = ctypes.c_void_p(
            lib.alz_create(self.window_ms, ring_capacity, max_edges, max_nodes)
        )

    def close(self) -> None:
        if self._h:
            self._lib.alz_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass

    @property
    def dropped(self) -> int:
        if not self._h:
            return 0  # closed: metrics gauges may still poll
        return int(self._lib.alz_dropped(self._h))

    @property
    def ring_dropped(self) -> int:
        """Backpressure drops (ring full), separate from lateness drops."""
        if not self._h:
            return 0
        return int(self._lib.alz_ring_dropped(self._h))

    @property
    def late_dropped(self) -> int:
        """Rows dropped because their window was already emitted."""
        if not self._h:
            return 0
        return int(self._lib.alz_late_dropped(self._h))

    @property
    def acc_dropped(self) -> int:
        """Rows dropped on node/edge table capacity."""
        if not self._h:
            return 0
        return int(self._lib.alz_acc_dropped(self._h))

    @staticmethod
    def to_records(rows: np.ndarray) -> np.ndarray:
        """REQUEST_DTYPE rows → packed native records (vectorized)."""
        out = np.zeros(rows.shape[0], dtype=NATIVE_RECORD_DTYPE)
        out["start_time_ms"] = rows["start_time_ms"]
        out["latency_ns"] = rows["latency_ns"]
        out["from_uid"] = rows["from_uid"]
        out["to_uid"] = rows["to_uid"]
        out["status"] = rows["status_code"]
        out["from_type"] = rows["from_type"]
        out["to_type"] = rows["to_type"]
        out["protocol"] = rows["protocol"]
        out["flags"] = rows["tls"].astype(np.uint8) | (
            (~rows["completed"]).astype(np.uint8) << 1
        )
        return out

    def push(self, rows: np.ndarray) -> int:
        """Push REQUEST_DTYPE rows; returns accepted count."""
        if not self._h:
            return 0
        recs = self.to_records(np.ascontiguousarray(rows))
        return self.push_records(recs)

    def push_records(self, recs: np.ndarray) -> int:
        """Push already-packed NATIVE_RECORD_DTYPE rows."""
        if not self._h:
            return 0
        recs = np.ascontiguousarray(recs)
        return int(
            self._lib.alz_push(
                self._h, recs.ctypes.data_as(ctypes.c_void_p), recs.shape[0]
            )
        )

    def poll(self) -> Optional[GraphBatch]:
        """Drain the ring; if a window closed, build and return its batch."""
        if not self._h:
            return None
        ready = int(self._lib.alz_drain(self._h))
        if ready == _INT64_MIN:
            return None
        return self._close_current()

    def flush(self) -> list[GraphBatch]:
        """Drain everything and close every open window, oldest first."""
        out: list[GraphBatch] = []
        if not self._h:
            return out
        while True:
            ready = int(self._lib.alz_drain(self._h))
            if ready == _INT64_MIN:
                break
            out.append(self._close_current())
        while int(self._lib.alz_current_window(self._h)) != _INT64_MIN:
            out.append(self._close_current())
        return out

    def _close_current(self) -> GraphBatch:
        """Close the oldest window via the C++ feature-assembly pass.

        The core emits dst-sorted COO columns plus both feature matrices
        straight into the padded numpy buffers the GraphBatch keeps, so
        the former numpy stage (argsort + 8 bincounts + log1p features +
        pad copies — ~120 ms per 256k-edge window) collapses to buffer
        allocation and pad fills."""
        from alaz_tpu_torch.graph.snapshot import pad_to_bucket

        e = int(self._lib.alz_current_edge_count(self._h))
        if e < 0:
            raise RuntimeError("alz_close_window called with no open window")
        n_nodes = int(self._lib.alz_node_count(self._h))
        e_pad = pad_to_bucket(e)
        n_pad = pad_to_bucket(n_nodes)

        es = np.zeros(e_pad, np.int32)
        ed = np.zeros(e_pad, np.int32)
        et = np.zeros(e_pad, np.int32)
        cnt = np.zeros(e_pad, np.uint64)
        ef = np.zeros((e_pad, EDGE_FEATURE_DIM), np.float32)
        nf = np.zeros((n_pad, NODE_FEATURE_DIM), np.float32)
        ws = ctypes.c_int64(0)
        sampled = np.zeros(2, np.int64)  # [cut_edges, cut_rows]
        ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
        n = int(
            self._lib.alz_close_window_feats(
                self._h, e_pad, n_pad, ctypes.byref(ws),
                ctypes.c_float(self.window_s),
                self.degree_cap, self.sample_seed,
                ptr(es), ptr(ed), ptr(et), ptr(cnt), ptr(ef), ptr(nf),
                ptr(sampled),
            )
        )
        if n == -2:
            raise RuntimeError("alz_close_window called with no open window")
        if n == -3:
            raise RuntimeError("native node buffer too small; raise max_nodes")
        if n < 0:
            raise RuntimeError("native edge buffer overflow; raise max_edges")
        if sampled[0]:
            self.sampled_edges += int(sampled[0])
            self.sampled_rows += int(sampled[1])
            if self.ledger is not None:
                self.ledger.add("sampled", int(sampled[1]), reason="degree_cap")

        uids = np.zeros(n_pad, np.int32)
        types = np.zeros(n_pad, np.uint8)
        self._lib.alz_export_nodes(self._h, n_pad, ptr(uids), ptr(types))
        node_type = types.astype(np.int32)
        window_start_ms = int(ws.value)

        if self.renumber and n > 0:
            # the locality pass permutes node ids, which invalidates the
            # core's dst-sort — rebuild (re-sort) through GraphBatch.build
            from alaz_tpu_torch.graph.builder import apply_renumber, cluster_renumber

            perm = cluster_renumber(
                es[:n], ed[:n], n_nodes, edge_weight=cnt[:n].astype(np.float64)
            )
            src, dst, rnf, rnt, ruids = apply_renumber(
                perm, es[:n], ed[:n], nf[:n_nodes], node_type[:n_nodes],
                uids[:n_nodes],
            )
            return self._finish(GraphBatch.build(
                node_feats=rnf,
                node_type=rnt,
                edge_src=src,
                edge_dst=dst,
                edge_type=et[:n],
                edge_feats=ef[:n],
                node_uids=ruids,
                window_start_ms=window_start_ms,
                window_end_ms=window_start_ms + self.window_ms,
            ))

        return self._finish(GraphBatch.from_presorted(
            nf, node_type, es, ed, et, ef, n_nodes, n,
            node_uids=uids,
            window_start_ms=window_start_ms,
            window_end_ms=window_start_ms + self.window_ms,
        ))

    def _finish(self, batch: GraphBatch) -> GraphBatch:
        """Post-close layout step shared by both close paths: under the
        blocked layout, derive the extents python-side at close time
        (the refusal surface documented in __init__ — the C core emits
        dst-sorted columns, which is all the searchsorted needs) so
        downstream staging/telemetry see the same eager window invariant
        the numpy builder ships."""
        if self.edge_layout == "blocked":
            batch.block_starts()
        return batch
