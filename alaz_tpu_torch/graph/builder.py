"""Windowed edge → graph aggregation (the COO batcher).

``WindowedGraphStore`` implements the DataStore interface, making the GNN
scorer a drop-in sink behind the same plugin seam the reference exposes
(datastore/datastore.go:3-21): the aggregator persists REQUEST_DTYPE rows,
the store buckets them into fixed time windows, and each closed window
becomes a :class:`GraphBatch` (BASELINE.json: "batched into sparse COO
graphs ... behind the existing datastore.DataStore plugin interface").

Node identity is persistent across windows (uid → stable slot) so temporal
models see consistent node indexing; per-window features are recomputed
vectorized from that window's edges.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, List, Optional

import numpy as np

from alaz_tpu_torch.config import env_str
from alaz_tpu_torch.datastore.interface import BaseDataStore
from alaz_tpu_torch.events.intern import Interner
from alaz_tpu_torch.events.k8s import EventType, ResourceType
from alaz_tpu_torch.graph.snapshot import GraphBatch
from alaz_tpu_torch.obs.device import blocked_pad_waste_pct_from, pad_waste_pct_from
from alaz_tpu_torch.obs.spans import SpanTracer

NODE_FEATURE_DIM = 32
EDGE_FEATURE_DIM = 16


class NodeTable:  # role-private: every instance is owned by one GraphBuilder and mutated only behind that builder's owner's lock (WindowedGraphStore._lock serial / ShardedIngest's bounded _merge_lock acquire sharded) — cross-role reach is serialized by the owner, and alazrace's golden map pins the ownership
    """uid-id → stable node slot, with endpoint type.

    Backed by flat int32 arrays, not a dict: uid ids are interner ids, so
    a uid-indexed slot array resolves a whole window's column in one
    vectorized take, and only genuinely-new uids cost any Python at all
    (one vectorized append per window, not one dict insert per uid). The
    slot array costs 4 bytes per interner id ever seen as a uid bound
    (amortized doubling) — the deliberate trade for O(1) row resolution;
    per-window transients are bounded by the window, not the id space
    (bulk_map's dense/sparse split).
    """

    def __init__(self) -> None:
        # uid id → slot, -1 = unseen (uids are dense interner ids)
        self._slot_of_uid = np.full(1024, -1, dtype=np.int32)
        self._uids = np.empty(1024, dtype=np.int32)
        self._types = np.empty(1024, dtype=np.int32)
        self._n = 0
        # batch-path instrumentation (perf smoke test: the vectorized
        # path must carry the traffic, not a per-row fallback)
        self.bulk_calls = 0
        self.scalar_calls = 0

    def __len__(self) -> int:
        return self._n

    def _ensure_uid_capacity(self, needed: int) -> None:
        cap = self._slot_of_uid.shape[0]
        if needed > cap:
            grown = np.full(max(needed, 2 * cap), -1, dtype=np.int32)
            grown[:cap] = self._slot_of_uid
            self._slot_of_uid = grown

    def _ensure_node_capacity(self, needed: int) -> None:
        cap = self._uids.shape[0]
        if needed > cap:
            new_cap = max(needed, 2 * cap)
            for name in ("_uids", "_types"):
                grown = np.empty(new_cap, dtype=np.int32)
                grown[: self._n] = getattr(self, name)[: self._n]
                setattr(self, name, grown)

    def get_or_add(self, uid_id: int, ep_type: int) -> int:
        self.scalar_calls += 1
        self._ensure_uid_capacity(uid_id + 1)
        slot = int(self._slot_of_uid[uid_id])
        if slot < 0:
            slot = self._n
            self._ensure_node_capacity(slot + 1)
            self._slot_of_uid[uid_id] = slot
            self._uids[slot] = uid_id
            self._types[slot] = ep_type
            self._n = slot + 1
        return slot

    def bulk_map(self, uid_ids: np.ndarray, ep_types: np.ndarray) -> np.ndarray:
        """get_or_add over a column of uid ids, fully vectorized AND
        sort-free: uids are dense interner ids, so presence comes from
        one bincount, first-occurrence indices from one reversed
        scatter, and after misses append (new slots in ascending-uid
        order — the exact order the scalar reference assigns them) every
        row resolves with a single take through the uid→slot array."""
        self.bulk_calls += 1
        uid_ids = np.asarray(uid_ids)
        n = uid_ids.shape[0]
        if n == 0:
            return np.zeros(0, dtype=np.int32)
        max_uid = int(uid_ids.max())
        self._ensure_uid_capacity(max_uid + 1)
        if max_uid < max(4 * n, 1 << 16):
            # dense id space: presence via bincount, first occurrence via
            # reversed scatter — no sort anywhere
            uniq = np.flatnonzero(np.bincount(uid_ids, minlength=max_uid + 1))
            miss = self._slot_of_uid[uniq] < 0
            if miss.any():
                miss_uids = uniq[miss].astype(np.int32)
                first_idx = np.empty(max_uid + 1, dtype=np.int64)
                first_idx[uid_ids[::-1]] = np.arange(n - 1, -1, -1)
                first_of_miss = first_idx[miss_uids]
                self._append_misses(miss_uids, np.asarray(ep_types)[first_of_miss])
        else:
            # sparse id space (the shared interner also numbers paths/SQL
            # strings, so uid ids can sit far above the window's node
            # count): one O(n log n) unique bounds the transients by the
            # WINDOW size, never by the global id space
            uniq, first_rows = np.unique(uid_ids, return_index=True)
            miss = self._slot_of_uid[uniq] < 0
            if miss.any():
                miss_uids = uniq[miss].astype(np.int32)
                self._append_misses(
                    miss_uids, np.asarray(ep_types)[first_rows[miss]]
                )
        return self._slot_of_uid[uid_ids]

    def _append_misses(self, miss_uids: np.ndarray, miss_types: np.ndarray) -> None:
        """Append new uids (ascending order — the scalar reference's slot
        assignment order) in one vectorized pass."""
        k = miss_uids.shape[0]
        self._ensure_node_capacity(self._n + k)
        self._uids[self._n : self._n + k] = miss_uids
        self._types[self._n : self._n + k] = miss_types
        self._slot_of_uid[miss_uids] = np.arange(
            self._n, self._n + k, dtype=np.int32
        )
        self._n += k

    def _scalar_bulk_map(self, uid_ids: np.ndarray, ep_types: np.ndarray) -> np.ndarray:
        """Pre-vectorization reference (one ``get_or_add`` per distinct
        uid, with per-element int() boxing) — kept for the equivalence
        property tests."""
        uniq, first_idx, inverse = np.unique(
            uid_ids, return_index=True, return_inverse=True
        )
        slots = np.empty(uniq.shape[0], dtype=np.int32)
        for j in range(uniq.shape[0]):
            slots[j] = self.get_or_add(int(uniq[j]), int(ep_types[first_idx[j]]))
        return slots[inverse]

    def types_array(self) -> np.ndarray:
        """Read-only view of the live types column (no per-call copy)."""
        return self._types[: self._n]

    def uids_array(self) -> np.ndarray:
        """Read-only view of the live uids column (no per-call copy)."""
        return self._uids[: self._n]


def cluster_renumber(
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    n_nodes: int,
    edge_weight: np.ndarray | None = None,
) -> np.ndarray:
    """Locality-oriented node renumbering: a permutation ``perm`` with
    ``perm[old_id] = new_id`` that places sources talking to the same
    destination in one contiguous id range.

    Why: batches are dst-sorted (snapshot.py), so a window of consecutive
    edges shares few destinations; after this pass their *source* rows
    also live in a narrow band of the node table, turning the step's
    residual src-side gathers from random row hits into windowed reads
    (ARCHITECTURE.md §3b — the three ~9 ms src gathers are the remaining
    step-time bound, and uniform-random ids are their adversarial case).
    Real service maps have community structure (teams of pods calling
    their own services); this pass is what converts that structure into
    memory locality. Cost: one O(E log E) host-side sort per window —
    free next to the device step.

    Ordering key per node: (its modal destination, out-traffic desc,
    old id) — out-traffic is edge count when unweighted, total request
    weight otherwise. Nodes with no outgoing edges (services, sinks)
    keep their relative order after all sources. ``edge_weight`` weights
    both the modal vote and the tiebreak — essential on AGGREGATED
    graphs (one edge per (src,dst,proto) pair, GraphBuilder.build),
    where the per-edge request count is what distinguishes a pod's home
    service from a one-off noise pair."""
    if edge_src.shape[0] == 0:
        return np.arange(n_nodes, dtype=np.int32)
    # modal dst per src via (weighted) pair counting — vectorized groupby
    pair_key = edge_src.astype(np.int64) * np.int64(n_nodes) + edge_dst.astype(np.int64)
    uniq_pairs, inverse = np.unique(pair_key, return_inverse=True)
    if edge_weight is None:
        pair_counts = np.bincount(inverse, minlength=uniq_pairs.shape[0])
    else:
        pair_counts = np.bincount(
            inverse, weights=edge_weight.astype(np.float64),
            minlength=uniq_pairs.shape[0],
        )
    pair_src = (uniq_pairs // n_nodes).astype(np.int64)
    pair_dst = (uniq_pairs % n_nodes).astype(np.int64)
    # per src, pick the dst with max count: sort by (src, count) and take last
    order = np.lexsort((pair_counts, pair_src))
    boundaries = np.flatnonzero(np.diff(pair_src[order], append=-1))
    top_dst = np.full(n_nodes, np.int64(n_nodes), dtype=np.int64)  # sinks last
    if edge_weight is None:
        out_deg = np.bincount(edge_src, minlength=n_nodes).astype(np.float64)
    else:
        out_deg = np.bincount(
            edge_src, weights=edge_weight.astype(np.float64), minlength=n_nodes
        )
    top_dst[pair_src[order][boundaries]] = pair_dst[order][boundaries]
    new_order = np.lexsort((np.arange(n_nodes), -out_deg, top_dst))
    perm = np.empty(n_nodes, dtype=np.int32)
    perm[new_order] = np.arange(n_nodes, dtype=np.int32)
    return perm


def src_band_windows(
    edge_src: np.ndarray, tile: int | None = None, window: int | None = None
) -> float:
    """Mean number of ``window``-row node-table windows each ``tile``-edge
    chunk's src band spans — the banded gather kernel's exact cost model
    (DMAs/chunk). ~1-4 after cluster_renumber on community maps; ~N/128
    on uniform-random ids, where the XLA row gather is the right choice.
    Callers use this to pick ModelConfig.src_gather per deployment.
    Defaults come from ops.constants so the gauge can never drift from
    the kernel's actual tiling."""
    return src_locality_gauges(edge_src, n_nodes=0, tile=tile, window=window)[0]


def src_straggler_fraction(
    edge_src: np.ndarray,
    n_nodes: int,
    tile: int | None = None,
    window: int | None = None,
    band: int | None = None,
) -> float:
    """Fraction of edges whose src falls OUTSIDE the fixed
    ``band``-window band centered on its chunk's median window — the
    hybrid banded gather's exact fix-up cost model (the kernel covers the
    band; everything else is an XLA row op). ≲0.15 after
    cluster_renumber on ~90%-local community maps; →1.0 on
    uniform-random ids, where the plain XLA gather is the right choice.
    The kernel falls back to the plain gather above 1/8 (its static
    straggler budget), so the operator threshold is 0.125."""
    return src_locality_gauges(edge_src, n_nodes, tile=tile, window=window, band=band)[1]


def src_locality_gauges(
    edge_src: np.ndarray,
    n_nodes: int,
    tile: int | None = None,
    window: int | None = None,
    band: int | None = None,
) -> tuple[float, float]:
    """(mean band windows, straggler fraction) in one shared pass over
    ``edge_src`` — the per-window-close gauge pair shares the pad +
    reshape so the hot window-close path walks the array once.
    ``n_nodes`` ≤ 0 skips the straggler half (returns 1.0)."""
    from alaz_tpu_torch.ops.constants import BAND_WINDOWS, DMA_WINDOW, TILE_E

    tile = TILE_E if tile is None else tile
    window = DMA_WINDOW if window is None else window
    band = BAND_WINDOWS if band is None else band
    e = edge_src.shape[0]
    if e == 0:
        return 0.0, 0.0
    pad = (-e) % tile
    ids = np.concatenate([edge_src, np.full(pad, edge_src[-1])]) if pad else edge_src
    win = ids.astype(np.int64) // window
    per_chunk = win.reshape(-1, tile)
    lo = per_chunk.min(axis=1)
    hi = per_chunk.max(axis=1)
    band_windows = float(np.mean(hi - lo + 1))
    if n_nodes <= 0:
        return band_windows, 1.0
    # ceil: the kernel sees the 128-padded node table, so a partial top
    # window is still coverable — flooring would misplace bands near the
    # table top and misread fractions sitting at the 0.125 threshold
    n_windows = max(1, -(-n_nodes // window))
    b = min(band, n_windows)
    med = np.median(per_chunk, axis=1).astype(np.int64)
    lo_w = np.clip(med - b // 2, 0, n_windows - b)
    lo_e = np.repeat(lo_w, tile)
    in_band = (win >= lo_e) & (win < lo_e + b)
    # padded ids replicate a real edge; count only the real edge axis
    return band_windows, float(np.mean(~in_band[:e]))


def apply_renumber(
    perm: np.ndarray,
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    *node_arrays: np.ndarray,
) -> tuple:
    """Apply a ``cluster_renumber`` permutation: edge endpoints are
    remapped through ``perm`` and every per-node array is reordered so
    row ``perm[i]`` of the output is row ``i`` of the input."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
    out_nodes = tuple(a[inv] for a in node_arrays)
    return (perm[edge_src], perm[edge_dst]) + out_nodes


# ---------------------------------------------------------------------------
# Grouped reduction (the per-window argsort+reduceat stage). The numpy
# implementation below is the fallback; when libalaz_ingest.so is loaded
# the same reduction runs in C++ (native/ingest.cc alz_group_edges) —
# stateless, so shard workers call it concurrently. Both produce groups
# in ascending key order with bit-identical reductions for the
# integer-valued float64 columns the builder feeds.
# ---------------------------------------------------------------------------

_native_grouping: Optional[bool] = None  # None = auto-detect on first use


def set_native_grouping(enabled: Optional[bool]) -> None:
    """Force the grouping backend: True = C++ (raises later if the .so is
    missing — callers gate on native.available()), False = numpy,
    None = auto-detect (the default)."""
    global _native_grouping
    _native_grouping = enabled


def _use_native_grouping() -> bool:
    global _native_grouping
    if _native_grouping is None:
        try:
            from alaz_tpu_torch.graph import native

            _native_grouping = native.available()
        except Exception:  # toolchain-less images: numpy serves
            _native_grouping = False
    return _native_grouping


def pack_group_key(
    src_slot: np.ndarray, dst_slot: np.ndarray, proto: np.ndarray
) -> np.ndarray:
    """DST-MAJOR (dst, src, proto) packing into one int64 sort key:
    ascending key order is dst-sorted (the layout GraphBatch needs), src
    keeps 28 bits (<2^28 slots), proto the low 4."""
    return (
        (dst_slot.astype(np.int64) << np.int64(32))
        | (src_slot.astype(np.int64) << np.int64(4))
        | (proto.astype(np.int64) & np.int64(0xF))
    )


def unpack_group_key(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(src_slot, dst_slot) halves of packed group keys. The protocol
    nibble is NOT recovered here — callers take it from a representative
    row so out-of-enum protocol bytes round-trip unclamped."""
    src = ((keys >> np.int64(4)) & np.int64(0xFFFFFFF)).astype(np.int32)
    dst = (keys >> np.int64(32)).astype(np.int32)
    return src, dst


def group_reduce(
    keys: np.ndarray,
    sum_cols: List[np.ndarray],
    max_cols: List[np.ndarray],
) -> tuple[np.ndarray, np.ndarray, np.ndarray, List[np.ndarray], List[np.ndarray]]:
    """Group rows by int64 key: ``(uniq_keys, count, rep, sums, maxes)``
    in ascending key order; ``rep`` is a representative row index per
    group. Routes through the C++ core when loaded; the numpy
    argsort+reduceat path is the fallback and the semantic reference."""
    n = keys.shape[0]
    if n and _use_native_grouping():
        from alaz_tpu_torch.graph import native

        out = native.group_edges(keys, sum_cols, max_cols)
        if out is not None:
            return out
    if n == 0:
        empty = np.zeros(0, dtype=np.float64)
        return (
            np.zeros(0, dtype=np.int64), empty, np.zeros(0, dtype=np.int64),
            [empty.copy() for _ in sum_cols], [empty.copy() for _ in max_cols],
        )
    # ONE argsort serves grouping AND every per-group statistic: group
    # boundaries fall out of the sorted keys (what np.unique would have
    # argsorted a second time), per-group sum/max run as reduceat over
    # the sorted values. No stability requirement — any group member is
    # a valid representative. Group order is ascending key, np.unique's.
    order = np.argsort(keys)
    sk = keys[order]
    is_start = np.empty(n, dtype=bool)
    is_start[0] = True
    np.not_equal(sk[1:], sk[:-1], out=is_start[1:])
    starts = np.flatnonzero(is_start)
    count = (np.append(starts[1:], n) - starts).astype(np.float64)
    sums = [np.add.reduceat(c[order], starts) for c in sum_cols]
    maxes = [np.maximum.reduceat(c[order], starts) for c in max_cols]
    return sk[starts], count, order[starts], sums, maxes


# ---------------------------------------------------------------------------
# Degree-capped neighbor sampling. One dst with in-degree ~N (a
# hot-key service) turns a window's aggregated edge list into an N-row
# batch: the bucket ladder jumps to its top rung and the close wave pays
# an N-proportional assembly. The cap bounds per-dst fan-in at window
# close with DETERMINISTIC reservoir sampling — every edge draws a 64-bit
# priority that is a pure function of (seed, window, dst-uid, src-uid,
# proto), and each over-cap dst keeps the `cap` smallest (bottom-k ==
# uniform reservoir sample under hash-random priorities, the
# sample-and-aggregate GNN sampling form, PAPERS.md). Purity is the
# point: serial builds, N-worker merges and reruns all select the same
# edges, so the sharded equivalence contract survives the cap.
#
# The selection routes through the C++ core (alz_sample_degree_cap,
# operating on the already-dst-grouped edges alz_group_edges emits) when
# the .so is loaded — same toggle as the grouping backend
# (set_native_grouping) so parity tests A/B both with one switch; the
# numpy lexsort path below is the fallback and the semantic reference.
# Ties break by ascending row index in BOTH backends (numpy's stable
# lexsort == the C++ (prio, idx) comparator), so they are bit-identical.
# ---------------------------------------------------------------------------

_MIX_C1 = 0xFF51AFD7ED558CCD  # splitmix64 finalizer constants — mirrored
_MIX_C2 = 0xC4CEB9FE1A85EC53  # by mix64() in native/ingest.cc (alazspec-pinned)
_U64 = np.uint64
_MASK64 = (1 << 64) - 1


def _mix64(x: np.ndarray) -> np.ndarray:
    """Vectorized mix64 — the same finalizer native/ingest.cc uses for
    its hash probes; uint64 arithmetic wraps mod 2^64 on both sides."""
    x = x.astype(np.uint64, copy=True)
    x ^= x >> _U64(33)
    x *= _U64(_MIX_C1)
    x ^= x >> _U64(33)
    x *= _U64(_MIX_C2)
    x ^= x >> _U64(33)
    return x


def _mix64_int(x: int) -> int:
    """Scalar mix64 over Python ints (avoids numpy scalar overflow
    warnings when mixing the (seed, window) base)."""
    x &= _MASK64
    x ^= x >> 33
    x = (x * _MIX_C1) & _MASK64
    x ^= x >> 33
    x = (x * _MIX_C2) & _MASK64
    x ^= x >> 33
    return x


def sample_priorities(
    seed: int,
    window_start_ms: int,
    dst_uid: np.ndarray,
    src_uid: np.ndarray,
    proto: np.ndarray,
) -> np.ndarray:
    """Per-edge sampling priority: a pure function of (seed, window,
    dst-uid, src-uid, proto) — uids, not slots, so any pipeline that
    interns the same strings draws the same sample regardless of worker
    count or slot-assignment order."""
    base = _mix64_int((int(seed) << 32) ^ (int(window_start_ms) & _MASK64))
    x = (
        (dst_uid.astype(np.int64).astype(np.uint64) << _U64(32))
        ^ src_uid.astype(np.int64).astype(np.uint64)
        ^ (proto.astype(np.int64).astype(np.uint64) << _U64(56))
    )
    x ^= _U64(base)
    return _mix64(x)


def degree_cap_select(
    e_dst: np.ndarray, prio: np.ndarray, cap: int
) -> np.ndarray:
    """Indices (ascending) of the edges that survive the per-dst cap:
    for every dst group in the DST-SORTED edge list, the ``cap``
    smallest priorities (ties by row index). C++ when loaded, numpy
    lexsort fallback otherwise — bit-identical by construction."""
    n = e_dst.shape[0]
    if n and _use_native_grouping():
        from alaz_tpu_torch.graph import native

        out = native.sample_degree_cap(e_dst, prio, cap)
        if out is not None:
            return out
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    # stable lexsort: within a dst group, ascending (prio, original
    # index) — the exact order the C++ (prio, idx) comparator ranks
    order = np.lexsort((prio, e_dst))
    sd = e_dst[order]
    is_start = np.empty(n, dtype=bool)
    is_start[0] = True
    np.not_equal(sd[1:], sd[:-1], out=is_start[1:])
    starts = np.flatnonzero(is_start)
    sizes = np.diff(np.append(starts, n))
    rank = np.arange(n, dtype=np.int64) - np.repeat(starts, sizes)
    keep = order[rank < cap]
    keep.sort()
    return keep


@dataclass
class EdgeAggregate:
    """One window's aggregated edges, slot-keyed — what feature assembly
    consumes. Produced either directly from REQUEST rows
    (GraphBuilder.build) or by recombining shard-worker partials
    (GraphBuilder.build_from_partials)."""

    e_src: np.ndarray  # [E] int32 node slots
    e_dst: np.ndarray  # [E] int32
    e_type: np.ndarray  # [E] int32 protocol codes
    count: np.ndarray  # [E] float64 (integer-valued)
    lat_sum: np.ndarray  # [E] float64
    lat_max: np.ndarray  # [E] float64
    err5_sum: np.ndarray  # [E] float64
    err4_sum: np.ndarray  # [E] float64
    tls_sum: np.ndarray  # [E] float64
    label_sum: Optional[np.ndarray] = None  # [E] float64

    @property
    def n_edges(self) -> int:
        return int(self.e_src.shape[0])


@dataclass
class EdgePartial:
    """A shard worker's per-(window, chunk) partial aggregation, keyed by
    UID (not slot: workers must not touch the shared NodeTable — slot
    assignment happens once, in the merge stage). All reductions are
    integer-valued float64, so merge-order changes cannot perturb them;
    the merge recombines same-key partial edges with one reduceat pass."""

    from_uid: np.ndarray  # [P] int32
    to_uid: np.ndarray  # [P] int32
    from_type: np.ndarray  # [P]
    to_type: np.ndarray  # [P]
    proto: np.ndarray  # [P] int32
    count: np.ndarray  # [P] float64
    lat_sum: np.ndarray  # [P] float64
    lat_max: np.ndarray  # [P] float64
    err5_sum: np.ndarray  # [P] float64
    err4_sum: np.ndarray  # [P] float64
    tls_sum: np.ndarray  # [P] float64
    label_sum: Optional[np.ndarray]  # [P] float64
    rows: int  # raw REQUEST rows folded in (conservation accounting)


def _request_row_stats(rows: np.ndarray) -> tuple[np.ndarray, ...]:
    """The per-row reduction inputs every aggregation path shares:
    (lat, err5, err4, tls) as float64 columns of a REQUEST batch."""
    lat = rows["latency_ns"].astype(np.float64)
    status = rows["status_code"].astype(np.int64)
    err5 = ((status >= 500) | (~rows["completed"])).astype(np.float64)
    err4 = ((status >= 400) & (status < 500)).astype(np.float64)
    tls = rows["tls"].astype(np.float64)
    return lat, err5, err4, tls


def aggregate_rows(
    rows: np.ndarray,
    src_slot: np.ndarray,
    dst_slot: np.ndarray,
    edge_label: Optional[np.ndarray] = None,
) -> tuple[EdgeAggregate, np.ndarray]:
    """REQUEST rows + slot columns → (EdgeAggregate, rep) via one grouped
    reduction over the dst-major key."""
    proto = rows["protocol"]
    key = pack_group_key(src_slot, dst_slot, proto.astype(np.int64))
    lat, err5, err4, tls = _request_row_stats(rows)
    sum_cols = [lat, err5, err4, tls]
    if edge_label is not None:
        sum_cols.append(edge_label.astype(np.float64))
    uniq, count, rep, sums, maxes = group_reduce(key, sum_cols, [lat])
    e_src, e_dst = unpack_group_key(uniq)
    agg = EdgeAggregate(
        e_src=e_src,
        e_dst=e_dst,
        e_type=proto[rep].astype(np.int32),
        count=count,
        lat_sum=sums[0],
        lat_max=maxes[0],
        err5_sum=sums[1],
        err4_sum=sums[2],
        tls_sum=sums[3],
        label_sum=sums[4] if edge_label is not None else None,
    )
    return agg, rep


def partial_from_rows(
    rows: np.ndarray,
    local_nodes: NodeTable,
    edge_label: Optional[np.ndarray] = None,
) -> EdgePartial:
    """A shard worker's thread-local aggregation of one chunk's window
    rows: grouping runs against the worker's PRIVATE NodeTable (slots are
    only a grouping aid here — the output is uid-keyed), so no shared
    state is touched and workers aggregate fully in parallel."""
    local_src = local_nodes.bulk_map(rows["from_uid"], rows["from_type"])
    local_dst = local_nodes.bulk_map(rows["to_uid"], rows["to_type"])
    agg, rep = aggregate_rows(rows, local_src, local_dst, edge_label)
    return EdgePartial(
        from_uid=rows["from_uid"][rep].astype(np.int32),
        to_uid=rows["to_uid"][rep].astype(np.int32),
        from_type=rows["from_type"][rep],
        to_type=rows["to_type"][rep],
        proto=agg.e_type,
        count=agg.count,
        lat_sum=agg.lat_sum,
        lat_max=agg.lat_max,
        err5_sum=agg.err5_sum,
        err4_sum=agg.err4_sum,
        tls_sum=agg.tls_sum,
        label_sum=agg.label_sum,
        rows=int(rows.shape[0]),
    )


class GraphBuilder:  # role-private: every instance is owned by one store and its mutations (node table growth, pad/sample counters) run only behind that owner's lock (WindowedGraphStore._lock serial / ShardedIngest's bounded _merge_lock acquire sharded) — cross-role reach is serialized by the owner, and alazrace's golden map pins the ownership
    """Aggregates one window's REQUEST_DTYPE rows into a GraphBatch.

    ``renumber=True`` applies the cluster_renumber locality pass to each
    built batch: node rows/ids are permuted per window so co-communicating
    sources are contiguous (narrow src bands → the banded gather kernel).
    The permutation is self-consistent within the batch (features, types,
    uids, and edge endpoints all move together; score export reads uids
    through the permuted table) but node SLOTS then differ between
    windows — do not combine with models that carry per-slot state across
    windows (the temporal model's memory)."""

    def __init__(
        self,
        nodes: Optional[NodeTable] = None,
        window_s: float = 1.0,
        renumber: bool = False,
        degree_cap: int = 0,
        sample_seed: int = 0,
        ledger=None,
        tracer: Optional[SpanTracer] = None,
        edge_layout: Optional[str] = None,
    ):
        self.nodes = nodes if nodes is not None else NodeTable()
        self.window_s = window_s
        self.renumber = renumber
        # edge-buffer layout this builder emits: "blocked"
        # computes the per-128-dst-row extents eagerly at window close
        # (assembly is the host's staging decision — the scoring thread
        # must never pay the searchsorted) and feeds the block-slot
        # ledger. Defaults from EDGE_LAYOUT so every construction site
        # (service, bench, sharded merge, replay) honors the env switch
        # without threading a parameter through each one.
        self.edge_layout = (
            edge_layout if edge_layout is not None
            else env_str("EDGE_LAYOUT", "coo")
        )
        # per-dst fan-in bound at window close (0 = unlimited — the
        # bit-identical legacy path). Sampled-away edges attribute their
        # request rows to the ledger's closed `sampled` cause.
        self.degree_cap = int(degree_cap)
        self.sample_seed = int(sample_seed)
        self.ledger = ledger
        # span plane: the builder owns three stages of the
        # window lifecycle — `merge` (grouped reduction/recombine),
        # `assemble` (feature matrices + pad/bucket) and `sample` (the
        # degree-cap decision + selection). None = untraced (training,
        # standalone builds) at zero cost.
        self.tracer = tracer
        self.sampled_rows = 0  # request rows cut by the cap (cumulative)
        self.sampled_edges = 0  # aggregated edges cut by the cap
        # bucket capacity accounting: every assembled batch
        # splits its edge bucket into real vs pad slots, so host-only
        # pipelines (bench --ingest, the chaos harness) publish the same
        # pad_waste_pct the service's staging-side device plane gauges —
        # assembly IS the host's staging decision, the device just pays
        # for it
        self.assembled_edge_rows = 0  # real (masked-in) edge slots
        self.assembled_pad_slots = 0  # pad-tail slots shipped anyway
        self.assembled_block_slots = 0  # blocked-layout tile slots

    @property
    def pad_waste_pct(self) -> float:
        """Percentage of assembled edge slots that were pad, cumulative
        over every batch this builder emitted — the host-side twin of
        the device plane's gauge, computed through the ONE shared
        definition (obs/device.py pad_waste_pct_from)."""
        return pad_waste_pct_from(
            self.assembled_edge_rows, self.assembled_pad_slots
        )

    @property
    def block_fill_pct(self) -> float:
        """Fill percentage of the blocked layout's tile slots, cumulative
        over every blocked batch — the host-side twin of the device
        plane's ``device.block_fill_pct`` gauge, through the same shared
        definition (obs/device.py blocked_pad_waste_pct_from). 0.0 until
        a blocked batch was assembled (COO builders never feed it)."""
        if not self.assembled_block_slots:
            return 0.0
        return 100.0 - blocked_pad_waste_pct_from(
            self.assembled_edge_rows, self.assembled_block_slots
        )

    def build(
        self,
        rows: np.ndarray,
        window_start_ms: int = 0,
        window_end_ms: int = 0,
        edge_label: Optional[np.ndarray] = None,
    ) -> GraphBatch:
        """Vectorized groupby (from_uid, to_uid, protocol) → edge rows with
        count/latency/error/tls features; node features from incident edges.

        ``edge_label`` is per-request labels (fault injection ground truth);
        an aggregated edge is labeled 1 if any of its requests were faulty.
        """
        tr = self.tracer
        t0 = time.perf_counter() if tr is not None else 0.0
        src_slot = self.nodes.bulk_map(rows["from_uid"], rows["from_type"])
        dst_slot = self.nodes.bulk_map(rows["to_uid"], rows["to_type"])
        # DST-MAJOR key → grouped reduction (C++ when loaded, numpy
        # argsort+reduceat otherwise): the aggregated edge list arrives
        # already dst-sorted, so assembly skips the per-window stable sort
        agg, _ = aggregate_rows(rows, src_slot, dst_slot, edge_label)
        if tr is not None:
            tr.observe(window_start_ms, "merge", time.perf_counter() - t0)
        return self._assemble(agg, window_start_ms, window_end_ms)

    def build_from_partials(
        self,
        partials: List[EdgePartial],
        window_start_ms: int = 0,
        window_end_ms: int = 0,
    ) -> GraphBatch:
        """Merge shard-worker partials into the window's GraphBatch: map
        uids through the SHARED NodeTable (miss slots append in
        ascending-uid order — the same assignment the single-thread path
        makes for the same window row set), then recombine same-key
        partial edges with one grouped-reduction pass (sum for
        count/lat/err/tls/label, max for lat_max). Bit-identical to
        ``build`` over the concatenated rows while per-window latency
        sums stay integer-exact in float64 (< 2^53 ns ≈ 104 days)."""
        tr = self.tracer
        t0 = time.perf_counter() if tr is not None else 0.0
        from_uid = np.concatenate([p.from_uid for p in partials])
        to_uid = np.concatenate([p.to_uid for p in partials])
        from_type = np.concatenate([p.from_type for p in partials])
        to_type = np.concatenate([p.to_type for p in partials])
        proto = np.concatenate([p.proto for p in partials])
        src_slot = self.nodes.bulk_map(from_uid, from_type)
        dst_slot = self.nodes.bulk_map(to_uid, to_type)
        key = pack_group_key(src_slot, dst_slot, proto.astype(np.int64))
        has_label = bool(partials) and all(
            p.label_sum is not None for p in partials
        )
        sum_cols = [
            np.concatenate([p.count for p in partials]),
            np.concatenate([p.lat_sum for p in partials]),
            np.concatenate([p.err5_sum for p in partials]),
            np.concatenate([p.err4_sum for p in partials]),
            np.concatenate([p.tls_sum for p in partials]),
        ]
        if has_label:
            sum_cols.append(np.concatenate([p.label_sum for p in partials]))
        max_cols = [np.concatenate([p.lat_max for p in partials])]
        uniq, _, rep, sums, maxes = group_reduce(key, sum_cols, max_cols)
        e_src, e_dst = unpack_group_key(uniq)
        agg = EdgeAggregate(
            e_src=e_src,
            e_dst=e_dst,
            e_type=proto[rep].astype(np.int32),
            count=sums[0],
            lat_sum=sums[1],
            lat_max=maxes[0],
            err5_sum=sums[2],
            err4_sum=sums[3],
            tls_sum=sums[4],
            label_sum=sums[5] if has_label else None,
        )
        if tr is not None:
            tr.observe(window_start_ms, "merge", time.perf_counter() - t0)
        return self._assemble(agg, window_start_ms, window_end_ms)

    def _assemble(
        self, agg: EdgeAggregate, window_start_ms: int, window_end_ms: int
    ) -> GraphBatch:
        """EdgeAggregate → GraphBatch: edge/node feature matrices, the
        optional locality renumber, pad/bucket. The ONE feature-assembly
        definition the direct and sharded-merge paths share — two copies
        could drift."""
        tr = self.tracer
        t0 = time.perf_counter() if tr is not None else 0.0
        n_edges = agg.n_edges
        e_src, e_dst, e_type = agg.e_src, agg.e_dst, agg.e_type
        count = agg.count
        lat_sum, lat_max = agg.lat_sum, agg.lat_max
        err5_sum, err4_sum, tls_sum = agg.err5_sum, agg.err4_sum, agg.tls_sum
        label_sum = agg.label_sum

        # -- node features ---------------------------------------------------
        # Everything here derives from the EDGE aggregates (sums of sums
        # of the per-row stats — exact, the inputs are integer-valued),
        # so the sharded merge needs no row-level columns. Computed from
        # the FULL aggregate, BEFORE any degree-cap sampling: the host
        # knows the true totals, so a hot-key dst keeps its real
        # in-degree/in-count/in-error signal even when its edge list is
        # cut — the anomaly stays visible while the batch stays bounded.
        n_nodes = len(self.nodes)
        node_type = self.nodes.types_array()
        nf = np.zeros((n_nodes, NODE_FEATURE_DIM), dtype=np.float32)
        for t in range(4):
            nf[:, t] = node_type == t
        out_cnt = np.bincount(e_src, weights=count, minlength=n_nodes)
        in_cnt = np.bincount(e_dst, weights=count, minlength=n_nodes)
        out_err = np.bincount(e_src, weights=err5_sum, minlength=n_nodes)
        in_err = np.bincount(e_dst, weights=err5_sum, minlength=n_nodes)
        out_lat = np.bincount(e_src, weights=lat_sum, minlength=n_nodes)
        in_lat = np.bincount(e_dst, weights=lat_sum, minlength=n_nodes)
        out_deg = np.bincount(e_src, minlength=n_nodes).astype(np.float64)
        in_deg = np.bincount(e_dst, minlength=n_nodes).astype(np.float64)
        nf[:, 4] = np.log1p(out_cnt)
        nf[:, 5] = np.log1p(in_cnt)
        nf[:, 6] = out_err / np.maximum(out_cnt, 1.0)
        nf[:, 7] = in_err / np.maximum(in_cnt, 1.0)
        nf[:, 8] = np.log1p(out_lat / np.maximum(out_cnt, 1.0)) / 20.0
        nf[:, 9] = np.log1p(in_lat / np.maximum(in_cnt, 1.0)) / 20.0
        nf[:, 10] = np.log1p(out_deg)
        nf[:, 11] = np.log1p(in_deg)

        # -- degree-capped sampling --------------------------------
        # n_edges <= cap is a free sufficient no-op check; past it, one
        # O(E) bincount decides whether any dst actually exceeds the cap
        # (the steady-state service map never does — this path costs one
        # bincount until the day a hot key shows up). The `sample` span
        # stage times this whole block — with no cap it measures the
        # decision branch, so the stage is nonzero in EVERY pipeline and
        # the span-completeness gate needs no cap conditional.
        ts0 = time.perf_counter() if tr is not None else 0.0
        if 0 < self.degree_cap < n_edges and int(in_deg.max()) > self.degree_cap:
            uids = self.nodes.uids_array()
            prio = sample_priorities(
                self.sample_seed, window_start_ms,
                uids[e_dst], uids[e_src], e_type,
            )
            keep = degree_cap_select(e_dst, prio, self.degree_cap)
            if keep.shape[0] < n_edges:
                cut_edges = n_edges - int(keep.shape[0])
                total_rows = int(round(float(count.sum())))
                e_src, e_dst, e_type = e_src[keep], e_dst[keep], e_type[keep]
                count = count[keep]
                lat_sum, lat_max = lat_sum[keep], lat_max[keep]
                err5_sum, err4_sum = err5_sum[keep], err4_sum[keep]
                tls_sum = tls_sum[keep]
                if label_sum is not None:
                    label_sum = label_sum[keep]
                cut_rows = total_rows - int(round(float(count.sum())))
                n_edges = int(keep.shape[0])
                self.sampled_edges += cut_edges
                self.sampled_rows += cut_rows
                if self.ledger is not None:
                    self.ledger.add("sampled", cut_rows, reason="degree_cap")
        sample_s = (time.perf_counter() - ts0) if tr is not None else 0.0

        window_s = max(self.window_s, 1e-6)
        mean_lat = lat_sum / np.maximum(count, 1.0)
        ef = np.zeros((n_edges, EDGE_FEATURE_DIM), dtype=np.float32)
        ef[:, 0] = np.log1p(count)
        ef[:, 1] = np.log1p(mean_lat) / 20.0
        ef[:, 2] = np.log1p(lat_max) / 20.0
        ef[:, 3] = err5_sum / np.maximum(count, 1.0)
        ef[:, 4] = err4_sum / np.maximum(count, 1.0)
        ef[:, 5] = tls_sum / np.maximum(count, 1.0)
        ef[:, 6] = np.log1p(count / window_s)
        # slots 7..15: protocol one-hot. Folding the edge-type embedding
        # into the edge features lets models learn type offsets through
        # their edge-feature projection instead of a per-edge embedding
        # gather — a [1M]-row gather costs ~9ms/step on TPU (row-op bound)
        # while these host-side writes are free.
        proto_idx = np.clip(e_type, 0, 8)
        ef[np.arange(n_edges), 7 + proto_idx] = 1.0

        el = None
        if label_sum is not None:
            el = (label_sum > 0).astype(np.float32)

        node_uids = self.nodes.uids_array()
        if self.renumber and n_edges > 0:
            # weight the modal vote by request count: heavy home-service
            # traffic must outrank one-off noise pairs on aggregated edges
            perm = cluster_renumber(e_src, e_dst, n_nodes, edge_weight=count)
            e_src, e_dst, nf, node_type, node_uids = apply_renumber(
                perm, e_src, e_dst, nf, node_type, node_uids
            )

        batch = GraphBatch.build(
            node_feats=nf,
            node_type=node_type,
            edge_src=e_src,
            edge_dst=e_dst,
            edge_type=e_type,
            edge_feats=ef,
            edge_label=el,
            node_uids=node_uids,
            window_start_ms=window_start_ms,
            window_end_ms=window_end_ms,
            # already dst-sorted by the dst-major group key (the
            # renumber path remaps endpoints, so its edges must re-sort)
            sort_by_dst=self.renumber and n_edges > 0,
        )
        self.assembled_edge_rows += batch.n_edges
        self.assembled_pad_slots += batch.pad_edge_slots
        if self.edge_layout == "blocked":
            # eager extent fill AT CLOSE: block_starts caches into the
            # batch, so staging/scoring consume the window invariant
            # without recomputing the searchsorted, and the telemetry
            # plane reads `edge_block_starts is not None` as the
            # blocked-window signal (obs/device.py observe_staged)
            batch.block_starts()
            self.assembled_block_slots += batch.blocked_edge_slots
        if tr is not None:
            tr.observe(window_start_ms, "sample", sample_s)
            tr.observe(
                window_start_ms, "assemble",
                (time.perf_counter() - t0) - sample_s,
            )
        return batch


class WindowedGraphStore(BaseDataStore):
    """DataStore sink: buckets persisted requests into time windows and
    emits a GraphBatch per closed window via ``on_batch`` (or an internal
    list). Windows close when a request arrives ≥1 window past their end
    (watermark), or on ``flush()``."""

    def __init__(
        self,
        interner: Interner,
        window_s: float = 1.0,
        on_batch: Optional[Callable[[GraphBatch], None]] = None,
        label_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        renumber: bool = False,
        ledger=None,
        degree_cap: int = 0,
        sample_seed: int = 0,
        tracer: Optional[SpanTracer] = None,
        edge_layout: Optional[str] = None,
    ):
        self.interner = interner
        self.window_s = window_s
        self.window_ms = int(window_s * 1000)
        self.on_batch = on_batch
        self.label_fn = label_fn
        # shared DropLedger: late stragglers attribute there in
        # addition to the store-local counter; degree-cap cuts
        # attribute through the builder as `sampled`
        self.ledger = ledger
        # window-lifecycle span plane: ON by default — a store
        # with no caller-supplied tracer keeps a private one whose spans
        # complete at emit (no scorer behind it). The service passes its
        # metrics-registered tracer instead, which stays open through
        # score/export. Cost is per window×stage, never per row.
        if tracer is None:
            tracer = SpanTracer(complete_at_emit=True)
        self.tracer = tracer
        self.builder = GraphBuilder(
            window_s=window_s, renumber=renumber,
            degree_cap=degree_cap, sample_seed=sample_seed, ledger=ledger,
            tracer=tracer, edge_layout=edge_layout,
        )
        self.batches: List[GraphBatch] = []
        self.request_count = 0  # guarded-by: self._lock
        self.late_dropped = 0  # guarded-by: self._lock
        self.last_persist_monotonic: float | None = None  # guarded-by: self._lock
        self._pending: dict[int, List[np.ndarray]] = {}
        self._watermark = -1  # guarded-by: self._lock
        self._closed_upto = -1
        self._lock = threading.Lock()

    # -- DataStore surface -------------------------------------------------

    def persist_requests(self, batch: np.ndarray) -> None:
        with self._lock:
            self.last_persist_monotonic = time.monotonic()
            self.request_count += batch.shape[0]
            if batch.shape[0] == 0:
                return
            wids = batch["start_time_ms"] // self.window_ms
            wmin, wmax = int(wids.min()), int(wids.max())
            if wmin == wmax:
                # the dominant steady-state shape: a whole chunk inside
                # one window — no sort, no per-window masking. Copy: the
                # rows are retained across calls and the caller may
                # reuse its buffer.
                present: np.ndarray | List[int] = [wmin]
            elif wmax - wmin < (1 << 20):
                # ascending like np.unique, but via one O(n) presence
                # bincount instead of a sort
                present = np.flatnonzero(np.bincount(wids - wmin)) + wmin
            else:  # degenerate timestamps: don't size a bincount by span
                present = np.unique(wids)
            for w in present:
                w = int(w)
                if w <= self._closed_upto:
                    # stragglers for an already-emitted window (e.g. the
                    # aggregator's retry path): drop, never re-emit a
                    # window — and never pay the row copy for them
                    k = batch.shape[0] if wmin == wmax else int((wids == w).sum())
                    self.late_dropped += k
                    if self.ledger is not None:
                        self.ledger.add("late", k)
                    continue
                rows = batch.copy() if wmin == wmax else batch[wids == w]
                self._pending.setdefault(w, []).append(rows)
                # span origin: idempotent, first call per window wins
                # (lock order: store lock → tracer lock, one direction)
                self.tracer.first_row(w * self.window_ms)
                if w > self._watermark:
                    self._watermark = w
            self._close_upto(self._watermark - 1)

    def persist_kafka_events(self, batch: np.ndarray) -> None:
        pass  # kafka edges already flow through persist_requests in topology terms

    def persist_alive_connections(self, batch: np.ndarray) -> None:
        pass

    def persist_resource(self, rtype: ResourceType, event: EventType, obj: Any) -> None:
        pass  # node metadata arrives via the aggregator's cluster state

    # -- window lifecycle --------------------------------------------------

    def _close_upto(self, upto: int) -> None:
        done = [w for w in self._pending if w <= upto]
        if done:
            self._closed_upto = max(self._closed_upto, max(done))
        for w in sorted(done):
            ws_ms = w * self.window_ms
            # the close reached this window: open-window residency since
            # first_row becomes the `scatter` stage
            self.tracer.close_start(ws_ms)
            tc0 = time.perf_counter()
            parts = self._pending.pop(w)
            rows = np.concatenate(parts) if len(parts) > 1 else parts[0]
            labels = self.label_fn(rows) if self.label_fn is not None else None
            # serial path: the pop+concat+label step is this window's
            # whole per-shard close (one shard — the store itself)
            self.tracer.observe(ws_ms, "shard_close", time.perf_counter() - tc0)
            batch = self.builder.build(
                rows,
                window_start_ms=ws_ms,
                window_end_ms=(w + 1) * self.window_ms,
                edge_label=labels,
            )
            if self.on_batch is not None:
                self.on_batch(batch)
            else:
                self.batches.append(batch)  # alazlint: disable=ALZ050 -- every close path appends under _lock (ingest/flush callers); scenario replay's batches read is a single-threaded epilogue after flush() returns
            self.tracer.emit(ws_ms)

    def flush(self) -> None:
        with self._lock:
            self._close_upto(self._watermark)
