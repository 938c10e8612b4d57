"""GraphBatch: the static-shape unit of device work.

A window's service graph is padded to a **bucketed** size (powers of two
with 1.5x midpoints) and the padding masked out, so the device sees few
distinct shapes. A copy of the JAX package's ``graph/snapshot.py``: the
two packages must build bit-identical batches from the same arrays.

All arrays are plain numpy. Fields:

- ``node_feats``  [N_pad, F]   float32 (cast to the compute dtype in the model)
- ``node_type``   [N_pad]      int32
- ``node_mask``   [N_pad]      bool
- ``edge_src/dst``[E_pad]      int32 (indices into the node axis)
- ``edge_type``   [E_pad]      int32 (L7 protocol codes)
- ``edge_feats``  [E_pad, Fe]  float32
- ``edge_mask``   [E_pad]      bool
- ``edge_label``  [E_pad]      float32 (fault labels when known; else 0)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

_BUCKET_STEPS = (128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536, 131072, 262144, 524288, 1048576)

# dst-block geometry of the blocked edge layout: one block per 128 node
# rows. Every bucket rung is a multiple of this, so extents always tile.
EDGE_BLOCK_ROWS = 128


def edge_block_starts_from(
    edge_dst: np.ndarray, n_edges: int, n_pad: int
) -> np.ndarray:
    """Blocked-CSR row starts over the REAL edge prefix: entry ``b`` is
    the first edge whose dst lands at or past node row 128·b, so dst
    block ``b`` owns edges ``[starts[b], starts[b+1])`` and
    ``starts[-1] == n_edges`` is the live-edge frontier. Precondition:
    ``edge_dst[:n_edges]`` dst-sorted. The pad tail is excluded by the
    prefix slice, so pad edges are invisible to the extents."""
    bounds = np.arange(0, n_pad + 1, EDGE_BLOCK_ROWS, dtype=np.int64)
    return np.searchsorted(edge_dst[:n_edges], bounds, side="left").astype(
        np.int32
    )


def blocked_edge_slots_from(block_starts: np.ndarray) -> int:
    """Edge-tile slots the blocked aggregation paths touch: each
    NONEMPTY dst block costs its extent rounded out to whole 128-edge
    tiles (a tile straddled by two blocks is charged to both); empty
    blocks cost nothing."""
    bs = block_starts.astype(np.int64)
    lo, hi = bs[:-1], bs[1:]
    tiles = np.where(
        hi > lo,
        -(-hi // EDGE_BLOCK_ROWS) - lo // EDGE_BLOCK_ROWS,
        0,
    )
    return int(tiles.sum()) * EDGE_BLOCK_ROWS


def pad_to_bucket(n: int, minimum: int = 128) -> int:
    """Next bucket ≥ n: powers of two with 1.5× midpoints (from 256 up, so
    every bucket stays a multiple of 128), capping padding waste at ~25%
    while keeping the shape count small."""
    n = max(n, minimum)
    for b in _BUCKET_STEPS:
        if n <= b:
            return b
        mid = b + b // 2
        if b >= 256 and n <= mid:
            return mid
    return int(2 ** np.ceil(np.log2(n)))


@dataclass
class GraphBatch:
    node_feats: np.ndarray  # [N_pad, F] f32
    node_type: np.ndarray  # [N_pad] i32
    node_mask: np.ndarray  # [N_pad] bool
    edge_src: np.ndarray  # [E_pad] i32
    edge_dst: np.ndarray  # [E_pad] i32
    edge_type: np.ndarray  # [E_pad] i32
    edge_feats: np.ndarray  # [E_pad, Fe] f32
    edge_mask: np.ndarray  # [E_pad] bool
    edge_label: np.ndarray  # [E_pad] f32
    n_nodes: int
    n_edges: int
    window_start_ms: int = 0
    window_end_ms: int = 0
    # node slot -> interned uid (host-side bookkeeping, not shipped)
    node_uids: Optional[np.ndarray] = field(default=None, repr=False)
    # [N_pad] f32 masked in-degree: a window invariant, computed once on
    # the host (one bincount). Lazily filled by device_arrays.
    node_deg: Optional[np.ndarray] = field(default=None, repr=False)
    # [N_pad//128 + 1] i32 blocked-CSR row starts over the real edge
    # prefix, shipped only under the blocked layout. Lazily filled by
    # block_starts().
    edge_block_starts: Optional[np.ndarray] = field(default=None, repr=False)

    @property
    def n_pad(self) -> int:
        return self.node_feats.shape[0]

    @property
    def e_pad(self) -> int:
        return self.edge_src.shape[0]

    @property
    def bucket_key(self) -> str:
        """The (node, edge) capacity label this batch scores under."""
        return f"n{self.n_pad}xe{self.e_pad}"

    @property
    def pad_edge_slots(self) -> int:
        """Edge slots in the bucket that carry padding, not data."""
        return self.e_pad - self.n_edges

    @property
    def edge_occupancy(self) -> float:
        """Real-edge fraction of the edge bucket (0..1)."""
        return self.n_edges / self.e_pad if self.e_pad else 0.0

    def aggregated_rows(self) -> int:
        """Exact request-row count this window aggregated: edge feature
        0 is log1p(request count), so the inverse recovers the total."""
        return int(
            np.rint(np.expm1(self.edge_feats[: self.n_edges, 0])).sum()
        )

    def block_starts(self) -> np.ndarray:
        """The blocked layout's per-128-dst-row extents (lazy window
        invariant, see ``edge_block_starts_from``)."""
        if self.edge_block_starts is None:
            self.edge_block_starts = edge_block_starts_from(
                self.edge_dst, self.n_edges, self.n_pad
            )
        return self.edge_block_starts

    @property
    def blocked_edge_slots(self) -> int:
        """Edge-tile slots the blocked paths touch for this window."""
        return blocked_edge_slots_from(self.block_starts())

    def device_arrays(self, edge_layout: str = "coo") -> dict:
        """The arrays the model consumes (static shapes only).
        ``edge_layout="blocked"`` adds the ``edge_block_starts``
        extents."""
        if self.node_deg is None:
            # pad edges sit masked on the last node slot and are excluded
            # by the [:n_edges] slice, so this equals the in-model
            # masked_degree exactly (models/common.py)
            self.node_deg = np.bincount(
                self.edge_dst[: self.n_edges], minlength=self.n_pad
            ).astype(np.float32)
        out = {
            "node_feats": self.node_feats,
            "node_type": self.node_type,
            "node_mask": self.node_mask,
            "node_deg": self.node_deg,
            "edge_src": self.edge_src,
            "edge_dst": self.edge_dst,
            "edge_type": self.edge_type,
            "edge_feats": self.edge_feats,
            "edge_mask": self.edge_mask,
        }
        if edge_layout == "blocked":
            out["edge_block_starts"] = self.block_starts()
        return out

    @staticmethod
    def from_presorted(
        node_feats: np.ndarray,
        node_type: np.ndarray,
        edge_src: np.ndarray,
        edge_dst: np.ndarray,
        edge_type: np.ndarray,
        edge_feats: np.ndarray,
        n_nodes: int,
        n_edges: int,
        node_uids: Optional[np.ndarray] = None,
        window_start_ms: int = 0,
        window_end_ms: int = 0,
    ) -> "GraphBatch":
        """Wrap ALREADY dst-sorted, already PADDED arrays into a
        GraphBatch. Owns the pad-slot policy so it cannot diverge from
        ``build``: pad dsts land on the masked last node slot, pad srcs
        repeat the last real src.

        OWNERSHIP TRANSFER: the input arrays become the batch's arrays,
        with no copies, and the edge_src/edge_dst pad tails are rewritten
        in place. Callers hand over freshly allocated, writable buffers
        and do not reuse them afterwards."""
        e_pad = edge_src.shape[0]
        n_pad = node_feats.shape[0]
        edge_src[n_edges:] = edge_src[n_edges - 1] if n_edges > 0 else 0
        edge_dst[n_edges:] = n_pad - 1
        edge_mask = np.zeros(e_pad, dtype=bool)
        edge_mask[:n_edges] = True
        node_mask = np.zeros(n_pad, dtype=bool)
        node_mask[:n_nodes] = True
        return GraphBatch(
            node_feats=node_feats,
            node_type=node_type,
            node_mask=node_mask,
            edge_src=edge_src,
            edge_dst=edge_dst,
            edge_type=edge_type,
            edge_feats=edge_feats,
            edge_mask=edge_mask,
            edge_label=np.zeros(e_pad, dtype=np.float32),
            n_nodes=n_nodes,
            n_edges=n_edges,
            window_start_ms=window_start_ms,
            window_end_ms=window_end_ms,
            node_uids=node_uids,
        )

    @staticmethod
    def build(
        node_feats: np.ndarray,
        node_type: np.ndarray,
        edge_src: np.ndarray,
        edge_dst: np.ndarray,
        edge_type: np.ndarray,
        edge_feats: np.ndarray,
        edge_label: Optional[np.ndarray] = None,
        node_uids: Optional[np.ndarray] = None,
        window_start_ms: int = 0,
        window_end_ms: int = 0,
        sort_by_dst: bool = True,
    ) -> "GraphBatch":
        """Pad/bucket raw COO arrays into a GraphBatch. Edges are sorted by
        destination so segment reductions see contiguous runs (the layout
        the sorted segment kernels require)."""
        n = int(node_feats.shape[0])
        e = int(edge_src.shape[0])
        n_pad = pad_to_bucket(n)
        e_pad = pad_to_bucket(e)

        if sort_by_dst and e > 0:
            order = np.argsort(edge_dst, kind="stable")
            edge_src = edge_src[order]
            edge_dst = edge_dst[order]
            edge_type = edge_type[order]
            edge_feats = edge_feats[order]
            if edge_label is not None:
                edge_label = edge_label[order]

        nf = np.zeros((n_pad, node_feats.shape[1]), dtype=np.float32)
        nf[:n] = node_feats
        nt = np.zeros(n_pad, dtype=np.int32)
        nt[:n] = node_type

        es = np.zeros(e_pad, dtype=np.int32)
        ed = np.zeros(e_pad, dtype=np.int32)
        et = np.zeros(e_pad, dtype=np.int32)
        ef = np.zeros((e_pad, edge_feats.shape[1]), dtype=np.float32)
        es[:e] = edge_src
        ed[:e] = edge_dst
        et[:e] = edge_type
        ef[:e] = edge_feats

        uids = None
        if node_uids is not None:
            uids = np.zeros(n_pad, dtype=np.int32)
            uids[:n] = node_uids

        # pad-slot policy lives in from_presorted, in one place only
        batch = GraphBatch.from_presorted(
            nf, nt, es, ed, et, ef, n, e,
            node_uids=uids,
            window_start_ms=window_start_ms,
            window_end_ms=window_end_ms,
        )
        if edge_label is not None:
            batch.edge_label[:e] = edge_label
        return batch
