"""The window builder's node-renumbering pass and its locality gauges.

Copies of the JAX package's ``graph/builder.py`` ``cluster_renumber``,
``src_band_windows``, ``src_straggler_fraction``, ``src_locality_gauges``
and ``apply_renumber``: numpy only, and bit-identical to the originals
(``tests/test_torch_builder.py``).
"""

from __future__ import annotations

import numpy as np

from alaz_tpu_torch.ops.constants import BAND_WINDOWS, DMA_WINDOW, TILE_E


def cluster_renumber(
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    n_nodes: int,
    edge_weight: np.ndarray | None = None,
) -> np.ndarray:
    """Locality-oriented node renumbering: a permutation ``perm`` with
    ``perm[old_id] = new_id`` that places sources talking to the same
    destination in one contiguous id range, so the src-side gathers of a
    dst-sorted window read a narrow band of the node table.

    Ordering key per node: (its modal destination, out-traffic desc,
    old id); out-traffic is edge count when unweighted, total request
    weight otherwise. Nodes with no outgoing edges keep their relative
    order after all sources. ``edge_weight`` weights both the modal vote
    and the tiebreak."""
    if edge_src.shape[0] == 0:
        return np.arange(n_nodes, dtype=np.int32)
    # modal dst per src via (weighted) pair counting
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
    chunk's src ids span: ~1-4 after ``cluster_renumber`` on community
    maps, ~N/128 on uniform-random ids."""
    return src_locality_gauges(edge_src, n_nodes=0, tile=tile, window=window)[0]


def src_straggler_fraction(
    edge_src: np.ndarray,
    n_nodes: int,
    tile: int | None = None,
    window: int | None = None,
    band: int | None = None,
) -> float:
    """Fraction of edges whose src falls outside the fixed ``band``-window
    band centered on its chunk's median window: ≲0.15 after
    ``cluster_renumber`` on ~90%-local community maps, →1.0 on
    uniform-random ids."""
    return src_locality_gauges(edge_src, n_nodes, tile=tile, window=window, band=band)[1]


def src_locality_gauges(
    edge_src: np.ndarray,
    n_nodes: int,
    tile: int | None = None,
    window: int | None = None,
    band: int | None = None,
) -> tuple[float, float]:
    """(mean band windows, straggler fraction) in one pass over
    ``edge_src``. ``n_nodes`` ≤ 0 skips the straggler half (returns
    1.0)."""
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
    # ceil: a partial top window of the 128-padded node table is coverable
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
    """Apply a node permutation (``cluster_renumber``'s, or any other):
    edge endpoints are remapped through ``perm`` and every per-node array
    is reordered so row ``perm[i]`` of the output is row ``i`` of the
    input."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
    out_nodes = tuple(a[inv] for a in node_arrays)
    return (perm[edge_src], perm[edge_dst]) + out_nodes
