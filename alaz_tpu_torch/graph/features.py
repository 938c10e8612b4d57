"""Feature widths and node renumbering of the window builder.

Copies of the JAX package's ``graph/builder.py`` constants and
``apply_renumber``: the port scores windows of the same widths.
"""

from __future__ import annotations

import numpy as np

NODE_FEATURE_DIM = 32
EDGE_FEATURE_DIM = 16


def apply_renumber(
    perm: np.ndarray,
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    *node_arrays: np.ndarray,
) -> tuple:
    """Apply a node permutation: edge endpoints are remapped through
    ``perm`` and every per-node array is reordered so row ``perm[i]`` of
    the output is row ``i`` of the input."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
    out_nodes = tuple(a[inv] for a in node_arrays)
    return (perm[edge_src], perm[edge_dst]) + out_nodes
