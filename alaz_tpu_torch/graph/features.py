"""Feature widths of the window builder.

Copies of the JAX package's ``graph/builder.py`` constants: the port
scores windows of the same widths. ``apply_renumber`` lives in
``graph/builder.py`` and is re-exported here under its old import path.
"""

from __future__ import annotations

from alaz_tpu_torch.graph.builder import apply_renumber

NODE_FEATURE_DIM = 32
EDGE_FEATURE_DIM = 16

__all__ = ["EDGE_FEATURE_DIM", "NODE_FEATURE_DIM", "apply_renumber"]
