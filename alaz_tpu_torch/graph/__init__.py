"""Graph batching: resolved edges → static-shape COO snapshots.

This is the bridge between the streaming data plane and the device: a
DataStore sink that accumulates REQUEST_DTYPE edges into time windows and
closes each window into a padded, bucketed :class:`GraphBatch` ready for
the model on the card. ``EDGE_BLOCK_ROWS`` is the blocked layout's tile
height.
"""

from alaz_tpu_torch.graph.snapshot import EDGE_BLOCK_ROWS, GraphBatch, pad_to_bucket
from alaz_tpu_torch.graph.builder import GraphBuilder, WindowedGraphStore

__all__ = ["EDGE_BLOCK_ROWS", "GraphBatch", "pad_to_bucket", "GraphBuilder", "WindowedGraphStore"]
