"""Windowed COO graph batches for the device."""

from alaz_tpu_torch.graph.snapshot import EDGE_BLOCK_ROWS, GraphBatch, pad_to_bucket

__all__ = ["EDGE_BLOCK_ROWS", "GraphBatch", "pad_to_bucket"]
