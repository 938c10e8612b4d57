"""Sparse message-passing primitives for the H100.

``segment``: segment sums and gathers, dispatching the sorted ops and the
banded src gather to the hand-written kernels. ``segment_kernels``: the
kernels' wrappers, plain versions and launch counters. The CUDA sources
are in ``csrc/``.
"""

from alaz_tpu_torch.ops.segment import gather_scatter_sum, segment_mean, segment_softmax, segment_sum

__all__ = [
    "gather_scatter_sum",
    "segment_mean",
    "segment_softmax",
    "segment_sum",
]
