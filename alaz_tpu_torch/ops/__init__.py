"""Sparse message-passing primitives for the H100.

``segment``: segment sums and gathers, dispatching the sorted ops to the
hand-written kernels. ``segment_kernels``: the kernels' wrappers, plain
versions and launch counters. The CUDA sources are in ``csrc/``.
"""
