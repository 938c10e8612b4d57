"""K4, the fused gather and sorted segment sum, as K3's backward runs it
(``block_starts_kernel``, ``gather_scatter_tile_kernel``,
``gather_scatter_carry_kernel``): the bytes of one such sum
(``yardstick.unsorted_segment_sum_bytes``) a tile kernel launch, over the
HBM rate, against the device time of all three kernels."""

from gpu_bench import trace, yardstick

PATTERNS = (r"block_starts_kernel", r"gather_scatter_tile_kernel", r"gather_scatter_carry_kernel")


def read(run):
    per_sum = yardstick.unsorted_segment_sum_bytes(run["cfg"], run["n_pad"], run["e_pad"])
    return trace.roofline(run, "k4", PATTERNS, (r"gather_scatter_tile_kernel",), per_sum)
