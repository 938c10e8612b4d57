"""K1, the sorted segment sum (``scatter_sum_sorted_kernel``): its launches'
bytes (``yardstick.sorted_segment_sum_bytes``: each input read once, each
output written once) over the HBM rate, against their device time."""

from gpu_bench import trace, yardstick

PATTERNS = (r"scatter_sum_sorted_kernel",)


def read(run):
    per_launch = yardstick.sorted_segment_sum_bytes(run["cfg"], run["n_pad"], run["e_pad"])
    return trace.roofline(run, "k1", PATTERNS, PATTERNS, per_launch)
