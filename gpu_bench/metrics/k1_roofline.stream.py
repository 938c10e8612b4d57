"""K1, the sorted segment sum (``scatter_sum_sorted_kernel``), in TGN's
encoder, which is GraphSAGE's: as ``k1_roofline`` reads it, each launch's
bytes GraphSAGE's count (``yardstick.sorted_segment_sum_bytes``) over the
padded shapes, over the HBM rate, against the launches' device time."""

from gpu_bench import trace, yardstick

PATTERNS = (r"scatter_sum_sorted_kernel",)


def read(run):
    per_launch = yardstick.sorted_segment_sum_bytes(dict(run["cfg"], model="graphsage"), run["n_pad"], run["e_pad"])
    return trace.roofline(run, "k1", PATTERNS, PATTERNS, per_launch)
