"""The port's stable sort of the ids (``alaz_sort_by_ids``: upsweep, scan
and downsweep kernels) in K3's backward: 12 bytes an edge a sort
(``yardstick.sort_bytes``) over the HBM rate, against the device time of
its launches. A sort is its passes' three kernels, counted by the
downsweeps (one a pass); a sort cut by the window's edges counts in part."""

import math

from gpu_bench import trace, yardstick

PATTERNS = (r"sort_upsweep_kernel", r"sort_scan_kernel", r"sort_downsweep_kernel")
PASS_BITS = 9  # the sort's radix: at most 9 bits a pass


def read(run):
    # keys run over [0, n_pad + 1]: the ids clamped to [-1, n_pad], plus one
    passes = math.ceil(math.ceil(math.log2(run["n_pad"] + 2)) / PASS_BITS)
    return trace.roofline(run, "sort", PATTERNS, (r"sort_downsweep_kernel",), yardstick.sort_bytes(run["e_pad"]) / passes)
