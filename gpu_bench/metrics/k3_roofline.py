"""K3, the banded row gather (``gather_rows_banded_kernel``): its launches'
bytes (``yardstick.row_gather_bytes``) over the HBM rate, against their
device time."""

from gpu_bench import trace, yardstick

PATTERNS = (r"gather_rows_banded_kernel",)


def read(run):
    per_launch = yardstick.row_gather_bytes(run["cfg"], run["n_pad"], run["e_pad"])
    return trace.roofline(run, "k3", PATTERNS, PATTERNS, per_launch)
