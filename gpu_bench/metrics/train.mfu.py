"""The whole train step's share of the chip's bf16 peak: the matrix products
of a forward and its backward (``yardstick.train_flops``) over the
window's real nodes and edges, times the steps, over the window's seconds."""

from gpu_bench import yardstick


def read(run):
    if not run.get("steps"):
        return None
    flops = yardstick.train_flops(run["cfg"], run["n_nodes"], run["n_edges"]) * run["steps"]
    return yardstick.mfu_pct(flops, run["seconds"])
