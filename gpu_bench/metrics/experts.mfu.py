"""The whole experts step's share of the chip's bf16 peak: the matrix
products of one forward over the window's real nodes and edges, the
routed expert products over its edges (``yardstick_experts.forward_flops``),
times the windows scored in the traced window, over the card's busy time
in it (the step's time on the device, as ``window_device_ms`` takes it)."""

from gpu_bench import yardstick, yardstick_experts


def read(run):
    tr = run.get("trace")
    if not run.get("windows_scored") or tr is None or tr.busy_s <= 0:
        return None
    flops = yardstick_experts.forward_flops(run["cfg"], run["n_nodes"], run["n_edges"]) * run["windows_scored"]
    return yardstick.mfu_pct(flops, tr.busy_s)
