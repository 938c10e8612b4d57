"""The TGN step's counts (``reference_tgn.py`` computes the same
equations): the matrix-product operations of one window, and the minimal
bytes of its memory update. Nothing here imports the program."""

from __future__ import annotations

from gpu_bench import yardstick
from gpu_bench.yardstick import BF16, F32

MASK = 1  # a bool a node slot


def step_flops(cfg: dict, n_nodes: int, n_edges: int) -> int:
    """One window over its real nodes and edges: the GraphSAGE encoder's
    forward (``yardstick.forward_flops``), the memory's input projection
    ``W_m·m`` and the GRU's three ``[N, 2H] × [2H, H]`` products
    (element-wise work is not counted)."""
    h = cfg["hidden_dim"]
    encoder = yardstick.forward_flops(dict(cfg, model="graphsage"), n_nodes, n_edges)
    return encoder + 2 * n_nodes * h * h + 3 * 2 * n_nodes * 2 * h * h


def memory_update_bytes(cfg: dict, rows: int) -> int:
    """The memory update over ``rows`` node slots (the node bucket), each
    input read once and the output written once: ``m_{t-1}`` (f32), the
    node states ``h_t`` (the compute dtype) and the node mask read,
    ``m_t`` (f32) written, and the GRU's weights and biases (f32) read."""
    h = cfg["hidden_dim"]
    h_bytes = BF16 if cfg["dtype"] == "bfloat16" else F32
    weights = 3 * (2 * h * h + h) * F32
    return rows * (h * F32 + h * h_bytes + MASK + h * F32) + weights
