"""The edge-type experts' counts (``reference_experts.py`` computes the
same equations): the matrix-product operations of one forward, and the
minimal bytes of one layer's expert dispatch. Neither depends on how the
program dispatches, so a later dispatch is read against the same work.
Nothing here imports the program."""

from __future__ import annotations

from gpu_bench import yardstick
from gpu_bench.yardstick import BF16, F32, I32


def forward_flops(cfg: dict, n_nodes: int, n_edges: int) -> int:
    """One forward over the window's real nodes and edges: GraphSAGE's
    products (``yardstick.forward_flops``) with each layer's message
    product ``2·N·H·H`` replaced by the routed one, ``2·E·H·H``: each
    real edge's ``h[src]`` row times its expert's weight (element-wise
    work is not counted)."""
    h, layers = cfg["hidden_dim"], cfg["num_layers"]
    sage = yardstick.forward_flops(dict(cfg, model="graphsage"), n_nodes, n_edges)
    return sage - layers * 2 * n_nodes * h * h + layers * 2 * n_edges * h * h


def dispatch_bytes(cfg: dict, e_pad: int) -> int:
    """One layer's routed dispatch over ``e_pad`` edge slots, each input
    read once and the output written once: each slot's src and type ids
    and its ``h`` row (the compute dtype) read, its message (the compute
    dtype) written; the experts' weights ``[T, H, H]`` and biases
    ``[T, H]`` (f32) read once. The bound of a dispatch roofline that
    reads the dispatch's kernels from the device trace; no metric reads it
    yet."""
    h, t = cfg["hidden_dim"], cfg["num_edge_types"]
    h_bytes = BF16 if cfg["dtype"] == "bfloat16" else F32
    return e_pad * (2 * I32 + 2 * h * h_bytes) + t * (h * h + h) * F32
