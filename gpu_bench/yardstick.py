"""The yardstick: published peaks, the operation and byte counts of the
models' steps and kernels, and the statistics every metric is taken with.

Nothing here imports the program: the counts follow the GraphSAGE and GAT
equations (``reference.py`` computes the same equations), so a change to
the program cannot move them.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity): 989
TFLOP/s in bf16, 3.35 TB/s of HBM. They assume the full 700 W; the run
prints the card's power limit beside its numbers.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

BF16_FLOPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12

# the leading edge-feature columns the model z-scores per window
EDGE_STAT_COLS = 7
BF16, F32, I32 = 2, 4, 4


# -- statistics -------------------------------------------------------------


def p95(samples: Sequence[float]) -> float | None:
    """The 95th percentile of every sample (linear interpolation between
    order statistics), or None with no sample."""
    if len(samples) == 0:
        return None
    return float(np.percentile(np.asarray(samples, dtype=np.float64), 95))


def rate(count: float, seconds: float) -> float:
    """All the work over all the time of a window."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return count / seconds


# -- model shapes -------------------------------------------------------------


def edge_feat_dim_in(cfg: dict) -> int:
    return cfg["edge_feature_dim"] + (EDGE_STAT_COLS if cfg["edge_feat_znorm"] else 0)


def _matmuls(cfg: dict, n: int, e: int) -> list:
    """Every matrix product of one forward: (name, flops, x_needs_grad,
    on_loss_path). ``x_needs_grad``: the left operand depends on the
    params, so a backward forms its gradient too; ``on_loss_path``: the
    edge loss reaches it (the node head's does not)."""
    h, fn, ef = cfg["hidden_dim"], cfg["node_feature_dim"], edge_feat_dim_in(cfg)
    mm = [("embed", 2 * n * fn * h, False, True)]
    for layer in range(cfg["num_layers"]):
        if cfg["model"] == "graphsage":
            mm += [
                (f"l{layer}.msg", 2 * n * h * h, True, True),
                (f"l{layer}.edge_proj", 2 * e * ef * h, False, True),
                (f"l{layer}.self", 2 * n * h * h, True, True),
                (f"l{layer}.neigh", 2 * n * h * h, True, True),
            ]
        elif cfg["model"] == "gat":
            mm += [
                (f"l{layer}.q", 2 * n * h * h, True, True),
                (f"l{layer}.kv", 2 * n * h * h, True, True),
                (f"l{layer}.edge_proj", 2 * e * ef * h, False, True),
                # the attention vector's three dot products a head
                (f"l{layer}.attn_q", 2 * n * h, True, True),
                (f"l{layer}.attn_k", 2 * e * h, True, True),
                (f"l{layer}.attn_e", 2 * e * h, True, True),
                (f"l{layer}.out", 2 * n * h * h, True, True),
            ]
        else:
            raise ValueError(f"no operation count for model {cfg['model']!r}")
    mm += [
        ("edge_head.src", 2 * n * h * h, True, True),
        ("edge_head.dst", 2 * n * h * h, True, True),
        ("edge_head.ef", 2 * e * ef * h, False, True),
        ("edge_head.out", 2 * e * h, True, True),
        ("node_head.0", 2 * n * h * h, True, False),
        ("node_head.1", 2 * n * h, True, False),
    ]
    return mm


def forward_flops(cfg: dict, n_nodes: int, n_edges: int) -> int:
    """Matrix-product operations of one forward over the window's real
    nodes and edges (element-wise work is not counted)."""
    return sum(f for _, f, _, _ in _matmuls(cfg, n_nodes, n_edges))


def train_flops(cfg: dict, n_nodes: int, n_edges: int) -> int:
    """One train step: the forward, and for every product the loss
    reaches, the weight gradient and (where the left operand depends on
    the params) the input gradient, each as many operations as the
    forward product."""
    total = 0
    for _, f, x_grad, on_path in _matmuls(cfg, n_nodes, n_edges):
        total += f
        if on_path:
            total += f * (2 if x_grad else 1)
    return total


# -- kernel operations: bytes of one launch -------------------------------------
# Each input read once and each output written once, over the tensors the
# operation is handed (padded shapes: ``n_pad`` rows, ``e_pad`` edges).


def sorted_segment_sum_bytes(cfg: dict, n_pad: int, e_pad: int) -> int:
    """K1: ``out[d] = Σ_{dst[e]=d} msgs[e]`` over dst-sorted edges. GraphSAGE
    sums its bf16 messages into bf16 rows; GAT sums the bf16 messages and
    the exp column of each head into f32 rows."""
    h = cfg["hidden_dim"]
    if cfg["model"] == "graphsage":
        f, out_b = h, BF16
    elif cfg["model"] == "gat":
        f, out_b = h + cfg["num_heads"], F32
    else:
        raise ValueError(f"no K1 count for model {cfg['model']!r}")
    return e_pad * (f * BF16 + I32) + n_pad * f * out_b


def row_gather_bytes(cfg: dict, n_pad: int, e_pad: int) -> int:
    """K3: ``out[e] = v[ids[e]]`` for unsorted ids, bf16 rows of the hidden
    width (GAT's key-value rows and the edge head's source side)."""
    h = cfg["hidden_dim"]
    return n_pad * h * BF16 + e_pad * I32 + e_pad * h * BF16


def unsorted_segment_sum_bytes(cfg: dict, n_pad: int, e_pad: int) -> int:
    """K4 in K3's backward: ``dv[i] = Σ_{ids[e]=i} g[e]``, the bf16 gradient
    rows gathered through the sort's permutation into the sorted ids' rows."""
    h = cfg["hidden_dim"]
    return e_pad * h * BF16 + 2 * e_pad * I32 + n_pad * h * BF16


def sort_bytes(e_pad: int) -> int:
    """The stable sort of int32 ids: the keys read, the sorted keys and the
    permutation written."""
    return 12 * e_pad


def roofline_pct(bytes_moved: float, flops: float, device_s: float, flops_per_s: float = BF16_FLOPS_PER_S) -> float:
    """The least time the chip could take (the larger of the bytes over the
    HBM rate and the operations over the peak) over the time taken, in %."""
    if device_s <= 0:
        raise ValueError(f"device time {device_s}")
    least = max(bytes_moved / HBM_BYTES_PER_S, flops / flops_per_s)
    return 100.0 * least / device_s


def mfu_pct(flops: float, seconds: float) -> float:
    return 100.0 * flops / (seconds * BF16_FLOPS_PER_S)
