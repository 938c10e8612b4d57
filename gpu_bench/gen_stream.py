"""The TGN cell's stream from a seed: config5's fleet (upstream alaz
``testconfig/config5_fleet_100k.json``) as 1 s windows over stable node
slots.

The pod → service pairs are drawn once from the seed: the calling pod
uniform over the pods, the called service uniform over the services, the
protocol (the edge type, as the replay's L7 protocol codes) from config5's
mix. Every window carries these pairs in this order, the pods in slots
``[0, pods)`` and the services in ``[pods, pods + services)``; only the
features change, each distinct window's drawn from ``(seed, index)``.

A window is raw numpy arrays, as ``gen_windows.make_window`` gives them:
the harness hands them to the program, which pads and sorts them itself,
and to the reference, which works from these arrays alone. Nothing here
imports the program.
"""

from __future__ import annotations

import numpy as np

from gpu_bench.gen_windows import EDGE_FEATURE_DIM, NODE_FEATURE_DIM

# the L7 protocol codes of the replay's payloads (gen_replay.PAYLOADS)
PROTOCOL_TYPES = {"HTTP": 1, "POSTGRES": 3, "REDIS": 5, "MYSQL": 7}
POD, SERVICE = 1, 2
_PAIRS, _FEATURES = 1_000_003, 1_000_033  # the seed's streams for each


def pairs(seed: int, pods: int, services: int, edges: int, protocol_mix: dict) -> dict:
    """The stream's pod → service pairs: ``edge_src``, ``edge_dst``,
    ``edge_type`` (int32, drawn order)."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), _PAIRS]))
    src = rng.integers(0, pods, edges).astype(np.int32)
    dst = (pods + rng.integers(0, services, edges)).astype(np.int32)
    names = list(protocol_mix)
    weights = np.asarray([protocol_mix[k] for k in names], dtype=np.float64)
    codes = np.asarray([PROTOCOL_TYPES[k] for k in names], dtype=np.int32)
    etype = codes[rng.choice(len(names), size=edges, p=weights / weights.sum())]
    return {"edge_src": src, "edge_dst": dst, "edge_type": etype}


def make_window(seed: int, index: int, stream_pairs: dict, pods: int, services: int) -> dict:
    """The stream's ``index``-th distinct window: every slot a node (its
    features standard normal), every pair an edge (its features standard
    normal)."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), _FEATURES, int(index)]))
    n = pods + services
    e = stream_pairs["edge_src"].shape[0]
    return {
        "node_feats": rng.standard_normal((n, NODE_FEATURE_DIM), dtype=np.float32),
        "node_type": np.where(np.arange(n) < pods, POD, SERVICE).astype(np.int32),
        "edge_src": stream_pairs["edge_src"].copy(),
        "edge_dst": stream_pairs["edge_dst"].copy(),
        "edge_type": stream_pairs["edge_type"].copy(),
        "edge_feats": rng.standard_normal((e, EDGE_FEATURE_DIM), dtype=np.float32),
        "edge_label": None,
    }


def make_windows(cfg: dict, seed: int, count: int) -> list:
    """The run's ``count`` distinct windows of ``cfg``'s deployment."""
    d = cfg["deployment"]
    p = pairs(seed, d["pods"], d["services"], d["window_edges"], d["protocol_mix"])
    return [make_window(seed, i, p, d["pods"], d["services"]) for i in range(count)]
