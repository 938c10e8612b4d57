"""What the load loops share: the program's model configuration from a
configuration file, the windows of a run, and the result a loop returns.

The program (``alaz_tpu_torch``) is imported inside the functions that
drive it, so the reference and the statistics load without it.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import numpy as np

from gpu_bench import gen_windows

MODEL_KEYS = ("model", "hidden_dim", "num_layers", "num_heads", "num_edge_types", "node_feature_dim",
              "edge_feature_dim", "edge_feat_znorm", "dtype", "use_pallas", "src_gather", "edge_layout")


@dataclass
class Outcome:
    """What a load loop hands back to ``run.py``."""

    window_start: float  # perf_counter at the window's open: set-up ends here
    e2e: dict  # end-to-end metric name -> value
    record: dict  # what the per-layer readers read
    attempted: int
    failed: int
    checks: dict  # name -> {"value", "limit"}; correct iff every value <= its limit
    memory_peak_bytes: int
    trace: object = None  # trace.DeviceTrace of a traced run


def model_config(cfg: dict):
    """The program's ``ModelConfig`` as the configuration file states it."""
    from alaz_tpu_torch.config import ModelConfig

    return ModelConfig(**{k: cfg[k] for k in MODEL_KEYS})


def make_raw_windows(cfg: dict, seed: int, count: int, label_rate: float = 0.0) -> list:
    d = cfg["deployment"]
    return [
        gen_windows.make_window(
            gen_windows.window_seed(seed, i), n_pods=d["pods"], n_svcs=d["services"],
            n_edges=d["window_edges"], structure=d["structure"], layout=d["layout"],
            label_rate=label_rate,
        )
        for i in range(count)
    ]


def to_batch(raw: dict):
    """A raw window as the program's ``GraphBatch`` (the program pads and
    sorts it); node uids are the node ids."""
    from alaz_tpu_torch.graph.snapshot import GraphBatch

    n = raw["node_feats"].shape[0]
    return GraphBatch.build(
        node_feats=raw["node_feats"], node_type=raw["node_type"], edge_src=raw["edge_src"],
        edge_dst=raw["edge_dst"], edge_type=raw["edge_type"], edge_feats=raw["edge_feats"],
        edge_label=raw["edge_label"], node_uids=np.arange(n, dtype=np.int32),
    )


def handoff(batch, index: int):
    """The ``index``-th hand-off of a window: a shallow copy under a window
    start of its own (the program stamps each hand-off it receives)."""
    b = copy.copy(batch)
    b.window_start_ms = 1_000 * (index + 1)
    b.window_end_ms = b.window_start_ms + 1_000
    return b


def copied(batch):
    """A second window with the same contents in arrays of its own."""
    b = copy.copy(batch)
    for k, v in vars(batch).items():
        if isinstance(v, np.ndarray):
            setattr(b, k, v.copy())
    return b


def mark(node_feats: np.ndarray, n_nodes: int, index: int, seed: int) -> None:
    """Write hand-off (or step) ``index``'s own last node-feature column
    (``gen_windows.handoff_column``) into ``node_feats`` in place: the
    arrays a window is handed over in are reused, and their contents
    change each time, as a close writes a window's feature rows anew."""
    node_feats[:n_nodes, -1] = gen_windows.handoff_column(seed, index, n_nodes)


def marked(raw: dict, index: int, seed: int) -> dict:
    """The raw window as hand-off (or step) ``index`` carried it: the
    reference's input for what the program did with that hand-off."""
    nf = raw["node_feats"].copy()
    nf[:, -1] = gen_windows.handoff_column(seed, index, nf.shape[0])
    return dict(raw, node_feats=nf)


def program_model(cfg: dict, params: dict, device):
    """The program's model module for ``cfg``, holding ``params``."""
    from alaz_tpu_torch.models.registry import get_model

    mcfg = model_config(cfg)
    init, _ = get_model(mcfg.model)
    model = init(0, mcfg, device=device)
    model.load_state_dict(params, strict=True)
    return mcfg, model


def check(value: float, limit: float) -> dict:
    return {"value": value, "limit": limit}
