"""Carry params and graphs across from numpy.

A JAX param tree of any of the four families (GraphSAGE, GAT, the
experts' stacked ``expert_w [T, H, H]`` and ``expert_b [T, H]``, TGN's
``encoder.*``, ``mem_in`` and ``gru_r/z/n``), with numpy leaves, becomes
the model module's state dict: the tree's dict keys and list indices
joined by ``.`` are the module's parameter names, and every leaf keeps
its shape and value (TGN's update-gate bias of -2 included). Dense
weights are ``[in, out]`` in both packages (``models/common.py Dense``
computes ``x @ w``), so nothing is transposed.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from alaz_tpu_torch.device import resolve_device


def params_from_jax(tree) -> dict:
    """Flatten a param tree (dicts and lists, numpy leaves) into a state
    dict of f32 CPU tensors, for ``module.load_state_dict``."""
    flat: dict = {}

    def walk(prefix: str, node) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{k}.", v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}{i}.", v)
        else:
            flat[prefix[:-1]] = torch.from_numpy(np.array(node, dtype=np.float32))

    walk("", tree)
    return flat


def params_to_numpy(module: nn.Module):
    """The inverse of ``params_from_jax``: the module's params as the JAX
    package's tree, lists where the tree has lists, numpy leaves."""
    tree: dict = {}
    for name, p in module.state_dict().items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = p.detach().float().cpu().numpy()

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out

    return listify(tree)


def graph_to_torch(device_arrays: dict, device=None) -> dict:
    """``GraphBatch.device_arrays()`` (numpy) as tensors on ``device``
    (default ``cuda``), dtypes kept: int32 ids, bool masks, f32 values."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(v, device=dev) for k, v in device_arrays.items()}
