"""Checkpoint and resume: model params, optimizer state, the step counter
and the TGN node memory, so training and the scoring loop restart from
the last saved state. The JAX package's ``train/checkpoint.py``, with the
same schema version, feature contract and refusals, in a format of this
package's own: one directory per step under ``directory``, holding
``state.pt`` (``torch.save`` of state dicts), read back with
``torch.load(weights_only=True)``. It does not read the JAX package's
orbax checkpoints.
"""

from __future__ import annotations

import os
import shutil
import zlib
from pathlib import Path
from typing import Any, Optional

import torch

# Bump when the model's parameter/feature contract changes incompatibly
# (the JAX package's history: v2 moved the edge-type embeddings into the
# edge-feature one-hot slots; v3 appended the z-scored edge-stat columns,
# widening edge_head/edge_proj inputs to edge_feat_dim_in).
SCHEMA_VERSION = 3
STATE_FILE = "state.pt"


def feature_contract(model_cfg) -> dict:
    """The shape-determining facts a checkpoint's params are only valid
    under: every config knob that changes a param shape (model, hidden
    width, layers, edge-feature width), so a mismatched restore fails
    with the fix named instead of at the first matmul. Ints only: the
    model name rides as a crc32."""
    return {
        "model_crc": zlib.crc32(model_cfg.model.encode()),
        "hidden_dim": int(model_cfg.hidden_dim),
        "num_layers": int(model_cfg.num_layers),
        "edge_feat_dim_in": int(model_cfg.edge_feat_dim_in),
        "edge_feat_znorm": bool(model_cfg.edge_feat_znorm),
    }


def _state_dict(obj):
    return obj.state_dict() if hasattr(obj, "state_dict") else obj


def _steps(directory: Path) -> list:
    if not directory.is_dir():
        return []
    return sorted(
        int(p.name) for p in directory.iterdir()
        if p.name.isdigit() and (p / STATE_FILE).is_file()
    )


def save(
    directory: str | Path,
    step: int,
    params: Any,
    opt_state: Any = None,
    memory: Optional[torch.Tensor] = None,
    max_to_keep: int = 3,
    contract: dict | None = None,
) -> None:
    """Write ``<directory>/<step>/state.pt`` and keep the newest
    ``max_to_keep`` steps. ``params`` and ``opt_state`` are modules or
    optimizers (their state dicts are saved) or state dicts. The step
    directory appears whole or not at all (written aside, then renamed)."""
    directory = Path(directory).resolve()
    directory.mkdir(parents=True, exist_ok=True)
    state = {"params": _state_dict(params), "schema_version": SCHEMA_VERSION}
    if contract:
        state["contract"] = {k: int(v) for k, v in sorted(contract.items())}
    if opt_state is not None:
        state["opt_state"] = _state_dict(opt_state)
    if memory is not None:
        state["memory"] = memory
    final = directory / str(int(step))
    tmp = directory / f".{int(step)}.{os.getpid()}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    torch.save(state, tmp / STATE_FILE)
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    for old in _steps(directory)[:-max_to_keep]:
        shutil.rmtree(directory / str(old))


def restore(
    directory: str | Path,
    step: Optional[int] = None,
    expect_contract: dict | None = None,
) -> tuple:
    """→ (step, state dict) of the newest step, or of ``step``, its tensors
    on the CPU. Raises FileNotFoundError when there is no checkpoint. The
    state holds ``params`` (a state dict), and ``opt_state`` and
    ``memory`` where they were saved. Refuses a checkpoint of another
    schema version, and one whose saved feature contract disagrees with
    ``expect_contract`` (see :func:`feature_contract`)."""
    directory = Path(directory).resolve()
    target = step if step is not None else latest_step(directory)
    if target is None or not (directory / str(target) / STATE_FILE).is_file():
        raise FileNotFoundError(f"no checkpoint under {directory}")
    state = torch.load(directory / str(target) / STATE_FILE, map_location="cpu", weights_only=True)
    found = int(state.pop("schema_version", 1))
    if found != SCHEMA_VERSION:
        raise ValueError(
            f"checkpoint {directory} has schema v{found}, this build "
            f"needs v{SCHEMA_VERSION} (the model feature contract "
            "changed — retrain or convert; restoring would silently "
            "degrade scores)"
        )
    saved_contract = {k: int(v) for k, v in (state.pop("contract", None) or {}).items()}
    if expect_contract is not None and saved_contract:
        want = {k: int(v) for k, v in sorted(expect_contract.items())}
        if saved_contract != want:
            raise ValueError(
                f"checkpoint {directory} was trained under feature "
                f"contract {saved_contract}, this process runs "
                f"{want} (EDGE_FEAT_ZNORM or feature widths differ "
                "— retrain, or set the env to match the checkpoint)"
            )
    return int(target), state


def latest_step(directory: str | Path) -> Optional[int]:
    steps = _steps(Path(directory))
    return steps[-1] if steps else None
