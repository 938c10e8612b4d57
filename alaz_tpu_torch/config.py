"""Model configuration, with the same fields, defaults and environment
knobs as the JAX package's ``ModelConfig``, so one deployment's settings
mean the same model in both packages.

Every knob reads ``ALAZ_TPU_<NAME>`` first, then ``<NAME>``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

_PREFIX = "ALAZ_TPU_"


def _env(name: str) -> str | None:
    return os.environ.get(_PREFIX + name, os.environ.get(name))


def env_bool(name: str, default: bool = False) -> bool:
    """An unrecognized token keeps the default rather than reading as
    False."""
    v = _env(name)
    if v is None:
        return default
    t = v.strip().lower()
    if t in ("1", "true", "yes", "on"):
        return True
    if t in ("0", "false", "no", "off"):
        return False
    return default


def env_int(name: str, default: int) -> int:
    v = _env(name)
    return default if v is None else int(v)


def env_str(name: str, default: str) -> str:
    v = _env(name)
    return default if v is None else v


@dataclass(frozen=True)
class ModelConfig:
    """Flagship model hyperparameters. ``use_pallas`` keeps its name so a
    config means the same in both packages: here it selects the
    hand-written CUDA kernels (``ops/segment.py kernels_enabled``)."""

    model: str = "graphsage"  # graphsage | gat | tgn | experts
    hidden_dim: int = 128
    num_layers: int = 2
    num_heads: int = 4  # gat only
    num_edge_types: int = 9  # one per L7 protocol enum slot
    expert_dispatch: str = "table"  # experts only
    node_feature_dim: int = 32
    edge_feature_dim: int = 16
    # append per-window z-scored copies of the leading edge-stat columns
    # inside the model (models/common.py znorm_edge_feats)
    edge_feat_znorm: bool = True
    dropout: float = 0.1
    dtype: str = "bfloat16"
    use_pallas: bool = True
    # src-side gather: "xla" is the plain row gather; "banded" is the
    # banded-gather kernel (K3), meant for windows laid out by
    # graph/builder.py cluster_renumber; both give exactly v[src]
    src_gather: str = "xla"
    # "coo" scores the flat dst-sorted edge list; "blocked" also ships
    # per-128-dst-row extents and routes segment sums through them
    edge_layout: str = "coo"
    remat: bool = False
    tgn_max_nodes: int = 4096

    @property
    def edge_feat_dim_in(self) -> int:
        """Edge-feature width as the model layers see it: the raw
        features plus the z-scored stat columns when ``edge_feat_znorm``
        is on."""
        from alaz_tpu_torch.models.common import EDGE_STAT_COLS

        return self.edge_feature_dim + (EDGE_STAT_COLS if self.edge_feat_znorm else 0)

    @classmethod
    def from_env(cls) -> "ModelConfig":
        return cls(
            model=env_str("MODEL", "graphsage"),
            hidden_dim=env_int("HIDDEN_DIM", 128),
            num_layers=env_int("NUM_LAYERS", 2),
            use_pallas=env_bool("USE_PALLAS", True),
            src_gather=env_str("SRC_GATHER", "xla"),
            edge_layout=env_str("EDGE_LAYOUT", "coo"),
            expert_dispatch=env_str("EXPERT_DISPATCH", "table"),
            edge_feat_znorm=env_bool("EDGE_FEAT_ZNORM", True),
            remat=env_bool("REMAT", False),
            tgn_max_nodes=env_int("TGN_MAX_NODES", 4096),
        )
