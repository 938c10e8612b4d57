"""Model registry: name → (init, apply)."""

from __future__ import annotations

from alaz_tpu_torch.models import experts, gat, graphsage, tgn

REGISTERED_MODELS = ("graphsage", "gat", "tgn", "experts")


def get_model(name: str):
    if name == "graphsage":
        return graphsage.init, graphsage.apply
    if name == "gat":
        return gat.init, gat.apply
    if name == "tgn":
        return tgn.init, tgn.apply
    if name == "experts":
        return experts.init, experts.apply
    raise ValueError(f"unknown model {name!r} ({'|'.join(REGISTERED_MODELS)})")


def init_params(cfg, key=0, device=None):
    """Random params for ``cfg.model`` from ``key`` (seed or
    ``torch.Generator``), on ``device`` (default ``cuda``)."""
    init, _ = get_model(cfg.model)
    return init(key, cfg, device=device)
