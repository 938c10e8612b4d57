"""Model registry: name → (init, apply)."""

from __future__ import annotations

from alaz_tpu_torch.models import gat, graphsage

REGISTERED_MODELS = ("graphsage", "gat", "tgn", "experts")
# models of the JAX package this package does not have yet, each with
# its place in ROADMAP.md's queue of slices
_NOT_PORTED = {
    "experts": "the experts slice",
    "tgn": "the TGN slice",
}


def get_model(name: str):
    if name == "graphsage":
        return graphsage.init, graphsage.apply
    if name == "gat":
        return gat.init, gat.apply
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported yet: ROADMAP.md queues it as {_NOT_PORTED[name]}"
        )
    raise ValueError(f"unknown model {name!r} ({'|'.join(REGISTERED_MODELS)})")


def init_params(cfg, key=0, device=None):
    """Random params for ``cfg.model`` from ``key`` (seed or
    ``torch.Generator``), on ``device`` (default ``cuda``)."""
    init, _ = get_model(cfg.model)
    return init(key, cfg, device=device)
