"""The control and the faults, planted in the program's place: the readings
the correctness limits are set from, and the tests that see each come out
not correct, run the cell through ``run.execute`` with one of these.

    python3 -m gpu_bench.run --workload <cell> --seed <n> --seconds 3 --plant <name>

- ``fp8``, the control: the reference's forward, one precision below the
  configuration's bf16 (``reference.fp8_quant``), in place of the
  program's model forward (``alaz_tpu_torch.models.<model>.apply``) on the
  window's live edges, with the program's own parameters. What consumes
  the logits (the scorer; the loss, its backward and AdamW) stays the
  program's.
- ``half_batch``: half of each batch's live edges left out of the train
  loss, the mean taken over the rest (``train/trainstep.py``'s
  ``edge_bce_loss``).
- ``state_unchanged``: the optimizer's step returns with every parameter
  and moment as it was.
- ``answer_altered``: one edge's answer turned round where the model
  produces it: its logit negated, so its score s reads 1 - s.
- ``identity_cache``: the train step keeps each window's device copy by
  its node features' array identity and reuses it when those arrays come
  back, whatever they hold now.

The benchmark's own runs plant nothing. This module imports the program
only inside a plant.
"""

from __future__ import annotations

import contextlib
import importlib

from gpu_bench import reference

ALTERED_EDGE = 7


def _fp8(cfg: dict) -> list:
    import torch

    mod = importlib.import_module(f"alaz_tpu_torch.models.{cfg['model']}")
    apply = mod.apply

    def control(params, graph, mcfg, *args, **kwargs):
        with torch.no_grad():
            out = apply(params, graph, mcfg, *args, **kwargs)
        n_e = int(graph["edge_mask"].sum())
        ef = graph["edge_feats"][:n_e]
        # the program may hand its model the z-scored columns already
        rcfg = dict(cfg, edge_feat_znorm=cfg["edge_feat_znorm"] and ef.shape[1] == cfg["edge_feature_dim"])
        g = {"node_feats": graph["node_feats"], "edge_src": graph["edge_src"][:n_e],
             "edge_dst": graph["edge_dst"][:n_e], "edge_feats": ef}
        logits = reference.forward(dict(params.named_parameters()), g, rcfg, reference.fp8_quant)
        pad = out["edge_logits"].shape[0] - n_e
        return dict(out, edge_logits=torch.cat([logits, logits.new_zeros(pad)]).to(out["edge_logits"].dtype))

    return [(mod, "apply", control)]


def _half_batch(cfg: dict) -> list:
    from alaz_tpu_torch.train import trainstep

    loss = trainstep.edge_bce_loss

    def half(logits, label, mask, *args, **kwargs):
        kept = mask.clone()
        kept[int(mask.sum()) // 2:] = 0.0  # the mean over the first half of the live edges
        return loss(logits, label, kept, *args, **kwargs)

    return [(trainstep, "edge_bce_loss", half)]


def _state_unchanged(cfg: dict) -> list:
    import torch

    return [(torch.optim.AdamW, "step", lambda self, closure=None: None)]


def _answer_altered(cfg: dict) -> list:
    mod = importlib.import_module(f"alaz_tpu_torch.models.{cfg['model']}")
    apply = mod.apply

    def altered(params, graph, mcfg, *args, **kwargs):
        out = apply(params, graph, mcfg, *args, **kwargs)
        logits = out["edge_logits"].clone()
        logits[ALTERED_EDGE] = -out["edge_logits"][ALTERED_EDGE]
        return dict(out, edge_logits=logits)

    return [(mod, "apply", altered)]


def _identity_cache(cfg: dict) -> list:
    from alaz_tpu_torch.train import trainstep

    import torch

    to_device = trainstep._train_graph
    kept: dict = {}

    def cached(graph, dev):
        key = id(graph["node_feats"])
        if key not in kept:  # a copy, as on a card (on the CPU the tensors would share the arrays)
            g = {k: v.clone() if torch.is_tensor(v) else v for k, v in to_device(graph, dev).items()}
            kept[key] = (graph["node_feats"], g)  # the arrays held, so their id stays their own
        return kept[key][1]

    return [(trainstep, "_train_graph", cached)]


PLANTS = {"fp8": _fp8, "half_batch": _half_batch, "state_unchanged": _state_unchanged,
          "answer_altered": _answer_altered, "identity_cache": _identity_cache}


@contextlib.contextmanager
def planted(name: str | None, cfg: dict):
    """Run the body with ``name`` planted in the program (none: as it is)."""
    if name is None:
        yield
        return
    patches = PLANTS[name](cfg)
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    for obj, attr, new in patches:
        setattr(obj, attr, new)
    try:
        yield
    finally:
        for obj, attr, old in reversed(saved):
            setattr(obj, attr, old)
