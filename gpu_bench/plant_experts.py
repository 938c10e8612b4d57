"""The experts cell's control and fault, planted in the program's place:
the readings ``limits/experts-fleet-stream.json`` is set from, taken
through the cell's own load and comparison (``run.execute``).

    python3 -m gpu_bench.plant_experts --plant <fp8|expert_shift> --seed <n> --seconds <s>

from the root of a checkout, on the card. ``plant.py``'s ``fp8`` runs
``reference.forward``, which has no experts; these patch the program's
``alaz_tpu_torch.models.experts`` before the Service is made.

- ``fp8``, the control: the plain reference (``reference_experts``), one
  precision below the configuration's bf16 (``reference.fp8_quant``), in
  place of the program's ``experts.apply``, with the program's own
  parameters, on the window's live nodes and edges.
- ``expert_shift``, the fault: the program's own forward with each edge's
  message taken from expert ``(t + 1) mod T`` in place of its own ``t``,
  inside the table dispatch (``_expert_messages_table``).

The benchmark's own runs plant nothing. This module imports the program
only inside a plant.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

from gpu_bench import reference, reference_experts

CELL = "experts-fleet-stream"


def _fp8(cfg: dict) -> list:
    import torch

    from alaz_tpu_torch.models import experts

    def control(params, graph, mcfg, around_dispatch=contextlib.nullcontext):
        n, n_e = int(graph["node_mask"].sum()), int(graph["edge_mask"].sum())
        ef = graph["edge_feats"][:n_e]
        # the program may hand its model the z-scored columns already
        rcfg = dict(cfg, edge_feat_znorm=cfg["edge_feat_znorm"] and ef.shape[1] == cfg["edge_feature_dim"])
        g = {"node_feats": graph["node_feats"][:n], "edge_src": graph["edge_src"][:n_e],
             "edge_dst": graph["edge_dst"][:n_e], "edge_type": graph["edge_type"][:n_e], "edge_feats": ef}
        logits = reference_experts.forward(dict(params.named_parameters()), g, rcfg, reference.fp8_quant)
        return {"edge_logits": torch.cat([logits, logits.new_zeros(graph["edge_mask"].shape[0] - n_e)])}

    return [(experts, "apply", control)]


def _expert_shift(cfg: dict) -> list:
    import torch

    from alaz_tpu_torch.models import experts

    table = experts._expert_messages_table

    def shifted(layer, h, edge_src, edge_type, dtype):
        t = layer.expert_w.shape[0]
        live = (edge_type >= 0) & (edge_type < t)
        return table(layer, h, edge_src, torch.where(live, (edge_type + 1) % t, edge_type), dtype)

    return [(experts, "_expert_messages_table", shifted)]


PLANTS = {"fp8": _fp8, "expert_shift": _expert_shift}


@contextlib.contextmanager
def planted(name: str, cfg: dict):
    """Run the body with ``name`` planted in the program's experts."""
    patches = PLANTS[name](cfg)
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    for obj, attr, new in patches:
        setattr(obj, attr, new)
    try:
        yield
    finally:
        for obj, attr, old in reversed(saved):
            setattr(obj, attr, old)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--plant", required=True, choices=sorted(PLANTS))
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    from gpu_bench import run, spec

    with planted(args.plant, spec.cell(run.ROOT, CELL).config):
        result = run.execute(CELL, args.seed, args.seconds, False)
    for name, c in result["checks"].items():
        print(f"gpu_bench check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps({"plant": args.plant, "seed": args.seed, "correct": result["correct"],
                      "attempted": result["attempted"], "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
