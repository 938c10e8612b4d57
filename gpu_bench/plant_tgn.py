"""The TGN cell's control and fault, planted in the program's place: the
readings ``limits/tgn-fleet-stream.json`` is set from, taken through the
cell's own load and comparison (``run.execute``).

    python3 -m gpu_bench.plant_tgn --plant <fp8|memory_reset> --seed <n> --seconds <s>

from the root of a checkout, on the card. ``plant.py``'s plants patch
``models.<model>.apply``, which the Service's TGN path does not call: it
scores TGN through ``tgn.make_step_fn``, which these patch.

- ``fp8``, the control: the plain reference (``reference_tgn``), one
  precision below the configuration's bf16 (``reference.fp8_quant``), in
  place of the program's step, with the program's own parameters and
  memory (pre-sized, as the cell sizes it), on the window's live nodes
  and edges. The cell's comparison then holds the reference threaded in
  fp8 against itself threaded in float32.
- ``memory_reset``, the fault: the program's own step with its memory
  zeroed before every window, the stale answer the cell exists to catch.

The benchmark's own runs plant nothing. This module imports the program
only inside a plant.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

from gpu_bench import reference, reference_tgn

CELL = "tgn-fleet-stream"


def _fp8() -> tuple:
    import torch

    from alaz_tpu_torch.models import tgn

    def make_control(mcfg):
        def control(params, graph, memory, around_update=contextlib.nullcontext):
            p = dict(params.named_parameters())
            n, n_e = int(graph["node_mask"].sum()), int(graph["edge_mask"].sum())
            g = {"node_feats": graph["node_feats"][:n], "edge_src": graph["edge_src"][:n_e],
                 "edge_dst": graph["edge_dst"][:n_e], "edge_feats": graph["edge_feats"][:n_e]}
            h, logits = reference_tgn.encode(p, g, memory[:n], reference.fp8_quant)
            with around_update():
                m = reference_tgn.update(p, memory[:n], h, reference.fp8_quant)
            edge_logits = torch.cat([logits, logits.new_zeros(graph["edge_mask"].shape[0] - n_e)])
            return {"edge_logits": edge_logits}, torch.cat([m, memory[n:]])

        return control

    return tgn, make_control


def _memory_reset() -> tuple:
    import torch

    from alaz_tpu_torch.models import tgn

    make_step_fn = tgn.make_step_fn

    def make_reset(mcfg):
        step = make_step_fn(mcfg)

        def reset(params, graph, memory, around_update=contextlib.nullcontext):
            return step(params, graph, torch.zeros_like(memory), around_update)

        return reset

    return tgn, make_reset


PLANTS = {"fp8": _fp8, "memory_reset": _memory_reset}


@contextlib.contextmanager
def planted(name: str):
    """Run the body with ``name`` in place of the program's
    ``tgn.make_step_fn``."""
    module, make = PLANTS[name]()
    saved = module.make_step_fn
    module.make_step_fn = make
    try:
        yield
    finally:
        module.make_step_fn = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--plant", required=True, choices=sorted(PLANTS))
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    from gpu_bench import run

    with planted(args.plant):
        result = run.execute(CELL, args.seed, args.seconds, False)
    for name, c in result["checks"].items():
        print(f"gpu_bench check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps({"plant": args.plant, "seed": args.seed, "correct": result["correct"],
                      "attempted": result["attempted"], "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
