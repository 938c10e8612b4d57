"""CLI driver for the chaos suite — what ``make chaos`` runs.

One JSON line per seed; exit 1 if any seed produced findings. The
default seeds are the fixed acceptance set: every PR must keep them
finding-free (wired into ``make test``).
"""

from __future__ import annotations

import argparse
import json
import sys

from alaz_tpu_torch.chaos.harness import run_chaos_suite
from alaz_tpu_torch.config import ChaosConfig


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m alaz_tpu.chaos",
        description="run the chaos suite (all four seams) over fixed seeds",
    )
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--rows", type=int, default=48_000)
    p.add_argument(
        "--legs", nargs="+", default=["pipeline", "frames", "backend"],
        choices=["pipeline", "frames", "backend"],
    )
    p.add_argument(
        "--ingest-backend", default="thread",
        choices=["thread", "process", "both"],
        help="sharded-ingest backend for the pipeline leg (ISSUE 15): "
        "'process' SIGKILLs real shard processes mid-wave instead of "
        "raising in threads; 'both' runs the thread suite as usual and "
        "then a process-mode pipeline leg per seed (same conservation/"
        "monotonic/self-healing gates through the kills)",
    )
    from alaz_tpu_torch.replay.incidents import SCENARIO_NAMES

    p.add_argument(
        "--composed", default="hot_key", metavar="SCENARIO",
        choices=list(SCENARIO_NAMES) + ["none"],
        help="also run one scenario×chaos composition (ISSUE 7): the "
        "named incident scenario's host leg with the chaos seams armed "
        "on top — 'hot-key during a degraded delivery'. 'none' skips it",
    )
    p.add_argument(
        "--tenants", action="store_true",
        help="also run the two-tenant incident+worker-kill composition "
        "(ISSUE 14): K=2 tenants, sharded partitions, hot_key incident "
        "AND chaos crashes on ONE tenant's pool — per-tenant ledger "
        "conservation must hold EXACTLY through the kills, and the "
        "clean tenant's latency/drift gates stay ON",
    )
    args = p.parse_args(argv)

    failed = 0
    first_backend = (
        "process" if args.ingest_backend == "process" else "thread"
    )
    for seed in args.seeds:
        cfg = ChaosConfig(enabled=True, seed=seed)
        rep = run_chaos_suite(
            cfg,
            n_workers=args.workers,
            n_rows=args.rows,
            legs=tuple(args.legs),
            ingest_backend=first_backend,
        )
        print(json.dumps(rep.as_dict(), sort_keys=True))
        if not rep.ok:
            failed += 1
    if args.ingest_backend == "both" and "pipeline" in args.legs:
        # process-mode pipeline leg per seed (ISSUE 15): the same
        # worker-seam faults land as SIGKILLs on real shard processes;
        # the conservation/monotonic/self-healing gates must hold
        # through the kill (frames/backend legs are backend-independent
        # and already ran above)
        for seed in args.seeds:
            cfg = ChaosConfig(enabled=True, seed=seed)
            rep = run_chaos_suite(
                cfg,
                n_workers=args.workers,
                n_rows=args.rows,
                legs=("pipeline",),
                ingest_backend="process",
            )
            print(json.dumps(rep.as_dict(), sort_keys=True))
            if not rep.ok:
                failed += 1
    if args.composed and args.composed != "none":
        from alaz_tpu_torch.replay.incidents import run_incident_scenario

        srep = run_incident_scenario(
            args.composed,
            seed=args.seeds[0],
            n_workers=args.workers,
            detection=False,
            chaos=ChaosConfig(enabled=True, seed=args.seeds[0]),
        )
        print(json.dumps(srep.as_dict(), sort_keys=True))
        if not srep.ok:
            failed += 1
    if args.tenants:
        from alaz_tpu_torch.replay.tenants import run_isolation_scenario

        trep = run_isolation_scenario(
            tenants=2,
            seed=args.seeds[0],
            incident="hot_key",
            ingest_workers=args.workers,
            # paced (default): the clean tenant's latency/drift gates
            # stay ON — incident + chaos on one fleet must not move the
            # other (the ISSUE 14 acceptance combination); kills arm
            # only on the perturbed tenant's pool
            chaos=ChaosConfig(
                enabled=True,
                seed=args.seeds[0],
                # boosted crash pressure: the composition exists to
                # prove conservation THROUGH kills, so make them likely
                worker_crash_prob=0.05,
                worker_max_crashes=4,
            ),
        )
        print(json.dumps(trep.as_dict(), sort_keys=True))
        if not trep.ok:
            failed += 1
    if failed:
        print(f"# {failed} seed(s) with findings", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
