"""CLI driver for the incident scenario suite — what ``make scenarios``
runs.

One JSON line per (scenario, seed); exit 1 if any produced findings.
The default sweep is the fixed-seed acceptance set: every scenario's
host-plane gates (bounded flush/drain, ledger conservation with the
``sampled`` cause, exactly-once windows, cap respected) plus — unless
``--no-detection`` — the per-scenario detection gate (blended AUROC
within tolerance of the clean gate). ``--stress`` additionally runs the
hot_key acceptance bound (500k fan-in, degree-capped) host leg.
"""

from __future__ import annotations

import argparse
import json
import sys

from alaz_tpu_torch.config import ScenarioConfig
from alaz_tpu_torch.replay.incidents import (
    SCENARIO_NAMES,
    HotKey,
    run_incident_scenario,
)


def main(argv=None) -> int:
    """The JAX package's suite CLI, run by the port: the same flags,
    seeds, gates and exit code (1 on any finding), with ``--device``
    (default ``cuda``) for the detection legs' training and scoring.
    ``--isolation`` runs the multi-tenant isolation gate
    (``replay/tenants.py``) on the host scorer: no model, no device."""
    scfg = ScenarioConfig.from_env()
    p = argparse.ArgumentParser(
        prog="python -m alaz_tpu_torch.replay",
        description="run the incident scenario suite (fixed seeds, all scenarios)",
    )
    p.add_argument("--seeds", type=int, nargs="+", default=[scfg.seed])
    p.add_argument(
        "--scenarios", nargs="+", default=list(SCENARIO_NAMES),
        choices=list(SCENARIO_NAMES),
    )
    p.add_argument("--workers", type=int, default=scfg.n_workers)
    p.add_argument(
        "--no-detection", action="store_true",
        help="host-plane gates only (skip the training leg)",
    )
    p.add_argument(
        "--stress", action="store_true",
        help="also run the hot_key 500k-fan-in acceptance bound (host leg)",
    )
    p.add_argument(
        "--isolation", action="store_true",
        help="also run the multi-tenant isolation gate: K=3 "
        "tenants on one service, one perturbed by an incident — clean "
        "tenants must hold latency vs solo, stay drift-silent, and "
        "conserve rows exactly per tenant",
    )
    p.add_argument(
        "--isolation-tenants", type=int, default=3,
        help="tenant count for the isolation gate",
    )
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    failed = 0
    for seed in args.seeds:
        for name in args.scenarios:
            rep = run_incident_scenario(
                name,
                seed=seed,
                n_workers=args.workers,
                detection=not args.no_detection,
                device=args.device,
            )
            print(json.dumps(rep.as_dict(), sort_keys=True), flush=True)
            if not rep.ok:
                failed += 1
    if args.isolation:
        from alaz_tpu_torch.replay.tenants import run_isolation_scenario

        trep = run_isolation_scenario(
            tenants=args.isolation_tenants, seed=args.seeds[0]
        )
        print(json.dumps(trep.as_dict(), sort_keys=True), flush=True)
        if not trep.ok:
            failed += 1
    if args.stress:
        rep = run_incident_scenario(
            "hot_key",
            seed=args.seeds[0],
            n_workers=args.workers,
            scale="stress",
            detection=False,
            degree_cap=scfg.degree_cap,
            incident=HotKey(args.seeds[0], fan_in=scfg.hot_key_fanin),
        )
        print(json.dumps(rep.as_dict(), sort_keys=True), flush=True)
        if not rep.ok:
            failed += 1
    if failed:
        print(f"# {failed} scenario run(s) with findings", file=sys.stderr)
        return 1
    return 0

if __name__ == "__main__":
    raise SystemExit(main())
