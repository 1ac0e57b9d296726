"""Seeded scenario sweep — the scenario factory's CLI entry point
(reference: the repository's root tools/scenario_sweep.py).

Runs named scenarios (tendermint_tpu_torch/sim/scenario.py SCENARIOS)
over seed ranges, entirely in virtual time, and fails loudly with the
(scenario, seed) pair that reproduces any invariant violation:

    python -m tendermint_tpu_torch.tools.scenario_sweep --list
    python -m tendermint_tpu_torch.tools.scenario_sweep \
        --scenario smoke_partition --seeds 0:20
    python -m tendermint_tpu_torch.tools.scenario_sweep --tier smoke \
        --seeds 0:3
    python -m tendermint_tpu_torch.tools.scenario_sweep \
        --scenario smoke_quorum --seed 7 \
        --determinism       # run twice, require identical app hashes

The catalog's scenarios verify on the host (verify_backend "host"),
so the sweep needs no GPU.

One SWEEP json line per run (BENCH-line convention) so CI shards can
grep results; exit code 1 if any run violated an invariant (or a
--determinism pair diverged).
"""

from __future__ import annotations

import argparse
import json
import sys


def parse_seeds(spec: str) -> list[int]:
    if ":" in spec:
        lo, hi = spec.split(":", 1)
        return list(range(int(lo), int(hi)))
    return [int(s) for s in spec.split(",")]


def run_one(name: str, seed: int, determinism: bool) -> dict:
    from ..sim import SCENARIOS, run_scenario

    sc = SCENARIOS[name]()
    report = run_scenario(sc, seed)
    if determinism:
        again = run_scenario(SCENARIOS[name](), seed)
        if report["app_hashes"] != again["app_hashes"]:
            report["violations"].append(
                f"determinism: identical (scenario={name}, seed={seed}) "
                f"runs produced different app hashes")
        # a violation that fires only on the RE-run is exactly the
        # nondeterminism this flag hunts — surface it, don't drop it
        report["violations"] += [
            v for v in again["violations"]
            if v not in report["violations"]]
        report["determinism_checked"] = True
    return report


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", action="append", default=None,
                    help="named scenario (repeatable); default: by --tier")
    ap.add_argument("--tier", default="smoke", choices=("smoke", "slow", "all"),
                    help="which registry tier when --scenario is omitted")
    ap.add_argument("--seeds", default=None,
                    help="'lo:hi' range or comma list (default: --seed)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--determinism", action="store_true",
                    help="run each (scenario, seed) twice and require "
                         "identical per-height app hashes")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    from ..sim import SCENARIOS

    if args.list:
        for name, factory in sorted(SCENARIOS.items()):
            sc = factory()
            print(f"{name:24s} tier={sc.tier:5s} nodes={sc.nodes:3d} "
                  f"valset={sc.valset_size or sc.nodes:6d} "
                  f"duration={sc.duration:6.1f}s faults={len(sc.faults)} "
                  f"byzantine={len(sc.byzantine_specs())}")
        return 0

    names = args.scenario
    if not names:
        names = [n for n, f in sorted(SCENARIOS.items())
                 if args.tier in ("all", f().tier)]
    for n in names:
        if n not in SCENARIOS:
            print(f"unknown scenario {n!r} (see --list)", file=sys.stderr)
            return 2
    seeds = parse_seeds(args.seeds) if args.seeds else [args.seed]

    failed = 0
    for name in names:
        for seed in seeds:
            report = run_one(name, seed, args.determinism)
            ok = not report["violations"]
            failed += 0 if ok else 1
            print("SWEEP " + json.dumps({
                "scenario": name, "seed": seed, "ok": ok,
                "heights": max(report["final_heights"], default=0),
                "virtual_s": report["virtual_duration_s"],
                "wall_s": report["wall_s"],
                "evidence": report["evidence_committed"],
                "violations": report["violations"],
            }, sort_keys=True), flush=True)
            for v in report["violations"]:
                print(f"VIOLATION: {v}", file=sys.stderr)
    print(f"{len(names) * len(seeds)} runs, {failed} failed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
