"""Randomized e2e manifest generator (reference:
tendermint_tpu/e2e/generate.py, draw for draw: a seed gives the same
manifest text in both packages; Go test/e2e/generator/generate.go +
random.go).

The hand-written manifests of the e2e tests cover the
dimensions one at a time; the cross-product bugs (fastsync x statesync
x privval x perturbation x valset-schedule) live in combinations
nobody thought to write down. This generator samples valid manifests
from the full space under a seeded RNG, so any failure reproduces from
its seed:

    python -m tendermint_tpu_torch.e2e.generate --seed 42 --out m.toml
    python -m tendermint_tpu_torch.e2e.runner m.toml [--device cpu]

Sampling mirrors the reference's approach (uniform/probabilistic
choices per dimension) but constrained to combinations Manifest.validate
accepts — the constraints themselves are product rules (e.g.
misbehaviors need local keys; external ABCI apps have no validator
txs), so the generator never wastes a nightly run on a rejected
manifest.
"""

from __future__ import annotations

import random

from .manifest import (
    OPS as PERTURB_OPS,
    Manifest,
    Misbehavior,
    Perturbation,
    ValidatorUpdate,
)


def generate(rng: random.Random, seed: int | None = None) -> Manifest:
    """Sample one valid Manifest.

    `seed` is the value `rng` was constructed from; when given it is
    stamped into the manifest (and therefore the run report) so the
    manifest reproduces from the report alone.
    """
    nodes = rng.choice([1, 2, 3, 3, 4, 4, 4, 5, 6])
    wait_height = rng.randint(6, 10)
    abci = rng.choice(["builtin", "builtin", "builtin", "tcp", "grpc"])
    privval = rng.choice(["file", "file", "file", "tcp"])
    seed_bootstrap = nodes >= 3 and rng.random() < 0.2
    # >= 4: the held-back validator must leave MORE than 2/3 of the
    # power online, so 3-node nets can never run this dimension
    late_statesync = (abci == "builtin" and nodes >= 4
                      and rng.random() < 0.2)

    m = Manifest(
        nodes=nodes,
        chain_id=f"gen-{rng.randrange(1 << 24):06x}",
        wait_height=wait_height,
        load_tx_rate=rng.choice([0.0, 2.0, 4.0]),
        timeout_commit_ms=rng.choice([100, 150, 200, 300]),
        abci=abci,
        privval=privval,
        seed_bootstrap=seed_bootstrap,
        late_statesync_node=late_statesync,
        generator_seed=seed,
    )

    # Perturbations: probabilistically per node (reference
    # nodePerturbations probSetChoice). The late statesync node starts
    # held back — never perturb it; tiny nets only get ops they can
    # survive without a quorum of helpers.
    perturbable = nodes - (1 if late_statesync else 0)
    # statesync_poison is its own dimension below: it is only valid
    # with a held-back statesync node to poison
    ops = tuple(o for o in PERTURB_OPS if o != "statesync_poison") \
        if nodes >= 3 else ("kill", "restart")
    # degrade-don't-kill failpoint rotation for sampled `chaos` ops
    # (docs/CHAOS.md): shapes every node must ride out under load
    chaos_choices = (
        ("wal.fsync", "delay"), ("db.set", "delay"),
        ("abci.deliver", "delay"), ("device.verify", "error"),
    )
    # kill-at-named-point rotation: commit-pipeline boundaries whose
    # crash/restart recovery the sweep proves (tools/crash_sweep.py);
    # here they run against a LIVE net with peers and load
    kill_points = (
        "consensus.commit.block_saved", "state.apply.app_committed",
        "store.save_block", "wal.fsync",
    ) + (("privval.save",) if privval == "file" else ())
    # privval.save only with local keys: a remote-signer node never
    # hits the point in-process (the runner would fall back to SIGKILL
    # and silently skip the dimension)
    for i in range(perturbable):
        if rng.random() < 0.35:
            op = rng.choice(ops)
            at_height = rng.randint(2, max(2, wait_height - 2))
            kwargs = {}
            if op == "kill" and rng.random() < 0.5:
                kwargs = {"failpoint": rng.choice(kill_points)}
            elif op == "chaos":
                fpname, action = rng.choice(chaos_choices)
                kwargs = {"failpoint": fpname, "action": action,
                          "delay_ms": rng.choice((10, 25, 50))}
            elif op == "overload":
                # throttle one of the host hot paths under flood —
                # including the admission plane's batch verify, with a
                # signed/garbage envelope mix so the shed path runs
                fpname = rng.choice(("device.verify", "abci.deliver",
                                     "mempool.admission.verify"))
                kwargs = {"failpoint": fpname, "action": "delay",
                          "delay_ms": rng.choice((10, 25)),
                          "tx_rate": rng.choice((100.0, 200.0))}
                if fpname == "mempool.admission.verify" \
                        or rng.random() < 0.5:
                    kwargs["tx_garbage"] = rng.choice((0.2, 0.5))
                    kwargs["tx_signed"] = rng.choice((0.0, 0.1))
            elif op == "light_proxy":
                # the serving plane needs a few committed heights to
                # fan out over (manifest floor: at_height >= 4)
                at_height = max(at_height, 4)
            m.perturbations.append(Perturbation(
                node=i,
                op=op,
                at_height=at_height,
                duration=round(rng.uniform(1.0, 4.0), 1),
                **kwargs,
            ))

    # Adversarial statesync: with a held-back joiner in play, half the
    # runs also turn one SERVING node into a chunk poisoner
    # (statesync.serve corrupt armed for the whole restore) — the
    # joiner must quarantine it and finish from the honest holders.
    if late_statesync and rng.random() < 0.5:
        m.perturbations.append(Perturbation(
            node=rng.randrange(perturbable),
            op="statesync_poison",
            at_height=rng.randint(2, max(2, wait_height - 2)),
        ))

    # Validator-power schedule: builtin app only (external abci-cli
    # kvstore has no validator txs). Power takes effect at H+2 and the
    # final valset check needs it live by wait_height. Not co-sampled
    # with a held-back statesync node: a power drop while one
    # validator is already offline can leave live power <= 2/3 and
    # deadlock the net (Manifest.validate simulates the schedule and
    # rejects those; the generator simply avoids the dimension combo).
    if (abci == "builtin" and wait_height >= 6 and not late_statesync
            and rng.random() < 0.4):
        for _ in range(rng.randint(1, 2)):
            node = rng.randrange(nodes)
            # removal (power 0) only from nets big enough to keep a
            # +2/3 quorum of the remaining equal-power validators
            power = rng.choice([0, 2, 3] if nodes >= 4 else [2, 3])
            m.validator_updates.append(ValidatorUpdate(
                node=node,
                at_height=rng.randint(2, wait_height - 3),
                power=power,
            ))
        # two updates for the same node: keep the later one only
        seen: dict[int, ValidatorUpdate] = {}
        for vu in m.validator_updates:
            prev = seen.get(vu.node)
            if prev is None or vu.at_height >= prev.at_height:
                seen[vu.node] = vu
        m.validator_updates = list(seen.values())

    # A maverick (double-prevote/propose) needs local keys and a net
    # that tolerates one byzantine voice (>= 4 equal-power validators).
    # Never the held-back statesync node: it state-syncs PAST the
    # misbehavior height, silently skipping the dimension.
    if (privval == "file" and nodes >= 4 and not m.validator_updates
            and rng.random() < 0.25):
        m.misbehaviors.append(Misbehavior(
            node=rng.randrange(perturbable),
            spec=rng.choice(["double-prevote", "double-propose"])
            + f"@{rng.randint(2, max(2, wait_height - 2))}",
        ))

    m.validate()
    return m


def to_toml(m: Manifest) -> str:
    out = [
        f'chain_id = "{m.chain_id}"',
        f"nodes = {m.nodes}",
        f"wait_height = {m.wait_height}",
        f"load_tx_rate = {m.load_tx_rate}",
        f"timeout_commit_ms = {m.timeout_commit_ms}",
        f'abci = "{m.abci}"',
        f'privval = "{m.privval}"',
        f"seed_bootstrap = {'true' if m.seed_bootstrap else 'false'}",
        f"late_statesync_node = "
        f"{'true' if m.late_statesync_node else 'false'}",
    ]
    if m.generator_seed is not None:
        out += [f"generator_seed = {m.generator_seed}"]
    for p in m.perturbations:
        out += ["", "[[perturbations]]", f"node = {p.node}",
                f'op = "{p.op}"', f"at_height = {p.at_height}",
                f"duration = {p.duration}"]
        if p.op == "kill" and p.failpoint:
            out += [f'failpoint = "{p.failpoint}"']
        if p.op in ("chaos", "overload"):
            out += [f'failpoint = "{p.failpoint}"',
                    f'action = "{p.action}"',
                    f"delay_ms = {p.delay_ms}"]
        if p.op == "overload":
            out += [f"tx_rate = {p.tx_rate}"]
            if p.tx_signed or p.tx_garbage:
                out += [f"tx_signed = {p.tx_signed}",
                        f"tx_garbage = {p.tx_garbage}"]
    for vu in m.validator_updates:
        out += ["", "[[validator_updates]]", f"node = {vu.node}",
                f"at_height = {vu.at_height}", f"power = {vu.power}"]
    for mb in m.misbehaviors:
        out += ["", "[[misbehaviors]]", f"node = {mb.node}",
                f'spec = "{mb.spec}"']
    return "\n".join(out) + "\n"


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="generate a random (seeded) e2e manifest")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", default="-",
                    help="output path ('-' = stdout)")
    args = ap.parse_args(argv)
    toml = to_toml(generate(random.Random(args.seed), seed=args.seed))
    if args.out == "-":
        print(toml, end="")
    else:
        with open(args.out, "w") as f:
            f.write(toml)
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
