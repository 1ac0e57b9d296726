"""e2e testnet manifest (reference: tendermint_tpu/e2e/manifest.py, the
same keys, defaults and validation errors; Go test/e2e/pkg/manifest.go).

TOML schema:

    chain_id = "e2e-chain"       # optional
    nodes = 4                    # validator count
    wait_height = 8              # success bar: every node reaches it
    load_tx_rate = 5             # txs/second of background load (0 off)
    timeout_commit_ms = 200      # consensus cadence for the run

    [[perturbations]]
    node = 1                     # node index
    op = "kill"                  # kill | pause | disconnect |
                                 #   disconnect_hard | restart | chaos
    at_height = 3                # trigger when the net reaches this
    duration = 3.0               # pause/disconnect/sever/chaos len (s)
    failpoint = "wal.fsync"      # chaos: named failpoint to degrade;
                                 # kill: crash AT this named commit-
                                 # pipeline point instead of SIGKILL
    action = "delay"             # chaos only: error | delay | corrupt
    delay_ms = 25                # chaos only: delay action stall

    [[validator_updates]]        # scheduled valset change
    node = 3                     # whose power to change
    at_height = 2                # submit the kvstore validator tx here
    power = 3                    # new voting power (0 = remove)
"""

from __future__ import annotations

from dataclasses import dataclass, field

# disconnect = long SIGSTOP (peers observe a stall); disconnect_hard =
# TCP severance via the switch's sever() hook (peers observe connection
# RESETS and must re-dial — reference perturb.go severs the docker net);
# chaos = arm a named failpoint (libs/failpoints.py) on the node via
# its POST /debug/failpoint endpoint for `duration` seconds;
# overload = tx-flood the node at `tx_rate`/s WHILE a delay failpoint
# (default device.verify) throttles its hot path — liveness under
# overload as an asserted invariant: heights keep advancing, shed
# counters climb, bounded queues stay bounded, and the /status
# overload level clears after the window;
# light_proxy = boot an in-runner light serving plane + proxy
# (light/serving.py) against the node's RPC, fan out concurrent
# verified header/commit requests with height overlap, and assert
# coalescing (verify launches ≪ requests), response parity with the
# primary, and 429 shed-newest under a light.verify-delay flood while
# the backing net keeps committing;
# spec_mismatch = arm `consensus.speculate` corrupt on the node (a
# wrong-timestamp flood into the verify-ahead plane,
# consensus/speculation.py) for `duration` seconds and assert
# speculation hits drop to ZERO while the fallback path keeps every
# commit verdict correct — the net must keep committing throughout;
# statesync_poison = arm `statesync.serve` corrupt on the node, so it
# serves GARBLED snapshot chunks to the late_statesync_node's restore
# (requires late_statesync_node; the target must not be the held-back
# node itself). The poisoning stays armed through the whole restore;
# after the net reaches wait_height the runner disarms it and — when
# the poisoner actually served chunks — asserts the late joiner
# quarantined a peer and retried the restore instead of wedging
OPS = ("kill", "pause", "disconnect", "disconnect_hard", "restart",
       "chaos", "overload", "light_proxy", "spec_mismatch",
       "statesync_poison")


@dataclass
class Perturbation:
    node: int
    op: str
    at_height: int
    duration: float = 3.0
    # chaos/overload ops: which failpoint, what shape, how slow
    failpoint: str = ""
    action: str = "delay"
    delay_ms: float = 25.0
    # overload op only: broadcast_tx_async flood rate (txs/s)
    tx_rate: float = 200.0
    # overload op only: fraction of flood txs wrapped in VALID
    # tx_envelope signatures / GARBAGE-signature envelopes, so the
    # flood exercises the mempool admission plane's verify+shed path
    # (the rest are raw unsigned txs)
    tx_signed: float = 0.0
    tx_garbage: float = 0.0

    def validate(self, n_nodes: int) -> None:
        if self.op not in OPS:
            raise ValueError(f"unknown perturbation op {self.op!r}")
        if not 0 <= self.node < n_nodes:
            raise ValueError(f"perturbation node {self.node} out of range")
        if self.at_height < 1:
            raise ValueError("perturbation at_height must be >= 1")
        if self.op == "kill" and self.failpoint:
            # kill-at-named-point: the runner arms `crash` on this
            # failpoint via the debug endpoint instead of SIGKILLing,
            # so the node dies at a PRECISE commit-pipeline boundary
            # and the restart proves handshake recovery from it.
            from ..libs.failpoints import BY_NAME

            if self.failpoint not in BY_NAME:
                raise ValueError(
                    f"unknown kill failpoint {self.failpoint!r}")
        if self.op == "disconnect_hard" and not 0 < self.duration <= 60:
            # same bound the unsafe_net_sever RPC enforces — reject at
            # manifest load, not mid-run
            raise ValueError("disconnect_hard duration must be in (0, 60]")
        if self.op == "chaos":
            from ..libs.failpoints import ACTIONS, BY_NAME

            if self.failpoint not in BY_NAME:
                raise ValueError(
                    f"unknown chaos failpoint {self.failpoint!r}")
            if self.action not in ACTIONS or self.action == "crash":
                # a crash mid-run is the `kill` op's job (the runner
                # restarts those); an uncoordinated crash would just
                # fail the run
                raise ValueError(
                    f"chaos action must be error|delay|corrupt, "
                    f"not {self.action!r}")
        if self.op == "spec_mismatch":
            if self.at_height < 2:
                # the plane serves commits from height 1 up; arming
                # before any commit exists would measure nothing
                raise ValueError("spec_mismatch at_height must be >= 2")
        if self.op == "light_proxy":
            if self.at_height < 4:
                # the plane needs a few committed heights to fan out
                # over (trust root at 1 + an overlap window above it)
                raise ValueError("light_proxy at_height must be >= 4")
        if self.op == "overload":
            from ..libs.failpoints import BY_NAME

            if self.failpoint and self.failpoint not in BY_NAME:
                raise ValueError(
                    f"unknown overload failpoint {self.failpoint!r}")
            if self.action not in ("delay", "error"):
                # overload models a SLOW (or host-degraded) hot path
                # under flood; corrupt/crash are other ops' jobs
                raise ValueError(
                    f"overload action must be delay|error, "
                    f"not {self.action!r}")
            if self.tx_rate <= 0:
                raise ValueError("overload tx_rate must be positive")
            if not (0.0 <= self.tx_signed <= 1.0
                    and 0.0 <= self.tx_garbage <= 1.0
                    and self.tx_signed + self.tx_garbage <= 1.0):
                raise ValueError(
                    "overload tx_signed/tx_garbage must be fractions "
                    "with tx_signed + tx_garbage <= 1")


@dataclass
class ValidatorUpdate:
    """A scheduled validator-set change (reference: manifest.go
    validator-set schedules): at `at_height`, submit a kvstore
    validator tx changing node `node`'s voting power to `power`
    (0 removes it from the set). Exercises the full valset-change
    path in a live net: EndBlock updates -> update_with_change_set ->
    proposer-priority rebuild -> device comb-table rewarm."""

    node: int
    at_height: int
    power: int

    def validate(self, n_nodes: int) -> None:
        if not 0 <= self.node < n_nodes:
            raise ValueError(f"validator_update node {self.node} "
                             "out of range")
        if self.at_height < 1:
            raise ValueError("validator_update at_height must be >= 1")
        if self.power < 0:
            raise ValueError("validator_update power must be >= 0")


@dataclass
class Misbehavior:
    """A maverick node (reference: maverick selectable via the e2e
    manifest): `spec` is NAME@HEIGHT[,NAME@HEIGHT...], passed to the
    node's --misbehavior flag."""

    node: int
    spec: str

    def validate(self, n_nodes: int) -> None:
        from ..consensus.misbehavior import MISBEHAVIORS

        if not 0 <= self.node < n_nodes:
            raise ValueError(f"misbehavior node {self.node} out of range")
        for part in self.spec.split(","):
            name, sep, h = part.partition("@")
            if name not in MISBEHAVIORS or not sep or not h.isdigit():
                raise ValueError(f"bad misbehavior spec {part!r}")


@dataclass
class Manifest:
    nodes: int = 4
    chain_id: str = ""
    wait_height: int = 8
    load_tx_rate: float = 0.0
    timeout_commit_ms: int = 200
    perturbations: list[Perturbation] = field(default_factory=list)
    misbehaviors: list[Misbehavior] = field(default_factory=list)
    validator_updates: list[ValidatorUpdate] = field(default_factory=list)
    # ABCI transport (reference manifest.go ABCIProtocol matrix):
    # "builtin" runs the kvstore in-process; "tcp" (varint-framed
    # socket) and "grpc" run one app SERVER PROCESS per node, so node
    # kill/restart perturbations exercise the handshake replay against
    # a live external app.
    abci: str = "builtin"
    # Privval mode (reference manifest.go PrivvalProtocol): "file"
    # keeps keys in the node homes; "tcp" moves every validator key
    # into a SIGNER SIDECAR PROCESS that dials its node's
    # priv_validator_laddr over SecretConnection — perturbations then
    # exercise consensus against out-of-process signing.
    privval: str = "file"
    # Seed-node bootstrap (reference manifest node "seed" role): node 0
    # runs in PEX seed mode, and every OTHER node's persistent-peer
    # mesh is REPLACED by seeds=node0 — the net only forms if address
    # -book gossip discovers the peers (drives PEX/addrbook e2e).
    seed_bootstrap: bool = False
    # Hold the LAST node back; once the net has snapshots, start it
    # with state sync configured from a live trust hash and make it
    # catch up (reference manifest state_sync node role).
    late_statesync_node: bool = False
    # The generator seed this manifest was sampled from (e2e/generate
    # stamps it; None for hand-written manifests). Carried into the
    # run report so ANY generated run reproduces from its report alone:
    #   python -m tendermint_tpu_torch.e2e.generate --seed <generator_seed>
    generator_seed: int | None = None

    def validate(self) -> None:
        if self.nodes < 1:
            raise ValueError("need at least one node")
        if self.abci not in ("builtin", "tcp", "grpc"):
            raise ValueError(f"unknown abci transport {self.abci!r}")
        if self.privval not in ("file", "tcp"):
            raise ValueError(f"unknown privval mode {self.privval!r}")
        if self.privval == "tcp" and self.misbehaviors:
            # maverick equivocation signs with a raw local key, which
            # a remote-signer node deliberately does not have
            raise ValueError("misbehaviors require privval = \"file\"")
        if self.abci != "builtin":
            # the external abci-cli kvstore is the plain in-memory app:
            # no validator txs, no snapshots
            if self.validator_updates:
                raise ValueError(
                    "validator_updates require abci = \"builtin\"")
            if self.late_statesync_node:
                raise ValueError(
                    "late_statesync_node requires abci = \"builtin\"")
        if self.late_statesync_node and self.nodes < 4:
            # the held-back node is a validator: with n equal-power
            # validators the remaining (n-1)/n must EXCEED 2/3, so
            # n=3 leaves exactly 2/3 and the net can never commit
            # (found by the randomized manifest campaign, seed 4)
            raise ValueError("late_statesync_node requires nodes >= 4")
        if self.late_statesync_node and self.validator_updates:
            # While the last node is held back, every intermediate
            # validator set the update schedule produces must keep
            # the LIVE power strictly above 2/3 of the total, or the
            # net deadlocks before the late joiner can sync. Genesis
            # power is the testnet generator's 10 per validator.
            powers = {i: 10 for i in range(self.nodes)}
            held = self.nodes - 1
            for vu in sorted(self.validator_updates,
                             key=lambda v: v.at_height):
                powers[vu.node] = vu.power
                total = sum(powers.values())
                live = total - powers.get(held, 0)
                if live * 3 <= total * 2:
                    raise ValueError(
                        f"validator_update at height {vu.at_height} "
                        f"leaves live power {live}/{total} <= 2/3 "
                        "while the late_statesync node is held back")
        if self.wait_height < 1:
            raise ValueError("wait_height must be >= 1")
        for p in self.perturbations:
            if p.op == "statesync_poison":
                if not self.late_statesync_node:
                    raise ValueError(
                        "statesync_poison requires late_statesync_node"
                        " (it poisons the late joiner's restore)")
                if p.node == self.nodes - 1:
                    raise ValueError(
                        "statesync_poison target must be a SERVING "
                        "node, not the held-back statesync node")
            p.validate(self.nodes)
        for mb in self.misbehaviors:
            mb.validate(self.nodes)
        for vu in self.validator_updates:
            vu.validate(self.nodes)
            # power takes effect at commit+2; the final valset check
            # needs the change live by wait_height
            if vu.at_height + 3 > self.wait_height:
                raise ValueError(
                    f"validator_update at {vu.at_height} cannot take "
                    f"effect by wait_height {self.wait_height}")

    @classmethod
    def load(cls, path: str) -> "Manifest":
        import tomllib

        with open(path, "rb") as f:
            d = tomllib.load(f)
        return cls.from_dict(d)

    _KEYS = frozenset({"nodes", "chain_id", "wait_height",
                       "load_tx_rate", "timeout_commit_ms",
                       "perturbations", "misbehaviors",
                       "validator_updates", "late_statesync_node",
                       "abci", "privval", "seed_bootstrap",
                       "generator_seed"})
    _PERTURB_KEYS = frozenset({"node", "op", "at_height", "duration",
                               "failpoint", "action", "delay_ms",
                               "tx_rate", "tx_signed", "tx_garbage"})
    _MISBEHAVIOR_KEYS = frozenset({"node", "spec"})
    _VALUPDATE_KEYS = frozenset({"node", "at_height", "power"})

    @classmethod
    def from_dict(cls, d: dict) -> "Manifest":
        # A typo'd key silently running with defaults would let an e2e
        # run "pass" against a weaker bar than the manifest intended.
        unknown = set(d) - cls._KEYS
        if unknown:
            raise ValueError(f"unknown manifest keys: {sorted(unknown)}")
        for p in d.get("perturbations", []):
            bad = set(p) - cls._PERTURB_KEYS
            if bad:
                raise ValueError(
                    f"unknown perturbation keys: {sorted(bad)}")
        for mb in d.get("misbehaviors", []):
            bad = set(mb) - cls._MISBEHAVIOR_KEYS
            if bad:
                raise ValueError(
                    f"unknown misbehavior keys: {sorted(bad)}")
        for vu in d.get("validator_updates", []):
            bad = set(vu) - cls._VALUPDATE_KEYS
            if bad:
                raise ValueError(
                    f"unknown validator_update keys: {sorted(bad)}")
        m = cls(
            nodes=int(d.get("nodes", 4)),
            chain_id=d.get("chain_id", ""),
            wait_height=int(d.get("wait_height", 8)),
            load_tx_rate=float(d.get("load_tx_rate", 0.0)),
            timeout_commit_ms=int(d.get("timeout_commit_ms", 200)),
            perturbations=[
                Perturbation(
                    node=int(p["node"]),
                    op=p["op"],
                    at_height=int(p["at_height"]),
                    duration=float(p.get("duration", 3.0)),
                    failpoint=p.get("failpoint", ""),
                    action=p.get("action", "delay"),
                    delay_ms=float(p.get("delay_ms", 25.0)),
                    tx_rate=float(p.get("tx_rate", 200.0)),
                    tx_signed=float(p.get("tx_signed", 0.0)),
                    tx_garbage=float(p.get("tx_garbage", 0.0)),
                )
                for p in d.get("perturbations", [])
            ],
            misbehaviors=[
                Misbehavior(node=int(mb["node"]), spec=mb["spec"])
                for mb in d.get("misbehaviors", [])
            ],
            validator_updates=[
                ValidatorUpdate(node=int(vu["node"]),
                                at_height=int(vu["at_height"]),
                                power=int(vu["power"]))
                for vu in d.get("validator_updates", [])
            ],
            late_statesync_node=bool(d.get("late_statesync_node", False)),
            abci=d.get("abci", "builtin"),
            privval=d.get("privval", "file"),
            seed_bootstrap=bool(d.get("seed_bootstrap", False)),
            generator_seed=(int(d["generator_seed"])
                            if d.get("generator_seed") is not None
                            else None),
        )
        m.validate()
        return m
