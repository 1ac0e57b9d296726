"""Declarative scenarios + the deterministic runner + invariants
(reference: tendermint_tpu/sim/scenario.py).

A Scenario is a seeded, declarative description of a net: topology,
valset size (keyed + phantom validators), link model, a fault
schedule (partitions/heals, node churn, link flaps), byzantine
assignments from the sim/byzantine.py catalog, tx load, and a
duration in VIRTUAL seconds. ``run_scenario(scenario, seed)`` builds
the net on a fresh sim event loop, executes the schedule, then runs
the invariant suite; every violation string embeds the
``(scenario, seed)`` pair, which is ALL that is needed to reproduce
the run bit-for-bit.

Invariants (the INVARIANTS registry; docs/CHAOS.md table):

  agreement            no two nodes commit different blocks at a height
  app_hash_oracle      every node's executed app hash at every height
                       equals an independent fold of the committed txs
                       (the kvstore hash rule), so execution divergence
                       is caught even when all nodes agree
  liveness             the net reaches the scenario's min_height
  liveness_after_heal  nodes resume committing after the last fault
                       heals (the partition/churn recovery contract)
  bounded_queues       no tracked bounded queue ever exceeds its
                       capacity while the scenario runs
  determinism          (checked by callers running twice) identical
                       (scenario, seed) → identical per-height app
                       hashes — pinned by tests and tools/scenario_sweep.py
"""

from __future__ import annotations

import asyncio
import random
import struct
import time as _wall
from dataclasses import dataclass, field

from .. import device
from ..abci.kvstore import VALIDATOR_TX_PREFIX
from ..crypto import batch as _batch
from ..libs import bits as libs_bits
from ..libs import clock as libs_clock
from ..libs.overload import CONTROLLER
from .byzantine import BYZANTINE_KINDS, make_byzantine
from .clock import SimStallError, VirtualClock, new_sim_loop
from .harness import (
    SimNode, install_verify_memo, sim_consensus_config, sim_genesis,
    sim_host,
)
from .network import LinkSpec, SimNetwork, derive_seed

FAULT_KINDS = ("partition", "churn", "link_down")

# name -> one-line contract; tools/check_scenarios.py lints this
# registry against the docs/CHAOS.md invariant table.
INVARIANTS = {
    "agreement": "no two nodes commit different blocks at any height",
    "app_hash_oracle": "executed app hashes match the committed-tx fold",
    "liveness": "the net reaches the scenario's min_height",
    "liveness_after_heal": "commits resume after the last fault heals",
    "bounded_queues": "tracked bounded queues never exceed capacity",
    "determinism": "same (scenario, seed) reproduces identical app hashes",
    "timeline_attribution": "collected height timelines reconstruct with "
                            "a proposer and full stage attribution",
}


@dataclass(frozen=True)
class Fault:
    kind: str                  # one of FAULT_KINDS
    at: float                  # virtual seconds from scenario start
    duration: float = 0.0      # heal/restart happens at at+duration
    groups: tuple = ()         # partition: tuple of tuples of node idx
    node: int = -1             # churn: which node restarts
    a: int = -1                # link_down endpoints
    b: int = -1

    def end(self) -> float:
        return self.at + self.duration


@dataclass
class Scenario:
    name: str
    nodes: int = 4
    valset_size: int | None = None  # > nodes adds phantom validators
    power: int = 100
    phantom_power: int = 1
    topology: str = "full"          # "full" | "ring" | "ring+K"
    duration: float = 20.0          # virtual seconds
    link: LinkSpec = field(default_factory=lambda: LinkSpec(
        latency_ms=25.0, jitter_ms=10.0))
    faults: tuple = ()
    # node index -> byzantine spec dict (or tuple of spec dicts):
    # {"kind": <BYZANTINE_KINDS>, "heights": [...], "from_t": ...}
    byzantine: dict = field(default_factory=dict)
    tx_rate: float = 2.0            # txs per virtual second
    min_height: int = 3
    # statesync serving: > 0 makes every node take app snapshots at
    # this height interval (retained deep — the sim commits fast, and
    # a snapshot pruned mid-fetch would flake the joiner)
    snapshot_interval: int = 0
    keep_snapshots: int = 10_000
    # pad every injected tx value with this many filler bytes: fattens
    # the app state so snapshots span MULTIPLE chunks (the statesync
    # scenarios need round-robin fetches to touch every holder)
    tx_pad: int = 0
    verify_backend: str = "host"    # "host" pins the deterministic oracle
    gossip_sleep: float = 0.05
    # ConsensusConfig field overrides on top of sim_consensus_config()
    # (e.g. production-cadence timeouts for WAN-scale scenarios: wall
    # cost tracks MESSAGES — heights and gossip ticks — not virtual
    # seconds, so stretching virtual time is free)
    consensus: dict = field(default_factory=dict)
    tier: str = "smoke"             # "smoke" (tier-1 scale) | "slow"
    # optional async probe(nodes, report) spawned beside the fault/load
    # drivers — tests use it to sample live state (trust scores, peer
    # sets) at virtual times without patching the runner
    probe = None
    # Height forensics: when True, the runner clears the global TRACER
    # at scenario start and folds per-height TIMELINE dicts (tools/
    # forensics.py) into report["timeline"], checked by the
    # timeline_attribution invariant. Off by default — a cleared
    # tracer ring is process-global state a test may not expect.
    collect_timeline: bool = False

    def byzantine_specs(self) -> list:
        out = []
        for idx in sorted(self.byzantine):
            specs = self.byzantine[idx]
            if isinstance(specs, dict):
                specs = (specs,)
            for spec in specs:
                out.append((idx, spec))
        return out

    def validate(self) -> None:
        if self.nodes < 1:
            raise ValueError("need at least one node")
        if self.valset_size is not None and self.valset_size < self.nodes:
            raise ValueError("valset_size must be >= nodes")
        if self.duration <= 0:
            raise ValueError("duration must be positive")
        if self.verify_backend not in ("host", "device"):
            raise ValueError(f"unknown verify_backend {self.verify_backend!r}")
        if self.tier not in ("smoke", "slow"):
            raise ValueError(f"unknown tier {self.tier!r}")
        if self.snapshot_interval < 0 or self.keep_snapshots < 1 or \
                self.tx_pad < 0:
            raise ValueError("bad snapshot settings")
        cfg = sim_consensus_config()
        for k in self.consensus:
            if not hasattr(cfg, k):
                raise ValueError(f"unknown consensus override {k!r}")
        if not (self.topology in ("full", "ring")
                or (self.topology.startswith("ring+")
                    and self.topology[5:].isdigit())):
            raise ValueError(f"unknown topology {self.topology!r}")
        self.link.validate()
        for f in self.faults:
            if f.kind not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {f.kind!r}")
            # strictly inside: a heal/restart scheduled AT the
            # duration loses the equal-deadline tie against the run's
            # own expiry sleep and never fires — the fault would end
            # the run half-applied with liveness_after_heal skipped
            if f.at < 0 or f.duration < 0 or f.end() >= self.duration:
                raise ValueError(
                    f"fault {f.kind} window [{f.at}, {f.end()}] must "
                    f"end strictly before scenario duration "
                    f"{self.duration} (the heal must get to run)")
            if f.kind == "partition":
                seen: set[int] = set()
                for g in f.groups:
                    for i in g:
                        if not 0 <= i < self.nodes or i in seen:
                            raise ValueError(f"bad partition groups {f.groups}")
                        seen.add(i)
            if f.kind == "churn" and not 0 <= f.node < self.nodes:
                raise ValueError(f"churn node {f.node} out of range")
            if f.kind == "link_down" and not (
                    0 <= f.a < self.nodes and 0 <= f.b < self.nodes):
                raise ValueError(f"link_down {f.a}-{f.b} out of range")
        for idx, spec in self.byzantine_specs():
            if not 0 <= idx < self.nodes:
                raise ValueError(f"byzantine node {idx} out of range")
            if spec.get("kind") not in BYZANTINE_KINDS:
                raise ValueError(f"unknown byzantine kind "
                                 f"{spec.get('kind')!r}")

    def edges(self, seed: int) -> list:
        """Deterministic topology edges [(i, j)] with i dialing j."""
        n = self.nodes
        if n == 1:
            return []
        if self.topology == "full":
            return [(i, j) for i in range(n) for j in range(i + 1, n)]
        edges = [(i, (i + 1) % n) for i in range(n)]
        if self.topology.startswith("ring+"):
            k = int(self.topology[5:])
            rng = random.Random(derive_seed("topology", self.name, seed))
            have = {frozenset(e) for e in edges}
            want = k * n // 2
            guard = 0
            while want > 0 and guard < 100 * n:
                guard += 1
                i, j = rng.randrange(n), rng.randrange(n)
                if i == j or frozenset((i, j)) in have:
                    continue
                have.add(frozenset((i, j)))
                edges.append((i, j))
                want -= 1
        return edges


# -- the runner -------------------------------------------------------


def pick_seed(name: str, seed: int) -> int:
    """The seed of the gossip picks (libs/bits.py pick_random) in a run
    of (name, seed). The reference draws them from the OS's entropy, so
    its reruns of one pair can commit different blocks (a recorded
    divergence); a test seeds the reference's draw with this to hold
    the two packages to one gossip order."""
    return derive_seed("gossip-pick", name, seed)


def run_scenario(scenario: Scenario, seed: int) -> dict:
    """Execute one seeded scenario on a fresh virtual-time loop and
    return the report dict (report["violations"] empty on success;
    every violation names the (scenario, seed) that reproduces it)."""
    scenario.validate()
    if scenario.verify_backend == "device":
        # no device: NoDeviceError here, before a node is built (the
        # reference runs on whatever platform JAX has; a net whose
        # batches stay under the crossover never reaches a device, so it
        # must not pass for a device run)
        device.default_device()
    vclock = VirtualClock()
    loop = new_sim_loop(vclock)
    libs_clock.install(vclock)
    restore_memo = install_verify_memo()
    prev_force = _batch.set_force_host(scenario.verify_backend == "host")
    rnd_state = random.getstate()
    random.seed(derive_seed("global-rng", scenario.name, seed))
    libs_bits.seed_picks(pick_seed(scenario.name, seed))
    t0 = _wall.perf_counter()
    report: dict = {
        "scenario": scenario.name, "seed": seed, "nodes": scenario.nodes,
        "virtual_duration_s": scenario.duration, "violations": [],
        "fault_log": [], "heights_at_heal": None, "last_heal_t": 0.0,
        # empty defaults so a deadlocked run (SimStallError fires
        # before _collect) still yields a well-formed report and the
        # sweep prints the repro pair instead of a KeyError traceback
        "final_heights": [], "restarts": [], "net": {}, "chain": [],
        "app_hashes": [], "evidence_committed": 0,
    }
    if scenario.collect_timeline:
        from ..libs import tracing as _tracing

        _tracing.TRACER.clear()
    try:
        loop.run_until_complete(_run(scenario, seed, report))
    except SimStallError as e:
        report["violations"].append(
            f"deadlock: {e} [scenario={scenario.name} seed={seed}]")
    finally:
        try:
            # settle stragglers (e.g. the receive routine's select
            # futures, cancelled mid-wait) so close() is silent
            pending = asyncio.all_tasks(loop)
            for t in pending:
                t.cancel()
            if pending:
                loop.run_until_complete(
                    asyncio.gather(*pending, return_exceptions=True))
        except Exception:
            pass
        try:
            loop.close()
        finally:
            random.setstate(rnd_state)
            libs_bits.seed_picks(None)
            _batch.set_force_host(prev_force)
            restore_memo()
            libs_clock.uninstall()
    report["wall_s"] = round(_wall.perf_counter() - t0, 3)
    return report


async def _run(sc: Scenario, seed: int, report: dict) -> None:
    net = SimNetwork(seed=derive_seed("net", sc.name, seed),
                     default_link=sc.link)
    gdoc, pvs = sim_genesis(sc.nodes, seed, valset_size=sc.valset_size,
                            power=sc.power, phantom_power=sc.phantom_power,
                            chain_id=f"sim-{sc.name}-{seed}")
    config = sim_consensus_config()
    for k, val in sc.consensus.items():
        setattr(config, k, val)
    nodes = [SimNode(i, gdoc, pvs[i], net, seed=seed, config=config,
                     gossip_sleep=sc.gossip_sleep,
                     snapshot_interval=sc.snapshot_interval,
                     keep_snapshots=sc.keep_snapshots)
             for i in range(sc.nodes)]
    # position k in the derivation: two same-kind specs on one node
    # must draw INDEPENDENT streams, not replay each other's
    byz = [(idx, make_byzantine(
        spec, random.Random(derive_seed(
            "byz", sc.name, seed, idx, k, spec.get("kind")))))
        for k, (idx, spec) in enumerate(sc.byzantine_specs())]
    for idx, b in byz:
        b.install(nodes[idx])
    edges = sc.edges(seed)
    try:
        for n in nodes:
            await n.start()
        for i, j in edges:
            await nodes[i].dial(nodes[j])

        drivers: list[tuple[str, asyncio.Task]] = []
        for idx, b in byz:
            d = b.driver(nodes[idx])
            if d is not None:
                drivers.append((f"byzantine[{idx}]",
                                asyncio.ensure_future(d)))
        if sc.tx_rate > 0:
            drivers.append(("tx_loader",
                            asyncio.ensure_future(_tx_loader(sc, nodes))))
        drivers.append(("queue_sampler", asyncio.ensure_future(
            _queue_sampler(sc, seed, report))))
        if sc.probe is not None:
            drivers.append(("probe", asyncio.ensure_future(
                sc.probe(nodes, report))))
        drivers.append(("fault_driver", asyncio.ensure_future(
            _fault_driver(sc, seed, nodes, net, edges, report))))

        await asyncio.sleep(sc.duration)

        for _, d in drivers:
            d.cancel()
        results = await asyncio.gather(*(d for _, d in drivers),
                                       return_exceptions=True)
        # a crashed driver means the scenario did NOT run as specified
        # (faults unapplied, load stopped early) — that must fail the
        # run loudly, not let it report a clean pass
        tag = f"[scenario={sc.name} seed={seed}]"
        for (label, _), res in zip(drivers, results):
            if isinstance(res, BaseException) and \
                    not isinstance(res, asyncio.CancelledError):
                report["violations"].append(
                    f"driver_crash: {label}: {res!r} {tag}")
    finally:
        for n in nodes:
            try:
                await n.stop()
            except Exception:
                pass
        net.close()

    _collect(sc, seed, nodes, net, report)
    _check_invariants(sc, seed, nodes, report)


async def _tx_loader(sc: Scenario, nodes: list) -> None:
    """Deterministic round-robin load: tx i lands in node i%n's
    mempool at virtual time i/rate and commits whenever that node
    proposes — app hashes then actually move, giving the oracle and
    the determinism check real material."""
    i = 0
    interval = 1.0 / sc.tx_rate
    pad = b"." * sc.tx_pad
    while True:
        node = nodes[i % len(nodes)]
        if node.running:
            node.mempool.add(b"sim-k%d=v%d" % (i, i) + pad)
        i += 1
        await asyncio.sleep(interval)


async def _queue_sampler(sc: Scenario, seed: int, report: dict) -> None:
    """bounded_queues invariant: sample every tracked queue once per
    virtual second; depth beyond capacity is a violation (shedding is
    fine — that is what the bound is FOR — overflow is not)."""
    while True:
        snap = CONTROLLER.evaluate()
        for name, q in snap["queues"].items():
            if q["capacity"] > 0 and q["depth"] > q["capacity"]:
                report["violations"].append(
                    f"bounded_queues: {name} depth {q['depth']} > "
                    f"capacity {q['capacity']} "
                    f"[scenario={sc.name} seed={seed}]")
        await asyncio.sleep(1.0)


async def _fault_driver(sc: Scenario, seed: int, nodes: list,
                        net: SimNetwork, edges: list,
                        report: dict) -> None:
    loop = asyncio.get_running_loop()
    events: list[tuple[float, int, str, Fault]] = []
    for k, f in enumerate(sorted(sc.faults, key=lambda f: (f.at, f.kind))):
        events.append((f.at, k, "begin", f))
        events.append((f.end(), k, "end", f))
    events.sort(key=lambda e: (e[0], e[1]))
    last_end = max((i for i, e in enumerate(events) if e[2] == "end"),
                   default=-1)
    for ev_idx, (at, _k, phase, f) in enumerate(events):
        delay = at - loop.time()
        if delay > 0:
            await asyncio.sleep(delay)
        report["fault_log"].append(
            {"t": round(loop.time(), 3), "fault": f.kind, "phase": phase})
        if f.kind == "partition":
            if phase == "begin":
                groups = [[sim_host(i) for i in g] for g in f.groups]
                net.partition(groups)
            else:
                net.heal()
        elif f.kind == "link_down":
            net.set_link_down(sim_host(f.a), sim_host(f.b),
                              down=(phase == "begin"))
        elif f.kind == "churn":
            node = nodes[f.node]
            if phase == "begin":
                await node.stop()
            else:
                await node.start()
                for i, j in edges:  # re-dial this node's outbound edges
                    if i == f.node:
                        try:
                            await node.dial(nodes[j])
                        except Exception:
                            pass  # peer partitioned/down: reconnect
                            # machinery retries via persistent addrs
        if ev_idx == last_end:
            report["last_heal_t"] = round(loop.time(), 3)
            report["heights_at_heal"] = [n.height() for n in nodes]


# -- collection + invariants ------------------------------------------


def _collect(sc: Scenario, seed: int, nodes: list, net: SimNetwork,
             report: dict) -> None:
    heights = [n.height() for n in nodes]
    report["final_heights"] = heights
    report["restarts"] = [n.restarts for n in nodes]
    report["net"] = dict(net.stats)
    best = max(range(len(nodes)), key=lambda i: heights[i])
    chain = []
    evidence = 0
    for h in range(1, heights[best] + 1):
        block = nodes[best].block_store.load_block(h)
        if block is None:
            chain.append(None)
            continue
        evidence += len(block.evidence.evidence)
        chain.append({
            "height": h,
            "block_hash": block.hash().hex(),
            "txs": len(block.data.txs),
        })
    # executed app hash for height h lives in header h+1
    for h in range(1, heights[best]):
        entry = chain[h - 1]
        if entry is not None:
            ah = nodes[best].app_hash_after(h)
            entry["app_hash"] = ah.hex() if ah is not None else None
    report["chain"] = chain
    report["app_hashes"] = [
        e.get("app_hash") for e in chain if e is not None]
    report["evidence_committed"] = evidence

    if sc.collect_timeline:
        from ..libs import tracing as _tracing
        from ..tools import forensics

        recs = _tracing.TRACER.snapshot()
        # only heights the whole run is past: the tip height's spans
        # are still open (a live height span isn't in the ring yet)
        done = [h for h in forensics.committed_heights(recs)
                if h < max(heights)]
        report["timeline"] = [forensics.timeline_from_ring(recs, h)
                              for h in done]
        report["timeline_dropped_spans"] = _tracing.TRACER.dropped


def _oracle_app_hashes(node, upto: int) -> dict:
    """Independent fold of the committed txs through the kvstore hash
    rule (abci/kvstore.py: app_hash = big-endian count of applied kv
    txs): catches execution divergence that unanimous agreement on a
    WRONG hash would hide."""
    size = 0
    out: dict[int, bytes] = {}
    for h in range(1, upto + 1):
        block = node.block_store.load_block(h)
        if block is None:
            continue
        for tx in block.data.txs:
            if not tx.startswith(VALIDATOR_TX_PREFIX):
                size += 1
        out[h] = struct.pack(">Q", size)
    return out


def _check_invariants(sc: Scenario, seed: int, nodes: list,
                      report: dict) -> None:
    tag = f"[scenario={sc.name} seed={seed}]"
    v = report["violations"]
    heights = report["final_heights"]
    max_h = max(heights)

    # agreement: at every height, all nodes that committed a block
    # committed the SAME block
    for h in range(1, max_h + 1):
        seen: dict[str, list[int]] = {}
        for i, n in enumerate(nodes):
            bh = n.block_hash(h)
            if bh is not None:
                seen.setdefault(bh.hex(), []).append(i)
        if len(seen) > 1:
            v.append(f"agreement: fork at height {h}: {seen} {tag}")

    # app-hash oracle, per node (execution correctness, not just
    # agreement): every executed height's app hash matches the fold
    best = max(range(len(nodes)), key=lambda i: heights[i])
    oracle = _oracle_app_hashes(nodes[best], max_h)
    for i, n in enumerate(nodes):
        for h in range(1, heights[i]):
            got = n.app_hash_after(h)
            want = oracle.get(h)
            if got is not None and want is not None and got != want:
                v.append(
                    f"app_hash_oracle: node {i} height {h} app hash "
                    f"{got.hex()} != oracle {want.hex()} {tag}")

    # liveness floor
    if max_h < sc.min_height:
        v.append(f"liveness: max height {max_h} < min_height "
                 f"{sc.min_height} {tag}")

    # liveness after the last heal: the net as a whole must keep
    # committing, and every node that was up at the end must have
    # moved past its at-heal height
    # timeline attribution (collect_timeline scenarios only): every
    # reconstructed height must name a proposer, and a fault-free
    # scenario must attribute every stage on every line — a None
    # stage means a lost anchor, i.e. the instrument itself regressed
    if sc.collect_timeline:
        from ..tools import forensics as _forensics

        tls = [t for t in report.get("timeline", []) if t]
        if not tls:
            v.append(f"timeline_attribution: no height reconstructed "
                     f"{tag}")
        for t in tls:
            if not t["proposer"]:
                v.append(f"timeline_attribution: height {t['height']} "
                         f"has no proposer {tag}")
            if not sc.faults and not sc.byzantine:
                missing = [s for s in _forensics.STAGES
                           if t["stages"][s]["ms"] is None]
                if missing:
                    v.append(
                        f"timeline_attribution: height {t['height']} "
                        f"missing stages {missing} {tag}")

    at_heal = report.get("heights_at_heal")
    if at_heal is not None:
        if max_h < max(at_heal) + 2:
            v.append(
                f"liveness_after_heal: max height {max_h} advanced "
                f"< 2 past heal snapshot {max(at_heal)} {tag}")
        for i, n in enumerate(nodes):
            if n.running and heights[i] <= at_heal[i] and \
                    heights[i] < max_h - 1:
                v.append(
                    f"liveness_after_heal: node {i} stuck at "
                    f"{heights[i]} (heal snapshot {at_heal[i]}, "
                    f"net at {max_h}) {tag}")


# -- named scenarios --------------------------------------------------

def _smoke_quorum() -> Scenario:
    return Scenario(name="smoke_quorum", nodes=4, topology="full",
                    duration=12.0, tx_rate=2.0, min_height=4)


def _smoke_partition() -> Scenario:
    return Scenario(
        name="smoke_partition", nodes=5, topology="full", duration=20.0,
        faults=(Fault(kind="partition", at=4.0, duration=5.0,
                      groups=((0, 1, 2), (3, 4))),),
        tx_rate=2.0, min_height=3)


def _smoke_churn() -> Scenario:
    return Scenario(
        name="smoke_churn", nodes=4, topology="full", duration=20.0,
        faults=(Fault(kind="churn", at=4.0, duration=4.0, node=3),),
        tx_rate=2.0, min_height=3)


def _smoke_equivocation() -> Scenario:
    return Scenario(
        name="smoke_equivocation", nodes=4, topology="full",
        duration=16.0, byzantine={3: {"kind": "equivocation",
                                      "heights": (2,)}},
        tx_rate=2.0, min_height=4)


def _smoke_garbage_flood() -> Scenario:
    return Scenario(
        name="smoke_garbage_flood", nodes=5, topology="full",
        duration=18.0,
        byzantine={4: {"kind": "garbage_flood", "rate": 30.0,
                       "from_t": 2.0, "until_t": 12.0}},
        tx_rate=2.0, min_height=3)


def _trust_collapse() -> Scenario:
    return Scenario(
        name="trust_collapse", nodes=5, topology="full", duration=30.0,
        byzantine={4: {"kind": "bad_signature_flood",
                       "from_t": 2.0, "until_t": 12.0}},
        tx_rate=2.0, min_height=3)


def _wan_50() -> Scenario:
    """The acceptance scenario: a 50-node WAN ring at PRODUCTION
    cadence (10 s commit pace, 20±8 ms links) with a 40-second 25/25
    partition, one churned node, an equivocating validator and a
    garbage-flooding one — 5 minutes of large-net virtual time in
    roughly half that wall clock, where a real 50-node net would need
    the full 5 minutes plus 50 machines."""
    return Scenario(
        name="wan_50", nodes=50, topology="ring+3", duration=420.0,
        link=LinkSpec(latency_ms=20.0, jitter_ms=8.0),
        faults=(
            Fault(kind="partition", at=50.0, duration=50.0,
                  groups=(tuple(range(0, 25)), tuple(range(25, 50)))),
            Fault(kind="churn", at=200.0, duration=30.0, node=7),
        ),
        byzantine={
            3: {"kind": "equivocation", "heights": (3,)},
            11: {"kind": "garbage_flood", "rate": 10.0,
                 "from_t": 20.0, "until_t": 140.0},
        },
        consensus={"timeout_propose_ms": 3000, "timeout_prevote_ms": 1000,
                   "timeout_precommit_ms": 1000,
                   "timeout_commit_ms": 15_000},
        tx_rate=1.0, min_height=10, gossip_sleep=0.25, tier="slow")


def _valset_10k() -> Scenario:
    """10k-validator valset structures (phantom low-power committee)
    through proposer selection, commit assembly and verification at
    every height. Wide-lane device launches are covered separately
    (test_scale_10k); this pins the CONSENSUS structures at scale."""
    return Scenario(
        # keyed power must beat the phantom mass: 6 validators must
        # hold > 2/3 of (6*power + 9994*1) total, i.e. power > 3332
        name="valset_10k", nodes=6, valset_size=10_000, power=4000,
        topology="full", duration=10.0, tx_rate=2.0, min_height=2,
        tier="slow")


def _timestamp_skew() -> Scenario:
    return Scenario(
        name="timestamp_skew", nodes=4, topology="full", duration=16.0,
        byzantine={2: {"kind": "timestamp_skew", "skew_ms": 120_000}},
        tx_rate=2.0, min_height=4)


def _withhold_parts() -> Scenario:
    return Scenario(
        name="withhold_parts", nodes=4, topology="full", duration=20.0,
        byzantine={1: {"kind": "withhold_parts",
                       "heights": (2, 3)}},
        tx_rate=2.0, min_height=3)


def _mesh_loss_probe():
    """Driver for mesh_device_loss: evict one verify-mesh device
    mid-height (per-device breaker, reason="scenario"), sample the
    watchdog's degraded view, then deterministically re-admit it
    (readmit_device — the virtual clock cannot wait out the wall-clock
    half-open cooldown) and check the fabric reports full width again.
    Each lifecycle step that fails appends a first-class violation."""

    async def probe(nodes, report):
        from ..crypto.cuda import watchdog as _watchdog

        tag = "[scenario=mesh_device_loss]"
        # a real forced host mesh when the process has one (tests /
        # sweep under the 8-device conftest env); a synthetic device
        # name otherwise — per-device breakers key on strings, so the
        # evict -> report -> re-admit lifecycle is identical
        devs = _batch._mesh_device_strs()
        dev = devs[3] if len(devs) > 3 else "sim-mesh:3"
        report["mesh_device"] = dev
        await asyncio.sleep(3.0)
        _batch.mark_device_failed("ed25519", device=dev,
                                  reason="scenario")
        evicted = _watchdog.evicted_mesh_devices()
        report["mesh_evicted"] = list(evicted)
        if dev not in evicted:
            report["violations"].append(
                f"mesh_device_loss: {dev} not reported evicted after "
                f"mark_device_failed (got {evicted}) {tag}")
        if _batch.breaker("ed25519").state != _batch.CLOSED:
            report["violations"].append(
                "mesh_device_loss: backend breaker opened on a "
                f"single-device eviction {tag}")
        await asyncio.sleep(4.0)
        _batch.readmit_device("ed25519", dev)
        left = _watchdog.evicted_mesh_devices()
        report["mesh_readmitted"] = list(left)
        if dev in left:
            report["violations"].append(
                f"mesh_device_loss: {dev} still evicted after "
                f"re-admission (got {left}) {tag}")

    return probe


def _mesh_device_loss() -> Scenario:
    """A verify-mesh chip fails MID-HEIGHT: its per-device breaker
    opens (the backend breaker stays closed), the watchdog reports the
    eviction, the net keeps committing on the survivors, and the
    device re-admits — liveness, app_hash_oracle and bounded_queues
    stay green through the whole evict -> degraded -> re-admit
    lifecycle."""
    sc = Scenario(name="mesh_device_loss", nodes=4, topology="full",
                  duration=14.0, tx_rate=2.0, min_height=4)
    sc.probe = _mesh_loss_probe()
    return sc


def _statesync_poison_probe():
    """Driver for statesync_poison: at t=10 boot a FRESH non-validator
    SimNode and state-sync it off the live net — which contains one
    `snapshot_poison` chunk corrupter and one `snapshot_liar`
    advertising heights it cannot serve. The joiner must finish the
    restore from the honest holders with the app bytes the light
    client verified, quarantine the poisoner BY NAME, and shrug the
    liar's adverts off as rejected snapshots. Every departure from
    that is a first-class violation."""

    async def probe(nodes, report):
        from ..libs.db import MemDB
        from ..light import (
            BlockStoreProvider, Client, LightStore, TrustOptions,
        )
        from ..statesync.stateprovider import LightClientStateProvider
        from .harness import SimNode

        seed = report["seed"]
        tag = f"[scenario=statesync_poison seed={seed}]"
        honest, poisoner = nodes[0], nodes[3]
        await asyncio.sleep(10.0)  # interval snapshots now exist

        HOUR = 3600 * 10**9

        def provider_factory(node):
            # trusted state comes off an HONEST node's stores — the
            # byzantine pair can only touch the snapshot channels
            prov = BlockStoreProvider(honest.block_store,
                                      honest.state_store, name="sim0")
            lc = Client(
                honest.gdoc.chain_id,
                TrustOptions(period_ns=HOUR, height=1,
                             hash=honest.block_store.load_block_meta(1)
                             .block_id.hash),
                prov, [prov], LightStore(MemDB()),
                now_fn=lambda: honest.gdoc.genesis_time + HOUR // 2,
            )
            return LightClientStateProvider(lc)

        joiner = SimNode(len(nodes), honest.gdoc, None, honest.network,
                         seed=seed, config=honest.config,
                         gossip_sleep=honest.gossip_sleep,
                         state_provider_factory=provider_factory,
                         run_consensus=False)
        await joiner.start()
        try:
            for n in nodes:
                await joiner.dial(n, persistent=False)
            # let every holder's advertisements land before the sync
            # picks a snapshot: the round-robin first attempt must
            # know ALL the holders (poisoner included) or the restore
            # would ride whoever answered first and never meet the
            # adversary
            await asyncio.sleep(2.0)
            state, _commit = await asyncio.wait_for(
                joiner.ss_reactor.sync(), 30.0)
            syncer = joiner.ss_reactor.syncer
            h = state.last_block_height
            report["statesync"] = {
                "height": h,
                "restore_attempts": syncer._restore_attempt,
                "quarantined": syncer.quarantined_peers(),
            }
            if joiner.app.height != h or \
                    joiner.app.app_hash != state.app_hash:
                report["violations"].append(
                    f"statesync_poison: restored app h={joiner.app.height}"
                    f" hash={joiner.app.app_hash.hex()} != verified state"
                    f" h={h} hash={state.app_hash.hex()} {tag}")
            want = honest.app_hash_after(h)
            if want is not None and joiner.app.app_hash != want:
                report["violations"].append(
                    f"statesync_poison: restored app hash "
                    f"{joiner.app.app_hash.hex()} != honest chain oracle "
                    f"{want.hex()} at h={h} {tag}")
            if poisoner.node_key.id not in syncer.quarantined_peers():
                report["violations"].append(
                    f"statesync_poison: poisoner {poisoner.node_key.id[:8]}"
                    f" not quarantined (got {syncer.quarantined_peers()})"
                    f" {tag}")
            for n in (nodes[0], nodes[1]):
                if n.node_key.id in syncer.quarantined_peers():
                    report["violations"].append(
                        f"statesync_poison: honest node {n.index} "
                        f"({n.node_key.id[:8]}) wrongly quarantined {tag}")
        except Exception as e:
            report["violations"].append(
                f"statesync_poison: joiner restore failed: {e!r} {tag}")
        finally:
            await joiner.stop()

    return probe


def _statesync_poison() -> Scenario:
    """Adversarial bootstrap: all four validators serve interval
    snapshots; node 3 poisons the chunks it serves, node 2 advertises
    lifted heights it cannot serve. The probe's joining node must
    still complete a verified restore from the honest holders with
    the poisoner quarantined by name — a poisoner costs bandwidth,
    never a joiner's liveness — while the validator net keeps
    committing underneath."""
    sc = Scenario(
        name="statesync_poison", nodes=4, topology="full",
        duration=22.0, snapshot_interval=2,
        # ~20 padded txs land before the probe joins: the snapshot
        # payload spans >= 3 chunks, so the round-robin first attempt
        # touches every holder — including the poisoner
        tx_pad=8192,
        byzantine={3: {"kind": "snapshot_poison"},
                   2: {"kind": "snapshot_liar", "lift": 1000}},
        tx_rate=2.0, min_height=4)
    sc.probe = _statesync_poison_probe()
    return sc


def _double_propose() -> Scenario:
    return Scenario(
        name="double_propose", nodes=4, topology="full", duration=20.0,
        byzantine={i: {"kind": "double_propose", "heights": (2,)}
                   for i in range(4)},
        tx_rate=2.0, min_height=3)


SCENARIOS: dict = {}
for _f in (_smoke_quorum, _smoke_partition, _smoke_churn,
           _smoke_equivocation, _smoke_garbage_flood, _trust_collapse,
           _timestamp_skew, _withhold_parts, _double_propose,
           _mesh_device_loss, _statesync_poison, _wan_50, _valset_10k):
    _sc = _f()
    _sc.validate()
    SCENARIOS[_sc.name] = _f
