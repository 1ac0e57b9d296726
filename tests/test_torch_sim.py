"""The port's simulator (tendermint_tpu_torch/sim) against the JAX
package's (tendermint_tpu/sim) on the host route.

The virtual clock and the sim loop, the seeded network model under
jitter and partitions, and Scenario.validate are held to the reference
on the same programs and specs. Then each smoke-tier scenario of the
catalog, at the seeds tests/test_sim.py runs it (seed 3 for
timestamp_skew, withhold_parts and double_propose), runs in both
packages and the reports must be equal on chain, app_hashes,
final_heights, fault_log, restarts, evidence_committed and
heights_at_heal, with no violation in either (statesync_poison's
restore record and mesh_device_loss's eviction record too, the mesh
entries mapped by index: the reference's eight XLA CPU devices, the
port's ``set_mesh(["cpu"] * 8)``).

The gossip picks (libs/bits.py pick_random) draw from the OS's entropy
in the reference, so two of its runs of one pair can commit different
blocks (trust_collapse at seed 5 gave 56 and 58 heights); the port's
run_scenario seeds them from (scenario, seed) (a recorded divergence),
and each reference run here draws from the same seed, which holds the
two packages to one gossip order. Tolerance: exact.

The determinism pair is repeated in the port, and the device-backend
divergence is pinned: with verify_backend "device" and no device the
port raises NoDeviceError before it builds a node, where the reference
runs on whatever platform JAX has. wan_50 and valset_10k are slow, as
the reference marks its own."""

import asyncio
import importlib
import random
import time as wall_time
import types

import pytest
import torch

from tendermint_tpu.crypto import batch as ref_batch
from tendermint_tpu.libs import bits as ref_bits
from tendermint_tpu_torch import device
from tendermint_tpu_torch.crypto import batch as port_batch
from tendermint_tpu_torch.sim.scenario import pick_seed

PACKAGES = ("tendermint_tpu", "tendermint_tpu_torch")
REPORT_KEYS = ("chain", "app_hashes", "final_heights", "fault_log",
               "restarts", "evidence_committed", "heights_at_heal",
               "violations")
PORT_MESH = ["cpu"] * 8  # the reference's conftest gives JAX 8 devices


def sim(package: str, module: str):
    return importlib.import_module(f"{package}.sim.{module}")


@pytest.fixture(autouse=True)
def _cpu():
    device.set_default_device("cpu")
    yield
    device.set_mesh(None)
    device.set_default_device(None)
    port_batch.reset_breakers()
    ref_batch.reset_breakers()


def run(package: str, name: str, seed: int, **changes) -> dict:
    """One run of a named scenario in `package`; the reference's gossip
    picks drawn from the seed the port's run_scenario uses."""
    scenario = sim(package, "scenario")
    sc = scenario.SCENARIOS[name]()
    for k, v in changes.items():
        setattr(sc, k, v)
    if package == "tendermint_tpu":
        saved = ref_bits.secrets
        ref_bits.secrets = types.SimpleNamespace(
            randbelow=random.Random(pick_seed(name, seed)).randrange)
        try:
            return scenario.run_scenario(sc, seed)
        finally:
            ref_bits.secrets = saved
    return scenario.run_scenario(sc, seed)


# -- virtual clock / sim loop ------------------------------------------


def _clock_program(package: str) -> dict:
    clock = sim(package, "clock")
    vc = clock.VirtualClock()
    loop = clock.new_sim_loop(vc)
    try:
        async def main():
            order = []

            async def sleeper(tag, d):
                await asyncio.sleep(d)
                order.append((tag, round(loop.time(), 6)))

            await asyncio.gather(sleeper("c", 30.0), sleeper("a", 5.0),
                                 sleeper("b", 12.5),
                                 sleeper("d", 12.5 + 1e-9))
            inline = await loop.run_in_executor(None, lambda: 40 + 2)
            try:
                await loop.run_in_executor(None, _raiser)
                raised = None
            except ValueError as e:
                raised = str(e)
            return order, inline, raised

        t0 = wall_time.perf_counter()
        order, inline, raised = loop.run_until_complete(main())
        wall = wall_time.perf_counter() - t0

        async def stuck():
            await asyncio.Event().wait()

        try:
            loop.run_until_complete(stuck())
            stall = None
        except clock.SimStallError as e:
            stall = str(e)
    finally:
        loop.close()
    return {"order": order, "now": vc.time(), "now_ns": vc.time_ns(),
            "inline": inline, "raised": raised, "stall": stall,
            "fast": wall < 5.0}


def _raiser():
    raise ValueError("boom")


def test_virtual_clock_and_sim_loop_equal_the_reference():
    ref, port = (_clock_program(p) for p in PACKAGES)
    assert port == ref
    assert [t for t, _ in port["order"]] == ["a", "b", "d", "c"]
    assert port["inline"] == 42 and port["raised"] == "boom"
    assert "deadlocked" in port["stall"] and port["fast"]


def test_the_libs_clock_seam_follows_the_virtual_clock():
    from tendermint_tpu_torch.libs import clock as libs_clock

    clock = sim("tendermint_tpu_torch", "clock")
    vc = clock.VirtualClock(start=7.0)
    libs_clock.install(vc)
    try:
        assert libs_clock.monotonic() == 7.0
        vc.advance(2.5)
        assert libs_clock.monotonic() == 9.5
        assert libs_clock.time_ns() == vc.time_ns() == \
            clock.VirtualClock.EPOCH_NS + 9_500_000_000
    finally:
        libs_clock.uninstall()
    assert libs_clock.installed() is None


# -- the network model -------------------------------------------------


def _network_program(package: str) -> dict:
    clock = sim(package, "clock")
    network = sim(package, "network")
    vc = clock.VirtualClock()
    loop = clock.new_sim_loop(vc)
    try:
        async def main():
            net = network.SimNetwork(seed=3, default_link=network.LinkSpec(
                latency_ms=30.0, jitter_ms=25.0), links={
                ("h1", "h3"): network.LinkSpec(latency_ms=5.0,
                                               jitter_ms=50.0,
                                               bandwidth_bps=1e6)})
            for h in ("h1", "h2", "h3"):
                net.listen(h, 1, object())
            a, b = net.connect("h1", "h2", 1)
            c, d = net.connect("h1", "h3", 1)
            got = []

            async def reader(name, conn, n):
                for _ in range(n):
                    frame = await conn.read_frame()
                    got.append((name, round(loop.time(), 9), frame))

            tasks = [asyncio.ensure_future(reader("b", b, 120)),
                     asyncio.ensure_future(reader("d", d, 80)),
                     asyncio.ensure_future(reader("a", a, 40))]
            for i in range(120):
                a.write_frame(bytes([i % 251]) * (8 + i % 5))
                if i < 80:
                    c.write_frame(bytes([i]) * 64)
                if i < 40:
                    b.write_frame(b"back%d" % i)
                if i % 7 == 0:
                    await asyncio.sleep(0.004)
            await asyncio.gather(*tasks)
            cut = net.partition([["h1"], ["h2", "h3"]])
            try:
                await b.read_frame()
                after_cut = None
            except ConnectionError as e:
                after_cut = type(e).__name__
            try:
                net.connect("h2", "h1", 1)
                refused = None
            except ConnectionError as e:
                refused = str(e)
            same_side = net.connect("h2", "h3", 1)[0].closed
            net.heal()
            e, f = net.connect("h1", "h2", 1)
            e.write_frame(b"after-heal")
            healed = (await f.read_frame(), round(loop.time(), 9))
            return {"got": got, "cut": cut, "after_cut": after_cut,
                    "refused": refused, "same_side_closed": same_side,
                    "healed": healed, "stats": dict(net.stats)}

        return loop.run_until_complete(main())
    finally:
        loop.close()


def test_sim_network_schedule_equals_the_reference():
    ref, port = (_network_program(p) for p in PACKAGES)
    assert port == ref
    # FIFO per direction despite the jitter
    for name, n in (("b", 120), ("d", 80), ("a", 40)):
        times = [t for who, t, _ in port["got"] if who == name]
        assert len(times) == n and times == sorted(times)
    assert port["cut"] == 4 and port["stats"]["dials_refused"] == 1
    assert port["healed"][0] == b"after-heal"


# -- Scenario.validate -------------------------------------------------

BAD_SPECS = [
    dict(nodes=0),
    dict(nodes=3, valset_size=2),
    dict(duration=0.0),
    dict(verify_backend="tpu"),
    dict(tier="fast"),
    dict(snapshot_interval=-1),
    dict(keep_snapshots=0),
    dict(tx_pad=-5),
    dict(consensus={"no_such_knob": 1}),
    dict(topology="mesh?"),
    dict(topology="ring+x"),
    dict(link=("LinkSpec", dict(latency_ms=-1.0))),
    dict(link=("LinkSpec", dict(loss=1.5))),
    dict(link=("LinkSpec", dict(bandwidth_bps=-1.0))),
    dict(nodes=3, duration=10.0, faults=(("Fault", dict(
        kind="partition", at=1.0, duration=2.0,
        groups=((0, 1), (1, 2)))),)),
    dict(duration=10.0, faults=(("Fault", dict(
        kind="churn", at=5.0, duration=20.0, node=0)),)),
    dict(duration=10.0, faults=(("Fault", dict(
        kind="churn", at=2.0, duration=8.0, node=0)),)),
    dict(duration=10.0, faults=(("Fault", dict(
        kind="churn", at=1.0, duration=1.0, node=9)),)),
    dict(duration=10.0, faults=(("Fault", dict(
        kind="link_down", at=1.0, duration=1.0, a=0, b=7)),)),
    dict(duration=10.0, faults=(("Fault", dict(kind="flood", at=1.0)),)),
    dict(byzantine={0: {"kind": "nope"}}),
    dict(byzantine={9: {"kind": "equivocation"}}),
]


def _build(package: str, spec: dict):
    scenario = sim(package, "scenario")
    network = sim(package, "network")

    def value(v):
        if isinstance(v, tuple) and len(v) == 2 and v[0] == "LinkSpec":
            return network.LinkSpec(**v[1])
        if isinstance(v, tuple) and v and isinstance(v[0], tuple) and \
                v[0][0] == "Fault":
            return tuple(scenario.Fault(**f[1]) for f in v)
        return v

    return scenario.Scenario(name="x", **{k: value(v)
                                          for k, v in spec.items()})


@pytest.mark.parametrize("spec", BAD_SPECS, ids=range(len(BAD_SPECS)))
def test_scenario_validate_refuses_what_the_reference_refuses(spec):
    messages = []
    for package in PACKAGES:
        with pytest.raises(ValueError) as e:
            _build(package, spec).validate()
        messages.append(str(e.value))
    assert messages[0] == messages[1]


def test_the_catalogs_equal_the_reference():
    ref, port = (sim(p, "scenario") for p in PACKAGES)
    ref_byz, port_byz = (sim(p, "byzantine") for p in PACKAGES)
    assert list(port.SCENARIOS) == list(ref.SCENARIOS)
    assert len(port.SCENARIOS) == 13
    assert port.INVARIANTS == ref.INVARIANTS
    assert list(port_byz.BYZANTINE_KINDS) == list(ref_byz.BYZANTINE_KINDS)
    for name in port.SCENARIOS:
        a, b = ref.SCENARIOS[name](), port.SCENARIOS[name]()
        assert (b.tier, b.nodes, b.valset_size, b.topology, b.duration,
                b.byzantine, b.consensus, b.min_height, b.tx_rate) == \
            (a.tier, a.nodes, a.valset_size, a.topology, a.duration,
             a.byzantine, a.consensus, a.min_height, a.tx_rate)
        assert [f.__dict__ for f in b.faults] == \
            [f.__dict__ for f in a.faults]
        assert b.edges(1) == a.edges(1)
    assert sorted(n for n, f in port.SCENARIOS.items()
                  if f().tier == "slow") == ["valset_10k", "wan_50"]


# -- the port's own runs ----------------------------------------------


def test_the_smoke_shard_is_deterministic_in_the_port():
    """The reference's determinism pair, in the port: one (scenario,
    seed) twice gives identical app hashes and block hashes (and here,
    with the gossip picks seeded, identical traffic), another seed
    another chain."""
    def blocks(r):
        return [e["block_hash"] for e in r["chain"] if e]

    first = {}
    for name, seed in (("smoke_quorum", 11), ("smoke_partition", 11)):
        r1 = run("tendermint_tpu_torch", name, seed)
        r2 = run("tendermint_tpu_torch", name, seed)
        assert r1["violations"] == [] and r2["violations"] == []
        assert r1["app_hashes"] == r2["app_hashes"]
        assert blocks(r1) == blocks(r2) and r1["net"] == r2["net"]
        first[name] = r1
    r3 = run("tendermint_tpu_torch", "smoke_quorum", 12)
    assert blocks(r3) != blocks(first["smoke_quorum"])


def test_a_device_scenario_without_a_device_raises_before_building():
    """Recorded divergence: verify_backend "device" with no GPU and no
    set_default_device("cpu") raises NoDeviceError before a node is
    built (nothing installed, nothing left behind); the reference runs
    on whatever platform JAX has. With the CPU pinned, a 4-node net's
    batches stay under the 40-lane crossover: the same report as the
    reference's device run, and no plain K4 call."""
    from tendermint_tpu_torch.crypto.cuda import verify as port_verify
    from tendermint_tpu_torch.libs import clock as libs_clock

    device.set_default_device(None)
    scenario = sim("tendermint_tpu_torch", "scenario")
    sc = scenario.SCENARIOS["smoke_quorum"]()
    sc.verify_backend = "device"
    if not torch.cuda.is_available():
        with pytest.raises(device.NoDeviceError):
            scenario.run_scenario(sc, 1)
        assert libs_clock.installed() is None
        assert not port_batch.host_forced()
    device.set_default_device("cpu")
    calls = port_verify.general_verify.launches
    port = run("tendermint_tpu_torch", "smoke_quorum", 1,
               verify_backend="device")
    assert port_verify.general_verify.launches == calls
    ref = run("tendermint_tpu", "smoke_quorum", 1, verify_backend="device")
    assert port["violations"] == [] == ref["violations"]
    assert {k: port[k] for k in REPORT_KEYS} == \
        {k: ref[k] for k in REPORT_KEYS}


# -- slow tier ---------------------------------------------------------


@pytest.mark.slow
def test_wan_50_report_equals_the_reference():
    ref = run("tendermint_tpu", "wan_50", 1)
    port = run("tendermint_tpu_torch", "wan_50", 1)
    assert port["violations"] == [] == ref["violations"]
    assert {k: port[k] for k in REPORT_KEYS} == \
        {k: ref[k] for k in REPORT_KEYS}
    assert port["evidence_committed"] >= 1 and port["restarts"][7] == 1


@pytest.mark.slow
def test_valset_10k_report_equals_the_reference():
    ref = run("tendermint_tpu", "valset_10k", 1)
    port = run("tendermint_tpu_torch", "valset_10k", 1)
    assert port["violations"] == [] == ref["violations"]
    assert {k: port[k] for k in REPORT_KEYS} == \
        {k: ref[k] for k in REPORT_KEYS}
