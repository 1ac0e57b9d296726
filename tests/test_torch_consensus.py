"""The port's consensus state machine commits heights by itself, in the
shapes of the reference's tests/test_consensus.py and
tests/test_maverick.py: a single validator, a full restart from FileDBs,
the WAL and a FilePV, a 4-node in-process network wired by
broadcast_hooks, a DoublePrevote maverick whose evidence is committed,
the speculation flusher serving a LastCommit with no verification
launch, crash healing at the two consensus.commit.* failpoints (the
RecoveryReport names the reference's repair for the same point), and
the port's kernel-fault rule (a KernelError from a vote batch halts the
node; the reference degrades the batch to the host and goes on).

Everything runs on the CPU (set_default_device("cpu")) at 1-4
validators, so every signature check takes the host path and no kernel
is asked for, except where a test counts launches. Waits are generous
and progress-gated: no assertion depends on which of two racing tasks
runs first."""

import asyncio
import hashlib
import types

import pytest

from tendermint_tpu_torch.abci.client import ClientCreator
from tendermint_tpu_torch.abci.kvstore import PersistentKVStoreApp
from tendermint_tpu_torch.config import (ConsensusConfig, SpeculationConfig,
                                         fast_consensus_config)
from tendermint_tpu_torch.consensus import messages as m
from tendermint_tpu_torch.consensus.misbehavior import DoublePrevote
from tendermint_tpu_torch.consensus.replay import reconcile_and_handshake
from tendermint_tpu_torch.consensus.speculation import SpeculationPlane
from tendermint_tpu_torch.consensus.state import ConsensusState
from tendermint_tpu_torch.consensus.wal import WAL
from tendermint_tpu_torch.crypto import batch as pbatch
from tendermint_tpu_torch.crypto import ed25519
from tendermint_tpu_torch.device import set_default_device
from tendermint_tpu_torch.evidence import Pool
from tendermint_tpu_torch.libs import failpoints
from tendermint_tpu_torch.libs.db import FileDB, MemDB
from tendermint_tpu_torch.privval import FilePV
from tendermint_tpu_torch.proxy import AppConns
from tendermint_tpu_torch.state.execution import BlockExecutor
from tendermint_tpu_torch.state.store import Store
from tendermint_tpu_torch.store import BlockStore
from tendermint_tpu_torch.types.events import EventBus
from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence
from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from tendermint_tpu_torch.types.priv_validator import MockPV

CHAIN = "torch-consensus-chain"
GENESIS_TIME = 1_700_000_000 * 1_000_000_000
WAIT_S = 120.0
# the networks' rounds at the default timeouts, so a node slowed by the
# load of other tests still sees each round's proposal; 200 ms between
# heights
NET_CONFIG = dict(timeout_commit_ms=200)


@pytest.fixture(autouse=True)
def _cpu():
    set_default_device("cpu")
    pbatch.reset_breakers()
    yield
    failpoints.disarm_all()
    pbatch.reset_breakers()
    set_default_device(None)


def seed(i: int) -> bytes:
    return hashlib.sha256(b"cs-val-%d" % i).digest()


def genesis(n: int):
    keys = [ed25519.Ed25519PrivKey(seed(i)) for i in range(n)]
    gdoc = GenesisDoc(chain_id=CHAIN, genesis_time=GENESIS_TIME,
                      validators=[GenesisValidator(k.pub_key(), 10)
                                  for k in keys])
    gdoc.validate_and_complete()
    return gdoc, keys


class Node:
    """One in-process validator: stores (FileDBs under `home` with a
    WAL, or MemDBs), the kvstore app behind AppConns, an EventBus, an
    evidence Pool, optionally a SpeculationPlane, and ConsensusState
    signing with `pv`."""

    def __init__(self, gdoc, pv, home=None, config=None, speculation=None):
        self.gdoc, self.pv, self.home = gdoc, pv, home
        self.config = config or fast_consensus_config()
        self.speculation = speculation
        if home is not None:
            self.dbs = tuple(FileDB(str(home / f"{n}.db"))
                             for n in ("state", "blocks", "app", "evidence"))
            self.wal_path = str(home / "cs.wal" / "wal")
        else:
            self.dbs = (MemDB(), MemDB(), MemDB(), MemDB())
            self.wal_path = None
        self.cs = None

    async def start(self):
        self.app = PersistentKVStoreApp(self.dbs[2])
        self.conns = AppConns(ClientCreator(app=self.app))
        await self.conns.start()
        self.ss, self.bs = Store(self.dbs[0]), BlockStore(self.dbs[1])
        self.state, self.report = await reconcile_and_handshake(
            None, self.ss, self.bs, self.gdoc, self.conns,
            wal_path=self.wal_path)
        self.bus = EventBus()
        self.evpool = Pool(self.dbs[3], self.ss, self.bs)
        executor = BlockExecutor(self.ss, self.conns.consensus,
                                 evidence_pool=self.evpool,
                                 event_bus=self.bus,
                                 speculation=self.speculation)
        self.cs = ConsensusState(
            self.config, self.state, executor, self.bs, evpool=self.evpool,
            wal=WAL(self.wal_path) if self.wal_path else None,
            event_bus=self.bus, speculation=self.speculation)
        self.cs.set_priv_validator(self.pv)
        await self.cs.start()
        return self

    async def stop(self):
        if self.cs is not None and self.cs.is_running:
            await self.cs.stop()
        await self.conns.stop()
        for db in self.dbs:
            db.close()


def msg_height(msg) -> int:
    if isinstance(msg, m.ProposalMessage):
        return msg.proposal.height
    if isinstance(msg, m.VoteMessage):
        return msg.vote.height
    return msg.height


def wire(nodes):
    """Relay proposals, parts and votes between the nodes (in lieu of
    p2p); a maverick's split vote goes one way to even-numbered peers
    and the other way to odd-numbered ones. A message for a height its
    destination has not reached waits in that node's inbox until it
    does, as the reactor's gossip would send it again: a node that
    commits late under load must not lose the next height's votes.
    Returns the pump tasks (cancel them before stopping the nodes)."""
    inboxes = [[] for _ in nodes]
    wakes = [asyncio.Event() for _ in nodes]

    for i, src in enumerate(nodes):
        def hook(event, payload, i=i):
            for j, dst in enumerate(nodes):
                if j == i or dst.cs is None or not dst.cs.is_running:
                    continue
                if event == "proposal":
                    msg = m.ProposalMessage(payload)
                elif event == "block_part":
                    msg = payload
                elif event == "vote":
                    msg = m.VoteMessage(payload)
                elif event == "vote_split":
                    msg = payload[j % 2]
                else:
                    continue
                inboxes[j].append((msg, f"n{i}"))
                wakes[j].set()
        src.cs.broadcast_hooks.append(hook)

    async def pump(j):
        dst = nodes[j]
        while True:
            held = []
            for msg, peer in inboxes[j]:
                if msg_height(msg) > dst.cs.rs.height:
                    held.append((msg, peer))
                else:
                    await dst.cs.add_peer_msg(msg, peer)
            inboxes[j][:] = held  # no await since the loop's last item
            wakes[j].clear()
            try:
                await asyncio.wait_for(wakes[j].wait(), 0.05)
            except asyncio.TimeoutError:
                pass

    return [asyncio.get_running_loop().create_task(pump(j))
            for j in range(len(nodes))]


async def stop_net(pumps, nodes):
    for t in pumps:
        t.cancel()
    await asyncio.gather(*pumps, return_exceptions=True)
    for n in nodes:
        await n.stop()


def run(coro):
    return asyncio.run(coro)


def test_single_validator_produces_blocks(tmp_path):
    async def go():
        gdoc, keys = genesis(1)
        node = await Node(gdoc, MockPV(keys[0]), tmp_path).start()
        try:
            await node.cs.wait_for_height(3, timeout=WAIT_S)
            assert node.cs.state.last_block_height >= 3
            b2 = node.bs.load_block(2)
            assert b2.header.height == 2 and b2.last_commit.height == 1
            assert node.app.height >= 3
            assert node.cs.rs.height == node.cs.state.last_block_height + 1
        finally:
            await node.stop()

    run(go())


def test_restart_from_disk_recovers_and_goes_on(tmp_path):
    """FileDBs, the WAL and a FilePV on disk; a full restart goes on
    from where it stopped, and the FilePV's state file holds the last
    HRS it signed."""
    async def go():
        gdoc, keys = genesis(1)
        key, st = str(tmp_path / "pv_key.json"), str(tmp_path / "pv_state.json")
        pv = FilePV(keys[0], key, st)
        pv.save_key()
        node = await Node(gdoc, pv, tmp_path).start()
        await node.cs.wait_for_height(2, timeout=WAIT_S)
        await node.stop()
        h_stop = node.cs.state.last_block_height
        lss = FilePV.load(key, st).last_sign_state
        assert lss.height >= h_stop and lss.step >= 1

        node2 = await Node(gdoc, FilePV.load(key, st), tmp_path).start()
        try:
            assert node2.cs.state.last_block_height >= h_stop
            await node2.cs.wait_for_height(h_stop + 2, timeout=WAIT_S)
            assert node2.bs.height >= h_stop + 2
            for h in range(1, h_stop + 2):
                assert node2.bs.load_block(h).header.height == h
        finally:
            await node2.stop()

    run(go())


def test_four_node_network_agrees_on_block_3():
    async def go():
        gdoc, keys = genesis(4)
        nodes = [Node(gdoc, MockPV(k), config=ConsensusConfig(**NET_CONFIG))
                 for k in keys]
        for n in nodes:
            await n.start()
        pumps = wire(nodes)
        try:
            await asyncio.gather(*(n.cs.wait_for_height(3, timeout=WAIT_S)
                                   for n in nodes))
            for h in (1, 2, 3):
                hashes = {n.bs.load_block_meta(h).header.hash()
                          for n in nodes}
                assert len(hashes) == 1, f"fork at height {h}"
        finally:
            await stop_net(pumps, nodes)

    run(go())


def test_double_prevote_evidence_is_committed():
    """A maverick double-prevotes at height 2; honest nodes that relay
    each other's votes build DuplicateVoteEvidence, and it lands in a
    block on every node."""
    async def go():
        gdoc, keys = genesis(4)
        nodes = [Node(gdoc, MockPV(k), config=ConsensusConfig(**NET_CONFIG))
                 for k in keys]
        for n in nodes:
            await n.start()
        nodes[3].cs.misbehaviors[2] = DoublePrevote()
        pumps = wire(nodes)

        def committed(node):
            for h in range(1, node.bs.height + 1):
                b = node.bs.load_block(h)
                if b is not None and b.evidence.evidence:
                    return b.evidence.evidence
            return None

        try:
            for _ in range(2400):
                if all(committed(n) for n in nodes):
                    break
                await asyncio.sleep(0.05)
            evs = [committed(n) for n in nodes]
            assert all(evs), [bool(e) for e in evs]
            ev = evs[0][0]
            assert isinstance(ev, DuplicateVoteEvidence)
            assert ev.vote_a.validator_address == \
                keys[3].pub_key().address()
            assert ev.vote_a.height == 2
            await asyncio.gather(*(n.cs.wait_for_height(4, timeout=WAIT_S)
                                   for n in nodes))
        finally:
            await stop_net(pumps, nodes)

    run(go())


def test_speculation_flusher_serves_the_last_commit(monkeypatch):
    """A single validator with a SpeculationPlane at SpeculationConfig's
    defaults (one validator is below the device crossover, so the
    flusher's launches verify on the host) and a 300 ms timeout_commit:
    the plane's own flusher launches as the precommits arrive, and each
    later block's LastCommit is served from it, with no verify_commit."""
    from tendermint_tpu_torch.types import validator_set

    served, verifies = [], []
    real_verify = validator_set.ValidatorSet.verify_commit

    def counting(self, *a, **kw):
        verifies.append(a[2].height if len(a) > 2 else None)
        return real_verify(self, *a, **kw)

    monkeypatch.setattr(validator_set.ValidatorSet, "verify_commit", counting)

    async def go():
        gdoc, keys = genesis(1)
        plane = SpeculationPlane(SpeculationConfig())
        real_serve = plane.serve_commit

        def serve(*a):
            ok = real_serve(*a)
            served.append((a[3], ok))
            return ok

        plane.serve_commit = serve
        cfg = ConsensusConfig(timeout_commit_ms=300)
        node = await Node(gdoc, MockPV(keys[0]), config=cfg,
                          speculation=plane).start()
        try:
            await node.cs.wait_for_height(3, timeout=WAIT_S)
            assert plane._flusher is not None and plane.fault is None
        finally:
            await node.stop()
        return plane

    plane = run(go())
    assert plane.hits >= 2 and not any(plane.misses.values())
    assert [ok for _, ok in served[:2]] == [True, True]
    assert verifies == []
    assert plane.status_check()["hits"] == plane.hits


async def crash_and_restart(p, home, point):
    """One validator of package p over FileDBs and a WAL under `home`:
    commit two heights, arm `point` with `error`, wait until a block is
    saved that the state never applied, stop; then reopen every store
    and reconcile. The repairs named, the heights, and whether the
    restarted node commits on."""
    import test_torch_consensus_state as parity

    gdoc = parity.genesis_doc(p, 1)
    pv = p.pv.MockPV(p.ed.Ed25519PrivKey(parity.seed(0)))

    async def node():
        dbs = [p.db.FileDB(str(home / f"{n}.db"))
               for n in ("state", "blocks", "app")]
        app = p.kv.PersistentKVStoreApp(dbs[2])
        conns = p.proxy.AppConns(p.client.ClientCreator(app=app))
        await conns.start()
        ss, bs = p.sstore.Store(dbs[0]), p.bstore.BlockStore(dbs[1])
        wal_path = str(home / "cs.wal" / "wal")
        state, report = await p.replay.reconcile_and_handshake(
            None, ss, bs, gdoc, conns, wal_path=wal_path)
        ex = p.ex.BlockExecutor(ss, conns.consensus)
        cs = p.cs.ConsensusState(p.config.fast_consensus_config(), state, ex,
                                 bs, wal=p.wal.WAL(wal_path))
        cs.set_priv_validator(pv)
        await cs.start()
        return types.SimpleNamespace(dbs=dbs, conns=conns, bs=bs, cs=cs,
                                     report=report)

    async def until(cond):
        for _ in range(int(WAIT_S / 0.01)):
            if cond():
                return
            await asyncio.sleep(0.01)
        raise TimeoutError(point)

    async def stop(n):
        if n.cs.is_running:
            await n.cs.stop()
        await n.conns.stop()
        for db in n.dbs:
            db.close()

    n = await node()
    await until(lambda: n.cs.state.last_block_height >= 2)
    p.failpoints.arm(point, "error")
    await until(lambda: n.bs.height > n.cs.state.last_block_height)
    await asyncio.sleep(0.2)
    p.failpoints.disarm_all()
    crashed = (n.bs.height, n.cs.state.last_block_height)
    await stop(n)
    n = await node()
    healed = n.cs.state.last_block_height
    await until(lambda: n.cs.state.last_block_height >= crashed[0] + 1)
    await stop(n)
    return [r["kind"] for r in n.report.repairs], crashed[0] - crashed[1], \
        healed - crashed[0]


@pytest.mark.parametrize("point", ["consensus.commit.block_saved",
                                   "consensus.commit.wal_delimited"])
def test_a_crash_at_a_commit_point_heals_on_restart(tmp_path, point):
    """An error at the point while a single validator commits: the port's
    node halts (wait_for_height re-raises it), the reference's stalls;
    the restart from disk names the same repair in both packages'
    RecoveryReport (state_reapply), heals to the saved block and commits
    on."""
    import test_torch_consensus_state as parity

    async def halted():
        gdoc, keys = genesis(1)
        node = await Node(gdoc, MockPV(keys[0]), tmp_path / "halt").start()
        await node.cs.wait_for_height(2, timeout=WAIT_S)
        failpoints.arm(point, "error")
        try:
            with pytest.raises(failpoints.FailpointError) as e:
                await node.cs.wait_for_height(10, timeout=WAIT_S)
        finally:
            failpoints.disarm_all()
        while node.cs.is_running:
            await asyncio.sleep(0.01)
        await node.stop()
        return e.value.name

    (tmp_path / "halt").mkdir()
    assert run(halted()) == point
    got = {}
    for p in (parity.REF, parity.PORT):
        (tmp_path / p.name).mkdir()
        got[p.name] = run(crash_and_restart(p, tmp_path / p.name, point))
    assert got["tendermint_tpu_torch"] == got["tendermint_tpu"] == \
        (["state_reapply"], 1, 0)


def test_a_kernel_error_from_a_vote_batch_halts_the_node(monkeypatch):
    """The divergence of ROADMAP Queue C: a KernelError from a vote
    batch ends the port's scheduler task, the node stops and
    wait_for_height re-raises it; the reference's scheduler degrades
    the same batch to host verification and the node commits on."""
    import tendermint_tpu.consensus.state as rstate
    from tendermint_tpu.config import ConsensusConfig as RConfig
    from tendermint_tpu_torch.consensus import state as pstate
    from tendermint_tpu_torch.crypto.cuda.kernels import KernelError

    import test_torch_consensus_state as parity

    def port_boom(batch, chain_id):
        raise KernelError("injected launch failure (CUDA code 700)")

    def ref_boom(self, batch, chain_id):
        raise RuntimeError("injected launch failure")

    monkeypatch.setattr(pstate, "batch_verdicts", port_boom)
    monkeypatch.setattr(rstate.ConsensusState, "_batch_verdicts", ref_boom)

    async def go(p, config):
        clock = parity.Clock()
        p.clock.install(clock)
        net = parity.Net(p, config=config, n_vals=4, node_index=0,
                         clock=clock)
        await net.start()
        try:
            # the three peers' prevotes and precommits for height 1
            got = await parity.outcome(net.drive_height_with_peer_batches())
            running, height = net.cs.is_running, net.cs.rs.height
        finally:
            await net.stop()
            p.clock.uninstall()
        return got, running, height

    cfg = dict(vote_batch_window_ms=1.0, timeout_propose_ms=600_000,
               timeout_prevote_ms=600_000, timeout_precommit_ms=600_000,
               timeout_commit_ms=600_000)
    ref = run(go(parity.REF, RConfig(**cfg)))
    port = run(go(parity.PORT, ConsensusConfig(**cfg)))
    assert ref == (("ok", None), True, 2)
    assert port[0][0] == "KernelError" and port[1:] == (False, 1)


def test_a_kernel_error_ends_the_speculation_flusher(monkeypatch):
    """The plane's flusher re-raises a KernelError instead of leaving the
    lanes for the commit-time fallback: the plane keeps it as `fault`
    and the next feed (the state machine's _add_vote) raises it."""
    from tendermint_tpu_torch.crypto.cuda.kernels import KernelError
    from tendermint_tpu_torch.types.block import BlockID, PartSetHeader
    from tendermint_tpu_torch.types.vote import Vote, VoteType

    gdoc, keys = genesis(4)
    from tendermint_tpu_torch.state import make_genesis_state

    vals = make_genesis_state(gdoc).validators
    bid = BlockID(b"\x01" * 32, PartSetHeader(1, b"\x02" * 32))

    def precommit(i):
        v = Vote(type=VoteType.PRECOMMIT, height=1, round=0, block_id=bid,
                 timestamp=GENESIS_TIME + i,
                 validator_address=vals.validators[i].address,
                 validator_index=i)
        v.signature = b"\x00" * 64
        return v

    def boom(entry, batch):
        raise KernelError("injected arena launch failure (CUDA code 700)")

    async def go():
        plane = SpeculationPlane(SpeculationConfig(flush_ms=0))
        monkeypatch.setattr(plane, "_launch_batch", boom)
        plane.begin_height(CHAIN, vals, 1, 0, bid)
        plane.observe_precommit(precommit(0))
        for _ in range(500):
            if plane.fault is not None:
                break
            await asyncio.sleep(0.01)
        assert isinstance(plane.fault, KernelError)
        with pytest.raises(KernelError):
            plane.observe_precommit(precommit(1))
        plane.close()

    run(go())
