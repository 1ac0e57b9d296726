"""The port's consensus reactor over real p2p, held against the JAX
package's (no kernel launches: four validators verify on the host). A
4-validator port net over TCP commits blocks; a mixed net of two port
and two reference nodes agrees on every block, app hash and results
hash; a port node that joins late catches up by gossip and then takes
part; PeerState's bit arrays equal the reference's after one scripted
message sequence; and the port's fault rule at the gossip routines: a
KernelError there halts the node (the reference logs it and the
routine dies). Each scenario runs under one deadline and asserts
outcomes, never timings.

``Node`` is the multi-node harness the other p2p test files use (the
reference's tests/p2p_harness.py P2PNode, for either package)."""

from __future__ import annotations

import asyncio
import hashlib
import importlib
import types

import pytest

from tendermint_tpu_torch.crypto import batch as pbatch
from tendermint_tpu_torch.crypto.cuda.kernels import KernelError
from tendermint_tpu_torch.device import set_default_device

CHAIN = "torch-p2p-chain"
GENESIS_TIME = 1_700_000_000 * 1_000_000_000
DEADLINE_S = 60.0

_MODULES = {
    "client": "abci.client", "kvstore": "abci.kvstore",
    "bcreactor": "blockchain.reactor", "config": "config",
    "reactor": "consensus.reactor", "replay": "consensus.replay",
    "cstate": "consensus.state", "messages": "consensus.messages",
    "cstypes": "consensus.cstypes", "ed25519": "crypto.ed25519",
    "evidence": "evidence", "evreactor": "evidence.reactor",
    "bits": "libs.bits", "db": "libs.db",
    "clist": "mempool.clist_mempool", "mreactor": "mempool.reactor",
    "key": "p2p.key", "node_info": "p2p.node_info", "switch": "p2p.switch",
    "transport": "p2p.transport", "proxy": "proxy",
    "execution": "state.execution", "sstore": "state.store",
    "store": "store", "block": "types.block", "events": "types.events",
    "genesis": "types.genesis", "pv": "types.priv_validator",
    "vote": "types.vote",
}


def _namespace(root: str) -> types.SimpleNamespace:
    ns = types.SimpleNamespace(name=root)
    for attr, mod in _MODULES.items():
        setattr(ns, attr, importlib.import_module(f"{root}.{mod}"))
    return ns


PORT = _namespace("tendermint_tpu_torch")
REF = _namespace("tendermint_tpu")


@pytest.fixture(autouse=True)
def _cpu():
    set_default_device("cpu")
    pbatch.reset_breakers()
    yield
    pbatch.reset_breakers()
    set_default_device(None)


def run(coro, deadline: float = DEADLINE_S):
    return asyncio.run(asyncio.wait_for(coro, deadline))


def seed(i: int) -> bytes:
    return hashlib.sha256(b"p2p-val-%d" % i).digest()


def genesis(p, n: int):
    keys = [p.ed25519.Ed25519PrivKey(seed(i)) for i in range(n)]
    gdoc = p.genesis.GenesisDoc(
        chain_id=CHAIN, genesis_time=GENESIS_TIME,
        validators=[p.genesis.GenesisValidator(k.pub_key(), 10)
                    for k in keys])
    gdoc.validate_and_complete()
    return gdoc, [p.pv.MockPV(k) for k in keys]


class Node:
    """One node of package `p` wired through a real Switch over TCP:
    the kvstore app behind AppConns, MemDB stores, an evidence Pool and
    its reactor, the consensus reactor, the blockchain reactor
    (`fast_sync` drives it), and with `mempool` a CListMempool and its
    reactor. `pv` None makes a non-validator. The app snapshots every
    `snapshot_interval` heights (keeping `keep_snapshots`); `statesync`
    adds a StateSyncReactor (a syncing one with the state provider
    `state_provider_factory(node)` gives), and `seeds` a PEXReactor over
    an empty AddrBook (ensure period `ensure_period`)."""

    def __init__(self, p, gdoc, pv, moniker: str, fast_sync=False,
                 mempool=False, config=None, block_store=None, app_db=None,
                 state_db=None, node_key=None, snapshot_interval=0,
                 keep_snapshots=4, statesync=False,
                 state_provider_factory=None, seeds=None,
                 ensure_period=30.0):
        self.p, self.gdoc, self.pv, self.moniker = p, gdoc, pv, moniker
        self.fast_sync, self.with_mempool = fast_sync, mempool
        self.snapshots = (snapshot_interval, keep_snapshots)
        self.statesync = statesync or state_provider_factory is not None
        self.state_provider_factory = state_provider_factory
        self.seeds, self.ensure_period = seeds, ensure_period
        self.config = config or p.config.fast_consensus_config()
        self.node_key = p.key.NodeKey(node_key or p.ed25519.Ed25519PrivKey(
            hashlib.sha256(b"node-" + moniker.encode()).digest()))
        self.dbs = (state_db or p.db.MemDB(), app_db or p.db.MemDB())
        self.block_store = block_store
        self.cs = self.switch = None

    async def start(self, wait_sync=None):
        p = self.p
        if wait_sync is None:
            wait_sync = self.fast_sync
        self.app = p.kvstore.PersistentKVStoreApp(
            self.dbs[1], snapshot_interval=self.snapshots[0],
            keep_snapshots=self.snapshots[1])
        self.conns = p.proxy.AppConns(p.client.ClientCreator(app=self.app))
        await self.conns.start()
        self.state_store = p.sstore.Store(self.dbs[0])
        if self.block_store is None:
            self.block_store = p.store.BlockStore(p.db.MemDB())
        state = await p.replay.handshake_and_load_state(
            None, self.state_store, self.block_store, self.gdoc, self.conns)
        self.evpool = p.evidence.Pool(p.db.MemDB(), self.state_store,
                                      self.block_store)
        self.mempool = None
        if self.with_mempool:
            self.mempool = p.clist.CListMempool(
                p.config.MempoolConfig(), self.conns.mempool,
                state.last_block_height)
        self.executor = p.execution.BlockExecutor(
            self.state_store, self.conns.consensus, mempool=self.mempool,
            evidence_pool=self.evpool, event_bus=p.events.EventBus())
        self.cs = p.cstate.ConsensusState(
            self.config, state, self.executor, self.block_store,
            mempool=self.mempool, evpool=self.evpool)
        if self.pv is not None:
            self.cs.set_priv_validator(self.pv)
        self.reactor = p.reactor.ConsensusReactor(
            self.cs, wait_sync=wait_sync, gossip_sleep=0.02)
        self.bc_reactor = p.bcreactor.BlockchainReactor(
            state, self.executor, self.block_store,
            fast_sync=self.fast_sync, consensus_reactor=self.reactor)
        self.ev_reactor = p.evreactor.EvidenceReactor(self.evpool)
        holder = {}

        def ni():
            t = holder["transport"]
            return p.node_info.NodeInfo(
                node_id=self.node_key.id,
                listen_addr=t.listen_addr if t._server else "",
                network=self.gdoc.chain_id, moniker=self.moniker,
                channels=bytes(sorted(
                    {0x20, 0x21, 0x22, 0x23, 0x30, 0x38, 0x40} |
                    set(self.switch.channel_ids()))))

        transport = p.transport.Transport(self.node_key, ni)
        holder["transport"] = transport
        self.switch = p.switch.Switch(transport, ni)
        self.switch.add_reactor("consensus", self.reactor)
        self.switch.add_reactor("blockchain", self.bc_reactor)
        self.switch.add_reactor("evidence", self.ev_reactor)
        if self.mempool is not None:
            self.mp_reactor = p.mreactor.MempoolReactor(self.mempool)
            self.switch.add_reactor("mempool", self.mp_reactor)
        if self.statesync:
            ssreactor = importlib.import_module(f"{p.name}.statesync.reactor")
            provider = self.state_provider_factory(self) \
                if self.state_provider_factory is not None else None
            self.ss_reactor = ssreactor.StateSyncReactor(self.conns.snapshot,
                                                         provider)
            self.switch.add_reactor("statesync", self.ss_reactor)
        if self.seeds is not None:
            pex = importlib.import_module(f"{p.name}.p2p.pex")
            self.book = pex.AddrBook()
            self.book.add_our_address(self.node_key.id)
            self.pex = pex.PEXReactor(self.book, seeds=self.seeds,
                                      ensure_period=self.ensure_period)
            self.switch.add_reactor("pex", self.pex)
        await transport.listen("127.0.0.1", 0)
        await self.switch.start()
        if not wait_sync:
            await self.cs.start()
        return self

    @property
    def addr(self) -> str:
        return f"{self.node_key.id}@{self.switch.transport.listen_addr}"

    async def dial(self, other, persistent=False):
        await self.switch.dial_peer(other.addr, persistent=persistent)

    async def stop(self):
        if self.cs is not None and self.cs.is_running:
            await self.cs.stop()
        if self.switch is not None and self.switch.is_running:
            await self.switch.stop()
        if self.mempool is not None:
            self.mempool.close()
        await self.conns.stop()

    def chain(self, upto: int) -> list:
        """(block hash, app hash, last_results_hash) per height."""
        out = []
        for h in range(1, upto + 1):
            b = self.block_store.load_block(h)
            out.append((b.hash().hex(), b.header.app_hash.hex(),
                        b.header.last_results_hash.hex()))
        return out


async def make_net(packages, wait_sync_last=False, **kw):
    """One node a package of `packages`, validators of one genesis,
    dialed in a ring."""
    nodes = []
    for i, p in enumerate(packages):
        gdoc, pvs = genesis(p, len(packages))
        nodes.append(Node(p, gdoc, pvs[i], f"val{i}", **kw))
    for i, node in enumerate(nodes):
        await node.start(wait_sync=wait_sync_last and i == len(nodes) - 1)
    for i, node in enumerate(nodes[:len(nodes) if len(nodes) > 2 else 1]):
        await node.dial(nodes[(i + 1) % len(nodes)])
    return nodes


async def stop_all(nodes):
    for n in nodes:
        await n.stop()


def test_a_four_validator_port_net_commits_over_tcp():
    async def go():
        nodes = await make_net([PORT] * 4)
        try:
            await asyncio.gather(*(n.cs.wait_for_height(3, timeout=50)
                                   for n in nodes))
            return [n.chain(3) for n in nodes]
        finally:
            await stop_all(nodes)

    chains = run(go())
    assert all(c == chains[0] for c in chains)


def test_a_mixed_net_of_port_and_reference_nodes_agrees():
    async def go():
        nodes = await make_net([PORT, REF, PORT, REF])
        try:
            await asyncio.gather(*(n.cs.wait_for_height(3, timeout=50)
                                   for n in nodes))
            return [n.chain(3) for n in nodes]
        finally:
            await stop_all(nodes)

    chains = run(go())
    assert all(c == chains[0] for c in chains) and len(chains[0]) == 3


def test_a_lagging_port_node_catches_up_by_gossip():
    """The fourth validator starts in wait_sync; three of four commit
    without it; switched to consensus at genesis, the catch-up gossip
    brings it to the head and it takes part."""
    async def go():
        nodes = await make_net([REF, REF, REF, PORT], wait_sync_last=True)
        late = nodes[-1]
        try:
            await asyncio.gather(*(n.cs.wait_for_height(2, timeout=50)
                                   for n in nodes[:3]))
            await late.reactor.switch_to_consensus(late.cs.state)
            await late.cs.wait_for_height(4, timeout=50)
            return late.chain(3), nodes[0].chain(3)
        finally:
            await stop_all(nodes)

    late, ref = run(go())
    assert late == ref


class _Peer:
    def __init__(self):
        self.id = "ab" * 20


def test_stamped_lifecycle_messages_are_the_reference_bytes():
    """The consensus reactor's origin tag (field 15) with no live span:
    the port's stamped Proposal and Vote messages equal the
    reference's byte for byte, and each package decodes the other's
    tag."""
    import importlib

    def stamped(p):
        # a reactor without a node: _stamped reads only the label (the
        # reference's on ConsensusState, the port's on the reactor)
        r = p.reactor.ConsensusReactor.__new__(p.reactor.ConsensusReactor)
        p.reactor.Reactor.__init__(r, "consensus")
        r.cs = types.SimpleNamespace(trace_node="val0")
        r.trace_node = "val0"
        psh = p.block.PartSetHeader(1, b"\x07" * 32)
        bid = p.block.BlockID(b"\x05" * 32, psh)
        vote = p.vote.Vote(type=p.vote.VoteType.PREVOTE, height=7, round=2,
                           block_id=bid, timestamp=GENESIS_TIME,
                           validator_address=b"\x01" * 20,
                           validator_index=0, signature=b"\x02" * 64)
        prop_mod = importlib.import_module(f"{p.name}.types.proposal")
        prop = prop_mod.Proposal(height=7, round=2, pol_round=-1,
                                 block_id=bid, timestamp=GENESIS_TIME,
                                 signature=b"\x03" * 64)
        m = p.messages
        return [r._stamped(x) for x in (m.VoteMessage(vote),
                                        m.ProposalMessage(prop))]

    port, ref = stamped(PORT), stamped(REF)
    assert port == ref
    tracing = importlib.import_module("tendermint_tpu.libs.tracing")
    ptracing = importlib.import_module("tendermint_tpu_torch.libs.tracing")
    for raw in port:
        msg = PORT.messages.decode_consensus_msg(raw)
        tag = ptracing.decode_origin(msg.origin)
        assert tuple(tag) == tuple(tracing.decode_origin(msg.origin)) == \
            (7, 2, "val0", 0)


def test_peer_state_bit_arrays_agree_after_a_scripted_sequence():
    def trace(p):
        m, bits = p.messages, p.bits
        ps = p.reactor.PeerState(_Peer())
        VT = p.vote.VoteType
        psh = p.block.PartSetHeader(4, b"\x07" * 32)
        bid = p.block.BlockID(b"\x05" * 32, psh)

        def ba(n, on):
            b = bits.BitArray(n)
            for i in on:
                b.set(i, True)
            return b

        def snap():
            def show(b):
                return None if b is None else str(b)
            return (ps.height, ps.round, int(ps.step), ps.proposal,
                    show(ps.proposal_block_parts), ps.proposal_pol_round,
                    show(ps.proposal_pol), ps.last_commit_round,
                    show(ps.last_commit), ps.catchup_commit_round,
                    show(ps.catchup_commit),
                    {r: show(b) for r, b in ps.prevotes.items()},
                    {r: show(b) for r, b in ps.precommits.items()})

        out = []
        ps.apply_new_round_step(m.NewRoundStepMessage(
            height=5, round=0, step=3, seconds_since_start_time=0,
            last_commit_round=-1))
        out.append(snap())
        for i in (0, 2, 3):
            ps.set_has_vote(5, 0, int(VT.PREVOTE), i, 4)
        ps.set_has_vote(5, 0, int(VT.PRECOMMIT), 1, 4)
        ps.apply_has_vote(m.HasVoteMessage(height=5, round=0,
                                           type=int(VT.PRECOMMIT), index=3))
        out.append(snap())
        ps.apply_new_valid_block(m.NewValidBlockMessage(
            height=5, round=0, block_parts_header=psh,
            block_parts=ba(4, (1, 2)), is_commit=False))
        ps.set_has_part(5, 0, 3)
        out.append(snap())
        ps.apply_vote_set_bits(
            m.VoteSetBitsMessage(height=5, round=0, type=int(VT.PREVOTE),
                                 block_id=bid, votes=ba(4, (1,))),
            ba(4, (0, 1)))
        out.append(snap())
        ps.ensure_catchup_commit(5, 2, 4)
        ps.apply_new_round_step(m.NewRoundStepMessage(
            height=5, round=1, step=1, seconds_since_start_time=0,
            last_commit_round=-1))
        out.append(snap())
        ps.apply_new_round_step(m.NewRoundStepMessage(
            height=6, round=0, step=1, seconds_since_start_time=0,
            last_commit_round=1))
        ps.set_has_vote(5, 1, int(VT.PRECOMMIT), 2)
        out.append(snap())
        return out

    assert trace(PORT) == trace(REF)


def test_a_kernel_error_in_a_gossip_routine_halts_the_node(monkeypatch):
    """The port's votes gossip routine meets a KernelError: the node
    halts (the switch stops, wait_for_height re-raises it). The
    reference's routine logs the error and dies; its node commits on."""
    async def go(p, exc):
        async def boom(self, rs, ps):
            raise exc

        monkeypatch.setattr(p.reactor.ConsensusReactor,
                            "_gossip_votes_for_height", boom)
        nodes = await make_net([p] * 2)
        try:
            try:
                await nodes[0].cs.wait_for_height(2, timeout=3)
                got = "ok"
            except Exception as e:
                got = type(e).__name__
            return (got, nodes[0].cs.is_running, nodes[0].switch.is_running)
        finally:
            await stop_all(nodes)

    assert run(go(PORT, KernelError("injected (CUDA code 700)"))) == \
        ("KernelError", False, False)
    # two validators of equal power need both: the reference's dead
    # vote gossip stalls its net, and its node runs on
    assert run(go(REF, RuntimeError("injected"))) == \
        ("TimeoutError", True, True)
