"""Port parity for the commit pipeline: state/execution.py
(BlockExecutor, update_state, max_data_bytes, build_last_commit_info,
abci_header_from_block, validator_updates_from_abci), state/validation.py
(validate_block, BlockValidationError), types/proposal.py and
types/priv_validator.py (MockPV), against the JAX package, in the shapes
of tests/test_execution.py.

`Node(p, ...)` is one node of package p over MemDB stores: genesis by
GenesisDoc, a PersistentKVStoreApp behind proxy.AppConns, a CListMempool,
an EventBus with an IndexerService, and a BlockExecutor, started by
consensus/replay.py reconcile_and_handshake. The same seeded keys sign
the same blocks in both packages; after every height the stores' bytes
(state, validator sets, params, ABCI responses, blocks), the app hash,
`last_results_hash` and the events must be equal. Most cases run at 4
validators on the host path; one runs at 130, where the port takes its
expanded route through the plain K3 version and the reference is held
on its host by crypto.batch.set_force_host(True), so no JAX kernel
compiles. Tolerance: exact."""

import asyncio
import functools
import hashlib
import importlib
import types

import pytest

from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu_torch.crypto import batch as pbatch
from tendermint_tpu_torch.crypto.cuda import expanded as pexpanded
from tendermint_tpu_torch.device import set_default_device

CHAIN = "torch-exec-chain"
GENESIS_TIME = 1_700_000_000 * 1_000_000_000

MODULES = dict(
    ed="crypto.ed25519", pv="types.priv_validator", proposal="types.proposal",
    block="types.block", vote="types.vote", genesis="types.genesis",
    validator="types.validator", vset="types.validator_set",
    events="types.events", pubsub="libs.pubsub", db="libs.db",
    failpoints="libs.failpoints", state="state", sstore="state.store",
    ex="state.execution", val="state.validation", txindex="state.txindex",
    bstore="store", t="abci.types", client="abci.client", kv="abci.kvstore",
    proxy="proxy", config="config", cm="mempool.clist_mempool",
    replay="consensus.replay", wal="consensus.wal", evidence="evidence")


def _namespace(root: str) -> types.SimpleNamespace:
    return types.SimpleNamespace(**{
        k: importlib.import_module(f"{root}.{m}") for k, m in MODULES.items()})


PACKAGES = {"port": _namespace("tendermint_tpu_torch"),
            "reference": _namespace("tendermint_tpu")}
PORT, REF = PACKAGES["port"], PACKAGES["reference"]


@pytest.fixture(autouse=True)
def _cpu():
    set_default_device("cpu")
    pbatch.reset_breakers()
    yield
    for p in PACKAGES.values():
        p.failpoints.disarm_all()
    pbatch.reset_breakers()
    set_default_device(None)


def outcome(fn):
    """fn()'s value, or its exception's class and text."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return (type(e).__name__, str(e))


async def aoutcome(coro):
    try:
        return ("ok", await coro)
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return (type(e).__name__, str(e))


@functools.cache
def seed(i: int) -> bytes:
    return hashlib.sha256(b"exec-val-%d" % i).digest()


def db_bytes(db) -> dict:
    return dict(db.iterate())


class Node:
    """One node of package p (see the module docstring). `n_vals`
    genesis validators of power 10; `extra` more keys whose validators
    sign once a change set adds them. `dbs`: (state, blocks, app) DBs,
    MemDBs by default."""

    def __init__(self, p, n_vals: int = 4, extra: int = 2, dbs=None,
                 mempool: bool = False, evidence: bool = False,
                 speculation=None):
        self.p = p
        self.pvs = [p.pv.MockPV(p.ed.Ed25519PrivKey(seed(i)))
                    for i in range(n_vals + extra)]
        self.gdoc = p.genesis.GenesisDoc(
            chain_id=CHAIN, genesis_time=GENESIS_TIME,
            validators=[p.genesis.GenesisValidator(pv.get_pub_key(), 10)
                        for pv in self.pvs[:n_vals]])
        self.gdoc.validate_and_complete()
        self.dbs = dbs or (p.db.MemDB(), p.db.MemDB(), p.db.MemDB())
        self.ss = p.sstore.Store(self.dbs[0])
        self.bs = p.bstore.BlockStore(self.dbs[1])
        self.app = p.kv.PersistentKVStoreApp(self.dbs[2])
        self.want_mempool, self.want_evidence = mempool, evidence
        self.speculation = speculation
        self.last_commit = None
        self.events: list = []

    async def start(self):
        p = self.p
        self.conns = p.proxy.AppConns(p.client.ClientCreator(app=self.app))
        await self.conns.start()
        self.bus = p.events.EventBus()
        self._sub = self.bus.subscribe("recorder",
                                       p.pubsub.Query.parse("tm.event EXISTS"))
        self.tx_db = p.db.MemDB()
        self.blk_db = p.db.MemDB()
        self.indexer = p.txindex.IndexerService(
            p.txindex.TxIndexer(self.tx_db), self.bus,
            p.txindex.BlockIndexer(self.blk_db))
        self.indexer.start()
        self.state, self.report = await p.replay.reconcile_and_handshake(
            None, self.ss, self.bs, self.gdoc, self.conns,
            event_bus=self.bus)
        self.mempool = (p.cm.CListMempool(p.config.MempoolConfig(),
                                          self.conns.mempool)
                        if self.want_mempool else None)
        self.evpool = (p.evidence.Pool(p.db.MemDB(), self.ss, self.bs)
                       if self.want_evidence else None)
        self.executor = p.ex.BlockExecutor(
            self.ss, self.conns.consensus, mempool=self.mempool,
            evidence_pool=self.evpool, event_bus=self.bus,
            speculation=self.speculation)
        if self.state.last_block_height:
            self.last_commit = self.bs.load_seen_commit(
                self.state.last_block_height)
        return self

    async def settle(self):
        """Let the indexer's tasks take every event published so far."""
        subs = [self.indexer._sub, self.indexer._blk_sub]
        idle = 0
        while idle < 16:  # a message takes a few loop turns past its get
            await asyncio.sleep(0)
            idle = 0 if any(not s.queue.empty() for s in subs) else idle + 1

    async def stop(self):
        await self.settle()
        self.indexer.stop()
        if self.mempool is not None:
            self.mempool.close()
        await self.conns.stop()

    def sign_commit(self, vals, height: int, bid, ts: int):
        """A precommit from every validator of `vals` whose key this
        node holds (an absent slot for any other), at time ts."""
        p = self.p
        by_addr = {pv.get_pub_key().address(): pv for pv in self.pvs}
        sigs = []
        for idx, v in enumerate(vals.validators):
            pv = by_addr.get(v.address)
            if pv is None:
                sigs.append(p.block.CommitSig.absent())
                continue
            vote = p.vote.Vote(type=p.vote.VoteType.PRECOMMIT, height=height,
                               round=0, block_id=bid, timestamp=ts,
                               validator_address=v.address,
                               validator_index=idx)
            pv.sign_vote(CHAIN, vote)
            sigs.append(p.block.CommitSig(p.block.BlockIDFlag.COMMIT,
                                          v.address, ts, vote.signature))
        return p.block.Commit(height, 0, bid, sigs)

    def next_block(self, txs=()):
        """The next valid block for the node's state, and its BlockID."""
        st = self.state
        if st.last_block_height == 0:
            height, t = st.initial_height, st.last_block_time
        else:
            height = st.last_block_height + 1
            t = self.p.state.median_time(self.last_commit, st.last_validators)
        block = st.make_block(height, list(txs), self.last_commit, [],
                              st.validators.get_proposer().address, t)
        return block, block.block_id()

    def seen_commit(self, block, bid):
        return self.sign_commit(self.state.validators, block.header.height,
                                bid, block.header.time + 1_000_000_000)

    async def commit_block(self, block, bid):
        """save_block (unless the store has the block) then apply_block,
        as consensus commits a height."""
        seen = self.seen_commit(block, bid)
        if self.bs.height < block.header.height:
            self.bs.save_block(block, block.make_part_set(), seen)
        self.state, _ = await self.executor.apply_block(self.state, bid,
                                                        block)
        self.last_commit = seen
        self.drain_events()

    async def step(self, txs=()):
        block, bid = self.next_block(txs)
        await self.commit_block(block, bid)
        return block

    def drain_events(self) -> None:
        q = self._sub.queue
        while not q.empty():
            m = q.get_nowait()
            self.events.append((type(m.data).__name__, m.attrs))

    def snapshot(self) -> dict:
        return dict(state=db_bytes(self.dbs[0]), blocks=db_bytes(self.dbs[1]),
                    app=db_bytes(self.dbs[2]), app_hash=self.state.app_hash,
                    last_results_hash=self.state.last_results_hash,
                    height=self.state.last_block_height)


def both(scenario, *args):
    """asyncio.run(scenario(p, *args)) in each package; the port's
    result, after asserting it equals the reference's."""
    got = {k: asyncio.run(scenario(p, *args)) for k, p in PACKAGES.items()}
    assert got["port"] == got["reference"]
    return got["port"]


def val_tx(p, i: int, power: int) -> bytes:
    pub = p.ed.Ed25519PrivKey(seed(i)).pub_key().bytes()
    return p.kv.encode_validator_tx(pub.hex(), power)


# ------------------------------------------------------------ executor


def test_apply_blocks_with_txs_equal_reference():
    """Five heights of kvstore txs: after each, equal stores (state,
    validator sets, params, ABCI responses, blocks), app hash and
    last_results_hash; the saved responses read back equal."""
    async def go(p):
        node = await Node(p).start()
        snaps = []
        for h in range(1, 6):
            await node.step([b"h%d=x" % h, b"k%d=%d" % (h, h * h), b"bad"])
            resp = node.ss.load_abci_responses(h)
            snaps.append((node.snapshot(), len(resp["deliver_txs"]),
                          [r.code for r in resp["deliver_txs"]]))
        assert node.state.app_hash == node.app.app_hash
        await node.stop()
        return snaps

    snaps = both(go)
    assert snaps[-1][0]["height"] == 5 and snaps[-1][1] == 3


BAD_BLOCKS = {
    # state-side mutations
    "app_hash": lambda p, st, b: setattr(st, "app_hash", b"\x99" * 32),
    "chain_id": lambda p, st, b: setattr(st, "chain_id", "other-chain"),
    "app_version": lambda p, st, b: setattr(st, "app_version", 7),
    "last_block_id": lambda p, st, b: setattr(
        st, "last_block_id", p.block.BlockID(
            b"\x01" * 32, p.block.PartSetHeader(1, b"\x02" * 32))),
    "last_results_hash": lambda p, st, b: setattr(
        st, "last_results_hash", b"\x03" * 32),
    "last_block_time": lambda p, st, b: setattr(
        st, "last_block_time", b.header.time),
    # header mutations
    "height": lambda p, st, b: setattr(b.header, "height", 9),
    "version_block": lambda p, st, b: setattr(b.header, "version_block", 10),
    "validators_hash": lambda p, st, b: setattr(
        b.header, "validators_hash", b"\x05" * 32),
    "next_validators_hash": lambda p, st, b: setattr(
        b.header, "next_validators_hash", b"\x06" * 32),
    "consensus_hash": lambda p, st, b: setattr(
        b.header, "consensus_hash", b"\x07" * 32),
    "median_time": lambda p, st, b: setattr(
        b.header, "time", b.header.time + 1),
    "proposer": lambda p, st, b: setattr(
        b.header, "proposer_address", b"\x08" * 20),
    # body mutations
    "txs": lambda p, st, b: setattr(b.data, "txs", [b"evil"]),
    "last_commit_sig": lambda p, st, b: setattr(
        b.last_commit.signatures[1], "signature", bytes(64)),
    "last_commit_short": lambda p, st, b: b.last_commit.signatures.pop(),
    "last_commit_nil": lambda p, st, b: setattr(b, "last_commit", None),
}


@pytest.mark.parametrize("case", sorted(BAD_BLOCKS))
def test_bad_block_rejected_with_the_reference_message(case):
    """Every mutation of a valid height-3 block (or of the state it is
    checked against) is rejected by validate_block with the reference's
    exception type and text; apply_block then leaves the stores and the
    app as they were."""
    async def go(p):
        node = await Node(p).start()
        for h in (1, 2):
            await node.step([b"h%d=x" % h])
        block, bid = node.next_block([b"h3=x"])
        st = node.state.copy()
        BAD_BLOCKS[case](p, st, block)
        block.header._hash = None
        got = outcome(lambda: node.executor.validate_block(st, block))
        before = node.snapshot(), node.app.height, node.app.app_hash
        applied = await aoutcome(node.executor.apply_block(st, bid, block))
        after = node.snapshot(), node.app.height, node.app.app_hash
        await node.stop()
        assert got[0] != "ok" and applied == got and before == after
        return got

    both(go)


def test_forged_last_commit_names_its_index():
    """One flipped signature in a LastCommit: BlockValidationError
    "invalid LastCommit: ..." naming the lane, in both packages."""
    async def go(p):
        node = await Node(p, n_vals=7).start()
        await node.step()
        block, bid = node.next_block()
        sig = block.last_commit.signatures[4].signature
        block.last_commit.signatures[4].signature = (
            sig[:40] + bytes([sig[40] ^ 4]) + sig[41:])
        got = await aoutcome(node.executor.apply_block(node.state, bid, block))
        await node.stop()
        return got

    kind, msg = both(go)
    assert kind == "BlockValidationError"
    assert msg == "invalid LastCommit: invalid signature(s) at index(es) [4]"


def test_a_last_commit_over_max_votes_count_is_refused():
    """A LastCommit of MAX_VOTES_COUNT + 1 slots fails the block's
    validate_basic in both packages, whatever the set: a chain of more
    than 10,000 validators cannot apply its second block."""
    async def go(p):
        node = await Node(p).start()
        await node.step()
        block, _ = node.next_block()
        lc, st = block.last_commit, node.state
        big = p.block.Commit(lc.height, lc.round, lc.block_id, lc.signatures + [
            p.block.CommitSig.absent()
            for _ in range(p.vote.MAX_VOTES_COUNT + 1 - len(lc.signatures))])
        block = st.make_block(2, [], big, [],
                              st.validators.get_proposer().address,
                              block.header.time)
        got = outcome(lambda: node.executor.validate_block(st, block))
        await node.stop()
        return got

    assert both(go) == ("ValueError", "too many signatures in commit")


def test_validator_change_set_through_the_executor():
    """`val:` txs at height 2 add two validators and remove one; the
    change reaches next_validators at once and validators at height 4,
    and the proposer order, the stored sets and build_last_commit_info
    across the change equal the reference's."""
    async def go(p):
        node = await Node(p, n_vals=4, extra=3).start()
        out = []
        for h in range(1, 9):
            txs = [b"h%d=x" % h]
            if h == 2:
                txs += [val_tx(p, 4, 15), val_tx(p, 5, 7), val_tx(p, 1, 0)]
            if h == 5:
                txs += [val_tx(p, 6, 3), val_tx(p, 4, 2)]
            block = await node.step(txs)
            info = p.ex.build_last_commit_info(block, node.ss, 1)
            st = node.state
            out.append((
                node.snapshot(),
                [(v.address, v.voting_power, v.proposer_priority)
                 for v in st.next_validators.validators],
                st.validators.get_proposer().address,
                st.last_height_validators_changed,
                [(v.address, v.power, v.signed_last_block)
                 for v in info.votes]))
        await node.stop()
        return out, [len(e) for e in (out[0][1], out[1][1], out[5][1])]

    _, sizes = both(go)
    assert sizes == [4, 5, 6]


def test_events_equal_reference():
    """NewBlock, NewBlockHeader, Tx and ValidatorSetUpdates events in the
    same order with the same attributes; the indexers find each tx at
    its height and each block's events."""
    async def go(p):
        node = await Node(p).start()
        for h in range(1, 4):
            txs = [b"e%d=%d" % (h, i) for i in range(h)]
            if h == 2:
                txs.append(val_tx(p, 4, 5))
            await node.step(txs)
        await node.settle()
        found = [(r.height, r.index, r.tx) for r in
                 node.indexer.indexer.search(
                     p.pubsub.Query.parse("tx.height >= 1"))]
        blocks = node.indexer.block_indexer.search(
            p.pubsub.Query.parse("block.height > 1"))
        await node.stop()
        return node.events, found, blocks, db_bytes(node.tx_db)

    events, found, blocks, _ = both(go)
    kinds = [e[0] for e in events]
    assert kinds.count("EventDataNewBlock") == 3
    assert kinds.count("EventDataTx") == 7
    assert kinds.count("EventDataValidatorSetUpdates") == 1
    assert [f[0] for f in found] == [1, 2, 2, 2, 3, 3, 3] and blocks == [2, 3]


def test_create_proposal_block_reaps_the_mempool():
    """Txs checked into a CListMempool are reaped into equal proposal
    blocks (equal hashes) that validate and apply; the mempool's update
    after Commit empties it."""
    async def go(p):
        node = await Node(p, mempool=True).start()
        out = []
        for h in range(1, 4):
            for i in range(5):
                res = await node.mempool.check_tx(b"m%d-%d=%d" % (h, i, i))
                assert res.code == 0
            st = node.state
            proposer = st.validators.get_proposer().address
            block = node.executor.create_proposal_block(
                st.last_block_height + 1, st, node.last_commit, proposer)
            node.executor.validate_block(st, block)
            bid = block.block_id()
            await node.commit_block(block, bid)
            out.append((block.hash(), len(block.data.txs),
                        node.mempool.size(), node.snapshot()))
        await node.stop()
        return out

    out = both(go)
    assert [o[1:3] for o in out] == [(5, 0)] * 3


def test_speculation_serve_point():
    """validate_block asks the plane first: a plane that serves the
    commit is the whole check (no verify_commit), one that declines
    falls through to verify_commit; its arguments equal the
    reference's."""
    class Plane:
        def __init__(self, serve):
            self.serve, self.calls = serve, []

        def serve_commit(self, vals, chain_id, bid, height, commit):
            self.calls.append((vals.hash(), chain_id, bid.hash, height,
                               commit.hash()))
            return self.serve

    async def go(p, serve):
        plane = Plane(serve)
        node = await Node(p, speculation=plane).start()
        verifies = []
        real = node.state.validators.__class__.verify_commit

        def spy(self, *a):
            verifies.append(a[2])
            return real(self, *a)

        node.state.validators.__class__.verify_commit = spy
        try:
            for h in range(1, 4):
                await node.step([b"s%d=1" % h])
        finally:
            node.state.validators.__class__.verify_commit = real
        await node.stop()
        return plane.calls, verifies, node.snapshot()

    served = both(go, True)
    declined = both(go, False)
    assert len(served[0]) == 2 and served[1] == []
    assert declined[1] == [1, 2] and served[2] == declined[2]


def test_failpoints_stop_apply_block_where_the_reference_stops():
    """Each state.apply.* failpoint armed with `error` raises from
    apply_block after the same persistence step: the stores and the app
    equal the reference's at each cut."""
    async def go(p, point):
        node = await Node(p).start()
        await node.step([b"a=1"])
        block, bid = node.next_block([b"b=2"])
        seen = node.seen_commit(block, bid)
        node.bs.save_block(block, block.make_part_set(), seen)
        p.failpoints.arm(point, "error")
        try:
            got = await aoutcome(node.executor.apply_block(node.state, bid,
                                                           block))
        finally:
            p.failpoints.disarm_all()
        snap = node.snapshot()
        await node.stop()
        return got, snap, node.app.app_hash

    for point in sorted(p for p in PORT.failpoints.CRASH_SITES
                        if p.startswith("state.apply.")):
        got = both(go, point)
        assert got[0] == ("FailpointError", f"injected failpoint {point!r}")


def test_metrics_count_the_pipeline():
    """The state family: one block_processing and one commit_verify
    observation a height past the first, and the validator updates
    counted."""
    m = PORT.ex.state_metrics()

    def counts():
        return (m.block_processing_seconds.count,
                m.commit_verify_seconds.count,
                m.validator_set_updates.value())

    before = counts()

    async def go():
        node = await Node(PORT).start()
        for h in range(1, 4):
            await node.step([val_tx(PORT, 4, 9)] if h == 2 else [])
        await node.stop()

    asyncio.run(go())
    after = counts()
    assert [a - b for a, b in zip(after, before)] == [3, 2, 1]
    assert m.block_processing_seconds.sum > 0


# ----------------------------------------------------- pure functions


def test_max_data_bytes_and_abci_header_equal_reference():
    async def go(p):
        node = await Node(p).start()
        block = await node.step([b"x=1"])
        await node.step()
        sizes = [p.ex.max_data_bytes(mb, nv, [])
                 for mb in (1024, 22020096, 100_000, 5_000_000)
                 for nv in (1, 4, 150, 10_240)]
        header = p.ex.abci_header_from_block(block)
        await node.stop()
        return sizes, header

    both(go)


def test_validator_updates_from_abci_equal_reference():
    def case(p):
        ups = [p.t.ValidatorUpdate(
            "ed25519", p.ed.Ed25519PrivKey(seed(i)).pub_key().bytes(), i)
            for i in range(4)]
        vals = p.ex.validator_updates_from_abci(ups)
        bad = outcome(lambda: p.ex.validator_updates_from_abci(
            [p.t.ValidatorUpdate("nope", b"\x01" * 32, 1)]))
        return [(v.address, v.voting_power, v.pub_key.bytes())
                for v in vals], bad[0]

    assert case(PORT) == case(REF)


def test_update_state_equal_reference():
    """update_state on the same block and responses, with consensus
    param updates from EndBlock: equal state bytes, params changed at
    H+1."""
    async def go(p):
        node = await Node(p).start()
        block = await node.step([b"u=1"])
        resp = node.ss.load_abci_responses(1)
        resp["end_block"].consensus_param_updates = {
            "block": {"max_bytes": 2_000_000, "max_gas": 77}}
        st = p.ex.update_state(node.state, block.block_id(), block, resp, [])
        store = p.sstore.Store(p.db.MemDB())
        store.save(st)
        await node.stop()
        return (db_bytes(store.db), st.last_height_consensus_params_changed,
                st.consensus_params.block.max_bytes)

    _, changed, max_bytes = both(go)
    assert (changed, max_bytes) == (2, 2_000_000)


# ---------------------------------------- proposals and MockPV (types/)


def test_proposal_bytes_and_signatures_equal_reference():
    def case(p):
        pv = p.pv.MockPV(p.ed.Ed25519PrivKey(seed(1)))
        bid = p.block.BlockID(b"\x11" * 32, p.block.PartSetHeader(3, b"\x22" * 32))
        out = []
        for pol in (-1, 0, 2):
            prop = p.proposal.Proposal(height=7, round=3, pol_round=pol,
                                       block_id=bid, timestamp=GENESIS_TIME + 5)
            pv.sign_proposal(CHAIN, prop)
            prop.validate_basic()
            back = p.proposal.Proposal.from_bytes(prop.to_bytes())
            out.append((prop.sign_bytes(CHAIN), prop.to_bytes(),
                        back.pol_round, back.signature == prop.signature))
        broken = p.pv.MockPV(p.ed.Ed25519PrivKey(seed(1)),
                             break_proposal_sigs=True, break_vote_sigs=True)
        prop = p.proposal.Proposal(7, 3, -1, bid, GENESIS_TIME)
        broken.sign_proposal(CHAIN, prop)
        vote = p.vote.Vote(type=p.vote.VoteType.PREVOTE, height=7, round=3,
                           block_id=bid, timestamp=GENESIS_TIME,
                           validator_address=pv.get_pub_key().address(),
                           validator_index=0)
        broken.sign_vote(CHAIN, vote)
        out.append((prop.signature, vote.signature))
        bad = [outcome(lambda: p.proposal.Proposal(
            h, r, pol, bid, 0, sig).validate_basic())
            for h, r, pol, sig in ((0, 0, -1, b"s"), (1, -1, -1, b"s"),
                                   (1, 1, 1, b"s"), (1, 0, -1, b""),
                                   (1, 0, -1, b"s" * 97))]
        out.append(bad)
        return out

    assert case(PORT) == case(REF)


# --------------------------------- the expanded route at 130 validators


def test_130_validators_take_the_expanded_route(monkeypatch):
    """At 130 validators the port verifies every LastCommit through its
    expanded route (the plain K1 and K3 versions on the CPU); the
    reference is held on its host route. Equal stores, app hashes and a
    forged LastCommit's message."""
    launches = []
    real = pexpanded.xverify

    def counted(*a, **kw):
        launches.append(a[0].shape[0])
        return real(*a, **kw)

    monkeypatch.setattr(pexpanded, "xverify", counted)

    async def go(p):
        node = await Node(p, n_vals=130, extra=0).start()
        for h in (1, 2, 3):
            await node.step([b"w%d=1" % h])
        block, bid = node.next_block()
        sig = block.last_commit.signatures[77].signature
        block.last_commit.signatures[77].signature = (
            sig[:9] + bytes([sig[9] ^ 2]) + sig[10:])
        forged = await aoutcome(node.executor.apply_block(node.state, bid,
                                                          block))
        await node.stop()
        return node.snapshot(), forged

    jbatch.set_force_host(True)
    try:
        _, forged = both(go)
    finally:
        jbatch.set_force_host(False)
    assert forged[1] == ("invalid LastCommit: invalid signature(s) at "
                         "index(es) [77]")
    assert len(launches) == 3  # heights 2 and 3, and the forged block


def test_forced_host_route_keeps_the_130_validator_chain_off_the_kernels(
        monkeypatch):
    """crypto.batch.set_force_host(True) (reference crypto/batch.py:416)
    pins the port's commit verifies to the host oracle, as it pins the
    reference's: no expanded launch, and the same stores and rejection
    as the reference's host run."""
    launches = []
    monkeypatch.setattr(pexpanded, "xverify",
                        lambda *a, **kw: launches.append(1))

    async def go(p):
        node = await Node(p, n_vals=130, extra=0).start()
        for h in (1, 2):
            await node.step([b"f%d=1" % h])
        block, bid = node.next_block()
        block.last_commit.signatures[5].signature = bytes(64)
        forged = await aoutcome(node.executor.apply_block(node.state, bid,
                                                          block))
        await node.stop()
        return node.snapshot(), forged

    prev = (pbatch.set_force_host(True), jbatch.set_force_host(True))
    try:
        assert pbatch.host_forced()
        _, forged = both(go)
    finally:
        pbatch.set_force_host(prev[0])
        jbatch.set_force_host(prev[1])
    assert not pbatch.host_forced() and launches == []
    assert forged[1] == ("invalid LastCommit: invalid signature(s) at "
                         "index(es) [5]")
