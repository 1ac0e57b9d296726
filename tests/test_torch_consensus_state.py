"""Scripted parity of the consensus state machine: the port's
consensus/state.py ConsensusState against the JAX package's, one
validator of a seeded 4-validator genesis each.

Both run over MemDB stores, the kvstore app, an evidence Pool, an
EventBus and a WAL file, with vote_batch_window_ms=0 and timeouts so
long that no timer of the loop fires; one clock source, advanced by the
test only, is installed into both packages' libs.clock. `Net(p, ...)`
drives one node of package p: the peers' proposals, block parts and
votes (signed by the other three keys) go in as wire bytes decoded by
the package's own decode_consensus_msg and delivered through
add_peer_msg, and the timeouts as TimeoutInfo put on the ticker's
queue. After each script step the test waits until the node is idle and
records its RoundState: height, round, step, locked/valid round and
block hash, the proposal block hash, each round's prevote and precommit
bit arrays, the last commit's, and the commit round. The two records,
every message the script sent, the node's own signed proposals and
votes (bytes), the decoded WAL records and the evidence pool must be
equal.

Scenarios: the happy path over heights 1-3 with the node proposing
one; an absent proposer (timeout_propose, a nil prevote, round 1); a
lock at round 0 on a POL and a relock at round 1; an invalid proposal
block (a forged LastCommit signature) prevoted nil; a late precommit
for the previous height extending last_commit; a conflicting vote
turned into one DuplicateVoteEvidence. Then one 150-validator height at
the default vote batching, whose batches of 128 votes or more take the
structured route (the plain K3 version, VoteSignBatch) while the
reference is held on its host (crypto.batch.set_force_host), with the
same outcome. Tolerance: exact."""

import asyncio
import dataclasses
import functools
import hashlib
import importlib
import threading
import time
import types

import pytest

from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu_torch.crypto import batch as pbatch
from tendermint_tpu_torch.device import set_default_device

CHAIN = "torch-cs-chain"
GENESIS_TIME = 1_700_000_000 * 1_000_000_000
LONG_MS = 600_000  # no timer of the loop fires within a test

MODULES = dict(
    ed="crypto.ed25519", pv="types.priv_validator", proposal="types.proposal",
    block="types.block", vote="types.vote", genesis="types.genesis",
    events="types.events", db="libs.db", clock="libs.clock",
    state="state", sstore="state.store", ex="state.execution",
    bstore="store", client="abci.client", kv="abci.kvstore", proxy="proxy",
    config="config", replay="consensus.replay", wal="consensus.wal",
    msgs="consensus.messages", cs="consensus.state",
    cst="consensus.cstypes", evidence="evidence", vset="types.validator_set",
    failpoints="libs.failpoints")


def _namespace(root: str) -> types.SimpleNamespace:
    ns = types.SimpleNamespace(**{
        k: importlib.import_module(f"{root}.{m}") for k, m in MODULES.items()})
    ns.name = root
    return ns


PORT = _namespace("tendermint_tpu_torch")
REF = _namespace("tendermint_tpu")


class Clock:
    """A time source both packages read: it moves only when told."""

    def __init__(self):
        self.mono = 1000.0
        self.ns = GENESIS_TIME + 5_000_000_000

    def monotonic(self) -> float:
        return self.mono

    def time_ns(self) -> int:
        return self.ns

    def advance(self, seconds: float) -> None:
        self.mono += seconds
        self.ns += int(seconds * 1e9)


@pytest.fixture(autouse=True)
def _cpu():
    set_default_device("cpu")
    pbatch.reset_breakers()
    yield
    for p in (PORT, REF):
        p.clock.uninstall()
        p.failpoints.disarm_all()
    jbatch.set_force_host(False)
    pbatch.reset_breakers()
    set_default_device(None)


@functools.cache
def seed(i: int) -> bytes:
    return hashlib.sha256(b"cs-parity-%d" % i).digest()


async def outcome(coro):
    try:
        return ("ok", await coro)
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return (type(e).__name__, str(e))


def proposer_index(p, n_vals: int, height: int, round_: int) -> int:
    """Which genesis key proposes (height, round_) while the set does
    not change."""
    gdoc = genesis_doc(p, n_vals)
    vs = p.state.make_genesis_state(gdoc).validators.copy()
    steps = height - 1 + round_
    if steps:
        vs.increment_proposer_priority(steps)
    addr = vs.get_proposer().address
    return [p.ed.Ed25519PrivKey(seed(i)).pub_key().address()
            for i in range(n_vals)].index(addr)


def genesis_doc(p, n_vals: int):
    gdoc = p.genesis.GenesisDoc(
        chain_id=CHAIN, genesis_time=GENESIS_TIME,
        validators=[p.genesis.GenesisValidator(
            p.ed.Ed25519PrivKey(seed(i)).pub_key(), 10)
            for i in range(n_vals)])
    gdoc.validate_and_complete()
    return gdoc


def rs_record(rs) -> dict:
    """The RoundState fields the parity holds (see the module docstring)."""
    def h(b):
        return b.hash().hex() if b is not None else None

    rounds = {}
    for r in sorted(rs.votes._round_vote_sets):
        pv, pc = rs.votes.prevotes(r), rs.votes.precommits(r)
        rounds[r] = (repr(pv.bit_array()), repr(pc.bit_array()))
    return dict(height=rs.height, round=rs.round, step=int(rs.step),
                locked_round=rs.locked_round, locked=h(rs.locked_block),
                valid_round=rs.valid_round, valid=h(rs.valid_block),
                proposal=h(rs.proposal_block),
                has_proposal=rs.proposal is not None,
                rounds=rounds, commit_round=rs.commit_round,
                last_commit=(repr(rs.last_commit.bit_array())
                             if rs.last_commit is not None else None))


def wal_records(p, path) -> list:
    out = []
    for tm in p.wal.WAL.decode_all(path):
        out.append((tm.time_ns, type(tm.msg).__name__,
                    dataclasses.asdict(tm.msg)))
    return out


class Net:
    """One node of package p among `n_vals` genesis validators (key
    `node_index` is the node's, the others are the scripted peers)."""

    def __init__(self, p, config=None, n_vals: int = 4, node_index: int = 0,
                 wal_dir=None, clock=None):
        self.p = p
        self.n_vals = n_vals
        self.config = config or p.config.ConsensusConfig(
            vote_batch_window_ms=0, timeout_propose_ms=LONG_MS,
            timeout_prevote_ms=LONG_MS, timeout_precommit_ms=LONG_MS,
            timeout_commit_ms=LONG_MS)
        self.clock = clock
        self.keys = [p.ed.Ed25519PrivKey(seed(i)) for i in range(n_vals)]
        self.pvs = [p.pv.MockPV(k) for k in self.keys]
        self.node_index = node_index
        self.node_addr = self.keys[node_index].pub_key().address()
        self.gdoc = genesis_doc(p, n_vals)
        self.wal_path = str(wal_dir / p.name / "wal") if wal_dir else None
        self.records: list = []   # RoundState after each step
        self.sent: list = []      # (peer, wire bytes) of every delivery
        self.own: list = []       # the node's own proposals and votes

    async def start(self):
        p = self.p
        self.dbs = (p.db.MemDB(), p.db.MemDB(), p.db.MemDB(), p.db.MemDB())
        self.ss = p.sstore.Store(self.dbs[0])
        self.bs = p.bstore.BlockStore(self.dbs[1])
        self.app = p.kv.PersistentKVStoreApp(self.dbs[2])
        self.conns = p.proxy.AppConns(p.client.ClientCreator(app=self.app))
        await self.conns.start()
        state, _ = await p.replay.reconcile_and_handshake(
            None, self.ss, self.bs, self.gdoc, self.conns)
        self.bus = p.events.EventBus()
        self.evpool = p.evidence.Pool(self.dbs[3], self.ss, self.bs)
        executor = p.ex.BlockExecutor(self.ss, self.conns.consensus,
                                      evidence_pool=self.evpool,
                                      event_bus=self.bus)
        wal = p.wal.WAL(self.wal_path) if self.wal_path else None
        self.cs = p.cs.ConsensusState(self.config, state, executor, self.bs,
                                      evpool=self.evpool, wal=wal,
                                      event_bus=self.bus)
        self.cs.set_priv_validator(self.pvs[self.node_index])
        self.cs.broadcast_hooks.append(self._hook)
        await self.cs.start()
        await self.settle()
        return self

    async def stop(self):
        if self.cs.is_running:
            await self.cs.stop()
        await self.conns.stop()

    def _hook(self, event, payload):
        p = self.p
        if event == "proposal":
            self.own.append(p.msgs.encode_consensus_msg(
                p.msgs.ProposalMessage(payload)))
        elif event == "vote" and payload.validator_address == self.node_addr:
            self.own.append(p.msgs.encode_consensus_msg(
                p.msgs.VoteMessage(payload)))

    # -- waiting --

    def _busy(self) -> bool:
        cs = self.cs
        buf = (cs.scheduler._vote_buf or cs.scheduler._in_batch
               if hasattr(cs, "scheduler") else cs._vote_buf)
        return bool(cs._state_mtx.locked() or cs.peer_funnel.qsize()
                    or not cs.internal_msg_queue.empty()
                    or not cs.ticker.queue.empty() or buf)

    async def settle(self, record: bool = True):
        idle = 0
        while idle < 10 and self.cs.is_running:
            await asyncio.sleep(0.002)
            idle = 0 if self._busy() else idle + 1
        if record:
            self.records.append(rs_record(self.cs.rs))

    # -- the script --

    async def deliver(self, msgs, peer=None):
        """Each message as wire bytes through decode_consensus_msg and
        add_peer_msg, then wait for the node to be idle."""
        p = self.p
        for msg in msgs:
            raw = p.msgs.encode_consensus_msg(msg)
            who = peer or "peer"
            self.sent.append((who, raw))
            await self.cs.add_peer_msg(p.msgs.decode_consensus_msg(raw), who)
        await self.settle()

    async def timeout(self, step, round_=0, height=None):
        p = self.p
        ti = p.wal.TimeoutInfo(0.0, height or self.cs.rs.height, round_,
                               int(step))
        await self.cs.ticker.queue.put(ti)
        await self.settle()

    async def new_height(self):
        """The timeout_commit wait ends: NewHeight fires."""
        self.clock.advance(1.0)
        await self.timeout(self.p.cst.RoundStep.NEW_HEIGHT)

    def peers(self, exclude=()):
        return [i for i in range(self.n_vals)
                if i != self.node_index and i not in exclude]

    def last_commit(self):
        st = self.cs.state
        if st.last_block_height == 0:
            return None
        return self.cs.rs.last_commit.make_commit()

    def make_block(self, txs=(), proposer=None, forge_last_commit=False):
        p, st = self.p, self.cs.state
        height = self.cs.rs.height
        commit = self.last_commit()
        if commit is None:
            t = st.last_block_time
            commit = p.block.Commit(0, 0, p.block.NIL_BLOCK_ID, [])
        else:
            t = p.state.median_time(commit, st.last_validators)
            if forge_last_commit:
                sigs = [p.block.CommitSig(c.block_id_flag, c.validator_address,
                                          c.timestamp, c.signature)
                        for c in commit.signatures]
                i = next(i for i, c in enumerate(sigs) if not c.is_absent())
                s = sigs[i].signature
                sigs[i].signature = s[:5] + bytes([s[5] ^ 1]) + s[6:]
                commit = p.block.Commit(commit.height, commit.round,
                                        commit.block_id, sigs)
        addr = self.keys[proposer].pub_key().address()
        block = st.make_block(height, list(txs), commit, [], addr, t)
        parts = block.make_part_set()
        return block, parts, p.block.BlockID(block.hash(), parts.header())

    def proposal_msgs(self, proposer, block, parts, bid, round_=0,
                      pol_round=-1):
        p = self.p
        prop = p.proposal.Proposal(height=self.cs.rs.height, round=round_,
                                   pol_round=pol_round, block_id=bid,
                                   timestamp=self.clock.time_ns())
        self.pvs[proposer].sign_proposal(CHAIN, prop)
        return [p.msgs.ProposalMessage(prop)] + [
            p.msgs.BlockPartMessage(prop.height, round_, parts.get_part(i))
            for i in range(parts.total)]

    def vote_msgs(self, vote_type, bid, who, round_=0, height=None, ts=None):
        p = self.p
        height = height or self.cs.rs.height
        vals = (self.cs.state.validators if height == self.cs.rs.height
                else self.cs.state.last_validators)
        out = []
        for i in who:
            addr = self.keys[i].pub_key().address()
            idx, _ = vals.get_by_address(addr)
            v = p.vote.Vote(type=vote_type, height=height, round=round_,
                            block_id=bid,
                            timestamp=ts or self.clock.time_ns() + 1000 * i,
                            validator_address=addr, validator_index=idx)
            self.pvs[i].sign_vote(CHAIN, v)
            out.append(p.msgs.VoteMessage(v))
        return out

    async def votes(self, bid, who=None, round_=0, kinds=("prevote",
                                                         "precommit")):
        VT = self.p.vote.VoteType
        who = self.peers() if who is None else who
        for kind in kinds:
            t = VT.PREVOTE if kind == "prevote" else VT.PRECOMMIT
            await self.deliver(self.vote_msgs(t, bid, who, round_))

    async def height(self, txs=(), who=None):
        """One clean round-0 height: the proposal (the node's own, or a
        peer's delivered), every peer's prevote and precommit for it."""
        rs = self.cs.rs
        proposer = proposer_index(self.p, self.n_vals, rs.height, 0)
        if proposer == self.node_index:
            bid = rs.proposal.block_id
        else:
            block, parts, bid = self.make_block(txs, proposer)
            await self.deliver(self.proposal_msgs(proposer, block, parts, bid))
        await self.votes(bid, who)
        return bid

    async def drive_height_with_peer_batches(self):
        """Height 1 with every peer's votes, then wait for its commit."""
        await self.height([b"k=v"])
        await self.cs.wait_for_height(1, timeout=30)


async def run_script(p, scenario, tmp_path, clock):
    p.clock.install(clock)
    net = Net(p, node_index=scenario.node, wal_dir=tmp_path, clock=clock)
    await net.start()
    try:
        await scenario.script(net)
    finally:
        await net.stop()
    ev = [e.to_bytes() for e in net.evpool.pending_evidence(-1)]
    blocks = [net.bs.load_block(h).hash() for h in range(1, net.bs.height + 1)]
    return dict(records=net.records, sent=net.sent, own=net.own,
                wal=wal_records(p, net.wal_path), evidence=ev, blocks=blocks,
                app_hash=net.cs.state.app_hash)


def both(scenario, tmp_path):
    out = {}
    for p in (REF, PORT):
        clock = Clock()
        out[p.name] = asyncio.run(run_script(p, scenario, tmp_path, clock))
        for q in (PORT, REF):
            q.clock.uninstall()
    return out["tendermint_tpu"], out["tendermint_tpu_torch"]


# ------------------------------------------------------------ scenarios


def node_proposing(height: int, round_: int = 0) -> int:
    return proposer_index(REF, 4, height, round_)


def node_not_proposing(*hr) -> int:
    busy = {proposer_index(REF, 4, h, r) for h, r in hr}
    return min(set(range(4)) - busy)


async def happy(net):
    for h in (1, 2, 3):
        await net.height([b"h%d=x" % h])
        assert net.cs.state.last_block_height == h
        await net.new_height()


async def absent_proposer(net):
    RS = net.p.cst.RoundStep
    await net.timeout(RS.PROPOSE)                # the proposer stays silent
    await net.votes(None)                        # nil prevotes, precommits
    assert net.cs.rs.round == 1
    proposer = proposer_index(net.p, 4, 1, 1)
    if proposer == net.node_index:
        bid = net.cs.rs.proposal.block_id
    else:
        block, parts, bid = net.make_block([b"r1=x"], proposer)
        await net.deliver(net.proposal_msgs(proposer, block, parts, bid, 1))
    await net.votes(bid, round_=1)
    assert net.cs.state.last_block_height == 1
    assert net.cs.rs.last_commit.round == 1


async def lock_relock(net):
    VT = net.p.vote.VoteType
    proposer = proposer_index(net.p, 4, 1, 0)
    block, parts, bid = net.make_block([b"lock=x"], proposer)
    await net.deliver(net.proposal_msgs(proposer, block, parts, bid))
    await net.votes(bid, kinds=("prevote",))     # the POL: the node locks
    assert net.cs.rs.locked_round == 0
    await net.deliver(net.vote_msgs(VT.PRECOMMIT, None, net.peers()))
    assert net.cs.rs.round == 1                  # +2/3 nil precommits
    proposer = proposer_index(net.p, 4, 1, 1)
    await net.deliver(net.proposal_msgs(proposer, block, parts, bid, 1, 0))
    await net.votes(bid, round_=1, kinds=("prevote",))
    assert net.cs.rs.locked_round == 1           # relocked at round 1
    await net.votes(bid, round_=1, kinds=("precommit",))
    assert net.cs.state.last_block_height == 1


async def invalid_block(net):
    await net.height([b"h1=x"])
    await net.new_height()
    proposer = proposer_index(net.p, 4, 2, 0)
    block, parts, bid = net.make_block([b"bad=x"], proposer,
                                       forge_last_commit=True)
    await net.deliver(net.proposal_msgs(proposer, block, parts, bid))
    own = net.p.msgs.decode_consensus_msg(net.own[-1]).vote
    assert own.height == 2 and own.block_id is None   # a nil prevote
    await net.votes(None)
    proposer = proposer_index(net.p, 4, 2, 1)
    if proposer == net.node_index:
        bid = net.cs.rs.proposal.block_id
    else:
        block, parts, bid = net.make_block([b"good=x"], proposer)
        await net.deliver(net.proposal_msgs(proposer, block, parts, bid, 1))
    await net.votes(bid, round_=1)
    assert net.cs.state.last_block_height == 2


async def late_precommit(net):
    VT = net.p.vote.VoteType
    late = net.peers()[-1]
    bid = await net.height([b"h1=x"], who=net.peers(exclude=[late]))
    assert net.cs.state.last_block_height == 1
    assert net.cs.rs.last_commit.bit_array().count() == 3
    await net.deliver(net.vote_msgs(VT.PRECOMMIT, bid, [late], height=1))
    assert net.cs.rs.last_commit.bit_array().count() == 4


async def conflicting_vote(net):
    VT = net.p.vote.VoteType
    await net.height([b"h1=x"])
    await net.new_height()
    proposer = proposer_index(net.p, 4, 2, 0)
    block, parts, bid = net.make_block([b"h2=x"], proposer)
    await net.deliver(net.proposal_msgs(proposer, block, parts, bid))
    cheat = net.peers()[0]
    await net.deliver(net.vote_msgs(VT.PREVOTE, bid, [cheat]))
    await net.deliver(net.vote_msgs(VT.PREVOTE, None, [cheat]))
    assert len(net.evpool.pending_evidence(-1)) == 1
    await net.votes(bid, who=net.peers(exclude=[cheat]))
    assert net.cs.state.last_block_height == 2


SCENARIOS = {
    "happy_path": types.SimpleNamespace(script=happy, node=node_proposing(2)),
    "absent_proposer": types.SimpleNamespace(
        script=absent_proposer, node=node_not_proposing((1, 0))),
    "lock_relock": types.SimpleNamespace(
        script=lock_relock, node=node_not_proposing((1, 0), (1, 1))),
    "invalid_block": types.SimpleNamespace(
        script=invalid_block, node=node_not_proposing((1, 0), (2, 0))),
    "late_precommit": types.SimpleNamespace(
        script=late_precommit, node=node_not_proposing((1, 0))),
    "conflicting_vote": types.SimpleNamespace(
        script=conflicting_vote, node=node_not_proposing((1, 0), (2, 0))),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scripted_round_states_equal_reference(tmp_path, name):
    ref, port = both(SCENARIOS[name], tmp_path)
    assert port["sent"] == ref["sent"]
    assert len(port["records"]) == len(ref["records"])
    for i, (a, b) in enumerate(zip(port["records"], ref["records"])):
        assert a == b, f"step {i}"
    assert port["own"] == ref["own"] and port["own"]
    assert port["wal"] == ref["wal"]
    assert port["evidence"] == ref["evidence"]
    assert port["blocks"] == ref["blocks"] and port["blocks"]
    assert port["app_hash"] == ref["app_hash"]
    if name == "conflicting_vote":
        assert len(port["evidence"]) == 1
    if name == "happy_path":
        own = [PORT.msgs.decode_consensus_msg(b) for b in port["own"]]
        assert any(isinstance(o, PORT.msgs.ProposalMessage) for o in own)


# ------------------------------------------- 150 validators, batched


def test_150_validators_batches_take_the_structured_route(tmp_path,
                                                          monkeypatch):
    """One height at 150 validators with the default vote batching:
    every peer's prevote and precommit is handed over at once, and the
    first multi-vote batch holds its executor thread until 128 votes
    wait in the buffer, so the next batch is wide whatever the load:
    the port's batches of 128 or more of one set launch the plain K3
    version on a VoteSignBatch, the narrower ones stay below it; the
    reference (held on its host) commits the same block with the same
    RoundState."""
    from tendermint_tpu_torch.crypto.cuda import expanded

    n_vals = 150
    routes, k3 = [], []
    real_lanes = PORT.vset.ValidatorSet._batch_verify_lanes
    real_structured = expanded.ExpandedKeys.verify_structured

    def spy_lanes(self, lanes, msgs, sigs):
        routes.append((type(msgs).__name__, len(lanes)))
        return real_lanes(self, lanes, msgs, sigs)

    def spy_structured(self, lanes, msgs, sigs):
        k3.append(len(lanes))
        return real_structured(self, lanes, msgs, sigs)

    monkeypatch.setattr(PORT.vset.ValidatorSet, "_batch_verify_lanes",
                        spy_lanes)
    monkeypatch.setattr(expanded.ExpandedKeys, "verify_structured",
                        spy_structured)
    jbatch.set_force_host(True)

    def gate(p, real_fn, sizes, net_box, method):
        held = {"done": False}

        def gated(*a):
            batch = a[1] if method else a[0]
            if 1 < len(batch) < 128 and not held["done"] and \
                    threading.current_thread() is not threading.main_thread():
                held["done"] = True
                cs = net_box[0].cs
                buf = cs.scheduler if hasattr(cs, "scheduler") else cs
                deadline = time.monotonic() + 60
                while len(buf._vote_buf) < 128 and \
                        time.monotonic() < deadline:
                    time.sleep(0.005)
            sizes.append(len(batch))
            return real_fn(*a)

        return gated

    async def go(p, sizes, box):
        clock = Clock()
        p.clock.install(clock)
        cfg = p.config.ConsensusConfig(
            timeout_propose_ms=LONG_MS, timeout_prevote_ms=LONG_MS,
            timeout_precommit_ms=LONG_MS, timeout_commit_ms=LONG_MS)
        node = proposer_index(p, n_vals, 1, 0) + 1
        net = Net(p, cfg, n_vals=n_vals, node_index=node, clock=clock)
        box.append(net)
        await net.start()
        try:
            proposer = node - 1
            block, parts, bid = net.make_block([b"wide=x"], proposer)
            await net.deliver(net.proposal_msgs(proposer, block, parts, bid))
            VT = p.vote.VoteType
            await net.deliver(net.vote_msgs(VT.PREVOTE, bid, net.peers())
                              + net.vote_msgs(VT.PRECOMMIT, bid, net.peers()))
            await net.cs.wait_for_height(1, timeout=120)
            await net.settle()
        finally:
            await net.stop()
            p.clock.uninstall()
        return net.records[-1], net.bs.load_block(1).hash(), \
            net.cs.state.app_hash

    ref_sizes, port_sizes, rbox, pbox = [], [], [], []
    rstate = importlib.import_module("tendermint_tpu.consensus.state")
    monkeypatch.setattr(rstate.ConsensusState, "_batch_verdicts",
                        gate(REF, rstate.ConsensusState._batch_verdicts,
                             ref_sizes, rbox, True))
    monkeypatch.setattr(PORT.cs, "batch_verdicts",
                        gate(PORT, PORT.cs.batch_verdicts, port_sizes, pbox,
                             False))
    ref = asyncio.run(go(REF, ref_sizes, rbox))
    port = asyncio.run(go(PORT, port_sizes, pbox))
    assert port == ref
    wide = [n for n in port_sizes if n >= 128]
    assert wide, port_sizes
    assert sorted(k3) == sorted(wide)
    assert sorted(n for t, n in routes if t == "VoteSignBatch") == sorted(wide)
    assert all(t == "list" for t, n in routes if n < 128)
