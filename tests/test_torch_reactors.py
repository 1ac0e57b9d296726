"""The port's mempool, evidence and blockchain reactors over real p2p,
held against the JAX package's: mempool gossip between a port node and
a reference node (and ``encode_txs``'s bytes), invalid evidence from a
peer stopping that peer, a tx committed while its check_tx waits in
the admission pre-verify kept out of the pool (a fix beyond the
reference), and a port node fast-syncing a chain from
reference nodes through BlockchainReactor (its windows on K3's plain
version, with _EXPAND_MIN lowered on the port only) and then switching
to consensus. Then the port's fault rule at the mempool reactor's
check_tx, the fast-sync pool routine and the evidence gossip routine:
a KernelError halts the node (the reference swallows it, logs it and
stalls, or logs it and the routine dies). The nodes are
test_torch_consensus_reactor.Node; each scenario runs under one
deadline and asserts outcomes, never timings."""

from __future__ import annotations

import asyncio
import importlib

import pytest

from tendermint_tpu_torch.crypto.cuda.kernels import KernelError
from tendermint_tpu_torch.types import validator_set as pvalidator_set

import test_torch_consensus_reactor as harness
from test_torch_consensus_reactor import PORT, REF, Node, genesis, run

_cpu = harness._cpu


async def until(cond, what: str, tries: int = 1500):
    for _ in range(tries):
        if cond():
            return
        await asyncio.sleep(0.02)
    raise AssertionError(what)


# -- mempool ------------------------------------------------------------------


def test_encode_txs_bytes_agree():
    txs = [b"", b"a=1", bytes(range(256)) * 3, b"\x00" * 40]
    for p in (PORT, REF):
        assert p.mreactor.decode_txs(REF.mreactor.encode_txs(txs)) == txs
    assert PORT.mreactor.encode_txs(txs) == REF.mreactor.encode_txs(txs)


@pytest.mark.parametrize("pa,pb", [(PORT, REF), (REF, PORT)],
                         ids=["port-ref", "ref-port"])
def test_mempool_gossip_across_packages(pa, pb):
    """A tx admitted at one node reaches the other node's mempool over
    the mempool reactor, and one sent back is not re-gossiped to its
    sender."""
    async def go():
        ga, pva = genesis(pa, 2)
        gb, pvb = genesis(pb, 2)
        a = await Node(pa, ga, None, "mp-a", mempool=True).start()
        b = await Node(pb, gb, None, "mp-b", mempool=True).start()
        try:
            await a.dial(b)
            await until(lambda: b.switch.n_peers() == 1, "inbound")
            # the broadcast routine waits for the peer's consensus height
            # (a non-validator pair sits at height 1 and may send)
            txs_a = [b"from-a-%d=%d" % (i, i) for i in range(5)]
            for tx in txs_a:
                await a.mempool.check_tx(tx)
            await b.mempool.check_tx(b"from-b=1")
            await until(lambda: b.mempool.size() == 6 and
                        a.mempool.size() == 6, "gossip")
            return (sorted(e.value.tx for e in _elems(a.mempool)),
                    sorted(e.value.tx for e in _elems(b.mempool)))
        finally:
            await a.stop()
            await b.stop()

    got_a, got_b = run(go())
    assert got_a == got_b and len(got_a) == 6


@pytest.mark.parametrize("p", [PORT, REF], ids=["port", "reference"])
def test_a_tx_committed_during_its_admission_wait_stays_out(p):
    """A gossiped tx waits in the admission pre-verify while a block
    carrying it commits (the mempool's update): the port drops it when
    the wait ends; the reference puts it back in the pool, to be
    committed a second time (a recorded divergence, ROADMAP Queue C)."""
    import types

    async def go():
        app = p.kvstore.PersistentKVStoreApp(p.db.MemDB())
        conns = p.proxy.AppConns(p.client.ClientCreator(app=app))
        await conns.start()
        mp = p.clist.CListMempool(p.config.MempoolConfig(), conns.mempool)
        gate = asyncio.Event()
        admit = mp.admission.admit

        async def held(tx):
            await gate.wait()
            return await admit(tx)

        mp.admission.admit = held
        tx = b"gossiped=1"
        check = asyncio.get_running_loop().create_task(
            mp.check_tx(tx, {"sender": "peer"}))
        await asyncio.sleep(0.01)
        mp.lock()
        await mp.update(1, [tx], [types.SimpleNamespace(code=0)])
        mp.unlock()
        gate.set()
        res = await check
        size = mp.size()
        mp.close()
        await conns.stop()
        return res.code, size

    assert run(go()) == ((0, 0) if p is PORT else (0, 1))


def _elems(mempool):
    e = mempool.txs.front()
    while e is not None:
        yield e
        e = e.next()


# -- evidence -----------------------------------------------------------------


@pytest.mark.parametrize("p", [PORT, REF], ids=["port", "reference"])
def test_invalid_evidence_from_a_peer_stops_that_peer(p):
    """A peer gossips a DuplicateVoteEvidence whose second signature is
    garbage: the node stops that peer and keeps nothing."""
    async def go():
        gdoc, pvs = genesis(p, 1)
        node = await Node(p, gdoc, pvs[0], "ev-node").start()
        sender = await Node(p, gdoc, None, "ev-sender").start()
        try:
            await node.cs.wait_for_height(2, timeout=30)
            await sender.dial(node)
            await until(lambda: node.switch.n_peers() == 1, "inbound")
            state = node.cs.state
            bid = [p.block.BlockID(bytes([s]) * 32,
                                   p.block.PartSetHeader(1, bytes([s]) * 32))
                   for s in (1, 2)]
            votes = []
            for b in bid:
                v = p.vote.Vote(
                    type=p.vote.VoteType.PRECOMMIT, height=1, round=0,
                    block_id=b, timestamp=gdoc.genesis_time + 1,
                    validator_address=pvs[0].get_pub_key().address(),
                    validator_index=0)
                pvs[0].sign_vote(gdoc.chain_id, v)
                votes.append(v)
            votes[1].signature = b"\x22" * 64
            evmod = importlib.import_module(f"{p.name}.types.evidence")
            block1 = node.block_store.load_block(1)
            ev = evmod.DuplicateVoteEvidence.from_votes(
                votes[0], votes[1], block1.header.time, state.validators)
            peer = next(iter(sender.switch.peers.values()))
            await peer.send(0x38, p.evreactor.encode_evidence_list([ev]))
            await until(lambda: node.switch.n_peers() == 0, "peer stopped")
            return node.evpool.size(), node.switch.is_running
        finally:
            await sender.stop()
            await node.stop()

    assert run(go()) == (0, True)


# -- fast sync ------------------------------------------------------------------


def test_a_port_node_fast_syncs_from_reference_nodes(monkeypatch):
    """Four reference validators build a chain and stop their consensus
    at height 6 (their switches serve blocks on); a port node with no
    key syncs the chain through BlockchainReactor (its windows and
    apply_block's LastCommit checks on the structured route: K3's plain
    version on the CPU), equals it block for block and hands over to
    consensus at the next height."""
    monkeypatch.setattr(pvalidator_set, "_EXPAND_MIN", 4)
    seen = []
    real = pvalidator_set.ValidatorSet._batch_verify_lanes

    def spy(self, lanes, msgs, sigs):
        seen.append(type(msgs).__name__)
        return real(self, lanes, msgs, sigs)

    monkeypatch.setattr(pvalidator_set.ValidatorSet, "_batch_verify_lanes",
                        spy)

    async def go():
        nodes = await harness.make_net([REF] * 4)
        gdoc, _ = genesis(PORT, 4)
        syncer = Node(PORT, gdoc, None, "syncer", fast_sync=True)
        try:
            await asyncio.gather(*(n.cs.wait_for_height(6, timeout=40)
                                   for n in nodes))
            for n in nodes:
                await n.cs.stop()
            top = min(n.block_store.height for n in nodes)
            await syncer.start()
            await syncer.dial(nodes[0])
            await syncer.dial(nodes[1])
            await syncer.bc_reactor.wait_synced(timeout=50)
            h = syncer.block_store.height
            return (h >= top - 1 >= 5, syncer.chain(h) == nodes[0].chain(h),
                    syncer.bc_reactor.blocks_synced == h,
                    syncer.cs.is_running, syncer.cs.rs.height == h + 1)
        finally:
            await syncer.stop()
            await harness.stop_all(nodes)

    assert run(go()) == (True, True, True, True, True)
    assert "MergedSignBatch" in seen


def test_a_kernel_error_in_the_fast_sync_routine_halts_the_node(
        monkeypatch):
    """A window's verification raises KernelError: the port node halts
    and wait_synced re-raises it. The reference's pool routine logs
    "fast-sync pool routine died" and the sync never completes."""
    async def go(p, exc):
        async def boom(self, vals, chain_id, blocks):
            raise exc

        monkeypatch.setattr(p.bcreactor.WindowPipeline, "verdicts", boom)
        gdoc, pvs = genesis(p, 1)
        val = await Node(p, gdoc, pvs[0], "fs-val").start()
        syncer = Node(p, gdoc, None, "fs-syncer", fast_sync=True)
        try:
            await val.cs.wait_for_height(3, timeout=30)
            await syncer.start()
            await syncer.dial(val)
            try:
                if p is PORT:
                    await syncer.bc_reactor.wait_synced(timeout=20)
                else:
                    await asyncio.wait_for(
                        syncer.bc_reactor.synced.wait(), 3)
                got = "synced"
            except Exception as e:
                got = type(e).__name__
            return got, syncer.switch.is_running, \
                syncer.block_store.height
        finally:
            await syncer.stop()
            await val.stop()

    assert run(go(PORT, KernelError("injected (CUDA code 700)"))) == \
        ("KernelError", False, 0)
    assert run(go(REF, RuntimeError("injected"))) == \
        ("TimeoutError", True, 0)


def test_a_kernel_error_from_check_tx_halts_the_node(monkeypatch):
    """A gossiped tx's check_tx raises KernelError (an admission flush's
    launch): the port node halts instead of logging it as gossip
    noise; the reference swallows the same exception and keeps the
    peer."""
    async def go(p, exc):
        gdoc, _ = genesis(p, 2)
        a = await Node(p, gdoc, None, "ct-a", mempool=True).start()
        b = await Node(p, gdoc, None, "ct-b", mempool=True).start()

        async def boom(tx, tx_info=None):
            raise exc

        try:
            await a.dial(b)
            await until(lambda: b.switch.n_peers() == 1, "inbound")
            b.mempool.check_tx = boom
            await a.mempool.check_tx(b"k=v")
            if p is PORT:
                with pytest.raises(KernelError):
                    await b.switch.wait_halted(timeout=20)
            else:
                await asyncio.sleep(0.5)
            return b.switch.is_running, b.switch.n_peers()
        finally:
            await a.stop()
            await b.stop()

    assert run(go(PORT, KernelError("injected (CUDA code 700)"))) == \
        (False, 0)
    assert run(go(REF, RuntimeError("injected"))) == (True, 1)


def test_a_kernel_error_in_the_evidence_gossip_routine_halts_the_node():
    """The evidence broadcast routine meets a KernelError: the port
    node halts (wait_halted re-raises it); the reference's routine
    logs it and dies while its node runs on."""
    async def go(p, exc):
        gdoc, _ = genesis(p, 2)

        async def boom():
            raise exc

        a = await Node(p, gdoc, None, "eg-a").start()
        b = await Node(p, gdoc, None, "eg-b").start()
        a.evpool.evidence_list.front_wait = boom
        try:
            await a.dial(b)
            if p is PORT:
                with pytest.raises(KernelError):
                    await a.switch.wait_halted(timeout=20)
            else:
                await asyncio.sleep(0.3)
            return a.switch.is_running, a.cs.is_running
        finally:
            await a.stop()
            await b.stop()

    assert run(go(PORT, KernelError("injected (CUDA code 700)"))) == \
        (False, False)
    assert run(go(REF, RuntimeError("injected"))) == (True, True)
