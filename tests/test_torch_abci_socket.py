"""The socket ABCI transport (abci/client.py SocketClient, abci/server.py
SocketServer) and the proof-capable kvstore (abci/kvstore.py
MerkleKVStoreApp, abci/kv_proofs.py, abci/counter.py) held against the
JAX package's.

Both ways across the packages — a port client against a reference
server and a reference client against a port server — the same
pipelined request sequence (many requests in flight on one connection)
gets responses whose wire bytes equal those of the reference client
against the reference server. The client reconnects after its server
restarts. MerkleKVStoreApp's app hashes and query proofs (values and
absences) equal the reference's after the same txs, and each package's
proof runtime accepts the other's proofs. Tolerance: exact."""

from __future__ import annotations

import asyncio
import types

import pytest

from tendermint_tpu.abci import client as rclient
from tendermint_tpu.abci import counter as rcounter
from tendermint_tpu.abci import kv_proofs as rproofs
from tendermint_tpu.abci import kvstore as rkv
from tendermint_tpu.abci import server as rserver
from tendermint_tpu.abci import types as rt
from tendermint_tpu.crypto import merkle as rmerkle
from tendermint_tpu.libs import db as rdb
from tendermint_tpu_torch.abci import client as pclient
from tendermint_tpu_torch.abci import counter as pcounter
from tendermint_tpu_torch.abci import kv_proofs as pproofs
from tendermint_tpu_torch.abci import kvstore as pkv
from tendermint_tpu_torch.abci import server as pserver
from tendermint_tpu_torch.abci import types as pt
from tendermint_tpu_torch.crypto import merkle as pmerkle
from tendermint_tpu_torch.libs import db as pdb

PACKAGES = {
    "port": types.SimpleNamespace(t=pt, kv=pkv, client=pclient,
                                  server=pserver, db=pdb, proofs=pproofs,
                                  merkle=pmerkle, counter=pcounter),
    "reference": types.SimpleNamespace(t=rt, kv=rkv, client=rclient,
                                       server=rserver, db=rdb,
                                       proofs=rproofs, merkle=rmerkle,
                                       counter=rcounter),
}


def run(coro):
    return asyncio.run(coro)


def requests(t) -> list:
    """One block's life in requests, several queries in between."""
    out = [t.RequestEcho("hello"), t.RequestInfo(),
           t.RequestInitChain(chain_id="sock-chain")]
    out += [t.RequestCheckTx(b"k%d=v%d" % (i, i)) for i in range(6)]
    out.append(t.RequestBeginBlock(hash=b"\x01" * 32))
    out += [t.RequestDeliverTx(b"k%d=v%d" % (i, i)) for i in range(6)]
    out.append(t.RequestDeliverTx(b"k2=changed"))
    out += [t.RequestEndBlock(height=1), t.RequestCommit(),
            t.RequestQuery(data=b"k2"),
            t.RequestQuery(data=b"k3", prove=True),
            t.RequestQuery(data=b"k25", prove=True),
            t.RequestQuery(data=b"zz", prove=True),
            t.RequestFlush(), t.RequestInfo()]
    return out


def _exchange(server_pkg: str, client_pkg: str) -> list:
    """The request sequence pipelined from `client_pkg`'s SocketClient
    to `server_pkg`'s SocketServer over a MerkleKVStoreApp; the
    responses in the server package's wire bytes."""
    s, c = PACKAGES[server_pkg], PACKAGES[client_pkg]

    async def go():
        srv = s.server.SocketServer(s.kv.MerkleKVStoreApp(s.db.MemDB()),
                                    port=0)
        await srv.start()
        cl = c.client.SocketClient("127.0.0.1", srv.port)
        await cl.start()
        try:
            futs = [asyncio.ensure_future(cl.deliver(r))
                    for r in requests(c.t)]
            await asyncio.sleep(0)
            in_flight = cl.in_flight()
            resps = await asyncio.gather(*futs)
        finally:
            await cl.stop()
            await srv.stop()
        # every response re-encoded by the server's package: the bytes
        # the wire carried, whichever side decoded them
        return in_flight, [s.t.encode_msg(s.t.decode_msg(c.t.encode_msg(r)))
                           for r in resps]

    return run(go())


_BASE: dict = {}


def baseline() -> tuple:
    if not _BASE:
        _BASE["ref"] = _exchange("reference", "reference")
    return _BASE["ref"]


@pytest.mark.parametrize("server,client", [("reference", "port"),
                                           ("port", "reference"),
                                           ("port", "port")])
def test_pipelined_responses_equal_the_reference_both_ways(server, client):
    in_flight, got = _exchange(server, client)
    _, want = baseline()
    assert got == want
    assert in_flight == len(requests(pt))  # all pipelined at once
    assert b"exists" in want[-5] and b"does not exist" in want[-3]


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_socket_client_reconnects_after_the_server_restarts(package,
                                                             monkeypatch):
    """A lost connection fails what was in flight; the client re-dials
    and the next request is served (counted in the port's abci_client_reconnects_total)."""
    pkg = PACKAGES[package]
    monkeypatch.setattr(pkg.client.SocketClient, "RECONNECT_BASE_S", 0.02)

    async def go():
        app = pkg.kv.KVStoreApp()
        srv = pkg.server.SocketServer(app, port=0)
        await srv.start()
        port = srv.port
        cl = pkg.client.SocketClient("127.0.0.1", port)
        await cl.start()
        try:
            first = await cl.deliver(pkg.t.RequestEcho("a"))
            # the link drops (the server's handler sees EOF and ends),
            # then the server goes away
            cl._writer.close()
            await srv.stop()
            for _ in range(200):
                if cl._conn_err is not None:
                    break
                await asyncio.sleep(0.01)
            with pytest.raises(pkg.client.ABCIClientError):
                await cl.deliver(pkg.t.RequestEcho("lost"))
            srv2 = pkg.server.SocketServer(app, port=port)
            await srv2.start()
            try:
                for _ in range(500):
                    if cl._conn_err is None:
                        break
                    await asyncio.sleep(0.01)
                second = await cl.deliver(pkg.t.RequestEcho("b"))
            finally:
                await cl.stop()  # the server waits for its connections
                await srv2.stop()
        finally:
            if cl.is_running:
                await cl.stop()
        return first.message, second.message

    from tendermint_tpu_torch.libs.metrics import abci_metrics

    reconnects = abci_metrics().client_reconnects
    before = reconnects.value(result="ok")
    assert run(go()) == ("a", "b")
    if package == "port":
        assert reconnects.value(result="ok") == before + 1


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_an_app_exception_is_an_error_frame(package):
    pkg = PACKAGES[package]

    class Broken(pkg.kv.KVStoreApp):
        def check_tx(self, req):
            raise RuntimeError("app bug")

    async def go():
        srv = pkg.server.SocketServer(Broken(), port=0)
        await srv.start()
        cl = pkg.client.SocketClient("127.0.0.1", srv.port)
        await cl.start()
        try:
            with pytest.raises(pkg.client.ABCIClientError, match="app bug"):
                await cl.deliver(pkg.t.RequestCheckTx(b"x"))
            return (await cl.deliver(pkg.t.RequestEcho("alive"))).message
        finally:
            await cl.stop()
            await srv.stop()

    assert run(go()) == "alive"


# -- MerkleKVStoreApp and its proofs ---------------------------------------

BLOCKS = [[b"a=1", b"c=3", b"b=2"], [b"b=22", b"e=5"], [],
          [b"a=", b"zz=top"]]
QUERIES = [b"a", b"b", b"c", b"e", b"zz", b"0", b"bb", b"d", b"zzz"]


def _merkle_run(pkg) -> list:
    """App hash after each block, then every query's response bytes."""
    app = pkg.kv.MerkleKVStoreApp(pkg.db.MemDB())
    app.init_chain(pkg.t.RequestInitChain(chain_id="proofs"))
    out = []
    for h, txs in enumerate(BLOCKS, 1):
        app.begin_block(pkg.t.RequestBeginBlock(hash=bytes([h]) * 32))
        for tx in txs:
            app.deliver_tx(pkg.t.RequestDeliverTx(tx))
        app.end_block(pkg.t.RequestEndBlock(height=h))
        out.append(app.commit(pkg.t.RequestCommit()).data.hex())
        out += [pkg.t.encode_msg(app.query(pkg.t.RequestQuery(
            data=q, prove=True))) for q in QUERIES]
    return out


def test_merkle_kvstore_hashes_and_proofs_equal_the_reference():
    assert _merkle_run(PACKAGES["port"]) == _merkle_run(PACKAGES["reference"])


@pytest.mark.parametrize("prover,verifier", [("port", "reference"),
                                             ("reference", "port")])
def test_proofs_verify_across_the_packages(prover, verifier):
    """Each query's proof ops, made by one package's app, verify in the
    other's proof runtime against the app hash; a tampered value fails."""
    p, v = PACKAGES[prover], PACKAGES[verifier]
    app = p.kv.MerkleKVStoreApp(p.db.MemDB())
    app.init_chain(p.t.RequestInitChain(chain_id="proofs"))
    for h, txs in enumerate(BLOCKS, 1):
        app.begin_block(p.t.RequestBeginBlock(hash=bytes([h]) * 32))
        for tx in txs:
            app.deliver_tx(p.t.RequestDeliverTx(tx))
        app.end_block(p.t.RequestEndBlock(height=h))
        root = app.commit(p.t.RequestCommit()).data
    rt_ = v.proofs.kv_proof_runtime()
    for q in QUERIES:
        res = app.query(p.t.RequestQuery(data=q, prove=True))
        ops = [v.merkle.ProofOp(o["type"], o["key"], o["data"])
               for o in res.proof_ops]
        if res.log == "exists":
            assert rt_.verify_value(ops, root, [q], res.value)
            assert not rt_.verify_value(ops, root, [q], res.value + b"!")
        else:
            assert rt_.verify_absence(ops, root, [q])
            assert not rt_.verify_absence(ops, b"\x00" * 32, [q])


def _counter_run(pkg) -> list:
    app = pkg.counter.CounterApp()
    out = []
    for tx in (b"\x00", b"serial=on", b"\x00", b"\x00\x01", b"\x05"):
        out.append(pkg.t.encode_msg(app.check_tx(pkg.t.RequestCheckTx(tx))))
        out.append(pkg.t.encode_msg(app.deliver_tx(
            pkg.t.RequestDeliverTx(tx))))
    out.append(pkg.t.encode_msg(app.commit(pkg.t.RequestCommit())))
    out.append(pkg.t.encode_msg(app.info(pkg.t.RequestInfo())))
    return out


def test_counter_app_equals_the_reference():
    assert _counter_run(PACKAGES["port"]) == \
        _counter_run(PACKAGES["reference"])
