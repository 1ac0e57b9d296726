"""Port parity for the ABCI layer (abci/types.py, abci/client.py,
abci/kvstore.py, proxy/__init__.py, libs/service.py), against the JAX
package, in the shapes of tests/test_abci.py (all but the socket and
gRPC transports, which wait for a later slice of the port).

Every message kind is built from one numpy seed in both packages: the
encoded bytes must be equal, and each package must decode the other's
bytes to the same message. The kvstore apps run the same request
sequences in both packages (blocks, restarts over their own MemDB,
validator txs, half-delivered replays, snapshots and a restore): every
response's bytes and every app hash must be equal. AppConns share one
app in both; the `abci.deliver` failpoint fires through hit_async in
both. Tolerance: exact."""

import asyncio
import dataclasses
import time
import types

import numpy as np
import pytest

from tendermint_tpu.abci import client as jclient
from tendermint_tpu.abci import kvstore as jkv
from tendermint_tpu.abci import types as jt
from tendermint_tpu.libs import db as jdb
from tendermint_tpu.libs import failpoints as jfailpoints
from tendermint_tpu.libs import service as jservice
from tendermint_tpu import proxy as jproxy
from tendermint_tpu_torch.abci import client as pclient
from tendermint_tpu_torch.abci import kvstore as pkv
from tendermint_tpu_torch.abci import types as pt
from tendermint_tpu_torch.libs import db as pdb
from tendermint_tpu_torch.libs import failpoints as pfailpoints
from tendermint_tpu_torch.libs import service as pservice
from tendermint_tpu_torch import proxy as pproxy

PACKAGES = {
    "port": types.SimpleNamespace(
        t=pt, kv=pkv, client=pclient, db=pdb, proxy=pproxy,
        failpoints=pfailpoints, service=pservice,
        disarm=pfailpoints.disarm_all),
    "reference": types.SimpleNamespace(
        t=jt, kv=jkv, client=jclient, db=jdb, proxy=jproxy,
        failpoints=jfailpoints, service=jservice,
        disarm=jfailpoints.reset),
}


def run(coro):
    return asyncio.run(coro)


# -- the codec -----------------------------------------------------------


def _value(pkg, ftype: str, name: str, rng):
    """A seeded value for a field of declared type `ftype`."""
    t = pkg.t
    nested = t._NESTED.get(name)
    if nested is not None:
        if ftype.startswith("list"):
            return [_message(pkg, nested, rng)
                    for _ in range(int(rng.integers(1, 4)))]
        return _message(pkg, nested, rng)
    if ftype.startswith("bytes"):
        return rng.bytes(int(rng.integers(1, 40)))
    if ftype == "str":
        return "s%dé\"\\" % rng.integers(1 << 30)
    if ftype == "bool":
        return bool(rng.integers(2))
    if ftype == "int":
        return int(rng.integers(-(1 << 40), 1 << 40))
    if ftype.startswith("dict"):
        return {"height": int(rng.integers(1 << 20)),
                "chain_id": "c%d" % rng.integers(100),
                "blob": {"inner": [1, 2, int(rng.integers(9))]}}
    if ftype == "list[int]":
        return [int(x) for x in rng.integers(0, 1 << 20, 3)]
    if ftype == "list[str]":
        return ["peer-%d" % x for x in rng.integers(0, 99, 2)]
    if ftype == "list":
        return [{"type": "app", "attributes": [
            {"key": "k", "value": "v%d" % rng.integers(99)}]}]
    raise AssertionError(f"no sample for {name}: {ftype}")


def _message(pkg, cls, rng):
    return cls(**{f.name: _value(pkg, f.type, f.name, rng)
                  for f in dataclasses.fields(cls)})


def test_registries_are_equal():
    assert sorted(pt._REGISTRY) == sorted(jt._REGISTRY)
    assert len(pt._REGISTRY) == 34
    assert {k.__name__: v for k, v in pt.HANDLERS.items()} == \
        {k.__name__: v for k, v in jt.HANDLERS.items()}
    assert pt._NESTED.keys() == jt._NESTED.keys()
    for name, cls in pt._REGISTRY.items():
        assert [(f.name, f.type) for f in dataclasses.fields(cls)] == \
            [(f.name, f.type) for f in dataclasses.fields(
                jt._REGISTRY[name])], name


@pytest.mark.parametrize("name", sorted(jt._REGISTRY))
def test_codec_bytes_equal_both_ways(name):
    """Every message kind, seeded fields (nested ones included), and
    its all-defaults form where every field has a default: equal bytes, and each package decodes the
    other's bytes to a message that re-encodes to the same bytes."""
    seed = int.from_bytes(name.encode()[:8], "little")
    defaults = all(f.default is not dataclasses.MISSING
                   or f.default_factory is not dataclasses.MISSING
                   for f in dataclasses.fields(jt._REGISTRY[name]))
    for full in (True, False) if defaults else (True,):
        msgs = {}
        for key, pkg in PACKAGES.items():
            cls = pkg.t._REGISTRY[name]
            msgs[key] = (_message(pkg, cls, np.random.default_rng(seed))
                         if full else cls())
        pb, jb = pt.encode_msg(msgs["port"]), jt.encode_msg(msgs["reference"])
        assert pb == jb
        back_p, back_j = pt.decode_msg(jb), jt.decode_msg(pb)
        assert type(back_p) is pt._REGISTRY[name]
        assert back_p == msgs["port"] and back_j == msgs["reference"]
        assert pt.encode_msg(back_p) == jt.encode_msg(back_j) == pb


def test_application_defaults_are_equal():
    """The base Application's default responses, method by method."""
    p_app, j_app = pt.Application(), jt.Application()
    for req_type, method in jt.HANDLERS.items():
        p_req = pt._REGISTRY[req_type.__name__]()
        got = getattr(p_app, method)(p_req)
        want = getattr(j_app, method)(req_type())
        assert pt.encode_msg(got) == jt.encode_msg(want), method


# -- the kvstore apps ----------------------------------------------------


def _drive(pkg, app, script):
    """Run `script` ([(method, request kwargs)]) through `app`; the
    encoded responses."""
    out = []
    for method, req_name, kw in script:
        req = pkg.t._REGISTRY[req_name](**kw)
        out.append(pkg.t.encode_msg(getattr(app, method)(req)))
    return out


def _block(txs, height):
    return ([("begin_block", "RequestBeginBlock", {})]
            + [("deliver_tx", "RequestDeliverTx", {"tx": tx}) for tx in txs]
            + [("end_block", "RequestEndBlock", {"height": height}),
               ("commit", "RequestCommit", {})])


def _txs(rng, n):
    out = []
    for i in range(n):
        k = rng.bytes(int(rng.integers(1, 12))).hex().encode()
        v = rng.bytes(int(rng.integers(0, 20))).hex().encode()
        out.append(k + b"=" + v if i % 5 else k)
    return out


def test_kvstore_app_flow():
    rng = np.random.default_rng(7)
    script = [("info", "RequestInfo", {}),
              ("check_tx", "RequestCheckTx", {"tx": b"a=1"})]
    for h in range(1, 4):
        script += _block(_txs(rng, 6), h)
        script += [("query", "RequestQuery", {"data": b"a"}),
                   ("info", "RequestInfo", {})]
    # a half-delivered block, replayed from BeginBlock
    script += [("begin_block", "RequestBeginBlock", {}),
               ("deliver_tx", "RequestDeliverTx", {"tx": b"half=1"})]
    script += _block([b"half=1", b"z=9"], 4)
    script += [("query", "RequestQuery", {"data": b"half"}),
               ("query", "RequestQuery", {"data": b"absent"})]
    got = [_drive(pkg, pkg.kv.KVStoreApp(), script)
           for pkg in PACKAGES.values()]
    assert got[0] == got[1]
    assert len(got[0]) == len(script)


def _persistent_script(rng, key_hexes, heights):
    script = []
    for h in heights:
        txs = _txs(rng, 4)
        txs.append(jkv.encode_validator_tx(key_hexes[h % 3], h % 4))
        txs.append(b"val:zz!1")  # invalid validator tx
        script += _block(txs, h)
    return script


def test_persistent_kvstore_restart_validators_and_snapshots():
    """Blocks with validator txs (valid, removal, invalid), a restart
    over the same DB, a half-delivered replay, snapshots every 2
    heights (3 kept), chunk loads and a restore into a fresh app:
    equal responses, app hashes and stored bytes."""
    keys = [bytes([i]) * 32 for i in (1, 2, 3)]
    hexes = [k.hex() for k in keys]
    results = {}
    for name, pkg in PACKAGES.items():
        rng = np.random.default_rng(11)
        db = pkg.db.MemDB()
        init = pkg.t.RequestInitChain(validators=[
            pkg.t.ValidatorUpdate("ed25519", k, 10) for k in keys])
        app = pkg.kv.PersistentKVStoreApp(db, snapshot_interval=2,
                                          keep_snapshots=3)
        out = [pkg.t.encode_msg(app.init_chain(init))]
        out += _drive(pkg, app, _persistent_script(rng, hexes, range(1, 5)))
        # restart over the same DB, then a half-delivered block replayed
        app = pkg.kv.PersistentKVStoreApp(db, snapshot_interval=2,
                                          keep_snapshots=3)
        out.append(pkg.t.encode_msg(app.info(pkg.t.RequestInfo())))
        out += _drive(pkg, app, [
            ("begin_block", "RequestBeginBlock", {}),
            ("deliver_tx", "RequestDeliverTx",
             {"tx": jkv.encode_validator_tx(hexes[0], 77)}),
            ("deliver_tx", "RequestDeliverTx", {"tx": b"h=1"})])
        out += _drive(pkg, app, _persistent_script(rng, hexes, range(5, 10)))
        out += _drive(pkg, app, [
            ("query", "RequestQuery", {"path": "/val",
                                       "data": hexes[1].encode()}),
            ("list_snapshots", "RequestListSnapshots", {})])
        snaps = app.list_snapshots(pkg.t.RequestListSnapshots()).snapshots
        chunks = [app.load_snapshot_chunk(pkg.t.RequestLoadSnapshotChunk(
            s.height, s.format, 0)).chunk for s in snaps]
        out += [pkg.t.encode_msg(pkg.t.ResponseLoadSnapshotChunk(c))
                for c in chunks]
        # restore the newest snapshot into a fresh app
        fresh = pkg.kv.PersistentKVStoreApp(pkg.db.MemDB())
        out.append(pkg.t.encode_msg(fresh.offer_snapshot(
            pkg.t.RequestOfferSnapshot(snaps[-1], b""))))
        out.append(pkg.t.encode_msg(fresh.apply_snapshot_chunk(
            pkg.t.RequestApplySnapshotChunk(0, chunks[-1], "peer"))))
        out.append(pkg.t.encode_msg(fresh.info(pkg.t.RequestInfo())))
        # a poisoned restore names its single sender
        bad = pkg.kv.PersistentKVStoreApp(pkg.db.MemDB())
        bad.offer_snapshot(pkg.t.RequestOfferSnapshot(snaps[-1], b""))
        out.append(pkg.t.encode_msg(bad.apply_snapshot_chunk(
            pkg.t.RequestApplySnapshotChunk(0, chunks[-1][:-1], "liar"))))
        out.append(pkg.t.encode_msg(bad.offer_snapshot(
            pkg.t.RequestOfferSnapshot(pkg.t.Snapshot(1, 2, 1, b""), b""))))
        results[name] = (out, list(db.iterate()), app.validators,
                         [s.height for s in snaps])
    assert results["port"] == results["reference"]
    assert results["port"][3] == [4, 6, 8]


# -- the connections -----------------------------------------------------


def test_app_conns_share_one_app_and_count_calls():
    async def go(pkg):
        app = pkg.kv.KVStoreApp()
        conns = pkg.proxy.AppConns(pkg.client.ClientCreator(app=app))
        await conns.start()
        out = []
        await conns.consensus.begin_block(pkg.t.RequestBeginBlock())
        out.append(await conns.consensus.deliver_tx(
            pkg.t.RequestDeliverTx(b"a=1")))
        out.append(await conns.consensus.commit())
        out.append(await conns.query.query(pkg.t.RequestQuery(data=b"a")))
        out.append(await conns.mempool.check_tx(pkg.t.RequestCheckTx(b"b=2")))
        out.append(await conns.snapshot.list_snapshots())
        out.append(await conns.query.echo("hi"))
        # concurrent submits through one connection: FIFO per app lock
        tasks = [conns.consensus.submit(pkg.t.RequestDeliverTx(b"k%d=v" % i))
                 for i in range(8)]
        out += await asyncio.gather(*tasks)
        running = [c.is_running for c in conns._all()]
        await conns.stop()
        return ([pkg.t.encode_msg(r) for r in out], running,
                [c.is_running for c in conns._all()], app.size)

    got = {k: run(go(pkg)) for k, pkg in PACKAGES.items()}
    assert got["port"] == got["reference"]
    assert got["port"][1] == [True] * 4 and got["port"][2] == [False] * 4
    calls = pproxy.METRICS["method_calls"]
    assert calls[("consensus", "deliver_tx")] >= 9
    assert calls[("query", "echo")] >= 1
    assert pproxy.METRICS["method_seconds"][("mempool", "check_tx")] >= 0
    assert [pproxy._snake(n) for n in ("RequestCheckTx",
                                       "RequestApplySnapshotChunk")] == \
        [jproxy._snake(n) for n in ("RequestCheckTx",
                                    "RequestApplySnapshotChunk")]


def test_local_client_in_flight_counts_lock_waiters():
    async def go(pkg):
        app = pkg.kv.KVStoreApp()
        lock = asyncio.Lock()
        a = pkg.client.LocalClient(app, lock)
        b = pkg.client.LocalClient(app, lock)
        await lock.acquire()
        ts = [asyncio.ensure_future(a.check_tx(pkg.t.RequestCheckTx(b"x")))
              for _ in range(3)]
        tb = asyncio.ensure_future(b.check_tx(pkg.t.RequestCheckTx(b"y")))
        await asyncio.sleep(0)
        seen = (a.in_flight(), b.in_flight())
        lock.release()
        await asyncio.gather(*ts, tb)
        return seen, (a.in_flight(), b.in_flight())

    got = {k: run(go(pkg)) for k, pkg in PACKAGES.items()}
    assert got["port"] == got["reference"] == ((3, 1), (0, 0))


def test_client_creator_with_an_address_raises():
    with pytest.raises(NotImplementedError, match="Queue A item 7"):
        pclient.ClientCreator(addr=("127.0.0.1", 26658))
    with pytest.raises(NotImplementedError):
        pclient.ClientCreator(unix_path="/nonexistent.sock")


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_abci_deliver_failpoint_through_hit_async(package):
    """`error` fails the call like a dead connection; `delay` stalls
    that call (asyncio.sleep) while the loop keeps running."""
    pkg = PACKAGES[package]

    async def go():
        app = pkg.kv.KVStoreApp()
        conns = pkg.proxy.AppConns(pkg.client.ClientCreator(app=app))
        await conns.start()
        pkg.failpoints.arm("abci.deliver", "error", count=1)
        with pytest.raises(pkg.failpoints.FailpointError):
            await conns.mempool.check_tx(pkg.t.RequestCheckTx(b"a"))
        ok = await conns.mempool.check_tx(pkg.t.RequestCheckTx(b"a"))
        pkg.failpoints.arm("abci.deliver", "delay", delay_ms=150.0, count=1)
        ticks = 0

        async def ticker():
            nonlocal ticks
            while True:
                await asyncio.sleep(0.01)
                ticks += 1

        tick = asyncio.ensure_future(ticker())
        t0 = time.monotonic()
        await conns.query.info(pkg.t.RequestInfo())
        dt = time.monotonic() - t0
        tick.cancel()
        await conns.stop()
        return ok.is_ok(), dt, ticks

    try:
        ok, dt, ticks = run(go())
    finally:
        pkg.disarm()
    assert ok and dt >= 0.14 and ticks >= 5


# -- the service lifecycle -----------------------------------------------


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_service_start_stop_spawn_and_crash(package):
    svc_mod = PACKAGES[package].service

    class Svc(svc_mod.Service):
        def __init__(self):
            super().__init__(name="svc")
            self.crashes, self.events = [], []

        async def on_start(self):
            self.events.append("start")
            self.spawn(self.boom(), name="boom")
            self.spawn(asyncio.sleep(3600), name="sleeper")

        async def on_stop(self):
            self.events.append("stop")

        async def boom(self):
            await asyncio.sleep(0)
            raise ValueError("boom")

        def on_task_crash(self, task, exc):
            self.crashes.append((task.get_name(), str(exc)))

    async def go():
        s = Svc()
        await s.start()
        with pytest.raises(svc_mod.AlreadyStarted):
            await s.start()
        for _ in range(5):
            await asyncio.sleep(0)
        running = s.is_running
        await s.stop()
        await s.stop()  # idempotent
        stopped = not s.is_running and not s._tasks
        await s.restart()
        for _ in range(5):
            await asyncio.sleep(0)
        again = s.is_running
        await s.stop()
        with pytest.raises(svc_mod.NotStarted):
            await Svc().stop()
        return running, stopped, again, s.crashes, s.events

    running, stopped, again, crashes, events = run(go())
    assert running and stopped and again
    assert crashes == [("boom", "boom"), ("boom", "boom")]
    assert events == ["start", "stop", "start", "stop"]
