"""Port parity for the mempool (libs/clist.py, mempool/__init__.py,
mempool/clist_mempool.py, config.MempoolConfig), against the JAX
package, in the shapes of tests/test_mempool.py.

Each scenario runs in both packages on the same seeded txs: every
CheckTx response's bytes, every exception's type name and text, the
admitted set, the reap order under byte and gas caps, the cache and
the WAL must be equal. Unsigned txs only here (the admission plane's
permissive default lets them through without a verify launch;
tests/test_torch_admission.py covers the envelopes). Tolerance:
exact."""

import asyncio
import types

import numpy as np
import pytest

from tendermint_tpu import config as jconfig
from tendermint_tpu import mempool as jmempool
from tendermint_tpu.abci import client as jclient
from tendermint_tpu.abci import kvstore as jkv
from tendermint_tpu.abci import types as jt
from tendermint_tpu.libs import clist as jclist
from tendermint_tpu.libs import overload as joverload
from tendermint_tpu.mempool import clist_mempool as jcm
from tendermint_tpu_torch import config as pconfig
from tendermint_tpu_torch import mempool as pmempool
from tendermint_tpu_torch.abci import client as pclient
from tendermint_tpu_torch.abci import kvstore as pkv
from tendermint_tpu_torch.abci import types as pt
from tendermint_tpu_torch.libs import clist as pclist
from tendermint_tpu_torch.libs import overload as poverload
from tendermint_tpu_torch.mempool import clist_mempool as pcm

PACKAGES = {
    "port": types.SimpleNamespace(
        t=pt, kv=pkv, client=pclient, clist=pclist, cm=pcm,
        mempool=pmempool, config=pconfig, overload=poverload),
    "reference": types.SimpleNamespace(
        t=jt, kv=jkv, client=jclient, clist=jclist, cm=jcm,
        mempool=jmempool, config=jconfig, overload=joverload),
}


def run(coro):
    return asyncio.run(coro)


def both(scenario, *args):
    """scenario(pkg, *args) in each package; the two results."""
    out = {k: scenario(pkg, *args) for k, pkg in PACKAGES.items()}
    return out["port"], out["reference"]


def counter_app(pkg):
    class CounterApp(pkg.t.Application):
        """Admits only counters >= the committed floor and wants gas =
        the counter's low byte: recheck has something to invalidate."""

        def __init__(self):
            self.committed = 0
            self.checks = 0

        def check_tx(self, req):
            self.checks += 1
            v = int.from_bytes(req.tx, "big")
            if v < self.committed:
                return pkg.t.ResponseCheckTx(code=2, log="stale counter")
            return pkg.t.ResponseCheckTx(code=pkg.t.CODE_TYPE_OK,
                                         gas_wanted=1 + v % 7)

    return CounterApp()


def make_pool(pkg, app=None, **cfg):
    app = app or pkg.kv.KVStoreApp()
    return pkg.cm.CListMempool(pkg.config.MempoolConfig(**cfg),
                               pkg.client.LocalClient(app)), app


async def outcome(pkg, coro):
    """A CheckTx's response bytes, or its exception's type and text."""
    try:
        return pkg.t.encode_msg(await coro)
    except Exception as e:
        return (type(e).__name__, str(e))


def txs_of(seed: int, n: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [b"%s=%s" % (rng.bytes(int(rng.integers(2, 9))).hex().encode(),
                        rng.bytes(int(rng.integers(0, 30))).hex().encode())
            for _ in range(n)]


# -- CList ---------------------------------------------------------------


def test_clist_basics_and_removal():
    def scenario(pkg):
        cl = pkg.clist.CList()
        els = [cl.push_back(i) for i in range(6)]
        trace = [list(cl), len(cl)]
        for i in (2, 0, 5, 2):
            trace.append(cl.remove(els[i]))
            trace.append((list(cl), len(cl), cl.front().value,
                          cl.back().value))
        trace.append([els[2].next().value, els[0].next().value,
                      els[5].next(), els[3].prev().value])
        return trace

    p, r = both(scenario)
    assert p == r


def test_clist_waitable_iteration():
    """A parked reader follows push_back, skips over a removed element
    from its frozen next pointer, and re-anchors at the front when its
    element is removed while it waits."""
    def scenario(pkg):
        async def go():
            cl = pkg.clist.CList()
            seen = []

            async def reader(stop):
                e = await cl.front_wait()
                while True:
                    seen.append(e.value)
                    if e.value == stop:
                        return
                    nxt = await e.next_wait()
                    e = nxt if nxt is not None else await cl.front_wait()

            t = asyncio.ensure_future(reader("e"))
            await asyncio.sleep(0)
            cl.push_back("a")
            await asyncio.sleep(0)
            eb = cl.push_back("b")
            cl.push_back("c")
            await asyncio.sleep(0)
            cl.remove(eb)
            await asyncio.sleep(0)
            ed = cl.push_back("d")
            await asyncio.sleep(0)
            cl.remove(ed)  # the reader is parked on d
            await asyncio.sleep(0)
            cl.push_back("e")
            await asyncio.wait_for(t, 2)
            return seen, list(cl)

        return run(go())

    p, r = both(scenario)
    assert p == r
    assert p[0][:3] == ["a", "b", "c"] and p[0][-1] == "e"


# -- CheckTx, reap, update ----------------------------------------------


def test_check_tx_admit_reap_cache_and_caps():
    def scenario(pkg):
        async def go():
            pool, app = make_pool(pkg, counter_app(pkg), size=30,
                                  cache_size=35, max_tx_bytes=64)
            ctxs = [i.to_bytes(8, "big") for i in range(32)]
            out = [await outcome(pkg, pool.check_tx(tx)) for tx in ctxs]
            out.append(await outcome(pkg, pool.check_tx(ctxs[3])))
            out.append(await outcome(pkg, pool.check_tx(b"x" * 65)))
            out.append((pool.size(), pool.tx_bytes(), app.checks))
            out.append(pool.reap_max_txs(-1))
            out.append(pool.reap_max_txs(5))
            out.append(pool.reap_max_bytes_max_gas(8 * 7 + 3, -1))
            out.append(pool.reap_max_bytes_max_gas(-1, 20))
            out.append(pool.reap_max_bytes_max_gas(80, 12))
            out.append(list(pool.cache._m))
            pool.close()
            return out

        return run(go())

    p, r = both(scenario)
    assert p == r
    assert [o[0] for o in p[30:34]] == ["MempoolFullError"] * 3 + [
        "TxTooLargeError"]
    assert p[34][0] == 30 and len(p[40]) == 30


def test_precheck_postcheck_and_resubmit():
    def scenario(pkg):
        async def go():
            pool, _ = make_pool(pkg)
            out = []
            pool.precheck = pkg.mempool.TxPreCheck(max_tx_bytes=8)
            out.append(await outcome(pkg, pool.check_tx(b"x" * 9)))
            pool.precheck = None
            pool.postcheck = pkg.mempool.TxPostCheck(max_gas=0)
            out.append(await outcome(pkg, pool.check_tx(b"k=1")))
            out.append(pool.size())
            pool.postcheck = None
            out.append(await outcome(pkg, pool.check_tx(b"k=1")))
            out.append(pkg.mempool.TxPreCheck(4)(b"12345"))
            out.append(pkg.mempool.TxPostCheck(-1)(
                b"", pkg.t.ResponseCheckTx(gas_wanted=10**9)))
            out.append(pool.reap_max_txs(-1))
            pool.close()
            return out

        return run(go())

    p, r = both(scenario)
    assert p == r
    assert p[0] == ("ValueError", "precheck: tx too large (9 > 8)")


def test_update_recheck_and_replay_guard():
    def scenario(pkg):
        async def go():
            app = counter_app(pkg)
            pool, _ = make_pool(pkg, app)
            c = [i.to_bytes(8, "big") for i in range(12)]
            out = [await outcome(pkg, pool.check_tx(tx)) for tx in c]
            ok = pkg.t.ResponseDeliverTx(code=pkg.t.CODE_TYPE_OK)
            bad = pkg.t.ResponseDeliverTx(code=5)
            pool.lock()
            app.committed = 3
            await pool.update(2, c[:3] + [c[7]], [ok, ok, bad, ok])
            pool.unlock()
            out.append(pool.reap_max_txs(-1))
            out.append(await outcome(pkg, pool.check_tx(c[0])))  # replay
            out.append(await outcome(pkg, pool.check_tx(c[2])))  # failed
            app.committed = 9
            checks = app.checks
            await pool.update(3, [], [])
            out.append((pool.reap_max_txs(-1), app.checks - checks))
            # recheck off: the floor moves, nothing leaves
            pool.config.recheck = False
            app.committed = 11
            await pool.update(4, [], [])
            out.append(pool.reap_max_txs(-1))
            out.append(pool.txs_available().is_set())
            await pool.update(5, list(pool.reap_max_txs(-1)),
                              [ok] * pool.size())
            out.append((pool.size(), pool.txs_available().is_set()))
            pool.close()
            return out

        return run(go())

    recheck0 = pcm.METRICS["recheck_times"]
    p, r = both(scenario)
    assert p == r
    assert p[13][0] == "TxInMempoolError"
    assert pcm.METRICS["recheck_times"] - recheck0 == 8 + 8


def test_commit_during_check_tx_drops_the_tx():
    """A tx that commits while its CheckTx is in flight is not added;
    an older commit never blackholes a resubmission."""
    def scenario(pkg):
        async def go():
            gate = asyncio.Event()
            pool, _ = make_pool(pkg)
            inner = pool.client.check_tx

            async def slow_check(req):
                await gate.wait()
                return await inner(req)

            pool.client.check_tx = slow_check
            t = asyncio.ensure_future(pool.check_tx(b"race=1"))
            await asyncio.sleep(0.01)
            ok = pkg.t.ResponseDeliverTx(code=pkg.t.CODE_TYPE_OK)
            await pool.update(2, [b"race=1"], [ok])
            gate.set()
            res = await outcome(pkg, t)
            return res, pool.size(), pool.reap_max_txs(-1)

        return run(go())

    p, r = both(scenario)
    assert p == r and p[1] == 0


def test_lock_blocks_check_tx_until_unlock():
    def scenario(pkg):
        async def go():
            pool, _ = make_pool(pkg)
            pool.lock()
            t = asyncio.ensure_future(pool.check_tx(b"l=1"))
            await asyncio.sleep(0.02)
            held = (t.done(), pool.size())
            pool.unlock()
            await asyncio.wait_for(t, 2)
            return held, pool.size()

        return run(go())

    p, r = both(scenario)
    assert p == r == ((False, 0), 1)


def test_busy_and_full_sheds_are_equal():
    """checktx_max_inflight sheds with MempoolBusyError; a full pool
    with MempoolFullError; both charge mempool.pool."""
    def scenario(pkg):
        async def go():
            gate = asyncio.Event()
            pool, app = make_pool(pkg, checktx_max_inflight=2, size=3)
            inner = pool.client.deliver

            async def gated(req):
                await gate.wait()
                return await inner(req)

            pool.client.deliver = gated
            first = [asyncio.ensure_future(pool.check_tx(b"b%d=1" % i))
                     for i in range(2)]
            await asyncio.sleep(0)
            pool.client._in_flight = 2  # both parked on the gate
            busy = await outcome(pkg, pool.check_tx(b"b9=1"))
            pool.client._in_flight = 0
            gate.set()
            await asyncio.gather(*first)
            await pool.check_tx(b"c=1")
            full = await outcome(pkg, pool.check_tx(b"d=1"))
            err = pool.admission_error(1)
            ev = pkg.overload.CONTROLLER.evaluate()
            pool.close()
            return (busy, full, type(err).__name__, ev["level"],
                    ev["queues"]["mempool.pool"])

        return run(go())

    shed0 = poverload.CONTROLLER.sheds.get("mempool.pool", 0)
    p, r = both(scenario)
    assert poverload.CONTROLLER.sheds["mempool.pool"] - shed0 == 2
    assert p == r
    assert p[0][0] == "MempoolBusyError" and p[1][0] == "MempoolFullError"


def test_wal_refill(tmp_path):
    txs = txs_of(5, 6)

    def scenario(pkg, name):
        async def go():
            wal = str(tmp_path / name / "mwal")
            pool, _ = make_pool(pkg, wal_dir=wal)
            for tx in txs:
                await pool.check_tx(tx)
            ok = pkg.t.ResponseDeliverTx(code=pkg.t.CODE_TYPE_OK)
            await pool.update(2, txs[:2], [ok, ok])  # compacts the WAL
            await pool.check_tx(b"late=1")
            pool.close()
            raw = open(wal + "/mempool.wal", "rb").read()
            # a torn tail is ignored
            with open(wal + "/mempool.wal", "ab") as f:
                f.write(b"\x00\x00\x01\x00torn")
            pool2, app2 = make_pool(pkg, wal_dir=wal)
            pending = pool2.wal_pending_txs()
            report = await pool2.refill_from_wal()
            out = (raw, pending, report, pool2.reap_max_txs(-1),
                   pool2.wal_pending_txs(), app2.size)
            pool2.close()
            return out

        return run(go())

    p = scenario(PACKAGES["port"], "p")
    r = scenario(PACKAGES["reference"], "r")
    assert p == r
    assert p[2] == {"pending": 5, "readmitted": 5, "rejected": 0}


def test_flush_and_nop_mempool():
    def scenario(pkg):
        async def go():
            pool, _ = make_pool(pkg)
            for tx in txs_of(9, 4):
                await pool.check_tx(tx)
            await pool.flush()
            out = [pool.size(), pool.tx_bytes(), len(pool.cache._m),
                   pool.txs_available().is_set()]
            out.append(await outcome(pkg, pool.check_tx(txs_of(9, 1)[0])))
            nop = pkg.mempool.NopMempool()
            out.append(await outcome(pkg, nop.check_tx(b"x")))
            out += [nop.reap_max_txs(3), nop.reap_max_bytes_max_gas(1, 1),
                    nop.size(), nop.tx_bytes()]
            await nop.update(1, [], [])
            pool.close()
            return out

        return run(go())

    p, r = both(scenario)
    assert p == r


@pytest.mark.parametrize("kw", [
    {}, {"admission": "strict"}, {"admission": "banana"},
    {"admission_batch": 0}, {"admission_queue": 0},
    {"admission_flush_ms": -1}, {"size": -1}, {"checktx_max_inflight": -1}])
def test_config_validation(kw):
    def check(pkg):
        try:
            pkg.config.MempoolConfig(**kw).validate_basic()
            return None
        except ValueError as e:
            return str(e)

    p, r = both(check)
    assert p == r


def test_config_fields_are_equal():
    import dataclasses

    assert [(f.name, f.default) for f in dataclasses.fields(
        pconfig.MempoolConfig)] == [(f.name, f.default) for f in
                                    dataclasses.fields(jconfig.MempoolConfig)]
