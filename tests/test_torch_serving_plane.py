"""Port parity for the light serving plane (light/serving.py
ServingPlane, active_plane, SHED_REASONS), against the JAX package, in
the shapes of tests/test_light_serving.py (all but the proxy, pool,
end-to-end and lint cases, which wait for the port's RPC layer).

Each case runs the same requests through both packages' planes over
clients on the same chains with a fixed clock. The results, the
trusted heights, the coalescing, cache and shed tallies, the primary's
fetches and the launches must be equal, or, where the event loop's
timing sets them (a flood under a stalled verify), hold the same
properties in both. The collectors run on the host (device_threshold
1e9, as the reference's tests do) but where a case drives the device
route: there the port launches K4's plain version and the reference's
kernel is faked. Also pinned: a plane built with its own
OverloadController registers its backlog there, not in the global one.
Tolerance: exact."""

import asyncio
import types

import numpy as np
import pytest
from test_torch_light_client import PACKAGES as CLIENT_PACKAGES
from test_torch_light_client import client, light_chain, provider
from test_torch_state_store import CHAIN

from tendermint_tpu.config import LightConfig as JLightConfig
from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.crypto.tpu import verify as jtpu_verify
from tendermint_tpu.libs import failpoints as jfailpoints
from tendermint_tpu.libs import overload as joverload
from tendermint_tpu.libs.metrics import light_metrics
from tendermint_tpu.light import errors as jerrors
from tendermint_tpu.light import serving as jserving
from tendermint_tpu_torch.config import LightConfig as PLightConfig
from tendermint_tpu_torch.crypto import batch as pbatch
from tendermint_tpu_torch.crypto.cuda import verify as pverify
from tendermint_tpu_torch.device import set_default_device
from tendermint_tpu_torch.libs import failpoints as pfailpoints
from tendermint_tpu_torch.libs import overload as poverload
from tendermint_tpu_torch.light import errors as perrors
from tendermint_tpu_torch.light import serving as pserving

BACKENDS = ("device", "host", "host_recheck")
HOUR = 3600 * 1_000_000_000
NOW = 1_700_000_000 * 1_000_000_000 + 100 * 1_000_000_000


def _port_launches(backend=None):
    met = pserving.light_metrics()
    return int(sum(met.verify_launches.value(backend=b)
                   for b in ((backend,) if backend else BACKENDS)))


def _ref_launches(backend=None):
    met = light_metrics()
    return sum(met.verify_launches.value(backend=b)
               for b in ((backend,) if backend else BACKENDS))


def _port_lanes():
    s = pserving.light_metrics().batch_lanes._series.get(())
    return s.sum if s else 0.0


def _ref_lanes():
    s = light_metrics().batch_lanes._series.get(())
    return s.sum if s else 0.0


PACKAGES = {
    "port": types.SimpleNamespace(
        serving=pserving, errors=perrors, LightConfig=PLightConfig,
        failpoints=pfailpoints,
        batch=pbatch, overload=poverload, launches=_port_launches,
        lanes=_port_lanes, disarm=pfailpoints.disarm_all),
    "reference": types.SimpleNamespace(
        serving=jserving, errors=jerrors, LightConfig=JLightConfig,
        failpoints=jfailpoints,
        batch=jbatch, overload=joverload, launches=_ref_launches,
        lanes=_ref_lanes, disarm=jfailpoints.reset),
}
for _name, _p in PACKAGES.items():
    _p.__dict__.update(vars(CLIENT_PACKAGES[_name]))
PORT, REF = PACKAGES["port"], PACKAGES["reference"]


@pytest.fixture(autouse=True)
def _cpu():
    set_default_device("cpu")
    for p in PACKAGES.values():
        p.batch.reset_breakers()
    yield
    for p in PACKAGES.values():
        p.disarm()
        p.batch.reset_breakers()
    set_default_device(None)


def run(coro):
    return asyncio.run(coro)


def err(e):
    return (type(e).__name__, str(e))


def plane(p, blocks, cfg=None, device_threshold=10**9, **client_kw):
    pl = p.serving.ServingPlane(client(p, blocks, **client_kw),
                                cfg or p.LightConfig(flush_ms=5.0))
    pl.collector.device_threshold = device_threshold
    return pl


def tallies(pl):
    return (pl.requests, pl.coalesced, pl.cache_hits, pl.cache_misses,
            dict(pl.sheds))


def both(fn):
    got = {name: run(fn(p)) for name, p in PACKAGES.items()}
    assert got["port"] == got["reference"]
    return got["port"]


def test_singleflight_coalesces_same_height():
    async def case(p):
        blocks = light_chain(p, 8)
        fetches = []
        pl = plane(p, blocks, primary=provider(p, blocks, fetches=fetches))
        await pl.client.initialize()
        fetches.clear()
        before = p.launches()
        res = await asyncio.gather(*(pl.get_verified(8) for _ in range(16)))
        out = ([lb.hash() == blocks[8].hash() for lb in res], fetches,
               p.launches() - before, tallies(pl))
        pl.close()
        return out

    got = both(case)
    assert got[1:] == ([8], 1, (16, 15, 0, 16, {"queue_full": 0}))


def test_64_requests_coalesce_and_the_second_wave_hits_the_cache():
    heights = list(range(9, 17))

    async def case(p):
        blocks = light_chain(p, 16)
        pl = plane(p, blocks)
        before, lanes0 = p.launches(), p.lanes()
        res = await asyncio.gather(*(pl.get_verified(heights[i % 8])
                                     for i in range(64)))
        launches = p.launches() - before
        ok = all(lb.hash() == blocks[heights[i % 8]].hash()
                 for i, lb in enumerate(res))
        wave1 = tallies(pl)
        res2 = await asyncio.gather(*(pl.get_verified(h) for h in heights))
        out = (ok, launches <= len(heights),
               (p.lanes() - lanes0) / launches > 1, wave1,
               [lb.height() for lb in res2], tallies(pl),
               p.launches() - before == launches,
               sorted(pl.client.store.heights()))
        pl.close()
        return out

    got = both(case)
    assert got[:3] == (True, True, True)
    assert got[3] == (64, 56, 0, 64, {"queue_full": 0})
    assert got[5][:3] == (72, 56, 8) and got[6]


def test_bisection_through_the_plane_lands_where_the_client_does():
    sets = lambda h: range(h, h + 4)  # noqa: E731

    async def case(p):
        blocks = light_chain(p, 16, sets)
        cl = client(p, blocks)
        serial = await cl.verify_light_block_at_height(16)
        pl = plane(p, blocks)
        before = p.launches()
        lb = await pl.get_verified(16)
        heights = pl.client.store.heights()
        out = (lb.hash() == serial.hash(), heights == cl.store.heights(),
               heights, p.launches() - before < 2 * (len(heights) - 1),
               dict(pl.client.store.db.iterate()) ==
               dict(cl.store.db.iterate()))
        pl.close()
        return out

    got = both(case)
    assert got[0] and got[1] and got[3] and got[4] and len(got[2]) > 2


def test_backwards_and_latest_through_the_plane():
    async def case(p):
        blocks = light_chain(p, 12)
        pl = plane(p, blocks)
        lb = await pl.get_verified(0)
        lb3 = await pl.get_verified(3)
        before = p.launches()
        lb0 = await pl.get_verified(0)
        out = (lb.height(), lb3.hash() == blocks[3].hash(), lb0.height(),
               p.launches() - before, tallies(pl),
               pl.client.store.heights())
        pl.close()
        return out

    assert both(case)[:4] == (12, True, 12, 0)


def test_a_store_resident_height_serves_on_a_saturated_plane():
    async def case(p):
        blocks = light_chain(p, 16)
        pl = plane(p, blocks, cfg=p.LightConfig(flush_ms=1.0, pending_max=4))
        await pl.get_verified(10)
        pl.cache.clear()
        p.failpoints.arm("light.verify", "delay", delay_ms=400)
        try:
            flood = [asyncio.ensure_future(pl.get_verified(h))
                     for h in range(12, 17)]
            for _ in range(400):
                if pl.collector.saturated():
                    break
                await asyncio.sleep(0.005)
            saturated = pl.collector.saturated()
            lb10 = await pl.get_verified(10)
            try:
                await pl.get_verified(5)
                shed = None
            except Exception as e:  # noqa: BLE001 - compared
                shed = err(e)
            await asyncio.gather(*flood, return_exceptions=True)
        finally:
            p.disarm()
        pl.close()
        return saturated, lb10.hash() == blocks[10].hash(), shed

    got = both(case)
    assert got[:2] == (True, True)
    assert got[2][0] == "LightServingShedError"


def test_a_lower_height_is_not_refused_by_an_advancing_head():
    async def case(p):
        blocks = light_chain(p, 10)
        base = provider(p, blocks)
        gate = asyncio.Event()

        class Slow5(p.provider.Provider):
            async def light_block(self, height):
                if height == 5:
                    await gate.wait()
                return await base.light_block(height)

        pl = plane(p, blocks, primary=Slow5())
        await pl.client.initialize()
        t5 = asyncio.ensure_future(pl.get_verified(5))
        await asyncio.sleep(0.01)
        lb10 = await pl.get_verified(10)
        head = pl.client.store.latest_height()
        gate.set()
        lb5 = await t5
        pl.close()
        return lb10.height(), head, lb5.hash() == blocks[5].hash()

    assert both(case) == (10, 10, True)


def test_an_expired_store_entry_is_never_served_as_trusted():
    async def case(p):
        blocks = light_chain(p, 8)
        pl = plane(p, blocks)
        await pl.get_verified(8)
        await pl.get_verified(5)
        t5 = blocks[5].time()
        pl.client.now_fn = lambda: t5 + HOUR + 1
        pl.cache.clear()
        before = p.launches()
        lb5 = await pl.get_verified(5)
        out = [lb5.hash() == blocks[5].hash(), p.launches() - before]
        pl.client.now_fn = lambda: blocks[8].time() + HOUR
        pl.cache.clear()
        try:
            await pl.get_verified(8)
        except Exception as e:  # noqa: BLE001 - compared
            out.append(err(e))
        pl.close()
        return out

    got = both(case)
    assert got[:2] == [True, 0]
    assert got[2] == ("OutsideTrustingPeriodError",
                      "stored header 8 outside trusting period")


def test_a_forged_target_is_rejected_by_the_plane():
    async def case(p):
        blocks = light_chain(p, 8)
        pl = plane(p, blocks, primary=provider(p, blocks, tamper_height=8))
        try:
            await pl.get_verified(8)
            out = None
        except Exception as e:  # noqa: BLE001 - compared
            out = err(e)
        res = (out, pl.client.store.get(8), pl.cache.get(8, NOW))
        pl.close()
        return res

    got = both(case)
    assert got[0] == ("ValueError", "commit is for a different block")
    assert got[1:] == (None, None)


def test_a_flood_dies_at_the_plane():
    """With light.verify stalled, a distinct-height flood sheds the
    newest requests, the backlog never passes its bound, status_check
    reads degraded while saturated, and a fresh request verifies once
    the stall clears — in both packages (how many shed is the event
    loop's timing)."""
    async def case(p):
        blocks = light_chain(p, 10)
        pl = plane(p, blocks, cfg=p.LightConfig(flush_ms=1.0, pending_max=2))
        await pl.client.initialize()
        p.failpoints.arm("light.verify", "delay", delay_ms=600)
        try:
            tasks = [asyncio.ensure_future(pl.get_verified(h))
                     for h in range(5, 11)]
            max_depth, degraded = 0, False
            while not all(t.done() for t in tasks):
                depth = pl.collector.depth()
                max_depth = max(max_depth, depth)
                if depth >= pl.collector.pending_max:
                    degraded |= pl.status_check()["status"] == "degraded"
                await asyncio.sleep(0.01)
            res = await asyncio.gather(*tasks, return_exceptions=True)
        finally:
            p.disarm()
        shed = [r for r in res if type(r).__name__ == "LightServingShedError"]
        served = [r for r in res if not isinstance(r, BaseException)]
        lb = await pl.get_verified(7)
        out = (bool(shed), bool(served), max_depth <= 2, degraded,
               pl.sheds["queue_full"] == len(shed),
               lb.hash() == blocks[7].hash(), str(shed[0]) if shed else "")
        pl.close()
        return out

    got = both(case)
    assert got[:6] == (True,) * 6
    assert got[6] == ("light serving plane overloaded: 2 commit checks "
                      "pending (limit 2); retry later")


def test_the_failpoint_degrades_the_plane_to_the_host():
    async def case(p):
        blocks = light_chain(p, 6)
        pl = plane(p, blocks)
        host0 = p.launches("host")
        p.failpoints.arm("light.verify", "error")
        try:
            lb = await pl.get_verified(6)
        finally:
            p.disarm()
        pl.close()
        return lb.hash() == blocks[6].hash(), p.launches("host") > host0

    assert both(case) == (True, True)


def _fake_kernel(p, monkeypatch, fn):
    target = pverify if p is PORT else jtpu_verify
    monkeypatch.setattr(target, "verify_batch", fn)


def test_a_false_sentinel_rechecks_on_the_host(monkeypatch):
    async def case(p):
        _fake_kernel(p, monkeypatch, lambda pubs, msgs, sigs: np.zeros(
            len(pubs), bool))
        blocks = light_chain(p, 6)
        pl = plane(p, blocks, device_threshold=1)
        recheck0 = p.launches("host_recheck")
        lb = await pl.get_verified(6)
        pl.close()
        return (lb.hash() == blocks[6].hash(),
                p.launches("host_recheck") > recheck0,
                p.batch.device_available("ed25519"))

    assert both(case) == (True, True, False)


def test_device_verdicts_stand_when_the_sentinel_verifies(monkeypatch):
    """The port's device route launches K4's plain version here; the
    reference's kernel is faked by its host oracle. A forged commit
    dies on the device verdict with no host recheck."""
    from tendermint_tpu.crypto.ed25519 import Ed25519PubKey

    monkeypatch.setattr(jtpu_verify, "verify_batch", lambda pubs, msgs, sigs:
                        np.array([Ed25519PubKey(pk).verify_signature(m, s)
                                  for pk, m, s in zip(pubs, msgs, sigs)],
                                 bool))

    async def case(p):
        blocks = light_chain(p, 6)
        lb = blocks[5]
        sh = lb.signed_header
        bad = p.block.Commit(sh.commit.height, sh.commit.round,
                             sh.commit.block_id,
                             [p.block.CommitSig(cs.block_id_flag,
                                                cs.validator_address,
                                                cs.timestamp, bytes(64))
                              for cs in sh.commit.signatures])
        coll = p.serving.LightVerifyCollector(batch_max=10**6, flush_ms=10.0,
                                              pending_max=64,
                                              device_threshold=1)
        dev0, re0 = p.launches("device"), p.launches("host_recheck")
        plan = lb.validator_set.plan_commit_light(CHAIN, bad.block_id, 5, bad)
        try:
            await coll.check(plan)
            out = None
        except Exception as e:  # noqa: BLE001 - compared
            out = err(e)
        coll.close()
        return (out, p.launches("device") - dev0,
                p.launches("host_recheck") - re0,
                p.batch.device_available("ed25519"))

    got = both(case)
    assert got == (("VerificationError",
                    "invalid signature(s) at index(es) [0, 1, 2]"), 1, 0,
                   True)


def test_an_open_breaker_routes_the_plane_to_the_host(monkeypatch):
    def must_not_launch(*a, **kw):
        raise AssertionError("device launched through an open breaker")

    async def case(p):
        _fake_kernel(p, monkeypatch, must_not_launch)
        p.batch.breaker("ed25519").record_failure()
        blocks = light_chain(p, 4)
        pl = plane(p, blocks, device_threshold=1)
        lb = await pl.get_verified(4)
        pl.close()
        return lb.hash() == blocks[4].hash()

    assert both(case) is True


def test_a_proven_fork_clears_the_cache():
    async def case(p):
        blocks = light_chain(p, 8)
        pl = plane(p, blocks)
        await pl.get_verified(5)
        filled = len(pl.cache)

        async def proven_fork(verified, now_ns):
            raise p.errors.DivergenceError(0, blocks[8], blocks[8])

        pl.client._detect_divergence = proven_fork
        try:
            await pl.get_verified(8)
            out = None
        except Exception as e:  # noqa: BLE001 - compared
            out = type(e).__name__
        res = (filled > 0, out, len(pl.cache))
        pl.close()
        return res

    assert both(case) == (True, "DivergenceError", 0)


def test_status_check_and_the_active_plane():
    async def case(p):
        blocks = light_chain(p, 8)
        assert p.serving.active_plane() is None
        pl = plane(p, blocks)
        active = p.serving.active_plane() is pl
        await pl.get_verified(8)
        await pl.get_verified(8)
        status = pl.status_check()
        status.pop("verify_launches")  # process totals of each package
        pl.close()
        return (active, status, p.serving.active_plane(),
                p.serving.SHED_REASONS, p.serving.SHED_QUEUE_FULL)

    got = both(case)
    assert got[0] and got[2] is None
    assert got[1]["status"] == "ok" and got[1]["trusted_height"] == 8
    assert got[1]["requests"] == 2 and got[1]["cache"]["hits"] == 1
    assert got[3] == ("queue_full",)


def test_status_check_names_an_open_breaker():
    async def case(p):
        blocks = light_chain(p, 4)
        pl = plane(p, blocks)
        p.batch.breaker("ed25519").record_failure()
        out = pl.status_check()
        pl.close()
        return out["status"], out.get("detail")

    assert both(case) == ("ok", "ed25519 breaker open: light plane "
                          "verifying on host")


def test_a_plane_registers_its_backlog_with_its_own_controller():
    """The collector takes `controller=` (the reference's
    light/serving.py:157-177) and the plane passes its own through: its
    light.pending_verify entry and its sheds land there, not in the
    process-global CONTROLLER."""
    async def case(p):
        blocks = light_chain(p, 10)
        own = p.overload.OverloadController()
        pl = p.serving.ServingPlane(client(p, blocks),
                                    p.LightConfig(flush_ms=1.0,
                                                  pending_max=2),
                                    controller=own)
        pl.collector.device_threshold = 10**9
        queues_own = sorted(own.evaluate()["queues"])
        in_global = "light.pending_verify" in \
            p.overload.CONTROLLER.evaluate()["queues"]
        global_sheds = dict(getattr(p.overload.CONTROLLER, "sheds", {}))
        await pl.client.initialize()
        p.failpoints.arm("light.verify", "delay", delay_ms=300)
        try:
            res = await asyncio.gather(*(pl.get_verified(h)
                                         for h in range(5, 11)),
                                       return_exceptions=True)
        finally:
            p.disarm()
        shed = sum(type(r).__name__ == "LightServingShedError" for r in res)
        # the reference counts sheds in its metrics, the port on the
        # controller (libs/overload.py)
        counted = (own.sheds.get("light.pending_verify") == shed
                   and p.overload.CONTROLLER.sheds == global_sheds
                   if p is PORT else True)
        out = (queues_own, in_global, shed > 0, counted)
        pl.close()
        return out + (sorted(own.evaluate()["queues"]),)

    got = both(case)
    assert got == (["light.pending_verify"], False, True, True, [])
    coll = pserving.LightVerifyCollector(pending_max=3)
    try:
        assert poverload.CONTROLLER.evaluate()["queues"][
            "light.pending_verify"]["capacity"] == 3
    finally:
        coll.close()
