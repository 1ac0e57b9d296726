"""Port parity for the mempool admission plane (types/tx_envelope.py,
mempool/admission.py and its wiring in mempool/clist_mempool.py),
against the JAX package, in the shapes of tests/test_admission.py.

The envelope codec is held byte for byte (encode, sign_tx, parse, and a
hypothesis fuzz of the bytes after MAGIC: the same envelope or the same
MalformedEnvelopeError text). A mixed flood (garbage, valid and raw,
the reference e2e mix) goes through both packages' pools: every
response's bytes, the app's CheckTx calls, the pool and the shed
tallies must be equal. The reference's collector runs on its host path
(device_threshold 1e9: no reference kernel compiles); the port's takes
its device route with verify_batch replaced by a counting host oracle,
except in one case, which launches K4's plain version once at the
128-lane bucket (with the sentinel lane) and holds its verdicts to the
host oracle's. The collector's edge cases (size and deadline flushes,
shed-newest, the breaker, the sentinel, the failpoint) run in both
packages with the same outcomes. Pinned divergence (ROADMAP Queue C):
the port's KernelError from the launch reaches check_tx, where the
reference degrades to the host. Tolerance: exact."""

import asyncio
import threading
import time
import types

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from tendermint_tpu import config as jconfig
from tendermint_tpu.abci import client as jclient
from tendermint_tpu.abci import kvstore as jkv
from tendermint_tpu.abci import types as jt
from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.crypto import ed25519 as jed
from tendermint_tpu.libs import failpoints as jfailpoints
from tendermint_tpu.libs import overload as joverload
from tendermint_tpu.mempool import admission as jadm
from tendermint_tpu.mempool import clist_mempool as jcm
from tendermint_tpu.types import tx_envelope as jenv
from tendermint_tpu_torch import config as pconfig
from tendermint_tpu_torch.abci import client as pclient
from tendermint_tpu_torch.abci import kvstore as pkv
from tendermint_tpu_torch.abci import types as pt
from tendermint_tpu_torch.crypto import batch as pbatch
from tendermint_tpu_torch.crypto import ed25519 as ped
from tendermint_tpu_torch.crypto.cuda import kernels as pkernels
from tendermint_tpu_torch.crypto.cuda import verify as pverify
from tendermint_tpu_torch.device import set_default_device
from tendermint_tpu_torch.libs import failpoints as pfailpoints
from tendermint_tpu_torch.libs import overload as poverload
from tendermint_tpu_torch.mempool import admission as padm
from tendermint_tpu_torch.mempool import clist_mempool as pcm
from tendermint_tpu_torch.types import tx_envelope as penv

PACKAGES = {
    "port": types.SimpleNamespace(
        t=pt, kv=pkv, client=pclient, config=pconfig, cm=pcm, adm=padm,
        env=penv, ed=ped, batch=pbatch, failpoints=pfailpoints,
        overload=poverload, disarm=pfailpoints.disarm_all),
    "reference": types.SimpleNamespace(
        t=jt, kv=jkv, client=jclient, config=jconfig, cm=jcm, adm=jadm,
        env=jenv, ed=jed, batch=jbatch, failpoints=jfailpoints,
        overload=joverload, disarm=jfailpoints.reset),
}
SECRET = b"admission-parity-signer"


@pytest.fixture(autouse=True)
def _cpu_and_clean_state():
    set_default_device("cpu")
    yield
    set_default_device(None)
    for pkg in PACKAGES.values():
        pkg.batch.reset_breakers()
        pkg.disarm()

def _by_label(counter, label: str) -> dict:
    """A port counter family's values keyed by one label."""
    return {dict(k)[label]: int(v) for k, v in counter._values.items()}


def run(coro):
    return asyncio.run(coro)


def signer(pkg, i: int = 0):
    return pkg.ed.Ed25519PrivKey.from_secret(SECRET + b"%d" % i)


def mix_tx(pkg, i: int, payload: bytes, signers) -> bytes:
    """The reference e2e envelope mix (e2e/runner.py envelope_mix_tx,
    garbage 30%, signed 10%): garbage when i % 100 < 30, a valid
    envelope when < 40, raw otherwise."""
    slot, key = i % 100, signers[i % len(signers)]
    if slot < 30:
        return pkg.env.encode(key.pub_key().bytes(), bytes(64), payload)
    if slot < 40:
        return pkg.env.sign_tx(key, payload)
    return payload


def payloads(seed: int, n: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [b"k%d-%s=%s" % (i, rng.bytes(4).hex().encode(),
                            rng.bytes(int(rng.integers(40, 90))).hex()
                            .encode()) for i in range(n)]


def counting_app(pkg):
    """A KVStoreApp of `pkg` that records its CheckTx deliveries."""
    class App(pkg.kv.KVStoreApp):
        def __init__(self):
            super().__init__()
            self.checked = []

        def check_tx(self, req):
            self.checked.append(req.tx)
            return super().check_tx(req)

    return App()


def make_pool(pkg, **cfg):
    cfg.setdefault("admission", "permissive")
    cfg.setdefault("admission_batch", 16)
    cfg.setdefault("admission_flush_ms", 10.0)
    app = counting_app(pkg)
    pool = pkg.cm.CListMempool(pkg.config.MempoolConfig(**cfg),
                               pkg.client.LocalClient(app))
    return pool, app


def host_oracle(calls):
    """A verify_batch stand-in: the host oracle's verdicts, each call's
    lane count recorded."""
    def fake(pubs, msgs, sigs, device=None):
        calls.append(len(pubs))
        return np.array([ped.Ed25519PubKey(p).verify_signature(m, s)
                         for p, m, s in zip(pubs, msgs, sigs)], bool)

    return fake


def ref_host_path(pkg, pool):
    """The reference collector on its host path: no kernel compiles."""
    if pkg is PACKAGES["reference"] and pool.admission is not None:
        pool.admission.collector.device_threshold = 10**9


async def outcome(pkg, coro):
    try:
        return pkg.t.encode_msg(await coro)
    except Exception as e:
        return (type(e).__name__, str(e))


# -- the envelope codec --------------------------------------------------


def test_envelope_codec_byte_for_byte():
    assert penv.MAGIC == jenv.MAGIC and penv.SIGN_DOMAIN == jenv.SIGN_DOMAIN
    for i, payload in enumerate(payloads(1, 12) + [b"", b"\x00" * 300]):
        p_key, j_key = signer(PACKAGES["port"], i), signer(
            PACKAGES["reference"], i)
        assert p_key.pub_key().bytes() == j_key.pub_key().bytes()
        ps, js = penv.sign_tx(p_key, payload), jenv.sign_tx(j_key, payload)
        assert ps == js
        assert penv.encode(b"\x07" * 32, b"\x09" * 64, payload) == \
            jenv.encode(b"\x07" * 32, b"\x09" * 64, payload)
        assert penv.sign_bytes(payload) == jenv.sign_bytes(payload)
        pe, je = penv.parse(ps), jenv.parse(js)
        assert (pe.pub_key, pe.signature, pe.payload) == \
            (je.pub_key, je.signature, je.payload)
        assert penv.is_enveloped(ps) and penv.parse(payload) is None \
            or payload.startswith(penv.MAGIC)
    for bad in ((b"short", bytes(64), b"p"), (bytes(32), bytes(63), b"p")):
        with pytest.raises(ValueError) as pe:
            penv.encode(*bad)
        with pytest.raises(ValueError) as je:
            jenv.encode(*bad)
        assert str(pe.value) == str(je.value)


def _parsed(env_mod, data: bytes):
    try:
        e = env_mod.parse(data)
        return None if e is None else (e.pub_key, e.signature, e.payload)
    except env_mod.MalformedEnvelopeError as e:
        return ("MalformedEnvelopeError", str(e))


@settings(max_examples=400, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.one_of(
    st.binary(max_size=200),
    st.builds(lambda pre, tail: pre + tail,
              st.sampled_from([bytes([0x0a, 0x20]) + bytes(32),
                               bytes([0x12, 0x40]) + bytes(64),
                               bytes([0x1a, 0x03]) + b"abc",
                               bytes([0x0a, 0x20]) + bytes(32)
                               + bytes([0x12, 0x40]) + bytes(64)]),
              st.binary(max_size=120))))
def test_envelope_parse_fuzz_after_magic(tail):
    data = penv.MAGIC + tail
    assert _parsed(penv, data) == _parsed(jenv, data)


# -- the plane on a mixed flood ------------------------------------------


def flood_outcomes(pkg, txs, **cfg):
    async def go():
        pool, app = make_pool(pkg, **cfg)
        ref_host_path(pkg, pool)
        res = await asyncio.gather(*(outcome(pkg, pool.check_tx(tx))
                                     for tx in txs))
        out = (res, sorted(app.checked), pool.size(),
               dict(pool.admission.sheds),
               (pool.admission.admitted_signed,
                pool.admission.admitted_unsigned),
               pool.admission.collector.depth())
        pool.close()
        return out

    return run(go())


def test_mixed_flood_outcomes_equal(monkeypatch):
    """The reference e2e mix over 8 signers, 300 txs, batches of 64: the
    port's device route (counting host oracle) against the reference's
    host path. Equal outcomes; one launch per flush of >= 40 lanes."""
    calls = []
    monkeypatch.setattr(pverify, "verify_batch", host_oracle(calls))
    pay = payloads(2, 300)
    got = {}
    for name, pkg in PACKAGES.items():
        keys = [signer(pkg, i) for i in range(8)]
        txs = [mix_tx(pkg, i, p, keys) for i, p in enumerate(pay)]
        got[name] = flood_outcomes(pkg, txs, admission_batch=64,
                                   admission_flush_ms=20.0)
    assert got["port"] == got["reference"]
    res, checked, size, sheds, admitted, depth = got["port"]
    assert sheds["bad_signature"] == 90 and size == 210
    assert admitted == (30, 180) and depth == 0
    # 120 envelopes in flushes of <= 64: each flush of >= 40 lanes is one
    # launch with the sentinel lane (+1); none smaller launched
    launches = _by_label(padm.admission_metrics().launches, "backend")
    assert calls and all(n - 1 >= 40 for n in calls)
    assert sum(n - 1 for n in calls) <= 120 and launches.get("device")


def test_strict_mode_and_malformed_sheds_equal(monkeypatch):
    monkeypatch.setattr(pverify, "verify_batch", host_oracle([]))
    pay = payloads(3, 40)
    got = {}
    for name, pkg in PACKAGES.items():
        key = signer(pkg)
        txs = [pkg.env.sign_tx(key, p) for p in pay[:20]]
        txs += pay[20:30]  # unsigned
        txs += [pkg.env.MAGIC + p for p in pay[30:]]  # malformed
        got[name] = flood_outcomes(pkg, txs, admission="strict")
    assert got["port"] == got["reference"]
    assert got["port"][3] == {"bad_signature": 0, "malformed": 10,
                              "unsigned": 10, "queue_full": 0}


def test_real_k4_plain_launch_at_the_128_bucket():
    """One real launch: 60 envelopes (20 garbage) + the sentinel, 61
    lanes in the 128-lane bucket, through K4's plain version on the CPU;
    verdicts equal to the reference's host path, one device launch."""
    pay = payloads(4, 60)
    got = {}
    before = dict(_by_label(padm.admission_metrics().launches, "backend"))
    for name, pkg in PACKAGES.items():
        key = signer(pkg, 3)
        txs = [pkg.env.encode(key.pub_key().bytes(), bytes(64), p)
               if i % 3 == 0 else pkg.env.sign_tx(key, p)
               for i, p in enumerate(pay)]
        got[name] = flood_outcomes(pkg, txs, admission_batch=60,
                                   admission_flush_ms=5000.0)
    assert got["port"] == got["reference"]
    assert got["port"][3]["bad_signature"] == 20
    after = _by_label(padm.admission_metrics().launches, "backend")
    assert after.get("device", 0) - before.get("device", 0) == 1
    assert pverify.lane_bucket(61) == 128


# -- the collector's edge cases ------------------------------------------


def _env(pkg, i=0, garbage=False):
    key = signer(pkg)
    raw = (pkg.env.encode(key.pub_key().bytes(), bytes(64), b"edge-%d" % i)
           if garbage else pkg.env.sign_tx(key, b"edge-%d" % i))
    return pkg.env.parse(raw)


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_deadline_and_size_flushes(package):
    pkg = PACKAGES[package]

    async def go():
        c = pkg.adm.AdmissionCollector(batch_max=100, flush_ms=30.0,
                                       queue_max=64, device_threshold=10**9)
        t0 = time.monotonic()
        lone = await asyncio.wait_for(c.verify(_env(pkg)), 5.0)
        lone_s = time.monotonic() - t0
        c.close()
        c = pkg.adm.AdmissionCollector(batch_max=3, flush_ms=30_000.0,
                                       queue_max=64, device_threshold=10**9)
        t0 = time.monotonic()
        full = await asyncio.wait_for(asyncio.gather(
            *(c.verify(_env(pkg, i)) for i in range(3))), 10.0)
        full_s = time.monotonic() - t0
        c.close()
        return lone, lone_s, full, full_s

    lone, lone_s, full, full_s = run(go())
    assert lone is True and 0.025 <= lone_s < 4.0
    assert full == [True] * 3 and full_s < 8.0


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_shed_newest_on_full_queue(package):
    pkg = PACKAGES[package]

    async def go():
        ctrl = pkg.overload.OverloadController()
        c = pkg.adm.AdmissionCollector(batch_max=2, flush_ms=1.0,
                                       queue_max=4, controller=ctrl)
        gate = threading.Event()
        real = c._verify_batch

        def stalled(envs):
            gate.wait(timeout=10.0)
            return real(envs)

        c._verify_batch = stalled
        tasks = [asyncio.ensure_future(c.verify(_env(pkg, i)))
                 for i in range(2)]
        for _ in range(200):
            await asyncio.sleep(0.005)
            if c._in_flight == 2:
                break
        tasks += [asyncio.ensure_future(c.verify(_env(pkg, i)))
                  for i in range(2, 4)]
        await asyncio.sleep(0)
        depth = c.depth()
        with pytest.raises(pkg.adm.AdmissionQueueFullError) as e:
            await c.verify(_env(pkg, 4))
        gate.set()
        oks = await asyncio.wait_for(asyncio.gather(*tasks), 20.0)
        q = ctrl.evaluate()["queues"][pkg.adm.PREVERIFY_QUEUE]
        c.close()
        return depth, str(e.value), oks, q, ctrl.evaluate()["queues"]

    depth, msg, oks, q, after = run(go())
    assert depth == 4 and oks == [True] * 4
    assert msg == ("admission pre-verify queue full: 4 txs pending "
                   "(limit 4); retry later")
    assert q["capacity"] == 4 and after == {}


def _device_case(monkeypatch, package, fake, envs):
    """Run `envs` through a device-route collector of `package`, its
    launch replaced by `fake` (the reference's kernel never compiles)."""
    pkg = PACKAGES[package]
    if package == "port":
        monkeypatch.setattr(pverify, "verify_batch", fake)
    else:
        from tendermint_tpu.crypto.tpu import verify as jtv

        monkeypatch.setattr(jtv, "verify_batch", fake)

    async def go():
        c = pkg.adm.AdmissionCollector(batch_max=len(envs), flush_ms=30_000,
                                       queue_max=64, device_threshold=1)
        oks = await asyncio.wait_for(asyncio.gather(
            *(c.verify(e) for e in envs)), 20.0)
        c.close()
        return oks

    return run(go())


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_breaker_open_routes_to_host(monkeypatch, package):
    pkg = PACKAGES[package]

    def must_not_launch(*a, **kw):
        raise AssertionError("device launched through an open breaker")

    pkg.batch.breaker("ed25519").record_failure()
    fb0 = pbatch.counters()["host_fallbacks"]
    oks = _device_case(monkeypatch, package, must_not_launch,
                       [_env(pkg, 0), _env(pkg, 1, garbage=True)])
    assert oks == [True, False]
    if package == "port":
        assert pbatch.counters()["host_fallbacks"] == fb0 + 1


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_sentinel_false_rechecks_on_host(monkeypatch, package):
    pkg = PACKAGES[package]
    m0 = dict(pbatch.counters())
    r0 = dict(_by_label(padm.admission_metrics().launches, "backend"))
    oks = _device_case(
        monkeypatch, package,
        lambda pubs, msgs, sigs, device=None: np.zeros(len(pubs), bool),
        [_env(pkg, 0), _env(pkg, 1), _env(pkg, 2, garbage=True)])
    assert oks == [True, True, False]
    assert not pkg.batch.device_available("ed25519")
    if package == "port":
        r = _by_label(padm.admission_metrics().launches, "backend")
        assert r["host_recheck"] == r0.get("host_recheck", 0) + 1
        assert r["device"] == r0.get("device", 0) + 1
        assert pbatch.counters()["host_rechecks"] == m0["host_rechecks"] + 1
        assert pbatch.counters()["host_fallbacks"] == m0["host_fallbacks"] + 1


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_all_garbage_batch_trusted(monkeypatch, package):
    pkg = PACKAGES[package]

    def fake(pubs, msgs, sigs, device=None):
        out = np.zeros(len(pubs), bool)
        out[-1] = True  # the sentinel rides last and verifies
        return out

    m0 = dict(pbatch.counters())
    oks = _device_case(monkeypatch, package, fake,
                       [_env(pkg, i, garbage=True) for i in range(3)])
    assert oks == [False] * 3
    assert pkg.batch.device_available("ed25519")
    assert pbatch.counters() == m0


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_failpoint_error_degrades_and_delay_sheds(package):
    pkg = PACKAGES[package]

    async def error_case():
        pkg.failpoints.arm("mempool.admission.verify", "error")
        pool, app = make_pool(pkg, admission_flush_ms=5.0)
        a = await outcome(pkg, pool.check_tx(pkg.env.sign_tx(
            signer(pkg), b"e1")))
        b = await outcome(pkg, pool.check_tx(pkg.env.encode(
            signer(pkg).pub_key().bytes(), bytes(64), b"e2")))
        pool.close()
        pkg.disarm()
        return a, b, len(app.checked)

    async def delay_case():
        pkg.failpoints.arm("mempool.admission.verify", "delay",
                           delay_ms=300.0)
        pool, _ = make_pool(pkg, admission_batch=2, admission_flush_ms=1.0,
                            admission_queue=3)
        txs = [pkg.env.sign_tx(signer(pkg), b"d-%d" % i) for i in range(8)]
        res = await asyncio.wait_for(asyncio.gather(
            *(pool.check_tx(t) for t in txs), return_exceptions=True), 30.0)
        shed = [r for r in res
                if isinstance(r, pkg.adm.AdmissionQueueFullError)]
        okd = [r for r in res if getattr(r, "code", -1) == 0]
        n_shed = pool.admission.sheds["queue_full"]
        pool.close()
        pkg.disarm()
        return len(shed), len(okd), n_shed

    a, b, checked = run(error_case())
    assert pkg.t.decode_msg(a).code == 0
    assert b"admission: bad_signature" in b and checked == 1
    n_shed, n_ok, tallied = run(delay_case())
    assert n_shed and n_ok and n_shed == tallied


def test_failpoint_outcomes_equal():
    def scenario(pkg):
        async def go():
            pkg.failpoints.arm("mempool.admission.verify", "error")
            pool, app = make_pool(pkg, admission_flush_ms=5.0)
            key = signer(pkg)
            txs = [pkg.env.sign_tx(key, b"f%d" % i) if i % 2 else
                   pkg.env.encode(key.pub_key().bytes(), bytes(64), b"f%d" % i)
                   for i in range(6)]
            res = [await outcome(pkg, pool.check_tx(t)) for t in txs]
            pool.close()
            pkg.disarm()
            return res, app.checked

        return run(go())

    assert scenario(PACKAGES["port"]) == scenario(PACKAGES["reference"])


def test_queue_full_sheds_neither_poison_the_cache_nor_unsigned_txs():
    def scenario(pkg):
        async def go():
            pool, app = make_pool(pkg)
            ref_host_path(pkg, pool)
            tx = pkg.env.sign_tx(signer(pkg), b"retry-me")
            sat = pool.admission.collector
            sat._in_flight = sat.queue_max
            out = [await outcome(pkg, pool.check_tx(tx)),
                   type(pool.admission_error(9, tx)).__name__,
                   pool.admission_error(9, b"raw-ok"),
                   await outcome(pkg, pool.check_tx(b"raw=1")),
                   pool.admission.status_check()["status"]]
            sat._in_flight = 0
            out.append(await outcome(pkg, pool.check_tx(tx)))
            out += [pool.size(), len(app.checked),
                    dict(pool.admission.sheds)]
            pool.close()
            return out

        return run(go())

    p, r = scenario(PACKAGES["port"]), scenario(PACKAGES["reference"])
    assert p == r
    assert p[0][0] == "AdmissionQueueFullError" and p[6] == 2


def test_bad_signature_never_blocks_the_valid_envelope():
    def scenario(pkg):
        async def go():
            out = []
            for keep in (False, True):
                pool, app = make_pool(pkg, keep_invalid_txs_in_cache=keep)
                ref_host_path(pkg, pool)
                key = signer(pkg)
                bad = pkg.env.encode(key.pub_key().bytes(), bytes(64),
                                     b"poison")
                out.append(await outcome(pkg, pool.check_tx(bad)))
                out.append(await outcome(pkg, pool.check_tx(bad)))
                out.append(await outcome(pkg, pool.check_tx(
                    pkg.env.sign_tx(key, b"poison"))))
                out.append((pool.size(), len(app.checked)))
                pool.close()
            return out

        return run(go())

    assert scenario(PACKAGES["port"]) == scenario(PACKAGES["reference"])


def test_status_check_keys_and_values():
    def scenario(pkg):
        async def go():
            pool, _ = make_pool(pkg)
            ref_host_path(pkg, pool)
            key = signer(pkg)
            await pool.check_tx(pkg.env.sign_tx(key, b"st-1"))
            await pool.check_tx(b"st-plain")
            await pool.check_tx(pkg.env.encode(key.pub_key().bytes(),
                                               bytes(64), b"st-2"))
            ok = pool.admission.status_check()
            pool.admission.collector._in_flight = \
                pool.admission.collector.queue_max
            deg = pool.admission.status_check()
            pool.admission.collector._in_flight = 0
            pkg.batch.breaker("ed25519").record_failure()
            opened = pool.admission.status_check()
            pool.close()
            return ok, deg, opened

        return run(go())

    p, r = scenario(PACKAGES["port"]), scenario(PACKAGES["reference"])
    for a, b in zip(p, r):
        assert sorted(a) == sorted(b)
        # verify_launches are process totals in both (the reference's
        # from its metrics registry)
        assert {k: v for k, v in a.items() if k != "verify_launches"} == \
            {k: v for k, v in b.items() if k != "verify_launches"}
    assert p[0]["status"] == "ok" and p[1]["status"] == "degraded"
    assert p[2]["detail"].startswith("ed25519 breaker open")
    assert p[0]["admitted"] == {"signed": 1, "unsigned": 1}


def test_wal_replay_routes_through_admission(tmp_path, monkeypatch):
    def scenario(pkg, name):
        async def go():
            wal = str(tmp_path / name)
            key = signer(pkg)
            good = pkg.env.sign_tx(key, b"keep")
            bad = pkg.env.encode(key.pub_key().bytes(), bytes(64), b"drop")
            pool1, _ = make_pool(pkg, wal_dir=wal, admission="off")
            await pool1.check_tx(good)
            await pool1.check_tx(bad)
            pool1.close()
            pool2, app2 = make_pool(pkg, wal_dir=wal, admission_flush_ms=5.0)
            ref_host_path(pkg, pool2)
            report = await pool2.refill_from_wal()
            out = (report, pool2.reap_max_txs(-1), app2.checked,
                   pool2.wal_pending_txs())
            pool2.close()
            return out

        return run(go())

    p = scenario(PACKAGES["port"], "p")
    r = scenario(PACKAGES["reference"], "r")
    assert p == r and p[0] == {"pending": 2, "readmitted": 1, "rejected": 1}


# -- the recorded divergence --------------------------------------------


def test_kernel_error_from_the_launch_reaches_check_tx(monkeypatch):
    """ROADMAP Queue C: the port re-raises crypto.batch.UNCAUGHT from the
    admission launch (no breaker opens, no fallback counted); it lands on
    every future of the batch, so each check_tx raises it. The reference
    degrades the same fault to its host oracle (its launch's exception is
    caught like any other)."""
    def raising(*a, **kw):
        raise pkernels.KernelError("illegal address (700)")

    monkeypatch.setattr(pverify, "verify_batch", raising)
    m0 = dict(pbatch.counters())

    async def go():
        pool, app = make_pool(PACKAGES["port"], admission_batch=3,
                              admission_flush_ms=30_000.0)
        pool.admission.collector.device_threshold = 1
        key = signer(PACKAGES["port"])
        res = await asyncio.gather(
            *(pool.check_tx(penv.sign_tx(key, b"kx%d" % i))
              for i in range(3)), return_exceptions=True)
        raw = await pool.check_tx(b"raw=still-fine")
        pool.close()
        return res, raw, app.checked

    res, raw, checked = run(go())
    assert all(isinstance(r, pkernels.KernelError) for r in res)
    assert raw.code == 0 and checked == [b"raw=still-fine"]
    assert pbatch.device_available("ed25519") and pbatch.counters() == m0

    from tendermint_tpu.crypto.tpu import verify as jtv

    def jraising(*a, **kw):
        raise RuntimeError("illegal address (700)")

    monkeypatch.setattr(jtv, "verify_batch", jraising)

    async def ref():
        pool, app = make_pool(PACKAGES["reference"], admission_batch=3,
                              admission_flush_ms=30_000.0)
        pool.admission.collector.device_threshold = 1
        key = signer(PACKAGES["reference"])
        res = await asyncio.gather(
            *(pool.check_tx(jenv.sign_tx(key, b"kx%d" % i))
              for i in range(3)))
        pool.close()
        return [r.code for r in res]

    assert run(ref()) == [0, 0, 0]
