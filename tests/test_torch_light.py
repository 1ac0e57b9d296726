"""Port parity for the light client's verify layer (light/): the
verifier, the MBT fixture driver, the codec of LightBlock and
LightClientAttackEvidence, the verified-header cache and the verify
collector, against the JAX package.

The 14 fixtures of tests/light_fixtures replay through both packages'
light.mbt, and each step's verify outcome (None, or the exception's
class and text) must be equal. The boundary cases of
tests/test_light_verifier.py run on chains both packages build from the
same seeds. LightBlock and LightClientAttackEvidence bytes must equal
the reference's and decode across the packages. The collector cases of
tests/test_light_serving.py run the port's LightVerifyCollector: its
device route on K4's plain version (device_threshold 1), a false
sentinel, an open breaker and the light.verify failpoint each to the
host, and the shed at pending_max, with verdicts and error texts equal
to the reference collector's (on its host route, which compiles no JAX
kernel) and to the verifier's. Tolerance: exact."""

import asyncio
import dataclasses
import functools
import glob
import hashlib
import json
import os
import types
from fractions import Fraction

import numpy as np
import pytest
from test_torch_vote_set import sign

from tendermint_tpu.config import LightConfig as JLightConfig
from tendermint_tpu.crypto import ed25519 as jed25519
from tendermint_tpu.light import mbt as jmbt
from tendermint_tpu.light import serving as jserving
from tendermint_tpu.light import types as jltypes
from tendermint_tpu.light import verifier as jverifier
from tendermint_tpu.types import block as jblock
from tendermint_tpu.types import evidence as jevidence
from tendermint_tpu.types import validator as jvalidator
from tendermint_tpu.types import validator_set as jvalidator_set
from tendermint_tpu.types import vote as jvote
from tendermint_tpu_torch.config import LightConfig as PLightConfig
from tendermint_tpu_torch.crypto import batch as pbatch
from tendermint_tpu_torch.crypto import ed25519 as ped25519
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.crypto.cuda import verify as pverify
from tendermint_tpu_torch.device import set_default_device
from tendermint_tpu_torch.libs import failpoints
from tendermint_tpu_torch.light import mbt as pmbt
from tendermint_tpu_torch.light import serving as pserving
from tendermint_tpu_torch.light import types as pltypes
from tendermint_tpu_torch.light import verifier as pverifier
from tendermint_tpu_torch.types import block as pblock
from tendermint_tpu_torch.types import evidence as pevidence
from tendermint_tpu_torch.types import validator as pvalidator
from tendermint_tpu_torch.types import validator_set as pvalidator_set
from tendermint_tpu_torch.types import vote as pvote

CHAIN = "torch-light-chain"
HOUR = 3600 * 1_000_000_000
T0 = 1_700_000_000 * 1_000_000_000
NOW = T0 + 100 * 1_000_000_000
DRIFT = pverifier.MAX_CLOCK_DRIFT_NS
FIXTURES = sorted(glob.glob(os.path.join(os.path.dirname(__file__),
                                         "light_fixtures", "*.json")))
PACKAGES = {
    "port": types.SimpleNamespace(
        ed=ped25519, block=pblock, vote=pvote, validator=pvalidator,
        vset=pvalidator_set, lt=pltypes, verifier=pverifier, mbt=pmbt,
        evidence=pevidence, serving=pserving),
    "reference": types.SimpleNamespace(
        ed=jed25519, block=jblock, vote=jvote, validator=jvalidator,
        vset=jvalidator_set, lt=jltypes, verifier=jverifier, mbt=jmbt,
        evidence=jevidence, serving=jserving),
}
PORT = PACKAGES["port"]


@pytest.fixture(autouse=True)
def _cpu():
    set_default_device("cpu")
    pbatch.reset_breakers()
    yield
    failpoints.disarm_all()
    pbatch.reset_breakers()
    set_default_device(None)


def outcome(fn):
    """None when fn() returns, else its exception's class and text."""
    try:
        fn()
        return None
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return (type(e).__name__, str(e))


def _seed(i: int) -> bytes:
    return hashlib.sha256(b"light-val-%d" % i).digest()


@functools.cache
def _pub(i: int) -> bytes:
    return ref.public_key_from_seed(_seed(i))


SEED_OF = {_pub(i): _seed(i) for i in range(16)}


def _valset(p, indices, power=lambda i: 10):
    return p.vset.ValidatorSet([p.validator.Validator.new(
        p.ed.Ed25519PubKey(_pub(i)), power(i)) for i in indices])


def _commit(p, vals, height, bid, ts, signers=None):
    """Every validator's precommit for bid (or only `signers`' indices
    into the set; the others absent)."""
    sigs = []
    for idx, v in enumerate(vals.validators):
        if signers is not None and idx not in signers:
            sigs.append(p.block.CommitSig.absent())
            continue
        sigs.append(p.block.CommitSig(p.block.BlockIDFlag.COMMIT, v.address,
                                      ts + idx, b""))
    commit = p.block.Commit(height, 0, bid, sigs)
    for idx, cs in enumerate(sigs):
        if cs.signature == b"" and not cs.is_absent():
            pub = vals.validators[idx].pub_key.bytes()
            cs.signature = sign(SEED_OF[pub],
                                commit.vote_sign_bytes(CHAIN, idx))
    return commit


def light_chain(p, n_heights, valset_for=lambda h: range(4), times=None,
                app_hash=b"\x04" * 32):
    """One package's chain of LightBlocks (heights 1..n) with the
    validator sets valset_for(h), made from seeds; the shape of
    tests/test_light.py's LightChain."""
    sets = {h: _valset(p, valset_for(h)) for h in range(1, n_heights + 2)}
    blocks, prev_bid = {}, None
    for h in range(1, n_heights + 1):
        vals, nvals = sets[h], sets[h + 1]
        header = p.block.Header(
            version_block=11, version_app=0, chain_id=CHAIN, height=h,
            time=T0 + h * 1_000_000_000 if times is None else times[h - 1],
            last_block_id=prev_bid, last_commit_hash=b"\x01" * 32,
            data_hash=b"\x02" * 32, validators_hash=vals.hash(),
            next_validators_hash=nvals.hash(), consensus_hash=b"\x03" * 32,
            app_hash=app_hash, last_results_hash=b"\x05" * 32,
            evidence_hash=b"\x06" * 32,
            proposer_address=vals.proposer.address)
        bid = p.block.BlockID(header.hash(),
                              p.block.PartSetHeader(1, b"\x07" * 32))
        commit = _commit(p, vals, h, bid, header.time + 1)
        blocks[h] = p.lt.LightBlock(p.lt.SignedHeader(header, commit), vals)
        prev_bid = bid
    return blocks


def forge(p, lb, **header_fields):
    """lb with its header fields replaced (the commit left as signed)."""
    hdr = dataclasses.replace(lb.signed_header.header, **header_fields)
    return p.lt.LightBlock(p.lt.SignedHeader(hdr, lb.signed_header.commit),
                           lb.validator_set)


def corrupt_commit(p, lb, slots=None):
    """lb with its commit's signatures zeroed (all, or at `slots`)."""
    c = lb.signed_header.commit
    sigs = [p.block.CommitSig(cs.block_id_flag, cs.validator_address,
                              cs.timestamp,
                              bytes(64) if cs.signature and (
                                  slots is None or i in slots)
                              else cs.signature)
            for i, cs in enumerate(c.signatures)]
    forged = p.block.Commit(c.height, c.round, c.block_id, sigs)
    return p.lt.LightBlock(p.lt.SignedHeader(lb.signed_header.header, forged),
                           lb.validator_set)


# -- the MBT corpus ------------------------------------------------------


@pytest.mark.parametrize("path", FIXTURES,
                         ids=[os.path.basename(f)[:-5] for f in FIXTURES])
def test_fixture_equals_reference(path):
    assert len(FIXTURES) == 14
    verdicts = {name: p.mbt.run_fixture_file(path)
                for name, p in PACKAGES.items()}
    assert verdicts["port"] == verdicts["reference"]
    doc = json.load(open(path))
    got = {}
    for name, p in PACKAGES.items():
        trusted = p.lt.LightBlock.from_bytes(
            bytes.fromhex(doc["initial"]["block"]))
        period = int(doc["initial"]["trusting_period_ns"])
        tl = Fraction(*doc.get("trust_level", [1, 3]))
        steps = []
        for step in doc["input"]:
            block = p.lt.LightBlock.from_bytes(bytes.fromhex(step["block"]))
            steps.append(outcome(lambda: p.verifier.verify(
                doc["chain_id"], trusted, block, period, int(step["now_ns"]),
                tl)))
            if steps[-1] is None:
                trusted = block
        got[name] = steps
    assert got["port"] == got["reference"]


# -- the verifier's boundary cases ---------------------------------------


def _rotate_at_8(h):
    return range(4) if h <= 8 else (3, 4, 5, 6)


def _disjoint_after_5(h):
    return range(4) if h <= 5 else range(10, 14)


def _cases(p):
    """(name, call) pairs in the shapes of tests/test_light.py and
    tests/test_light_verifier.py."""
    c = light_chain(p, 8)
    v = p.verifier
    t1, t8 = c[1].time(), c[8].time()
    mono = light_chain(p, 4, times=[T0, T0 + 10, T0 + 5, T0 + 7])
    equal = light_chain(p, 3, times=[T0, T0 + 10, T0 + 10])
    rot = light_chain(p, 16, valset_for=_rotate_at_8)
    dis = light_chain(p, 10, valset_for=_disjoint_after_5)
    other = light_chain(p, 3, app_hash=b"\x44" * 32)
    return [
        ("adjacent", lambda: v.verify_adjacent(CHAIN, c[1], c[2], HOUR, NOW)),
        ("adjacent_expired", lambda: v.verify_adjacent(CHAIN, c[1], c[2], 1,
                                                        NOW)),
        ("adjacent_not_adjacent", lambda: v.verify_adjacent(
            CHAIN, c[1], c[3], HOUR, NOW)),
        ("adjacent_forged_header", lambda: v.verify_adjacent(
            CHAIN, c[1], forge(p, c[2], app_hash=b"\xee" * 32), HOUR, NOW)),
        ("adjacent_bad_commit", lambda: v.verify_adjacent(
            CHAIN, c[1], corrupt_commit(p, c[2], {1}), HOUR, NOW)),
        ("adjacent_valset_mismatch", lambda: v.verify_adjacent(
            CHAIN, rot[7], forge(p, rot[8], next_validators_hash=b"\x09" * 32),
            HOUR, NOW)),
        ("adjacent_wrong_chain", lambda: v.verify_adjacent(
            "other-chain", c[1], c[2], HOUR, NOW)),
        ("skip", lambda: v.verify_non_adjacent(CHAIN, c[1], c[8], HOUR, NOW)),
        ("skip_expiry_inside", lambda: v.verify_non_adjacent(
            CHAIN, c[1], c[8], HOUR, t1 + HOUR - 1)),
        ("skip_expiry_boundary", lambda: v.verify_non_adjacent(
            CHAIN, c[1], c[8], HOUR, t1 + HOUR)),
        ("adjacent_expiry_boundary", lambda: v.verify_adjacent(
            CHAIN, c[1], c[2], HOUR, t1 + HOUR)),
        ("drift_boundary", lambda: v.verify_non_adjacent(
            CHAIN, c[1], c[8], HOUR, t8 - DRIFT)),
        ("drift_inside", lambda: v.verify_non_adjacent(
            CHAIN, c[1], c[8], HOUR, t8 - DRIFT + 1)),
        ("adjacent_drift", lambda: v.verify_adjacent(
            CHAIN, c[1], c[2], HOUR, c[2].time() - DRIFT)),
        ("time_regression", lambda: v.verify_non_adjacent(
            CHAIN, mono[2], mono[4], HOUR, T0 + HOUR // 2)),
        ("time_stalled", lambda: v.verify_adjacent(
            CHAIN, equal[2], equal[3], HOUR, T0 + HOUR // 2)),
        ("height_not_above", lambda: v.verify_non_adjacent(
            CHAIN, mono[2], mono[2], HOUR, T0 + HOUR // 2)),
        ("cant_trust_rotation", lambda: v.verify_non_adjacent(
            CHAIN, rot[1], rot[16], HOUR, NOW)),
        ("cant_trust_disjoint", lambda: v.verify_non_adjacent(
            CHAIN, dis[1], dis[10], HOUR, NOW)),
        ("skip_two_thirds", lambda: v.verify_non_adjacent(
            CHAIN, rot[1], rot[10], HOUR, NOW, Fraction(2, 3))),
        ("verify_adjacent_dispatch", lambda: v.verify(
            CHAIN, rot[8], rot[9], HOUR, NOW)),
        ("verify_skip_bad_commit", lambda: v.verify(
            CHAIN, c[1], corrupt_commit(p, c[6], {0}), HOUR, NOW)),
        ("backwards", lambda: v.verify_backwards(
            c[3].signed_header.header, c[4].signed_header.header)),
        ("backwards_wrong_link", lambda: v.verify_backwards(
            other[2].signed_header.header, c[4].signed_header.header)),
        ("backwards_wrong_time", lambda: v.verify_backwards(
            c[4].signed_header.header, c[4].signed_header.header)),
    ]


def test_verifier_equals_reference():
    got = {name: [(case, outcome(call)) for case, call in _cases(p)]
           for name, p in PACKAGES.items()}
    assert got["port"] == got["reference"]
    kinds = {o[0] if o else None for _, o in got["port"]}
    assert kinds == {None, "VerificationFailedError", "ValueError",
                     "OutsideTrustingPeriodError",
                     "NewValSetCantBeTrustedError"}


# -- the codec -----------------------------------------------------------


def _attack(p):
    """A lunatic attack (the conflicting header's app hash differs) and an
    equivocation (a second commit for another block at the same round)
    as LightClientAttackEvidence, with their byzantine validators."""
    c = light_chain(p, 4, valset_for=lambda h: range(5))
    lunatic = light_chain(p, 4, valset_for=lambda h: range(5),
                          app_hash=b"\x66" * 32)[4]
    hdr = dataclasses.replace(c[4].signed_header.header,
                              time=c[4].time() + 5)
    bid = p.block.BlockID(hdr.hash(), p.block.PartSetHeader(1, b"\x07" * 32))
    equiv = p.lt.LightBlock(p.lt.SignedHeader(
        hdr, _commit(p, c[4].validator_set, 4, bid, hdr.time,
                     signers={0, 2, 3, 4})), c[4].validator_set)
    out = []
    for cb in (lunatic, equiv):
        assert cb.validate_basic(CHAIN) is None
        byz = p.lt.compute_byzantine_validators(
            c[3].validator_set, c[4].signed_header, cb)
        out.append(p.lt.LightClientAttackEvidence(
            cb, 3, byz, c[3].validator_set.total_voting_power(), c[3].time()))
    return c, out


def test_codec_equals_reference():
    got = {}
    for name, p in PACKAGES.items():
        c, attacks = _attack(p)
        lb_bytes = [c[h].to_proto().finish() for h in sorted(c)]
        ev = [(a.to_bytes(), a.hash(), [v.address for v in
                                        a.byzantine_validators],
               p.lt.conflicting_header_is_invalid(
                   a.conflicting_block.signed_header.header,
                   c[4].signed_header.header)) for a in attacks]
        data = p.evidence.EvidenceData(attacks)
        got[name] = (lb_bytes, ev, data.hash(), data.to_proto().finish())
    assert got["port"] == got["reference"]
    lb_bytes, ev, _, data_bytes = got["port"]
    assert [len(e[2]) for e in ev] == [5, 4]  # lunatic: all; equivocation: 4
    # cross-decoding: each package re-encodes the other's bytes unchanged
    for p in PACKAGES.values():
        for b in lb_bytes:
            assert p.lt.LightBlock.from_bytes(b).to_proto().finish() == b
        for b, *_ in ev:
            e = p.evidence.evidence_from_bytes(b)
            assert type(e).__name__ == "LightClientAttackEvidence"
            assert e.to_bytes() == b and e.height() == 3
            assert e.conflicting_height() == 4 and e.validate_basic() is None
        d = p.evidence.EvidenceData.from_bytes(data_bytes)
        assert [e.to_bytes() for e in d.evidence] == [e[0] for e in ev]


def test_attack_evidence_validate_basic_equals_reference():
    got = {}
    for name, p in PACKAGES.items():
        _, attacks = _attack(p)
        a = attacks[0]
        got[name] = [
            outcome(lambda: dataclasses.replace(a, common_height=0)
                    .validate_basic()),
            outcome(lambda: dataclasses.replace(a, common_height=9)
                    .validate_basic()),
            outcome(lambda: p.lt.LightClientAttackEvidence._from_inner(b"")),
            outcome(lambda: p.lt.LightBlock.from_bytes(b"")),
        ]
    assert got["port"] == got["reference"]


# -- the cache and the config --------------------------------------------


def test_cache_lru_and_trusting_period_equal_reference():
    got = {}
    for name, p in PACKAGES.items():
        chain = light_chain(p, 6)
        cache = p.serving.VerifiedHeaderCache(max_entries=3, period_ns=HOUR)
        for h in (1, 2, 3):
            cache.put(chain[h], NOW)
        t3 = chain[3].time()
        steps = [cache.get(1, NOW) is chain[1]]
        cache.put(chain[4], NOW)  # evicts the least recent (2)
        steps += [cache.get(2, NOW), cache.get(1, NOW) is chain[1],
                  cache.get(3, t3 + HOUR - 1) is chain[3],
                  cache.get(3, t3 + HOUR), len(cache)]
        cache.put(chain[5], chain[5].time() + HOUR)  # expired: not cached
        steps += [cache.get(5, NOW), len(cache)]
        cache.clear()
        got[name] = steps + [len(cache)]
    assert got["port"] == got["reference"] == [True, None, True, True, None,
                                               2, None, 2, 0]


def test_light_config_equals_reference():
    cases = [{}, {"pending_max": 0}, {"pending_max": 1}, {"pending_max": 2},
             {"flush_ms": -1.0}, {"batch_max": 0}, {"cache_size": 0},
             {"workers": 0}]
    for kw in cases:
        assert outcome(PLightConfig(**kw).validate_basic) == \
            outcome(JLightConfig(**kw).validate_basic), kw
    assert dataclasses.asdict(PLightConfig()) == dataclasses.asdict(
        JLightConfig())


# -- the verify collector ------------------------------------------------


def _plans(p, chain, n=4):
    """The two plans of a 1 -> n skip and the light plan of n - 1 -> n."""
    sh = chain[n].signed_header
    trusting = chain[1].validator_set.plan_commit_trusting(
        CHAIN, sh.commit, 1, 3)
    light = chain[n].validator_set.plan_commit_light(
        CHAIN, sh.commit.block_id, n, sh.commit)
    return trusting, light


async def _checks(coll, plans):
    res = await asyncio.gather(*(coll.check(pl) for pl in plans),
                               return_exceptions=True)
    coll.close()
    return [None if r is None else (type(r).__name__, str(r)) for r in res]


def _collector_outcomes(p, **kw):
    """A good plan pair and a forged-commit plan pair through one
    collector launch; the reference stays on its host route."""
    good = light_chain(p, 6)
    bad = {h: corrupt_commit(p, lb, {1, 3}) for h, lb in good.items()}
    plans = [*_plans(p, good, 6), *_plans(p, bad, 5)]
    if p is not PORT:
        kw = dict(kw, device_threshold=10**9)
    coll = p.serving.LightVerifyCollector(batch_max=10**6, flush_ms=20.0,
                                          pending_max=64, **kw)
    return asyncio.run(_checks(coll, plans))


def _launches():
    c = pserving.light_metrics().verify_launches
    return {dict(k)["backend"]: int(v) for k, v in c._values.items()}


def _delta(before):
    after = _launches()
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


def test_collector_scatters_verdicts_per_plan_on_the_device_route():
    """One coalesced K4 launch (plain, on the CPU) with the sentinel lane:
    the forged plans alone fail, with the reference's text."""
    before = _launches()
    port = _collector_outcomes(PORT, device_threshold=1)
    assert port == _collector_outcomes(PACKAGES["reference"])
    assert port[:2] == [None, None]
    # slot 3 lies beyond both plans' selection (2 and 3 of 4 lanes)
    assert port[2:] == [("VerificationError",
                         "invalid signature(s) at index(es) [1]")] * 2
    assert _delta(before) == {"device": 1}
    assert pbatch.device_available("ed25519")


def test_false_sentinel_rechecks_on_the_host(monkeypatch):
    monkeypatch.setattr(pverify, "verify_batch",
                        lambda pubs, msgs, sigs: np.zeros(len(pubs), bool))
    before, m0 = _launches(), dict(pbatch.counters())
    port = _collector_outcomes(PORT, device_threshold=1)
    assert port == _collector_outcomes(PACKAGES["reference"])
    assert _delta(before) == {"device": 1, "host_recheck": 1}
    assert not pbatch.device_available("ed25519")
    assert pbatch.counters()["host_rechecks"] == m0["host_rechecks"] + 1
    assert pbatch.counters()["host_fallbacks"] == m0["host_fallbacks"] + 1


def test_open_breaker_routes_to_the_host(monkeypatch):
    def must_not_launch(*a, **kw):
        raise AssertionError("device launched through an open breaker")

    monkeypatch.setattr(pverify, "verify_batch", must_not_launch)
    pbatch.breaker("ed25519").record_failure()
    before = _launches()
    port = _collector_outcomes(PORT, device_threshold=1)
    assert port == _collector_outcomes(PACKAGES["reference"])
    assert _delta(before) == {"host": 1}


def test_failpoint_routes_to_the_host(monkeypatch):
    def must_not_launch(*a, **kw):
        raise AssertionError("device launched under the failpoint")

    monkeypatch.setattr(pverify, "verify_batch", must_not_launch)
    failpoints.arm("light.verify", "error")
    before = _launches()
    port = _collector_outcomes(PORT, device_threshold=1)
    assert port == _collector_outcomes(PACKAGES["reference"])
    assert _delta(before) == {"host": 1}
    assert pbatch.device_available("ed25519")


def test_shed_at_pending_max():
    """The third check at pending_max=2 is shed at once with the
    reference's text; the two parked checks verify; the backlog is the
    light.pending_verify entry of the overload controller."""
    from tendermint_tpu_torch.libs.overload import CONTROLLER

    got = {}
    for name, p in PACKAGES.items():
        chain = light_chain(p, 4)
        plans = [*_plans(p, chain), _plans(p, chain)[1]]
        coll = p.serving.LightVerifyCollector(pending_max=2,
                                              device_threshold=10**9)
        if p is PORT:
            assert CONTROLLER.evaluate()["queues"]["light.pending_verify"][
                "capacity"] == 2
        got[name] = asyncio.run(_checks(coll, plans))
    assert got["port"] == got["reference"]
    assert got["port"][2] == ("LightServingShedError",
                              "light serving plane overloaded: 2 commit "
                              "checks pending (limit 2); retry later")
    assert "light.pending_verify" not in CONTROLLER.evaluate()["queues"]


def _through_cases(p):
    c = light_chain(p, 8)
    rot = light_chain(p, 16, valset_for=_rotate_at_8)
    return [(c[1], c[2]), (c[1], c[8]), (rot[1], rot[16]), (rot[1], rot[9]),
            (c[1], corrupt_commit(p, c[5], {2})),
            (c[4], corrupt_commit(p, c[5], {0})),
            (c[1], forge(p, c[6], app_hash=b"\xee" * 32)),
            (rot[7], forge(p, rot[8], next_validators_hash=b"\x09" * 32))]


def test_verify_through_equals_the_verifier():
    """The pooled step (the reference's ServingPlane._verify_one) gives
    verifier.verify's outcome, error class and text, on every case; the
    16 concurrent checks of 8 requests coalesce into few launches."""
    cases = _through_cases(PORT)
    want = [outcome(lambda: pverifier.verify(CHAIN, t, u, HOUR, NOW))
            for t, u in cases]
    assert want == [outcome(lambda: jverifier.verify(CHAIN, t, u, HOUR, NOW))
                    for t, u in _through_cases(PACKAGES["reference"])]

    async def go():
        coll = pserving.LightVerifyCollector(flush_ms=20.0,
                                             device_threshold=10**9)
        res = await asyncio.gather(*(
            pserving.verify_through(coll, CHAIN, t, u, HOUR, NOW)
            for t, u in cases), return_exceptions=True)
        coll.close()
        return [None if r is None else (type(r).__name__, str(r))
                for r in res]

    before = _launches()
    assert asyncio.run(go()) == want
    assert _delta(before) == {"host": 1}  # one flush for every check
