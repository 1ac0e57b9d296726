"""Port parity for the speculation plane (consensus/speculation.py):
the same scenarios through the reference's SpeculationPlane (its host
path, device_min=10**9, as its own tests drive it) and the port's
(device_min=1, so every flush splices into the arena and runs K7's
plain version on the CPU), with votes signed once and shared. Each
scenario records the serve's outcome (its return value or the raised
exception's type and text), the hit/miss tallies, the lanes the serve
re-verified and each speculated lane's (timestamp, verdict, poisoned).
Tolerance: exact."""

import hashlib

import pytest

from tendermint_tpu.config import SpeculationConfig as JSpeculationConfig
from tendermint_tpu.consensus import speculation as jspeculation
from tendermint_tpu.crypto import ed25519 as jed25519
from tendermint_tpu.types import block as jblock
from tendermint_tpu.types import validator as jvalidator
from tendermint_tpu.types import validator_set as jvalidator_set
from tendermint_tpu.types import vote as jvote
from tendermint_tpu_torch.config import SpeculationConfig
from tendermint_tpu_torch.consensus import speculation as pspeculation
from tendermint_tpu_torch.crypto import ed25519 as ped25519
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.crypto.cuda import expanded, resident, verify
from tendermint_tpu_torch.device import set_default_device
from tendermint_tpu_torch.types import block as pblock
from tendermint_tpu_torch.types import validator as pvalidator
from tendermint_tpu_torch.types import validator_set as pvalidator_set
from tendermint_tpu_torch.types import vote as pvote

N = 8
H = 5
CHAIN = "torch-spec"
BASE_TS = 1_700_000_000_000_000_000
SEEDS = [hashlib.sha256(b"spec-val-%d" % i).digest() for i in range(N)]
PUBS = [ref.public_key_from_seed(s) for s in SEEDS]
SEED_OF = dict(zip(PUBS, SEEDS))
PACKAGES = {
    "port": (ped25519, pblock, pvalidator, pvalidator_set, pvote,
             pspeculation, SpeculationConfig),
    "reference": (jed25519, jblock, jvalidator, jvalidator_set, jvote,
                  jspeculation, JSpeculationConfig),
}


@pytest.fixture(autouse=True)
def _cpu():
    set_default_device("cpu")
    yield
    set_default_device(None)


_SIGS: dict = {}


def _sign(seed: bytes, msg: bytes) -> bytes:
    if (seed, msg) not in _SIGS:
        _SIGS[seed, msg] = ref.sign(seed, msg)
    return _SIGS[seed, msg]


class World:
    """One package's validator set, block id, vote and commit makers."""

    def __init__(self, name: str):
        (ed, self.blk, val, vset, self.vmod, self.spec,
         self.cfg) = PACKAGES[name]
        self.name = name
        self.vs = vset.ValidatorSet([val.Validator.new(ed.Ed25519PubKey(p), 10)
                                     for p in PUBS])
        self.bid = self.blk.BlockID(b"\xab" * 32,
                                    self.blk.PartSetHeader(1, b"\xcd" * 32))
        self.calls: list = []
        orig = self.vs._batch_verify_lanes

        def spy(lanes, msgs, sigs):
            self.calls.append(list(lanes))
            return orig(lanes, msgs, sigs)

        self.vs._batch_verify_lanes = spy

    def plane(self, **kw):
        if self.name == "port":
            return self.spec.SpeculationPlane(self.cfg(arena_lanes=32),
                                              device_min=1, **kw)
        return self.spec.SpeculationPlane(self.cfg(), device_min=10**9, **kw)

    def vote(self, idx, ts, *, nil=False, sig=None, height=H):
        val = self.vs.validators[idx]
        v = self.vmod.Vote(type=self.vmod.VoteType.PRECOMMIT, height=height,
                           round=0, block_id=None if nil else self.bid,
                           timestamp=ts, validator_address=val.address,
                           validator_index=idx)
        v.signature = sig if sig is not None else _sign(
            SEED_OF[val.pub_key.bytes()], v.sign_bytes(CHAIN))
        return v

    def commit(self, votes):
        sigs = []
        for v in votes:
            flag = (self.blk.BlockIDFlag.NIL if v.block_id is None
                    else self.blk.BlockIDFlag.COMMIT)
            sigs.append(self.blk.CommitSig(flag, v.validator_address,
                                           v.timestamp, v.signature))
        return self.blk.Commit(H, 0, self.bid, sigs)

    def serve(self, plane, commit):
        try:
            return ("served", plane.serve_commit(self.vs, CHAIN, self.bid, H,
                                                 commit))
        except Exception as e:  # compared across packages, type and text
            return ("raised", type(e).__name__, str(e))


def _ts(i):
    return BASE_TS + i * 1_000_003


def _scenario(w: World, name: str):
    """Drive one scenario; returns what the two packages must agree on."""
    plane = w.plane()
    votes = [w.vote(i, _ts(i)) for i in range(N)]
    outcome = None
    if name == "retire":
        for h in (5, 6, 7, 8):
            plane.begin_height(CHAIN, w.vs, h, 0, w.bid)
        bounded = sorted(plane._heights)
        plane.retire_below(9)
        return bounded, sorted(plane._heights)
    if name == "no_plan":
        outcome = w.serve(plane, w.commit(votes))
    elif name == "orphans":
        for v in votes:
            plane.observe_precommit(v)
        plane.begin_height(CHAIN, w.vs, H, 0, w.bid)
        plane.flush_sync()
        outcome = w.serve(plane, w.commit(votes))
    else:
        plane.begin_height(CHAIN, w.vs, H, 0, w.bid)
        observed = list(votes)
        if name == "nil":
            observed[3] = votes[3] = w.vote(3, _ts(3), nil=True)
        if name == "equivocation_nil_first":
            plane.observe_precommit(w.vote(2, _ts(2) + 5, nil=True))
        if name == "bad_lane":  # a precommit whose signature is wrong
            sig = votes[3].signature
            observed[3] = votes[3] = w.vote(
                3, _ts(3), sig=sig[:5] + bytes([sig[5] ^ 1]) + sig[6:])
        if name == "unpatched_not_launched":
            observed = observed[:N - 1]
        for v in observed:
            plane.observe_precommit(v)
        if name == "equivocation":
            plane.observe_precommit(w.vote(1, _ts(1) + 999_999))
        if name != "unpatched_not_launched":
            plane.flush_sync()
        if name == "mismatch":  # slot 2 re-signed at another timestamp
            votes[2] = w.vote(2, _ts(2) + 1)
        if name == "bad_sig":  # slot 1: another timestamp, garbage bytes
            votes[1] = w.vote(1, _ts(1) + 7, sig=b"\x01" * 64)
        if name == "insufficient":
            votes = votes[:5]
        commit = w.commit(votes)
        if name == "insufficient":
            absent = w.blk.CommitSig.absent()
            commit.signatures += [absent] * (N - 5)
        outcome = w.serve(plane, commit)
    entry = plane._heights.get(H)
    lanes = ({i: (ln.ts, ln.verdict, ln.poisoned)
              for i, ln in entry.lanes.items()} if entry else None)
    return (outcome, plane.hits, dict(plane.misses), plane.patched_lanes,
            w.calls, lanes)


SCENARIOS = ["hit", "mismatch", "bad_sig", "bad_lane", "equivocation",
             "equivocation_nil_first", "nil", "unpatched_not_launched",
             "no_plan", "orphans", "insufficient", "retire"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_plane_matches_reference(name):
    port, reference = World("port"), World("reference")
    assert [v.address for v in port.vs.validators] == \
        [v.address for v in reference.vs.validators]
    got = _scenario(port, name)
    want = _scenario(reference, name)
    assert got == want
    if name == "hit":
        assert got[:3] == (("served", True), 1,
                           {r: 0 for r in pspeculation.MISS_REASONS})
    if name == "bad_sig":
        assert got[0] == ("raised", "VerificationError",
                          "invalid signature(s) at index(es) [1]")
        assert got[4] == [[1]]
    if name == "mismatch":
        assert got[4] == [[2]] and got[2]["mismatch"] == 1
    if name == "bad_lane":  # the speculated verdict itself rejects
        assert got[0][2] == "invalid signature(s) at index(es) [3]"
        assert got[4] == [] and got[5][3][1] is False
    if name == "equivocation_nil_first":
        assert got[5][2][2] is True
    if name == "unpatched_not_launched":
        assert got[2]["not_launched"] == N - 1 and got[2]["unpatched"] == 1
    if name == "retire":
        assert got == ([6, 7, 8], [8])


def test_full_hit_serves_with_zero_launches(monkeypatch):
    """A full hit in the port calls none of K3 (with K2 inside its
    structured form, the structured verify entry), K4 or K7 (and their
    launch counters stay as they were) and re-verifies no lane; the
    flush before it went through the arena (K6 + K7)."""
    calls = []
    kernels = [expanded.xverify, expanded.shard_verify, verify.general_verify,
               resident.arena_verify]
    for mod, fn in ((expanded.ExpandedKeys, "verify_structured"),
                    (expanded, "xverify"),
                    (verify, "general_verify"), (resident, "arena_verify"),
                    (resident, "splice")):
        real = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, lambda *a, _r=real, _n=fn, **k:
                            calls.append(_n) or _r(*a, **k))
    w = World("port")
    plane = w.plane()
    votes = [w.vote(i, _ts(i)) for i in range(N)]
    plane.begin_height(CHAIN, w.vs, H, 0, w.bid)
    for v in votes:
        plane.observe_precommit(v)
    plane.flush_sync()
    assert calls == ["splice", "arena_verify"]
    assert plane._arena.active_lanes == N + 1
    counters = [f.launches for f in kernels]
    del calls[:]
    assert plane.serve_commit(w.vs, CHAIN, w.bid, H, w.commit(votes))
    assert calls == [] and w.calls == []
    assert plane.hits == 1
    assert counters == [f.launches for f in kernels]


def test_device_path_fallbacks_by_input():
    """Input properties route a batch to the host as in the reference:
    below device_min, a timestamp >= 2^63, a valset over the arena's
    capacity, a signature that is not 64 bytes. The verdicts agree."""
    w = World("port")
    plane = w.plane()
    plane.begin_height(CHAIN, w.vs, H, 0, w.bid)
    for v in [w.vote(i, _ts(i)) for i in range(N)]:
        plane.observe_precommit(v)
    long_sig = w.vote(0, _ts(0)).signature + b"\0"
    entry = plane._heights[H]
    kept = [(0, _ts(0), long_sig), (1, _ts(1), w.vote(1, _ts(1)).signature)]
    assert plane._device_verify(entry, kept) is None
    assert plane._verify_lanes(entry, kept).tolist() == [False, True]
    assert plane._arena is None  # nothing reached the arena
    big = w.plane()
    big.arena_lanes = N  # the set and the sentinel do not fit
    assert big._ensure_arena(entry) is None
    low = w.plane()
    low.device_min = 3
    assert low._verify_lanes(entry, kept[1:]).tolist() == [True]
    assert low._arena is None
    huge = [(1, 1 << 63, kept[1][2])]
    assert plane._verify_lanes(entry, huge).tolist() == [False]
    assert plane._arena is None


def test_failed_sentinel_opens_breaker_and_rechecks_on_host(monkeypatch):
    """A launch whose sentinel reads false does not raise out of
    flush_sync: as in the reference, the single arena cannot attribute
    it, so the backend ed25519 breaker opens, the burst re-verifies on
    the host (one host recheck) and the lanes keep correct verdicts."""
    from tendermint_tpu_torch.crypto import batch as cbatch

    w = World("port")
    plane = w.plane()
    plane.begin_height(CHAIN, w.vs, H, 0, w.bid)
    for v in [w.vote(i, _ts(i)) for i in range(N)]:
        plane.observe_precommit(v)
    real = resident.arena_verify

    def broken(*a, **k):
        out = real(*a, **k)
        out[0] = False
        return out

    monkeypatch.setattr(resident, "arena_verify", broken)
    rechecks = cbatch.counters()["host_rechecks"]
    try:
        plane.flush_sync()
        assert cbatch.breaker_states()["ed25519"] == "open"
        assert cbatch.device_breaker_states() == {}
        assert cbatch.counters()["host_rechecks"] == rechecks + 1
    finally:
        cbatch.reset_breakers()
    lanes = plane._heights[H].lanes
    assert [lanes[i].verdict for i in range(N)] == [True] * N


def test_config_and_vote_basics():
    cfg = SpeculationConfig()
    assert (cfg.arena_lanes, cfg.max_heights_ahead, cfg.flush_ms) == \
        (12288, 2, 2.0)
    cfg.validate_basic()
    for field, value, text in (("arena_lanes", 1, "arena_lanes"),
                               ("max_heights_ahead", 0, "max_heights_ahead"),
                               ("flush_ms", -1.0, "flush_ms")):
        bad = SpeculationConfig(**{field: value})
        with pytest.raises(ValueError, match=text):
            bad.validate_basic()
        ref_bad = JSpeculationConfig(**{field: value})
        with pytest.raises(ValueError, match=text):
            ref_bad.validate_basic()
    p, j = World("port"), World("reference")
    pv, jv = p.vote(3, _ts(3)), j.vote(3, _ts(3))
    assert pv.sign_bytes(CHAIN) == jv.sign_bytes(CHAIN)
    assert pv.is_nil() is jv.is_nil() is False
    assert p.vote(3, 0, nil=True).is_nil()
    pv.validate_basic()
    for field, value in (("height", 0), ("round", -1), ("signature", b""),
                         ("signature", b"\0" * 97), ("validator_index", -1),
                         ("validator_address", b"\0" * 19)):
        texts = []
        for v in (p.vote(3, _ts(3)), j.vote(3, _ts(3))):
            setattr(v, field, value)
            with pytest.raises(ValueError) as err:
                v.validate_basic()
            texts.append(str(err.value))
        assert texts[0] == texts[1]
