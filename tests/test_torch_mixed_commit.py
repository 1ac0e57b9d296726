"""Port parity for the mixed ed25519 + sr25519 slice: one 200-validator
set (100 keys of each type) and its commits through both packages'
ValidatorSet.verify_commit, verify_commit_light and
verify_commit_light_trusting (trust 1/3), and the duplicate-vote
evidence check on an sr25519 validator.

The port runs on the CPU (its plain PyTorch versions: K4 for the
ed25519 lanes, K9 for the sr25519 lanes), the reference on the XLA CPU
backend. Cases: a valid commit (with nil votes), one corrupted sr25519
signature, one corrupted ed25519 signature, and a commit short of 2/3
of the power. Both packages must pass, or raise the same exception
type with the same text. Tolerance: exact."""

import hashlib

import pytest
import torch

from tendermint_tpu.crypto import ed25519 as jed25519
from tendermint_tpu.crypto import sr25519 as jsr25519
from tendermint_tpu.evidence import verify as jev_verify
from tendermint_tpu.types import block as jblock
from tendermint_tpu.types import evidence as jevidence
from tendermint_tpu.types import validator as jvalidator
from tendermint_tpu.types import validator_set as jvalidator_set
from tendermint_tpu.types import vote as jvote
from tendermint_tpu_torch.crypto import ed25519 as ped25519
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.crypto import sr25519 as psr25519
from tendermint_tpu_torch.crypto import sr25519_ref as sr
from tendermint_tpu_torch.crypto import vectors
from tendermint_tpu_torch.crypto.cuda import sr_verify as sv
from tendermint_tpu_torch.crypto.cuda import verify as tv
from tendermint_tpu_torch.device import set_default_device
from tendermint_tpu_torch.evidence import verify as pev_verify
from tendermint_tpu_torch.types import block as pblock
from tendermint_tpu_torch.types import evidence as pevidence
from tendermint_tpu_torch.types import validator as pvalidator
from tendermint_tpu_torch.types import validator_set as pvalidator_set
from tendermint_tpu_torch.types import vote as pvote

N = 200
CHAIN = "torch-mixed"
PACKAGES = {
    "port": (ped25519, psr25519, pblock, pvalidator, pvalidator_set),
    "reference": (jed25519, jsr25519, jblock, jvalidator, jvalidator_set),
}


@pytest.fixture(autouse=True)
def _cpu():
    set_default_device("cpu")
    yield
    set_default_device(None)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The plain versions run no faster on more threads at these batch
    sizes; one keeps parallel test workers from starving each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keys(n: int):
    """n secrets: key i is sr25519 when i is odd, ed25519 when even.
    Returns [(is_sr, secret, public key bytes)]."""
    out = []
    for i in range(n):
        secret = hashlib.sha256(b"mixed-val-%d" % i).digest()
        if i % 2:
            out.append((True, secret, sr.public_key_from_mini(secret)))
        else:
            out.append((False, secret, ref.public_key_from_seed(secret)))
    return out


def _valset(pkg: str, keys, power: int = 10):
    ed, srk, _blk, val, vset = PACKAGES[pkg]
    return vset.ValidatorSet([
        val.Validator.new((srk.Sr25519PubKey if is_sr else ed.Ed25519PubKey)(
            pub), power) for is_sr, _, pub in keys])


def _sign(keys_by_pub, vs, msgs: dict[int, bytes]) -> dict[int, bytes]:
    """Signatures of msgs[slot] by validator slot's key: ed25519 by
    ed25519_ref, sr25519 in one sr_sign_batch."""
    out, sr_slots = {}, []
    for slot, msg in msgs.items():
        is_sr, secret = keys_by_pub[vs.validators[slot].pub_key.bytes()]
        if is_sr:
            sr_slots.append(slot)
        else:
            out[slot] = ref.sign(secret, msg)
    sigs = vectors.sr_sign_batch(
        [keys_by_pub[vs.validators[s].pub_key.bytes()][1] for s in sr_slots],
        [msgs[s] for s in sr_slots])
    out.update(zip(sr_slots, sigs))
    return out


def _build(case: str) -> dict:
    """{package: (valset, block_id, commit)} with identical content, and
    the slot a corrupted case corrupted."""
    keys = _keys(N)
    keys_by_pub = {pub: (is_sr, secret) for is_sr, secret, pub in keys}
    out, sigs, bad = {}, None, None
    for name in PACKAGES:
        blk = PACKAGES[name][2]
        vs = _valset(name, keys)
        bid = blk.BlockID(b"\x33" * 32, blk.PartSetHeader(2, b"\x44" * 32))
        slots = []
        for i, v in enumerate(vs.validators):
            if case == "insufficient" and i % 5 >= 3:
                slots.append(blk.CommitSig.absent())
                continue
            flag = blk.BlockIDFlag.NIL if i % 20 == 7 else blk.BlockIDFlag.COMMIT
            slots.append(blk.CommitSig(flag, v.address,
                                       1_753_928_000_000_000_000 + 7919 * i, b""))
        commit = blk.Commit(43, 0, bid, slots)
        if sigs is None:
            msgs = {i: commit.vote_sign_bytes(CHAIN, i)
                    for i in range(N) if not slots[i].is_absent()}
            sigs = _sign(keys_by_pub, vs, msgs)
            if case.startswith("corrupted"):
                want_sr = case == "corrupted_sr"
                bad = next(i for i in range(11, N) if (vs.validators[i].pub_key
                                                       .type_name == "sr25519")
                           == want_sr)
                s = sigs[bad]
                sigs[bad] = s[:40] + bytes([s[40] ^ 0x10]) + s[41:]
        for i, cs in enumerate(slots):
            cs.signature = sigs.get(i, b"")
        out[name] = (vs, bid, commit)
    return out, bad


@pytest.fixture(scope="module",
                params=["valid", "corrupted_sr", "corrupted_ed", "insufficient"])
def commits(request):
    made, bad = _build(request.param)
    return request.param, made, bad


def _outcome(entry: str, vs, bid, commit):
    try:
        if entry == "verify_commit":
            vs.verify_commit(CHAIN, bid, commit.height, commit)
        elif entry == "verify_commit_light":
            vs.verify_commit_light(CHAIN, bid, commit.height, commit)
        else:
            vs.verify_commit_light_trusting(CHAIN, commit, 1, 3)
    except Exception as e:  # compared across packages below
        return type(e).__name__, str(e)
    return None


def _expected(case: str, entry: str, bad):
    if case.startswith("corrupted"):
        return "VerificationError", f"invalid signature(s) at index(es) [{bad}]"
    if case == "insufficient" and entry != "verify_commit_light_trusting":
        return "VerificationError", "insufficient voting power: 1100 of 2000"
    return None


@pytest.mark.parametrize("entry", ["verify_commit", "verify_commit_light",
                                   "verify_commit_light_trusting"])
def test_mixed_commit_outcomes_match_reference(commits, entry, monkeypatch):
    case, made, bad = commits
    groups = []
    for mod, fn in ((tv, "verify_batch"), (sv, "verify_batch_sr")):
        real = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, lambda *a, _f=fn, _r=real, **k: (
            groups.append((_f, len(a[0]))) or _r(*a, **k)))
    got = _outcome(entry, *made["port"])
    want = _outcome(entry, *made["reference"])
    assert got == want
    assert got == _expected(case, entry, bad)
    vs = made["port"][0]
    assert sum(v.pub_key.type_name == "sr25519" for v in vs.validators) == N // 2
    if entry == "verify_commit" and case != "insufficient":
        # one device group of each key type: the 100 sr25519 lanes and
        # the ed25519 lanes (nil votes verify too)
        assert sorted(groups) == [("verify_batch", N // 2),
                                  ("verify_batch_sr", N // 2)]


def test_mixed_set_takes_no_tables():
    keys = _keys(N)
    assert _valset("port", keys).warm_device_tables() is None
    assert _valset("reference", keys).warm_device_tables() is None


def _evidence_case(pkg: str, case: str):
    """An sr25519 validator's two precommits at one height and round
    for two block ids, as DuplicateVoteEvidence in package pkg."""
    blk = PACKAGES[pkg][2]
    vote_mod, ev_mod = ((pvote, pevidence) if pkg == "port"
                        else (jvote, jevidence))
    keys = _keys(4)
    vs = _valset(pkg, keys, power=7)
    slot = next(i for i, v in enumerate(vs.validators)
                if v.pub_key.type_name == "sr25519")
    val = vs.validators[slot]
    mini = next(s for is_sr, s, pub in keys if pub == val.pub_key.bytes())
    bids = [blk.BlockID(bytes([b]) * 32, blk.PartSetHeader(1, bytes([b]) * 32))
            for b in (0x51, 0x52)]
    if case == "same_block_id":
        bids[1] = bids[0]
    votes = []
    for k, bid in enumerate(bids):
        v = vote_mod.Vote(vote_mod.VoteType.PRECOMMIT, 12, 1, bid,
                          1_700_000_000_000_000_000 + k, val.address, slot)
        v.signature = sr.sign(mini, v.sign_bytes(CHAIN))
        votes.append(v)
    if case == "wrong_signature":
        s = votes[1].signature
        votes[1].signature = s[:8] + bytes([s[8] ^ 1]) + s[9:]
    ev = ev_mod.DuplicateVoteEvidence.from_votes(votes[0], votes[1],
                                                 1_700_000_000, vs)
    if case == "wrong_power":
        ev.validator_power += 1
    return ev, vs


@pytest.mark.parametrize("case", ["valid", "wrong_signature",
                                  "same_block_id", "wrong_power"])
def test_duplicate_vote_matches_reference(case):
    outcomes = []
    for pkg, verify in (("port", pev_verify), ("reference", jev_verify)):
        ev, vs = _evidence_case(pkg, case)
        try:
            ev.validate_basic()
            basic = None
        except ValueError as e:
            basic = str(e)
        try:
            verify.verify_duplicate_vote(ev, CHAIN, vs, 1_700_000_000)
            outcomes.append((basic, ev.height(), None))
        except verify.EvidenceError as e:
            outcomes.append((basic, ev.height(), str(e)))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][2] == {
        "valid": None,
        "wrong_signature": "invalid signature on vote B",
        "same_block_id": "votes are for the same block id",
        "wrong_power": "validator power mismatch: 8 != 7",
    }[case]
