"""Port parity for the slice as a whole: one 200-validator set and its
commits through both packages' ValidatorSet.verify_commit,
verify_commit_light and verify_commit_light_trusting (trust 1/3).

The port runs on the CPU (its plain PyTorch versions), the reference
on the XLA CPU backend. Cases: a valid commit (with nil votes), one
corrupted signature, and a commit short of 2/3 of the power. Both
packages must pass, or raise the same exception type with the same
text. Tolerance: exact."""

import hashlib

import pytest

from tendermint_tpu.crypto import ed25519 as jed25519
from tendermint_tpu.types import block as jblock
from tendermint_tpu.types import validator as jvalidator
from tendermint_tpu.types import validator_set as jvalidator_set
from tendermint_tpu_torch.crypto import ed25519 as ped25519
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.device import set_default_device
from tendermint_tpu_torch.types import block as pblock
from tendermint_tpu_torch.types import validator as pvalidator
from tendermint_tpu_torch.types import validator_set as pvalidator_set

N = 200
CHAIN = "torch-commit"
PACKAGES = {
    "port": (ped25519, pblock, pvalidator, pvalidator_set),
    "reference": (jed25519, jblock, jvalidator, jvalidator_set),
}


@pytest.fixture(autouse=True)
def _cpu():
    set_default_device("cpu")
    yield
    set_default_device(None)


def _build(case: str) -> dict:
    """{package: (valset, block_id, commit)} with identical content."""
    seeds = [hashlib.sha256(b"commit-val-%d" % i).digest() for i in range(N)]
    pubs = [ref.public_key_from_seed(s) for s in seeds]
    seed_of = dict(zip(pubs, seeds))
    out = {}
    sigs = None
    for name, (ed, blk, val, vset) in PACKAGES.items():
        vs = vset.ValidatorSet([val.Validator.new(ed.Ed25519PubKey(p), 10)
                                for p in pubs])
        bid = blk.BlockID(b"\x11" * 32, blk.PartSetHeader(3, b"\x22" * 32))
        slots = []
        for i, v in enumerate(vs.validators):
            if case == "insufficient" and i % 5 >= 3:
                slots.append(blk.CommitSig.absent())
                continue
            flag = blk.BlockIDFlag.NIL if i % 20 == 7 else blk.BlockIDFlag.COMMIT
            slots.append(blk.CommitSig(flag, v.address,
                                       1_753_928_000_000_000_000 + 7919 * i, b""))
        commit = blk.Commit(42, 0, bid, slots)
        if sigs is None:
            sigs = []
            for i, v in enumerate(vs.validators):
                if slots[i].is_absent():
                    sigs.append(b"")
                    continue
                pub = v.pub_key.bytes()
                sig = ref.sign(seed_of[pub], commit.vote_sign_bytes(CHAIN, i))
                if case == "corrupted" and i == 5:
                    sig = sig[:10] + bytes([sig[10] ^ 0x20]) + sig[11:]
                sigs.append(sig)
        for cs, sig in zip(slots, sigs):
            cs.signature = sig
        out[name] = (vs, bid, commit)
    return out


@pytest.fixture(scope="module", params=["valid", "corrupted", "insufficient"])
def commits(request):
    return request.param, _build(request.param)


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


EXPECTED = {
    ("valid", "verify_commit"): None,
    ("valid", "verify_commit_light"): None,
    ("valid", "verify_commit_light_trusting"): None,
    ("corrupted", "verify_commit"): (
        "VerificationError", "invalid signature(s) at index(es) [5]"),
    ("corrupted", "verify_commit_light"): (
        "VerificationError", "invalid signature(s) at index(es) [5]"),
    ("corrupted", "verify_commit_light_trusting"): (
        "VerificationError", "invalid signature(s) at index(es) [5]"),
    ("insufficient", "verify_commit"): (
        "VerificationError", "insufficient voting power: 1100 of 2000"),
    ("insufficient", "verify_commit_light"): (
        "VerificationError", "insufficient voting power: 1100 of 2000"),
    ("insufficient", "verify_commit_light_trusting"): None,
}


@pytest.mark.parametrize("entry", ["verify_commit", "verify_commit_light",
                                   "verify_commit_light_trusting"])
def test_commit_outcomes_match_reference(commits, entry):
    case, made = commits
    got = _outcome(entry, *made["port"])
    want = _outcome(entry, *made["reference"])
    assert got == want
    assert got == EXPECTED[(case, entry)]
