"""Port parity for the vote scheduler's host layer: VoteSignBatch,
VoteSet and HeightVoteSet (types/sign_batch.py, types/vote_set.py,
consensus/cstypes.py), against the JAX package on votes both packages
build from the same seeds.

VoteSignBatch's templates, patches and groups must equal the
reference's byte for byte on mixed-type, nil and edge-timestamp votes,
and its MAX_GROUPS cap must raise the same error. VoteSet and
HeightVoteSet run the shapes of tests/test_vote_set.py case by case in
both packages; every return value, exception (class and text), tally,
bit array and commit must be equal. No kernel runs. Tolerance: exact
everywhere."""

import hashlib
import types

import numpy as np
import pytest

from tendermint_tpu.consensus import cstypes as jcstypes
from tendermint_tpu.crypto import ed25519 as jed25519
from tendermint_tpu.libs import bits as jbits
from tendermint_tpu.types import block as jblock
from tendermint_tpu.types import sign_batch as jsign_batch
from tendermint_tpu.types import validator as jvalidator
from tendermint_tpu.types import validator_set as jvalidator_set
from tendermint_tpu.types import vote as jvote
from tendermint_tpu.types import vote_set as jvote_set
from tendermint_tpu_torch.consensus import cstypes as pcstypes
from tendermint_tpu_torch.crypto import ed25519 as ped25519
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.libs import bits as pbits
from tendermint_tpu_torch.types import block as pblock
from tendermint_tpu_torch.types import sign_batch as psign_batch
from tendermint_tpu_torch.types import validator as pvalidator
from tendermint_tpu_torch.types import validator_set as pvalidator_set
from tendermint_tpu_torch.types import vote as pvote
from tendermint_tpu_torch.types import vote_set as pvote_set

CHAIN = "torch-vote-chain"
TS = 1_753_928_000_123_456_789
PACKAGES = {
    "port": types.SimpleNamespace(
        ed=ped25519, block=pblock, vote=pvote, vote_set=pvote_set,
        validator=pvalidator, vset=pvalidator_set, sign_batch=psign_batch,
        cstypes=pcstypes, bits=pbits),
    "reference": types.SimpleNamespace(
        ed=jed25519, block=jblock, vote=jvote, vote_set=jvote_set,
        validator=jvalidator, vset=jvalidator_set, sign_batch=jsign_batch,
        cstypes=jcstypes, bits=jbits),
}

_SIGS: dict = {}


def sign(seed: bytes, msg: bytes) -> bytes:
    """ed25519_ref.sign, memoized so both packages sign once."""
    if (seed, msg) not in _SIGS:
        _SIGS[seed, msg] = ref.sign(seed, msg)
    return _SIGS[seed, msg]


def make_valset(p, n: int, tag: bytes = b"vote-val", power=lambda i: 10):
    """One package's n-validator ed25519 set from seeds, and each key's
    seed by public key."""
    seeds = [hashlib.sha256(b"%s-%d" % (tag, i)).digest() for i in range(n)]
    pubs = [ref.public_key_from_seed(s) for s in seeds]
    vals = p.vset.ValidatorSet([p.validator.Validator.new(
        p.ed.Ed25519PubKey(k), power(i)) for i, k in enumerate(pubs)])
    return vals, dict(zip(pubs, seeds))


def block_id(p, tag: int):
    return p.block.BlockID(bytes([tag]) * 32,
                           p.block.PartSetHeader(1, bytes([tag + 1]) * 32))


def make_vote(p, vals, seed_of, idx, *, bid=0xAA, height=1, round_=0,
              type_="PREVOTE", ts=TS, chain_id=CHAIN, signer=None):
    """Validator idx's signed vote (bid None: nil); `signer` signs in
    another validator's place (an address mismatch when idx differs)."""
    v = vals.validators[idx if signer is None else signer]
    vote = p.vote.Vote(
        type=getattr(p.vote.VoteType, type_), height=height, round=round_,
        block_id=None if bid is None else block_id(p, bid), timestamp=ts,
        validator_address=v.address, validator_index=idx)
    vote.signature = sign(seed_of[v.pub_key.bytes()],
                          vote.sign_bytes(chain_id))
    return vote


def norm(x):
    """A package-free form of a result, for equality across packages."""
    if x is None or isinstance(x, (bool, int, str, bytes)):
        return x
    if isinstance(x, (tuple, list)):
        return type(x)(norm(e) for e in x)
    name = type(x).__name__
    if name == "BlockID":
        return ("BlockID", x.key())
    if name in ("Vote", "Commit"):
        return (name, x.to_bytes())
    if name == "BitArray":
        return ("BitArray", x.size, x.to_bytes())
    raise TypeError(f"cannot normalise {name}")


def outcome(fn):
    """fn()'s normalised result, or its exception's class and text (and
    for a ConflictingVoteError both votes)."""
    try:
        return ("ok", norm(fn()))
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        extra = ()
        if type(e).__name__ == "ConflictingVoteError":
            extra = (norm(e.existing), norm(e.new))
        return ("raise", type(e).__name__, str(e), *extra)


# -- VoteSignBatch -------------------------------------------------------


def _mixed_votes(p, n: int = 96):
    """Seeded mixed-type votes: prevotes and precommits over two heights
    and rounds, for three blocks and nil, with edge timestamps."""
    rng = np.random.default_rng(7)
    vals, seed_of = make_valset(p, 16)
    edge = [1, 999_999_999, 1_000_000_000, 1_000_000_001,
            (1 << 31) * 1_000_000_000, TS]
    votes = []
    for _ in range(n):
        ts = edge[int(rng.integers(len(edge)))] + int(rng.integers(3))
        bid = [None, 0xAA, 0xBB, 0xCC][int(rng.integers(4))]
        votes.append(make_vote(
            p, vals, seed_of, int(rng.integers(16)), bid=bid,
            height=[7, 300][int(rng.integers(2))],
            round_=int(rng.integers(2)),
            type_=["PREVOTE", "PRECOMMIT"][int(rng.integers(2))], ts=ts))
    return votes


def test_vote_sign_batch_equals_reference():
    batches = {name: p.sign_batch.VoteSignBatch(CHAIN, _mixed_votes(p))
               for name, p in PACKAGES.items()}
    port, want = batches["port"], batches["reference"]
    for f in ("pre", "pre_len", "suf", "suf_len", "group", "patch",
              "split", "patch_len"):
        np.testing.assert_array_equal(getattr(port, f), getattr(want, f),
                                      err_msg=f)
    assert port.pre.shape[0] > 4  # several template groups
    full = port.materialize()
    assert full == want.materialize()
    assert [port.host_assemble(i) for i in range(len(port))] == full
    assert port.anchor_bytes() == full[0]
    assert port.max_msg_len() == want.max_msg_len()


@pytest.mark.parametrize("groups", [psign_batch.MAX_GROUPS,
                                    psign_batch.MAX_GROUPS + 1])
def test_vote_sign_batch_group_cap(groups):
    """One group per distinct block id: MAX_GROUPS fits, one more
    raises the reference's ValueError (which sends structured_or_bytes
    to the full bytes)."""
    assert psign_batch.MAX_GROUPS == jsign_batch.MAX_GROUPS == 32
    got = {}
    for name, p in PACKAGES.items():
        vals, seed_of = make_valset(p, 4)
        votes = [make_vote(p, vals, seed_of, g % 4, bid=g)
                 for g in range(groups)]
        got[name] = outcome(
            lambda: p.sign_batch.VoteSignBatch(CHAIN, votes).pre.shape[0])
    assert got["port"] == got["reference"]
    if groups > psign_batch.MAX_GROUPS:
        assert got["port"] == ("raise", "ValueError", "too many vote groups "
                               "for one structured launch")
    else:
        assert got["port"] == ("ok", groups)


# -- VoteSet / HeightVoteSet ---------------------------------------------


def _set(p, n=4, height=1, round_=0, type_="PREVOTE"):
    vals, seed_of = make_valset(p, n)
    vs = p.vote_set.VoteSet(CHAIN, height, round_,
                            getattr(p.vote.VoteType, type_), vals)
    return vs, vals, seed_of


def _state(vs):
    """Everything a VoteSet exposes after a scenario."""
    return [norm(vs.two_thirds_majority()), vs.has_two_thirds_majority(),
            vs.has_two_thirds_any(), vs.has_all(), vs.sum,
            norm(vs.bit_array()),
            [norm(vs.get_by_index(i)) for i in range(vs.size())]]


def sc_majority_progression(p):
    vs, vals, so = _set(p)
    out = []
    for i in range(3):
        out.append(outcome(lambda: vs.add_vote(make_vote(p, vals, so, i))))
        out.append(_state(vs))
    return out


def sc_duplicate_noop(p):
    vs, vals, so = _set(p)
    v = make_vote(p, vals, so, 0)
    out = [outcome(lambda: vs.add_vote(v)), outcome(lambda: vs.add_vote(v)),
           vs.is_duplicate(v)]
    other = make_vote(p, vals, so, 0, ts=TS + 1)  # same block, other sig
    out += [vs.is_duplicate(other), outcome(lambda: vs.add_vote(other))]
    return out + [_state(vs)]


def sc_bad_signature(p):
    vs, vals, so = _set(p)
    v = make_vote(p, vals, so, 0)
    v.signature = bytes(64)
    u = make_vote(p, vals, so, 1)
    u.signature = b""
    return [outcome(lambda: vs.add_vote(v)), outcome(lambda: vs.add_vote(u)),
            _state(vs)]


def sc_address_mismatch(p):
    vs, vals, so = _set(p)
    wrong = make_vote(p, vals, so, 1, signer=0)  # validator 0 in slot 1
    far = make_vote(p, vals, so, 0)
    far.validator_index = 9
    neg = make_vote(p, vals, so, 0)
    neg.validator_index = -1
    return [outcome(lambda: vs.add_vote(wrong)),
            outcome(lambda: vs.add_vote(far)),
            outcome(lambda: vs.add_vote(neg)),
            outcome(lambda: vs.add_vote(None)), _state(vs)]


def sc_conflict_both_votes(p):
    vs, vals, so = _set(p)
    v1 = make_vote(p, vals, so, 0, bid=0xAA)
    v2 = make_vote(p, vals, so, 0, bid=0xCC)
    return [outcome(lambda: vs.add_vote(v1)), outcome(lambda: vs.add_vote(v2)),
            _state(vs)]


def sc_peer_maj23(p):
    vs, vals, so = _set(p)
    out = [outcome(lambda: vs.add_vote(make_vote(p, vals, so, i)))
           for i in range(3)]
    out.append(outcome(lambda: vs.set_peer_maj23("peer1", block_id(p, 0xCC))))
    out.append(outcome(lambda: vs.set_peer_maj23("peer1", block_id(p, 0xCC))))
    out.append(outcome(lambda: vs.set_peer_maj23("peer1", block_id(p, 0xAA))))
    bad = p.block.BlockID(b"\x01" * 5, None)
    out.append(outcome(lambda: vs.set_peer_maj23("peer2", bad)))
    out.append(outcome(lambda: vs.add_vote(make_vote(p, vals, so, 0,
                                                     bid=0xCC))))
    out.append(norm(vs.bit_array_by_block_id(block_id(p, 0xCC))))
    out.append(norm(vs.bit_array_by_block_id(block_id(p, 0xDD))))
    out.append(norm(vs.get_vote(0, block_id(p, 0xCC).key())))
    return out + [_state(vs)]


def sc_nil_votes(p):
    vs, vals, so = _set(p, 3, type_="PRECOMMIT")
    out = [outcome(lambda: vs.add_vote(make_vote(
        p, vals, so, i, bid=None, type_="PRECOMMIT"))) for i in range(3)]
    return out + [_state(vs), outcome(vs.make_commit)]


def sc_make_commit(p):
    vs, vals, so = _set(p, 4, height=2, round_=1, type_="PRECOMMIT")
    for i in range(3):
        vs.add_vote(make_vote(p, vals, so, i, height=2, round_=1,
                              type_="PRECOMMIT", ts=TS + i))
    vs.add_vote(make_vote(p, vals, so, 3, bid=None, height=2, round_=1,
                          type_="PRECOMMIT"))
    commit = vs.make_commit()
    vals.verify_commit(CHAIN, block_id(p, 0xAA), 2, commit)
    return [norm(commit), _state(vs)]


def sc_make_commit_needs_block_majority(p):
    vs, vals, so = _set(p, type_="PRECOMMIT")
    out = [outcome(vs.make_commit)]
    for i in range(3):
        vs.add_vote(make_vote(p, vals, so, i, bid=None, type_="PRECOMMIT"))
    prevotes, _, _ = _set(p)
    return out + [outcome(vs.make_commit), outcome(prevotes.make_commit)]


def sc_wrong_height_round_type(p):
    vs, vals, so = _set(p)
    return [outcome(lambda: vs.add_vote(make_vote(p, vals, so, 0, height=2))),
            outcome(lambda: vs.add_vote(make_vote(p, vals, so, 0, round_=1))),
            outcome(lambda: vs.add_vote(make_vote(p, vals, so, 0,
                                                  type_="PRECOMMIT"))),
            _state(vs)]


def sc_pre_verified(p):
    vs, vals, so = _set(p)
    v = make_vote(p, vals, so, 0)
    v.signature = b"z" * 64  # would fail verification
    return [outcome(lambda: vs.add_vote(v, verify=False)),
            outcome(lambda: vs.add_vote(make_vote(p, vals, so, 1, bid=0xCC),
                                        verify=False)),
            _state(vs)]


def sc_height_vote_set(p):
    """Routing by round and type, catch-up rounds (two a peer), set_round
    and the proof-of-lock round."""
    vals, so = make_valset(p, 4)
    hvs = p.cstypes.HeightVoteSet(CHAIN, 3, vals)
    out = []
    for i in range(3):
        out.append(outcome(lambda: hvs.add_vote(
            make_vote(p, vals, so, i, height=3, round_=1), "pA")))
    out.append(outcome(hvs.pol_info))
    for r in (5, 6, 7):
        out.append(outcome(lambda: hvs.add_vote(
            make_vote(p, vals, so, 0, height=3, round_=r), "pB")))
    out.append(outcome(lambda: hvs.add_vote(
        make_vote(p, vals, so, 1, height=3, round_=9), "pC", verify=False)))
    bad = make_vote(p, vals, so, 2, height=3)
    bad.type = 7
    out.append(outcome(lambda: hvs.add_vote(bad)))
    out.append(outcome(lambda: hvs.set_round(2)))
    out.append(outcome(lambda: hvs.set_round(1)))
    out.append([hvs.prevotes(r) is not None for r in range(11)])
    out.append(outcome(lambda: hvs.set_peer_maj23(
        12, p.vote.VoteType.PRECOMMIT, "pD", block_id(p, 0xAA))))
    out.append(_state(hvs.precommits(12)))
    out.append([_state(hvs.prevotes(r)) for r in (0, 1, 5, 6, 9)])
    return out


SCENARIOS = {name[3:]: fn for name, fn in globals().items()
             if name.startswith("sc_")}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_vote_set_equals_reference(scenario):
    got = {name: SCENARIOS[scenario](p) for name, p in PACKAGES.items()}
    assert got["port"] == got["reference"]


def test_conflicting_vote_carries_both_votes():
    """The port's ConflictingVoteError holds both votes and the first
    one stays counted (the raw material of DuplicateVoteEvidence)."""
    p = PACKAGES["port"]
    vs, vals, so = _set(p)
    v1 = make_vote(p, vals, so, 0, bid=0xAA)
    v2 = make_vote(p, vals, so, 0, bid=0xCC)
    assert vs.add_vote(v1)
    with pytest.raises(pvote_set.ConflictingVoteError) as ei:
        vs.add_vote(v2)
    assert ei.value.existing is v1 and ei.value.new is v2
    assert vs.get_by_index(0) is v1


def test_max_votes_count_bound():
    """A set above MAX_VOTES_COUNT is refused, as in the reference."""
    got = {}
    for name, p in PACKAGES.items():
        vals, _ = make_valset(p, 2)
        vals.validators = vals.validators * (p.vote.MAX_VOTES_COUNT // 2 + 1)
        got[name] = outcome(lambda: p.vote_set.VoteSet(
            CHAIN, 1, 0, p.vote.VoteType.PREVOTE, vals))
    assert got["port"] == got["reference"]
    assert got["port"][0] == "raise"
