"""Port parity for the block codec: Header, Data, Block, Part, PartSet,
EvidenceData (with DuplicateVoteEvidence), Vote's wire form, the merkle
proofs, BitArray and the fast-sync messages.

Both packages build the same chain from the same seeds (8 validators,
17 blocks, one carrying duplicate-vote evidence, one large enough for
several parts): every hash, encoding, part proof and header must equal
the reference's byte for byte, and blocks must cross between the
packages by to_bytes/from_bytes in both directions. No kernel runs.
Tolerance: exact everywhere."""

import hashlib
import types

import numpy as np
import pytest

from tendermint_tpu.blockchain import msgs as jmsgs
from tendermint_tpu.crypto import ed25519 as jed25519
from tendermint_tpu.crypto import merkle as jmerkle
from tendermint_tpu.libs import bits as jbits
from tendermint_tpu.types import block as jblock
from tendermint_tpu.types import evidence as jevidence
from tendermint_tpu.types import validator as jvalidator
from tendermint_tpu.types import validator_set as jvalidator_set
from tendermint_tpu.types import vote as jvote
from tendermint_tpu_torch.blockchain import msgs as pmsgs
from tendermint_tpu_torch.crypto import ed25519 as ped25519
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.crypto import merkle as pmerkle
from tendermint_tpu_torch.libs import bits as pbits
from tendermint_tpu_torch.types import block as pblock
from tendermint_tpu_torch.types import evidence as pevidence
from tendermint_tpu_torch.types import validator as pvalidator
from tendermint_tpu_torch.types import validator_set as pvalidator_set
from tendermint_tpu_torch.types import vote as pvote

CHAIN = "torch-block-chain"
N_VALS = 8
START = 121  # the chain crosses height 128
N_BLOCKS = 17
BASE_TS = 1_753_928_000_000_000_000
PACKAGES = {
    "port": types.SimpleNamespace(
        ed=ped25519, block=pblock, evidence=pevidence, vote=pvote,
        validator=pvalidator, vset=pvalidator_set, msgs=pmsgs,
        merkle=pmerkle, bits=pbits),
    "reference": types.SimpleNamespace(
        ed=jed25519, block=jblock, evidence=jevidence, vote=jvote,
        validator=jvalidator, vset=jvalidator_set, msgs=jmsgs,
        merkle=jmerkle, bits=jbits),
}

_SIGS: dict = {}


def sign(seed: bytes, msg: bytes) -> bytes:
    """ed25519_ref.sign, memoized so both packages sign once."""
    if (seed, msg) not in _SIGS:
        _SIGS[seed, msg] = ref.sign(seed, msg)
    return _SIGS[seed, msg]


def make_chain(p, n_vals: int = N_VALS, start: int = START,
               n_blocks: int = N_BLOCKS, *, seed: int = 0,
               chain_id: str = CHAIN, rounds: dict | None = None,
               evidence_at: tuple = (), big_at: tuple = ()):
    """One package's chain, made from `seed`: n_vals ed25519 validators
    of power 10 and blocks start .. start + n_blocks - 1. Block h + 1's
    LastCommit is signed by every validator over block h's real
    BlockID (hash, part set header), with per-slot timestamps, in round
    rounds.get(h, 0); the first block's LastCommit is signed over a
    BlockID made from `start` (the block before the chain). Blocks at
    `evidence_at` carry a DuplicateVoteEvidence of validator 0; blocks
    at `big_at` carry ~150 kB of transactions (three parts).
    Returns (valset, blocks, seed_of)."""
    rounds = rounds or {}
    rng = np.random.default_rng(seed)
    seeds = [hashlib.sha256(b"block-val-%d-%d" % (seed, i)).digest()
             for i in range(n_vals)]
    pubs = [ref.public_key_from_seed(s) for s in seeds]
    seed_of = dict(zip(pubs, seeds))
    vals = p.vset.ValidatorSet([p.validator.Validator.new(
        p.ed.Ed25519PubKey(k), 10) for k in pubs])
    vhash = vals.hash()
    blocks = []
    # the block before the chain (a node that state-synced to it)
    tag = hashlib.sha256(b"before-%d" % start).digest()
    last_bid = p.block.BlockID(tag, p.block.PartSetHeader(1, tag))
    last_commit = sign_commit(p, vals, seed_of, start - 1, 0, last_bid,
                              chain_id)
    for h in range(start, start + n_blocks):
        n_tx = 50_000 if h in big_at else 4
        txs = [rng.bytes(int(rng.integers(1, 9))) for _ in range(n_tx)]
        ev = []
        if h in evidence_at:
            ev.append(duplicate_vote(p, vals, seed_of, h - 1, chain_id))
        evd = p.evidence.EvidenceData(ev)
        header = p.block.Header(
            version_block=11, version_app=1, chain_id=chain_id, height=h,
            time=BASE_TS + h * 1_000_000_007, last_block_id=last_bid,
            last_commit_hash=last_commit.hash(),
            data_hash=p.block.Data(txs).hash(), validators_hash=vhash,
            next_validators_hash=vhash, consensus_hash=rng.bytes(32),
            app_hash=rng.bytes(32), last_results_hash=b"",
            evidence_hash=evd.hash(),
            proposer_address=vals.validators[h % n_vals].address)
        block = p.block.Block(header, p.block.Data(txs), evd, last_commit)
        blocks.append(block)
        bid = p.block.BlockID(block.hash(), block.make_part_set().header())
        last_commit = sign_commit(p, vals, seed_of, h, rounds.get(h, 0), bid,
                                  chain_id)
        last_bid = bid
    return vals, blocks, seed_of


def sign_commit(p, vals, seed_of, height, round_, bid, chain_id=CHAIN):
    """Every validator's precommit for bid, per-slot timestamps."""
    cs = [p.block.CommitSig(p.block.BlockIDFlag.COMMIT, v.address,
                            BASE_TS + height * 1_000_000_007 + 977 * i, b"")
          for i, v in enumerate(vals.validators)]
    commit = p.block.Commit(height, round_, bid, cs)
    for i, v in enumerate(vals.validators):
        cs[i].signature = sign(seed_of[v.pub_key.bytes()],
                               commit.vote_sign_bytes(chain_id, i))
    return commit


def duplicate_vote(p, vals, seed_of, height, chain_id=CHAIN):
    """Validator 0's two conflicting precommits at `height`."""
    v0 = vals.validators[0]
    votes = []
    for tag in (b"\x0a", b"\x0b"):
        bid = p.block.BlockID(tag * 32, p.block.PartSetHeader(1, tag * 32))
        vote = p.vote.Vote(type=p.vote.VoteType.PRECOMMIT, height=height,
                           round=0, block_id=bid, timestamp=BASE_TS + height,
                           validator_address=v0.address, validator_index=0)
        vote.signature = sign(seed_of[v0.pub_key.bytes()],
                              vote.sign_bytes(chain_id))
        votes.append(vote)
    return p.evidence.DuplicateVoteEvidence.from_votes(
        votes[0], votes[1], BASE_TS + height, vals)


@pytest.fixture(scope="module")
def chains():
    return {name: make_chain(p, evidence_at=(START + 3,), big_at=(START + 5,))
            for name, p in PACKAGES.items()}


def test_headers_blocks_and_encodings_match(chains):
    _, port, _ = chains["port"]
    _, jref, _ = chains["reference"]
    assert len(port) == len(jref) == N_BLOCKS
    for b, r in zip(port, jref):
        assert b.header.hash() == r.header.hash()
        assert b.hash() == r.hash() and len(b.hash()) == 32
        assert b.header.to_proto().finish() == r.header.to_proto().finish()
        assert b.to_bytes() == r.to_bytes()
        assert b.data.hash() == r.data.hash()
        assert b.last_commit.to_bytes() == r.last_commit.to_bytes()
        assert b.last_commit.hash() == r.last_commit.hash()
    assert [b.header.height for b in port] == list(
        range(START, START + N_BLOCKS))


@pytest.mark.parametrize("part_size", [pblock.BLOCK_PART_SIZE, 997])
def test_part_sets_match(chains, part_size):
    _, port, _ = chains["port"]
    _, jref, _ = chains["reference"]
    totals = set()
    for b, r in zip(port, jref):
        ps, rs = b.make_part_set(part_size), r.make_part_set(part_size)
        assert (ps.total, ps.hash, ps.byte_size, ps.count) == (
            rs.total, rs.hash, rs.byte_size, rs.count)
        assert ps.header() == pblock.PartSetHeader(rs.total, rs.hash)
        assert ps.parts_bitarray.to_bytes() == rs.parts_bitarray.to_bytes()
        assert [x.to_bytes() for x in ps.parts] == [
            x.to_bytes() for x in rs.parts]
        assert ps.assemble() == rs.assemble() == b.to_bytes()
        assert b.block_id(part_size) == pblock.BlockID(
            r.hash(), pblock.PartSetHeader(rs.total, rs.hash))
        totals.add(ps.total)
    assert max(totals) >= 3  # the large block spans several parts


def test_evidence_data_and_vote_encodings_match(chains):
    _, port, _ = chains["port"]
    _, jref, _ = chains["reference"]
    assert pevidence.EvidenceData().hash() == jevidence.EvidenceData().hash()
    assert pevidence.EvidenceData().to_proto() is None
    with_ev = [(b, r) for b, r in zip(port, jref) if b.evidence.evidence]
    assert len(with_ev) == 1
    b, r = with_ev[0]
    pe, je = b.evidence.evidence[0], r.evidence.evidence[0]
    assert pe.to_bytes() == je.to_bytes() and pe.hash() == je.hash()
    assert b.evidence.hash() == r.evidence.hash() == b.header.evidence_hash
    assert b.evidence.to_proto().finish() == r.evidence.to_proto().finish()
    for pv, jv in ((pe.vote_a, je.vote_a), (pe.vote_b, je.vote_b)):
        assert pv.to_bytes() == jv.to_bytes()
        assert pvote.Vote.from_bytes(jv.to_bytes()) == pv
        assert jvote.Vote.from_bytes(pv.to_bytes()).to_bytes() == pv.to_bytes()
    back = pevidence.evidence_from_bytes(je.to_bytes())
    assert back == pe and back.to_bytes() == je.to_bytes()


def test_vote_verify_matches_reference(chains):
    pvals, port, seed_of = chains["port"]
    jvals, _, _ = chains["reference"]
    pe = next(b for b in port if b.evidence.evidence).evidence.evidence[0]
    je = jevidence.evidence_from_bytes(pe.to_bytes())
    pk_p, pk_j = pvals.validators[0].pub_key, jvals.validators[0].pub_key
    assert pe.vote_a.verify(CHAIN, pk_p) is je.vote_a.verify(CHAIN, pk_j) is True
    assert pe.vote_a.verify("other", pk_p) is je.vote_a.verify(
        "other", pk_j) is False
    other = pvals.validators[1].pub_key  # another address
    assert pe.vote_a.verify(CHAIN, other) is je.vote_a.verify(
        CHAIN, jvals.validators[1].pub_key) is False


def test_light_client_attack_evidence_is_unsupported():
    """Field 2 of the Evidence oneof (light-client-attack evidence) now
    decodes as the reference decodes it (light/types.py; the test's name
    dates from before that port): this malformed inner message fails
    with the reference's error, and a well-formed one round-trips
    (tests/test_torch_light.py)."""
    data = jevidence.Writer().bytes(2, b"\x08\x01").finish()
    with pytest.raises(ValueError, match="^truncated bytes field$"):
        jevidence.evidence_from_bytes(data)
    with pytest.raises(ValueError, match="^truncated bytes field$"):
        pevidence.evidence_from_bytes(data)
    with pytest.raises(ValueError, match="^unknown evidence encoding$"):
        pevidence.evidence_from_bytes(b"")


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_blocks_round_trip_across_packages(chains, direction):
    src, dst = (("reference", pblock) if direction == "reference_to_port"
                else ("port", jblock))
    _, blocks, _ = chains[src]
    for b in blocks:
        data = b.to_bytes()
        back = dst.Block.from_bytes(data)
        assert back.to_bytes() == data and back.hash() == b.hash()
        assert back.make_part_set().hash == b.make_part_set().hash
        back.validate_basic()
        h = dst.Header.from_bytes(b.header.to_proto().finish())
        assert h.hash() == b.header.hash()
        c = dst.Commit.from_bytes(b.last_commit.to_bytes())
        assert c.to_bytes() == b.last_commit.to_bytes()
        assert [s.timestamp for s in c.signatures] == [
            s.timestamp for s in b.last_commit.signatures]


@pytest.mark.parametrize("fault", ["last_commit_hash", "data", "evidence",
                                   "proposer"])
def test_validate_basic_rejects_as_the_reference(chains, fault):
    outcomes = {}
    for name, p in PACKAGES.items():
        block = p.block.Block.from_bytes(chains[name][1][4].to_bytes())
        if fault == "last_commit_hash":
            block.last_commit.signatures[0].timestamp += 1
            block.last_commit._hash = None
        elif fault == "data":
            block.data.txs.append(b"extra")
        elif fault == "evidence":
            block.evidence.evidence.append(
                chains[name][1][3].evidence.evidence[0])
        else:
            block.header.proposer_address = b"\x01" * 19
        try:
            block.validate_basic()
            outcomes[name] = None
        except ValueError as e:
            outcomes[name] = str(e)
    assert outcomes["port"] == outcomes["reference"] is not None


def test_part_proofs_verify_and_reject_a_flipped_aunt(chains):
    _, port, _ = chains["port"]
    _, jref, _ = chains["reference"]
    big = next(i for i, b in enumerate(port) if b.make_part_set().total > 1)
    for size in (pblock.BLOCK_PART_SIZE, 997):
        ps = port[big].make_part_set(size)
        rs = jref[big].make_part_set(size)
        empty = pblock.PartSet(ps.total, ps.hash)
        for part, rpart in zip(ps.parts, rs.parts):
            assert part.proof.verify(ps.hash, part.bytes_)
            assert part.proof.compute_root() == rpart.proof.compute_root()
            flipped = list(part.proof.aunts)
            flipped[0] = bytes([flipped[0][0] ^ 1]) + flipped[0][1:]
            bad = pmerkle.Proof(part.proof.total, part.proof.index,
                                part.proof.leaf_hash, flipped)
            jbad = jmerkle.Proof(part.proof.total, part.proof.index,
                                 part.proof.leaf_hash, flipped)
            assert not bad.verify(ps.hash, part.bytes_)
            assert not jbad.verify(rs.hash, part.bytes_)
            assert not part.proof.verify(ps.hash, part.bytes_ + b"\x00")
            # a part from the reference, through its bytes
            assert empty.add_part(pblock.Part.from_bytes(rpart.to_bytes()))
            with pytest.raises(ValueError, match="invalid part proof"):
                pblock.PartSet(ps.total, ps.hash).add_part(pblock.Part(
                    part.index, part.bytes_, bad))
        assert empty.is_complete() and empty.assemble() == port[big].to_bytes()


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 8, 13])
def test_merkle_proofs_match_reference(n):
    items = [hashlib.sha256(b"leaf %d" % i).digest()[: i % 7 + 1]
             for i in range(n)]
    root, proofs = pmerkle.proofs_from_byte_slices(items)
    jroot, jproofs = jmerkle.proofs_from_byte_slices(items)
    assert root == jroot == pmerkle.hash_from_byte_slices(items)
    assert [(q.total, q.index, q.leaf_hash, q.aunts) for q in proofs] == [
        (q.total, q.index, q.leaf_hash, q.aunts) for q in jproofs]
    for q, item in zip(proofs, items):
        assert q.verify(root, item)
    assert pmerkle.Proof(n, n, b"", []).compute_root() is None


def test_bit_array_matches_reference_on_seeded_operations():
    rng = np.random.default_rng(5)
    port = {k: pbits.BitArray(5 * k) for k in range(4)}
    jref = {k: jbits.BitArray(5 * k) for k in range(4)}
    for _ in range(400):
        size = int(rng.integers(0, 70))
        name = int(rng.integers(0, 4))
        op = int(rng.integers(0, 9))
        for arrays, mod in ((port, pbits), (jref, jbits)):
            if name not in arrays or op == 0:
                arrays[name] = mod.BitArray(size)
        a, ja = port[name], jref[name]
        b, jb = port[(name + 1) % 4], jref[(name + 1) % 4]
        i = int(rng.integers(-2, 72))
        v = bool(rng.integers(0, 2))
        if op in (1, 2, 3):
            assert a.set(i, v) == ja.set(i, v)
        elif op == 4:
            assert a.or_(b).to_bytes() == ja.or_(jb).to_bytes()
        elif op == 5:
            assert a.and_(b).to_bytes() == ja.and_(jb).to_bytes()
        elif op == 6:
            assert a.not_().to_bytes() == ja.not_().to_bytes()
        elif op == 7:
            assert a.sub(b).to_bytes() == ja.sub(jb).to_bytes()
        else:
            back = pbits.BitArray.from_bytes(a.size, ja.to_bytes())
            assert back == a and repr(back) == repr(ja)
        assert (a.get(i), a.is_empty(), a.is_full(), a.count(), a.size) == (
            ja.get(i), ja.is_empty(), ja.is_full(), ja.count(), ja.size)
        assert a.to_bytes() == ja.to_bytes()
    with pytest.raises(ValueError):
        pbits.BitArray(-1)


def test_fastsync_messages_round_trip(chains):
    block = chains["port"][1][5]
    jblk = chains["reference"][1][5]
    for p_msg, j_msg in (
            (pmsgs.BlockRequestMessage(7), jmsgs.BlockRequestMessage(7)),
            (pmsgs.NoBlockResponseMessage(9), jmsgs.NoBlockResponseMessage(9)),
            (pmsgs.StatusRequestMessage(), jmsgs.StatusRequestMessage()),
            (pmsgs.StatusResponseMessage(42, 3),
             jmsgs.StatusResponseMessage(42, 3)),
            (pmsgs.BlockResponseMessage(block),
             jmsgs.BlockResponseMessage(jblk))):
        data = pmsgs.encode_bc_msg(p_msg)
        assert data == jmsgs.encode_bc_msg(j_msg)
        back = pmsgs.decode_bc_msg(jmsgs.encode_bc_msg(j_msg))
        assert pmsgs.encode_bc_msg(back) == data
        assert type(back) is type(p_msg)
    back = pmsgs.decode_bc_msg(pmsgs.encode_bc_msg(
        pmsgs.BlockResponseMessage(block)))
    assert back.block.hash() == block.hash()


@pytest.mark.parametrize("data", [
    b"", bytes([99]), "request_zero", "no_block_zero", "status_base_above",
    "block_response_empty", "too_large"])
def test_fastsync_messages_reject_as_the_reference(data):
    if data == "request_zero":
        data = jmsgs.encode_bc_msg(jmsgs.BlockRequestMessage(0))
    elif data == "no_block_zero":
        data = jmsgs.encode_bc_msg(jmsgs.NoBlockResponseMessage(0))
    elif data == "status_base_above":
        data = jmsgs.encode_bc_msg(jmsgs.StatusResponseMessage(3, 5))
    elif data == "block_response_empty":
        data = bytes([2])
    elif data == "too_large":
        data = bytes([1]) + b"\x00" * jmsgs.MAX_MSG_SIZE
    errors = []
    for mod in (pmsgs, jmsgs):
        with pytest.raises(ValueError) as e:
            mod.decode_bc_msg(data)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    with pytest.raises(ValueError, match="unknown blockchain message"):
        pmsgs.encode_bc_msg(object())
