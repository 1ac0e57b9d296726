"""Port parity: the sr25519 host layer (Merlin, the batched challenges,
the ristretto oracle, signing and the key classes) against the JAX
package's, on numpy-seeded inputs, on the CPU. Tolerance: exact —
challenge bytes and scalars, encodings, signatures, verdicts and
addresses identical."""

import hashlib

import numpy as np
import pytest

from tendermint_tpu.crypto import merlin as jmerlin
from tendermint_tpu.crypto import merlin_batch as jmb
from tendermint_tpu.crypto import sr25519 as jsr_keys
from tendermint_tpu.crypto import sr25519_ref as jsr
from tendermint_tpu_torch import crypto as pcrypto
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.crypto import merlin, merlin_batch, vectors
from tendermint_tpu_torch.crypto import sr25519 as sr_keys
from tendermint_tpu_torch.crypto import sr25519_ref as sr


def test_merlin_known_vector():
    # From merlin's tests (transcript equivalence test).
    t = merlin.Transcript(b"test protocol")
    t.append_message(b"some label", b"some data")
    c = t.challenge_bytes(b"challenge", 32)
    assert c.hex() == (
        "d5a21972d0d5fe320c0d263fac7fffb8145aa640af6e9bca177c03c7efcf0615"
    )


def test_merlin_random_transcripts_match_reference():
    rng = np.random.default_rng(31)
    for _ in range(6):
        label = rng.bytes(int(rng.integers(1, 20)))
        ts = (merlin.Transcript(label), jmerlin.Transcript(label))
        outs = ([], [])
        for _ in range(int(rng.integers(1, 6))):
            lab = rng.bytes(int(rng.integers(0, 12)))
            msg = rng.bytes(int(rng.integers(0, 400)))
            n = int(rng.integers(1, 200))
            for t, out in zip(ts, outs):
                t.append_message(lab, msg)
                t.append_u64(b"n", n)
                out.append(t.challenge_bytes(lab, n))
        assert outs[0] == outs[1]
    assert merlin.keccak_f1600(list(range(25))) == jmerlin.keccak_f1600(
        list(range(25)))


def test_challenges_match_reference_and_scalar_transcript():
    rng = np.random.default_rng(32)
    n = 40
    pubs = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    rs = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    msgs = [rng.bytes(int(k)) for k in
            [0, 1, 165, 166, 167, 300] + list(rng.integers(0, 301, n - 6))]
    for ctx in (b"", b"substrate"):
        got = merlin_batch.sr25519_challenges(pubs, msgs, rs, ctx)
        assert list(got) == list(jmb.sr25519_challenges(pubs, msgs, rs, ctx))
        for i in (0, 5, n - 1):
            assert got[i] == sr.challenge(pubs[i].tobytes(), rs[i].tobytes(),
                                          msgs[i], ctx)


# RFC 9496 §A.1: encodings of B, 2B, ... (first four).
_RISTRETTO_MULTIPLES = [
    "0000000000000000000000000000000000000000000000000000000000000000",
    "e2f2ae0a6abc4e71a884a961c500515f58e30b6aa582dd8db6a65945e08d2d76",
    "6a493210f7499cd17fecb510ae0cea23a110e8d5b901f8acadd3095c73a3b919",
    "94741f5d5d52755ece4f23f044ee27d5d1ea1e2bd196b462166b16152a9d0259",
]


def test_ristretto_encode_decode_match_reference():
    for k, want in enumerate(_RISTRETTO_MULTIPLES):
        assert sr.ristretto_encode(ref.base_mult(k)).hex() == want
    rng = np.random.default_rng(33)
    # random points, each also moved by every 4-torsion point (the
    # same ristretto element, four representatives)
    torsion = [ref.IDENTITY, (0, ref.P - 1, 1, 0),
               (ref.SQRT_M1, 0, 1, 0), (ref.P - ref.SQRT_M1, 0, 1, 0)]
    encs = []
    for _ in range(6):
        pt = ref.base_mult(int.from_bytes(rng.bytes(32), "little") % ref.L)
        got = {sr.ristretto_encode(ref.pt_add(pt, t)) for t in torsion}
        assert len(got) == 1
        enc = got.pop()
        assert enc == jsr.ristretto_encode(pt)
        encs.append(enc)
    encs += [rng.bytes(32) for _ in range(12)]
    encs += [bytes([b & 0xFE for b in rng.bytes(31)]) + b"\x01"
             for _ in range(6)]
    encs += [b"\xff" * 32, ref.P.to_bytes(32, "little"), bytes(31),
             b"\x01" + bytes(31), vectors._failing_encoding("flipped_i"),
             vectors._failing_encoding("none"),
             vectors._failing_encoding("odd_t")]
    decoded = [sr.ristretto_decode(e) for e in encs]
    assert decoded == [jsr.ristretto_decode(e) for e in encs]
    assert all(d is not None for d in decoded[:6])
    for e, d in zip(encs, decoded):
        if d is not None:
            assert sr.ristretto_encode(d) == e


def test_sign_and_public_key_match_reference():
    for i in range(5):
        mini = hashlib.sha256(b"sr-parity-%d" % i).digest()
        msg = b"precommit %d " % i * i
        ctx = b"" if i % 2 else b"ctx"
        pub = sr.public_key_from_mini(mini)
        assert pub == jsr.public_key_from_mini(mini)
        sig = sr.sign(mini, msg, ctx)
        assert sig == jsr.sign(mini, msg, ctx)
        assert sr.expand_ed25519(mini) == jsr.expand_ed25519(mini)
        assert sr.verify(pub, msg, sig, ctx) and jsr.verify(pub, msg, sig, ctx)


def test_verify_matches_reference_on_adversarial_batch():
    b = vectors.sr_adversarial_batch(len(vectors.SR_KINDS) * 2, seed=34)
    got = [sr.verify(p, m, s) for p, m, s in zip(b["pubs"], b["msgs"],
                                                 b["sigs"])]
    assert got == [jsr.verify(p, m, s) for p, m, s in zip(
        b["pubs"], b["msgs"], b["sigs"])]
    assert got == b["expect"].tolist()
    assert set(b["kinds"]) == set(vectors.SR_KINDS)


def test_substrate_dev_key_anchors():
    """Substrate's well-known dev accounts: seed -> published sr25519
    public key (pins ExpandEd25519, the comb and ristretto encoding
    against the Rust schnorrkel)."""
    for seed_hex, pub_hex in [
        ("e5be9a5092b81bca64be81d212e7f2f9eba183bb7a90954f7b76361f6edb5c0a",
         "d43593c715fdd31c61141abd04a99fd6822c8558854ccde39a5684e7a56da27d"),
        ("398f0c28f98885e046333d4a41c19cee4c37368a9832c6502f6cfd182e2aef89",
         "8eaf04151687736326c9fea17e25fc5287613693c912909cb226aa4794f26a48"),
    ]:
        assert sr.public_key_from_mini(bytes.fromhex(seed_hex)).hex() == pub_hex


def test_sr_sign_batch_equals_sign():
    minis = [hashlib.sha256(b"bulk-%d" % (i % 5)).digest() for i in range(12)]
    rng = np.random.default_rng(35)
    msgs = [rng.bytes(int(rng.integers(0, 200))) for _ in minis]
    for ctx in (b"", b"ctx"):
        assert vectors.sr_sign_batch(minis, msgs, ctx) == [
            sr.sign(m, msg, ctx) for m, msg in zip(minis, msgs)]


def test_key_classes_match_reference():
    priv = sr_keys.Sr25519PrivKey.from_secret(b"validator-3")
    jpriv = jsr_keys.Sr25519PrivKey.from_secret(b"validator-3")
    pub = priv.pub_key()
    assert pub.bytes() == jpriv.pub_key().bytes()
    assert pub.address() == jpriv.pub_key().address()
    assert len(pub.address()) == 20
    assert pub.type_name == jpriv.pub_key().type_name == "sr25519"
    assert priv.type_name == "sr25519" and priv.bytes() == jpriv.bytes()
    sig = priv.sign(b"vote")
    assert sig == jpriv.sign(b"vote")
    assert pub.verify_signature(b"vote", sig)
    assert not pub.verify_signature(b"evot", sig)
    assert not pub.verify_signature(b"vote", sig[:63])
    rt = pcrypto.pubkey_from_type_and_bytes("sr25519", pub.bytes())
    assert rt == pub and isinstance(rt, sr_keys.Sr25519PubKey)
    ed = pcrypto.pubkey_from_type_and_bytes("ed25519", bytes(32))
    assert ed.type_name == "ed25519"
    with pytest.raises(ValueError, match="unknown pubkey type"):
        pcrypto.pubkey_from_type_and_bytes("secp256k1", bytes(33))
    with pytest.raises(ValueError, match="32 bytes"):
        sr_keys.Sr25519PubKey(bytes(31))
    with pytest.raises(ValueError, match="32 bytes"):
        sr_keys.Sr25519PrivKey(bytes(33))
