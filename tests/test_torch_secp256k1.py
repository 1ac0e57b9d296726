"""The port's secp256k1 keys (tendermint_tpu_torch/crypto/secp256k1.py)
held against the JAX package's (tendermint_tpu/crypto/secp256k1.py) on
the same numpy-seeded inputs. Tolerance: exact — equal public keys,
addresses and signature bytes (RFC 6979 nonces make signing
deterministic), equal verdicts on valid, high-S, wrong-size, off-curve
and out-of-range inputs, equal genesis documents, and a mixed
BatchVerifier on the CPU (ed25519 lanes through the plain K4, secp256k1
lanes on the host) with the reference's verdicts lane for lane."""

from __future__ import annotations

import hashlib
import json

import numpy as np
import pytest

from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.crypto import ed25519 as jed
from tendermint_tpu.crypto import secp256k1 as jsecp
from tendermint_tpu.types import genesis as jgenesis
from tendermint_tpu_torch import device
from tendermint_tpu_torch.crypto import batch as pbatch
from tendermint_tpu_torch.crypto import ed25519 as ped
from tendermint_tpu_torch.crypto import secp256k1 as psecp
from tendermint_tpu_torch.types import genesis as pgenesis

N = jsecp._N


@pytest.fixture(autouse=True)
def _cpu():
    device.set_default_device("cpu")
    yield
    pbatch.reset_breakers()
    jbatch.reset_breakers()


def _secrets(seed: int, n: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(rng.integers(1, 48))) for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1])
def test_keys_addresses_and_signatures_are_byte_equal(seed):
    rng = np.random.default_rng(100 + seed)
    for secret in _secrets(seed, 6):
        jk = jsecp.Secp256k1PrivKey.from_secret(secret)
        pk = psecp.Secp256k1PrivKey.from_secret(secret)
        assert pk.bytes() == jk.bytes()
        assert pk.pub_key().bytes() == jk.pub_key().bytes()
        assert len(pk.pub_key().bytes()) == 33
        assert pk.pub_key().address() == jk.pub_key().address()
        assert pk.pub_key().address() == psecp._ripemd160_py(
            hashlib.sha256(pk.pub_key().bytes()).digest())
        for _ in range(3):
            msg = rng.bytes(int(rng.integers(0, 200)))
            sig = pk.sign(msg)
            assert sig == jk.sign(msg) == pk.sign(msg)
            assert int.from_bytes(sig[32:], "big") <= N // 2
            assert pk.pub_key().verify_signature(msg, sig)
            assert jk.pub_key().verify_signature(msg, sig)
        raw = pk.bytes()
        assert psecp.Secp256k1PrivKey(raw).pub_key() == pk.pub_key()


def _cases(p, seed: int) -> list[tuple[bytes, bytes, bytes]]:
    """(pubkey bytes, msg, sig) cases: valid, high-S, wrong sizes,
    r or s zero or >= N, an off-curve key, a bad prefix, a wrong msg."""
    rng = np.random.default_rng(seed)
    k = p.Secp256k1PrivKey.from_secret(b"case%d" % seed)
    pub = k.pub_key().bytes()
    msg = rng.bytes(40)
    sig = k.sign(msg)
    r, s = sig[:32], int.from_bytes(sig[32:], "big")
    high = r + (N - s).to_bytes(32, "big")
    x_off = None
    for x in range(5, 200):  # the first x with no point on the curve
        y2 = (x ** 3 + 7) % jsecp._P
        if pow(y2, (jsecp._P - 1) // 2, jsecp._P) != 1:
            x_off = x
            break
    off_curve = b"\x02" + x_off.to_bytes(32, "big")
    return [
        (pub, msg, sig),
        (pub, msg, high),
        (pub, msg, sig[:63]),
        (pub, msg, sig + b"\x00"),
        (pub, msg, b"\x00" * 32 + sig[32:]),
        (pub, msg, r + b"\x00" * 32),
        (pub, msg, N.to_bytes(32, "big") + sig[32:]),
        (pub, msg, r + N.to_bytes(32, "big")),
        (pub, msg + b"x", sig),
        (off_curve, msg, sig),
        (b"\x04" + pub[1:], msg, sig),
        (b"\x02" + (jsecp._P + 1).to_bytes(32, "big"), msg, sig),
    ]


@pytest.mark.parametrize("seed", [2, 3])
def test_verdicts_agree_on_adversarial_inputs(seed):
    cases = _cases(psecp, seed)
    assert cases == _cases(jsecp, seed)
    got = [psecp.Secp256k1PubKey(pk).verify_signature(m, s)
           for pk, m, s in cases]
    want = [jsecp.Secp256k1PubKey(pk).verify_signature(m, s)
            for pk, m, s in cases]
    assert got == want
    assert got[0] and not any(got[1:])
    # the pure-Python oracle (no OpenSSL) gives the same verdicts
    slow = []
    for pk, m, s in cases:
        key = psecp.Secp256k1PubKey(pk)
        key._verify_openssl = lambda *a: None
        slow.append(key.verify_signature(m, s))
    assert slow == got


def test_construction_errors_match():
    for bad in (b"", b"\x02" * 32, b"\x02" * 34):
        for p in (psecp, jsecp):
            with pytest.raises(ValueError):
                p.Secp256k1PubKey(bad)
    for bad in (b"\x00" * 32, N.to_bytes(32, "big"), b"\x01" * 31):
        errs = []
        for p in (psecp, jsecp):
            with pytest.raises(ValueError) as e:
                p.Secp256k1PrivKey(bad)
            errs.append(str(e.value))
        assert errs[0] == errs[1]


def test_registry_and_genesis_json_load_equal(tmp_path):
    from tendermint_tpu import crypto as jcrypto
    from tendermint_tpu_torch import crypto as pcrypto

    assert pcrypto.pubkey_types() >= {"ed25519", "sr25519", "secp256k1"}
    keys = [psecp.Secp256k1PrivKey.from_secret(b"g%d" % i).pub_key()
            for i in range(3)]
    for k in keys:
        pk = pcrypto.pubkey_from_type_and_bytes("secp256k1", k.bytes())
        jk = jcrypto.pubkey_from_type_and_bytes("secp256k1", k.bytes())
        assert (pk.address(), pk.bytes()) == (jk.address(), jk.bytes())
    edk = ped.Ed25519PrivKey(hashlib.sha256(b"g-ed").digest()).pub_key()
    doc = pgenesis.GenesisDoc(
        chain_id="secp-chain", genesis_time=1_700_000_000 * 10**9,
        validators=[pgenesis.GenesisValidator(k, 3 + i)
                    for i, k in enumerate(keys)]
        + [pgenesis.GenesisValidator(edk, 7)])
    doc.validate_and_complete()
    path = tmp_path / "genesis.json"
    doc.save(str(path))
    jdoc = jgenesis.GenesisDoc.load(str(path))
    pdoc = pgenesis.GenesisDoc.load(str(path))
    assert jdoc.hash() == pdoc.hash() == doc.hash()
    assert [(v.pub_key.type_name, v.address, v.power)
            for v in jdoc.validators] == \
        [(v.pub_key.type_name, v.address, v.power)
         for v in pdoc.validators]
    jpath = tmp_path / "genesis_ref.json"
    jdoc.save(str(jpath))
    assert jpath.read_bytes() == path.read_bytes()
    assert json.loads(path.read_text())["validators"][0]["pub_key"][
        "type"] in ("secp256k1", "tendermint/PubKeySecp256k1")


def _mixed(p_ed, p_secp, n_ed: int, n_secp: int, seed: int):
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n_ed):
        k = p_ed.Ed25519PrivKey(hashlib.sha256(b"mx-ed%d" % i).digest())
        m = rng.bytes(int(rng.integers(1, 90)))
        items.append((k.pub_key(), m, k.sign(m)))
    for i in range(n_secp):
        k = p_secp.Secp256k1PrivKey.from_secret(b"mx-secp%d" % i)
        m = rng.bytes(int(rng.integers(1, 90)))
        items.append((k.pub_key(), m, k.sign(m)))
    # one bad signature of each type
    pk, m, s = items[3]
    items[3] = (pk, m, s[:10] + bytes([s[10] ^ 1]) + s[11:])
    pk, m, s = items[n_ed + 2]
    items[n_ed + 2] = (pk, m + b"!", s)
    order = rng.permutation(len(items))
    return [items[i] for i in order]


def test_mixed_batch_verifier_on_the_cpu_equals_the_reference(monkeypatch):
    """48 ed25519 lanes (one plain K4 launch: over the 40-lane crossover)
    and 8 secp256k1 lanes (the host, key by key) in one BatchVerifier;
    the reference verifies all on its host."""
    from tendermint_tpu_torch.crypto.cuda import verify as pverify

    calls = []
    real = pverify.verify_batch

    def counting(*a, **k):
        calls.append(len(a[0]))
        return real(*a, **k)

    monkeypatch.setattr(pverify, "verify_batch", counting)
    pitems = _mixed(ped, psecp, 48, 8, 5)
    jitems = _mixed(jed, jsecp, 48, 8, 5)
    pbv = pbatch.BatchVerifier()
    for it in pitems:
        pbv.add(*it)
    jbatch.set_force_host(True)
    try:
        jbv = jbatch.BatchVerifier()
        for it in jitems:
            jbv.add(*it)
        jok, jlanes = jbv.verify()
    finally:
        jbatch.set_force_host(False)
    pok, plines = pbv.verify()
    assert calls == [48]
    assert (pok, plines.tolist()) == (jok, jlanes.tolist())
    assert not pok and int((~plines).sum()) == 2
    oracle = [pk.verify_signature(m, s) for pk, m, s in pitems]
    assert plines.tolist() == oracle
