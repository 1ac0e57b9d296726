"""The port's symmetric crypto, ASCII armor and encrypted key files
(tendermint_tpu_torch/crypto/{symmetric,armor,keyfile}.py) held against
the JAX package's on the same numpy-seeded inputs. Tolerance: exact —
hchacha20/hsalsa20 outputs and keystreams equal byte for byte, each
package opens the other's XChaCha20-Poly1305 and secretbox ciphertexts
and decrypts the other's armored key file, and every tampering fails in
both with ValueError."""

from __future__ import annotations

import numpy as np
import pytest

from tendermint_tpu.crypto import armor as jarmor
from tendermint_tpu.crypto import keyfile as jkeyfile
from tendermint_tpu.crypto import symmetric as jsym
from tendermint_tpu_torch.crypto import armor as parmor
from tendermint_tpu_torch.crypto import keyfile as pkeyfile
from tendermint_tpu_torch.crypto import symmetric as psym

PAIRS = [(psym, jsym), (jsym, psym)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_subkeys_and_keystreams_are_equal(seed):
    rng = np.random.default_rng(seed)
    for _ in range(4):
        key, n16, n24 = rng.bytes(32), rng.bytes(16), rng.bytes(24)
        assert psym.hchacha20(key, n16) == jsym.hchacha20(key, n16)
        assert psym.hsalsa20(key, n16) == jsym.hsalsa20(key, n16)
        ln = int(rng.integers(0, 300))
        assert psym._xsalsa20_stream(key, n24, ln) == \
            jsym._xsalsa20_stream(key, n24, ln)
        state = [int(v) for v in rng.integers(0, 2**32, 16, dtype=np.uint64)]
        assert psym._chacha_rounds(state) == jsym._chacha_rounds(state)


@pytest.mark.parametrize("seed", [3, 4])
def test_xchacha20poly1305_opens_across_packages(seed):
    rng = np.random.default_rng(seed)
    key = rng.bytes(32)
    for enc, dec in PAIRS:
        for ln in (0, 1, 63, 64, 65, 1000):
            nonce, pt, aad = rng.bytes(24), rng.bytes(ln), rng.bytes(
                int(rng.integers(0, 20)))
            ct = enc.XChaCha20Poly1305(key).seal(nonce, pt, aad)
            assert ct == dec.XChaCha20Poly1305(key).seal(nonce, pt, aad)
            assert dec.XChaCha20Poly1305(key).open(nonce, ct, aad) == pt
        ct = enc.XChaCha20Poly1305(key).seal(nonce, b"secret", b"aad")
        for bad_ct, bad_aad, bad_nonce in (
                (ct[:-1] + bytes([ct[-1] ^ 1]), b"aad", nonce),
                (ct, b"other", nonce), (ct, b"aad", bytes(24))):
            for p in (psym, jsym):
                with pytest.raises(ValueError):
                    p.XChaCha20Poly1305(key).open(bad_nonce, bad_ct,
                                                  bad_aad)
    for p in (psym, jsym):
        with pytest.raises(ValueError):
            p.XChaCha20Poly1305(b"short")
        with pytest.raises(ValueError):
            p.XChaCha20Poly1305(key).seal(b"short-nonce", b"m")


@pytest.mark.parametrize("seed", [5, 6])
def test_secretbox_decrypts_across_packages_and_refuses_tampering(seed):
    rng = np.random.default_rng(seed)
    secret = rng.bytes(32)
    for enc, dec in PAIRS:
        for ln in (0, 19, 4096):
            pt = rng.bytes(ln)
            box = enc.encrypt_symmetric(pt, secret)
            assert len(box) == 24 + 16 + ln
            assert dec.decrypt_symmetric(box, secret) == pt
        box = enc.encrypt_symmetric(b"attack at dawn", secret)
        for bad, key in ((box[:-1] + bytes([box[-1] ^ 1]), secret),
                         (box[:24] + bytes(16) + box[40:], secret),
                         (box, bytes(32)), (b"short", secret)):
            errs = []
            for p in (psym, jsym):
                with pytest.raises(ValueError) as e:
                    p.decrypt_symmetric(bad, key)
                errs.append(str(e.value))
            assert errs[0] == errs[1]
    for p in (psym, jsym):
        with pytest.raises(ValueError):
            p.encrypt_symmetric(b"x", b"badkey")


def test_armor_is_byte_equal_and_refuses_corruption():
    rng = np.random.default_rng(7)
    data = rng.bytes(700)
    headers = {"kdf": "scrypt", "salt": "ABCD", "type": "secp256k1"}
    s = parmor.encode_armor("TENDERMINT PRIVATE KEY", headers, data)
    assert s == jarmor.encode_armor("TENDERMINT PRIVATE KEY", headers, data)
    for p in (parmor, jarmor):
        assert p.decode_armor(s) == ("TENDERMINT PRIVATE KEY", headers, data)
    lines = s.split("\n")
    assert lines[4] == "" and len(lines[5]) == 64
    lines[5] = "A" * 64
    for bad in ("\n".join(lines), "no armor here",
                s.replace("END TENDERMINT", "END OTHER")):
        errs = []
        for p in (parmor, jarmor):
            with pytest.raises(ValueError) as e:
                p.decode_armor(bad)
            errs.append(str(e.value))
        assert errs[0] == errs[1]


@pytest.mark.parametrize("key_type", ["ed25519", "secp256k1"])
def test_keyfiles_decrypt_across_packages(key_type):
    rng = np.random.default_rng(8)
    priv = rng.bytes(32)
    for enc, dec in ((pkeyfile, jkeyfile), (jkeyfile, pkeyfile)):
        armored = enc.encrypt_armor_priv_key(priv, "hunter2", key_type)
        assert "kdf: scrypt" in armored
        assert dec.unarmor_decrypt_priv_key(armored, "hunter2") == \
            (priv, key_type)
        for p in (pkeyfile, jkeyfile):
            with pytest.raises(ValueError):
                p.unarmor_decrypt_priv_key(armored, "wrong-pass")
            with pytest.raises(ValueError):
                p.unarmor_decrypt_priv_key(
                    armored.replace("PRIVATE KEY", "PUBLIC KEY"), "hunter2")
