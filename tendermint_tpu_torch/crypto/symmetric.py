"""Symmetric crypto (reference: tendermint_tpu/crypto/symmetric.py; Go
crypto/xchacha20poly1305/, crypto/xsalsa20symmetric/), a copy of the
JAX package's module.

XChaCha20-Poly1305 AEAD: HChaCha20 subkey derivation (pure Python, one
block) + the IETF ChaCha20-Poly1305 from `cryptography` (OpenSSL) on
the derived subkey — the standard XChaCha20 construction
(draft-irtf-cfrg-xchacha-03 §2): subkey = HChaCha20(key, nonce[:16]),
inner nonce = 4 zero bytes || nonce[16:24].

XSalsa20-Poly1305 "secretbox" (EncryptSymmetric/DecryptSymmetric):
NaCl secretbox semantics exactly — XSalsa20 keystream (HSalsa20 subkey
+ Salsa20 core, pure Python: the only consumer is key-file encryption
where throughput is irrelevant), first 32 keystream bytes key Poly1305
over the ciphertext; wire layout nonce(24) || tag(16) || ciphertext,
matching the Go reference's EncryptSymmetric framing.
"""

from __future__ import annotations

import os
import struct

_MASK = 0xFFFFFFFF


def _rotl32(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & _MASK


# --- ChaCha20 quarter-round core (for HChaCha20 only) ---

_CHACHA_CONST = struct.unpack("<4I", b"expand 32-byte k")


def _chacha_rounds(state: list[int]) -> list[int]:
    x = list(state)

    def qr(a, b, c, d):
        x[a] = (x[a] + x[b]) & _MASK
        x[d] = _rotl32(x[d] ^ x[a], 16)
        x[c] = (x[c] + x[d]) & _MASK
        x[b] = _rotl32(x[b] ^ x[c], 12)
        x[a] = (x[a] + x[b]) & _MASK
        x[d] = _rotl32(x[d] ^ x[a], 8)
        x[c] = (x[c] + x[d]) & _MASK
        x[b] = _rotl32(x[b] ^ x[c], 7)

    for _ in range(10):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)
    return x


def hchacha20(key: bytes, nonce16: bytes) -> bytes:
    """HChaCha20(key, 16-byte nonce) -> 32-byte subkey."""
    assert len(key) == 32 and len(nonce16) == 16
    state = list(_CHACHA_CONST) + list(struct.unpack("<8I", key)) + \
        list(struct.unpack("<4I", nonce16))
    x = _chacha_rounds(state)
    return struct.pack("<8I", *(x[i] for i in (0, 1, 2, 3, 12, 13, 14, 15)))


class XChaCha20Poly1305:
    """24-byte-nonce AEAD (Go: crypto/xchacha20poly1305)."""

    KEY_SIZE = 32
    NONCE_SIZE = 24
    TAG_SIZE = 16

    def __init__(self, key: bytes):
        if len(key) != self.KEY_SIZE:
            raise ValueError("xchacha20poly1305: bad key size")
        self._key = key

    def _inner(self, nonce: bytes):
        from cryptography.hazmat.primitives.ciphers.aead import (
            ChaCha20Poly1305,
        )

        if len(nonce) != self.NONCE_SIZE:
            raise ValueError("xchacha20poly1305: bad nonce size")
        subkey = hchacha20(self._key, nonce[:16])
        return ChaCha20Poly1305(subkey), b"\x00" * 4 + nonce[16:]

    def seal(self, nonce: bytes, plaintext: bytes,
             aad: bytes = b"") -> bytes:
        aead, iv = self._inner(nonce)
        return aead.encrypt(iv, plaintext, aad or None)

    def open(self, nonce: bytes, ciphertext: bytes,
             aad: bytes = b"") -> bytes:
        from cryptography.exceptions import InvalidTag

        aead, iv = self._inner(nonce)
        try:
            return aead.decrypt(iv, ciphertext, aad or None)
        except InvalidTag as e:
            raise ValueError("xchacha20poly1305: authentication failed") from e


# --- Salsa20 core / XSalsa20 / secretbox ---

_SALSA_CONST = struct.unpack("<4I", b"expand 32-byte k")


def _salsa_core(inp: list[int], add_input: bool) -> list[int]:
    x = list(inp)

    def qr(a, b, c, d):
        x[b] ^= _rotl32((x[a] + x[d]) & _MASK, 7)
        x[c] ^= _rotl32((x[b] + x[a]) & _MASK, 9)
        x[d] ^= _rotl32((x[c] + x[b]) & _MASK, 13)
        x[a] ^= _rotl32((x[d] + x[c]) & _MASK, 18)

    for _ in range(10):
        qr(0, 4, 8, 12)
        qr(5, 9, 13, 1)
        qr(10, 14, 2, 6)
        qr(15, 3, 7, 11)
        qr(0, 1, 2, 3)
        qr(5, 6, 7, 4)
        qr(10, 11, 8, 9)
        qr(15, 12, 13, 14)
    if add_input:
        x = [(a + b) & _MASK for a, b in zip(x, inp)]
    return x


def _salsa_state(key_words, n0, n1, c0, c1):
    return [
        _SALSA_CONST[0], key_words[0], key_words[1], key_words[2],
        key_words[3], _SALSA_CONST[1], n0, n1,
        c0, c1, _SALSA_CONST[2], key_words[4],
        key_words[5], key_words[6], key_words[7], _SALSA_CONST[3],
    ]


def hsalsa20(key: bytes, nonce16: bytes) -> bytes:
    assert len(key) == 32 and len(nonce16) == 16
    kw = struct.unpack("<8I", key)
    n = struct.unpack("<4I", nonce16)
    st = _salsa_state(kw, n[0], n[1], n[2], n[3])
    x = _salsa_core(st, add_input=False)
    return struct.pack("<8I", *(x[i] for i in (0, 5, 10, 15, 6, 7, 8, 9)))


def _xsalsa20_stream(key: bytes, nonce24: bytes, length: int) -> bytes:
    subkey = hsalsa20(key, nonce24[:16])
    kw = struct.unpack("<8I", subkey)
    n0, n1 = struct.unpack("<2I", nonce24[16:])
    out = bytearray()
    counter = 0
    while len(out) < length:
        st = _salsa_state(kw, n0, n1, counter & _MASK,
                          (counter >> 32) & _MASK)
        out += struct.pack("<16I", *_salsa_core(st, add_input=True))
        counter += 1
    return bytes(out[:length])


NONCE_SIZE = 24
_TAG = 16


def encrypt_symmetric(plaintext: bytes, secret: bytes) -> bytes:
    """Go: crypto/xsalsa20symmetric EncryptSymmetric —
    nonce(24) || poly1305 tag(16) || xsalsa20 ciphertext."""
    from cryptography.hazmat.primitives.poly1305 import Poly1305

    if len(secret) != 32:
        raise ValueError("secret must be 32 bytes")
    nonce = os.urandom(NONCE_SIZE)
    stream = _xsalsa20_stream(secret, nonce, 32 + len(plaintext))
    ct = bytes(p ^ s for p, s in zip(plaintext, stream[32:]))
    tag = Poly1305.generate_tag(stream[:32], ct)
    return nonce + tag + ct


def decrypt_symmetric(ciphertext: bytes, secret: bytes) -> bytes:
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives.poly1305 import Poly1305

    if len(secret) != 32:
        raise ValueError("secret must be 32 bytes")
    if len(ciphertext) < NONCE_SIZE + _TAG:
        raise ValueError("ciphertext too short")
    nonce = ciphertext[:NONCE_SIZE]
    tag = ciphertext[NONCE_SIZE: NONCE_SIZE + _TAG]
    ct = ciphertext[NONCE_SIZE + _TAG:]
    stream = _xsalsa20_stream(secret, nonce, 32 + len(ct))
    try:
        Poly1305.verify_tag(stream[:32], ct, tag)
    except InvalidSignature as e:
        raise ValueError("ciphertext decryption failed") from e
    return bytes(c ^ s for c, s in zip(ct, stream[32:]))
