"""Ed25519 keys (reference: crypto/ed25519/ed25519.go).

Signing uses OpenSSL via ``cryptography`` when available (RFC 8032 —
identical output to the pure-Python path).

Verification is ZIP-215 (the consensus-normative accept set; the CUDA
batch kernels match it bit-for-bit) with a sound OpenSSL fast path:
OpenSSL's strict RFC 8032 cofactorless verify accepts a strict SUBSET
of ZIP-215's cofactored accept set — canonical encodings only, and
[S]B = R + [k]A implies [8]([S]B - R - [k]A) = 0 — so

    OpenSSL accepts  -> accept (≈50 µs, no false accepts possible)
    OpenSSL rejects  -> recheck with the pure-Python ZIP-215 oracle
                        (~3 ms, but only for actually-invalid sigs or
                        the rare non-canonical/small-order edge cases)

This keeps every one-off verify (proposal signatures, privval
sanity checks, sub-threshold batches) fast without changing the accept
set by a single bit.
"""

from __future__ import annotations

import os

from . import PrivKey, PubKey, register_pubkey
from . import ed25519_ref, tmhash

KEY_TYPE = "ed25519"
PUBKEY_SIZE = 32
PRIVKEY_SIZE = 64  # seed || pubkey, matching the reference's layout
SIGNATURE_SIZE = 64

try:  # fast signing + fast-path verification via OpenSSL
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
        Ed25519PublicKey,
    )

    _HAVE_OPENSSL = True
except Exception:  # pragma: no cover
    _HAVE_OPENSSL = False


class Ed25519PubKey(PubKey):
    __slots__ = ("_b", "_addr", "_ossl")

    def __init__(self, b: bytes):
        if len(b) != PUBKEY_SIZE:
            raise ValueError(f"ed25519 pubkey must be {PUBKEY_SIZE} bytes")
        self._b = bytes(b)
        self._addr: bytes | None = None
        self._ossl = None
        if _HAVE_OPENSSL:
            try:
                self._ossl = Ed25519PublicKey.from_public_bytes(self._b)
            except Exception:
                self._ossl = None  # non-canonical key: oracle-only path

    def address(self) -> bytes:
        if self._addr is None:
            self._addr = tmhash.sum_truncated(self._b)
        return self._addr

    def bytes(self) -> bytes:
        return self._b

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        if len(sig) != SIGNATURE_SIZE:
            return False
        if self._ossl is not None:
            try:
                self._ossl.verify(sig, msg)
                return True  # strict accept is a subset of ZIP-215 accept
            except InvalidSignature:
                pass  # fall through: ZIP-215 may still accept
            except Exception:
                pass
        return ed25519_ref.verify(self._b, msg, sig)

    @property
    def type_name(self) -> str:
        return KEY_TYPE

    def __repr__(self) -> str:
        return f"Ed25519PubKey({self._b.hex()[:16]}…)"


class Ed25519PrivKey(PrivKey):
    __slots__ = ("_seed", "_pub", "_ossl")

    def __init__(self, b: bytes):
        # Accept 32-byte seed or 64-byte seed||pub.
        if len(b) == PRIVKEY_SIZE:
            seed = b[:32]
        elif len(b) == 32:
            seed = b
        else:
            raise ValueError("ed25519 privkey must be 32 or 64 bytes")
        self._seed = bytes(seed)
        if _HAVE_OPENSSL:
            self._ossl = Ed25519PrivateKey.from_private_bytes(self._seed)
            from cryptography.hazmat.primitives import serialization

            pub = self._ossl.public_key().public_bytes(
                serialization.Encoding.Raw, serialization.PublicFormat.Raw
            )
        else:
            self._ossl = None
            pub = ed25519_ref.public_key_from_seed(self._seed)
        self._pub = Ed25519PubKey(pub)

    @classmethod
    def generate(cls) -> "Ed25519PrivKey":
        return cls(os.urandom(32))

    @classmethod
    def from_secret(cls, secret: bytes) -> "Ed25519PrivKey":
        """Deterministic key from a secret (reference: GenPrivKeyFromSecret)."""
        return cls(tmhash.sum256(secret))

    def bytes(self) -> bytes:
        return self._seed + self._pub.bytes()

    def sign(self, msg: bytes) -> bytes:
        if self._ossl is not None:
            return self._ossl.sign(msg)
        return ed25519_ref.sign(self._seed, msg)

    def pub_key(self) -> Ed25519PubKey:
        return self._pub

    @property
    def type_name(self) -> str:
        return KEY_TYPE


register_pubkey(KEY_TYPE, Ed25519PubKey)
