"""sr25519 keys (reference: crypto/sr25519/pubkey.go, privkey.go).

Schnorr signatures over ristretto255 with Merlin signing-context
transcripts, semantics matching go-schnorrkel as the reference uses it
(empty context bytes, pubkey.go:50). The math lives in
crypto/sr25519_ref.py (the host oracle); the Merlin transcript stays
on the host, while batches of sr25519 lanes verify together through
crypto.batch (the group equation on the GPU, crypto/cuda/sr_verify.py).
"""

from __future__ import annotations

import os

from . import PrivKey, PubKey, register_pubkey
from . import sr25519_ref, tmhash

KEY_TYPE = "sr25519"
PUBKEY_SIZE = 32
PRIVKEY_SIZE = 32  # the mini secret key
SIGNATURE_SIZE = 64


class Sr25519PubKey(PubKey):
    __slots__ = ("_b", "_addr")

    def __init__(self, b: bytes):
        if len(b) != PUBKEY_SIZE:
            raise ValueError(f"sr25519 pubkey must be {PUBKEY_SIZE} bytes")
        self._b = bytes(b)
        self._addr: bytes | None = None

    def address(self) -> bytes:
        if self._addr is None:
            self._addr = tmhash.sum_truncated(self._b)
        return self._addr

    def bytes(self) -> bytes:
        return self._b

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        if len(sig) != SIGNATURE_SIZE:
            return False
        return sr25519_ref.verify(self._b, msg, sig)

    @property
    def type_name(self) -> str:
        return KEY_TYPE

    def __repr__(self) -> str:
        return f"Sr25519PubKey({self._b.hex()[:16]}…)"


class Sr25519PrivKey(PrivKey):
    __slots__ = ("_mini", "_pub")

    def __init__(self, b: bytes):
        if len(b) != PRIVKEY_SIZE:
            raise ValueError(f"sr25519 privkey must be {PRIVKEY_SIZE} bytes")
        self._mini = bytes(b)
        self._pub = Sr25519PubKey(sr25519_ref.public_key_from_mini(self._mini))

    @classmethod
    def generate(cls) -> "Sr25519PrivKey":
        return cls(os.urandom(PRIVKEY_SIZE))

    @classmethod
    def from_secret(cls, secret: bytes) -> "Sr25519PrivKey":
        return cls(tmhash.sum256(secret))

    def bytes(self) -> bytes:
        return self._mini

    def sign(self, msg: bytes) -> bytes:
        return sr25519_ref.sign(self._mini, msg)

    def pub_key(self) -> Sr25519PubKey:
        return self._pub

    @property
    def type_name(self) -> str:
        return KEY_TYPE


register_pubkey(KEY_TYPE, Sr25519PubKey)
