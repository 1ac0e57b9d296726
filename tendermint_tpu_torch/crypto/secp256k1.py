"""secp256k1 ECDSA keys (reference: tendermint_tpu/crypto/secp256k1.py;
Go crypto/secp256k1/secp256k1.go), a copy of the JAX package's module.

Semantics matched to the Go reference:
  - pubkey = 33-byte compressed SEC1 point
  - signature = 64 bytes R || S big-endian, lower-S form; verification
    REJECTS high-S signatures (malleability guard,
    secp256k1_nocgo.go:34-53)
  - the message is SHA-256 hashed before ECDSA
  - address = RIPEMD160(SHA256(pubkey)) — Bitcoin style
    (secp256k1.go:140-152)

Signing uses deterministic RFC 6979 nonces. Pure Python — secp256k1 is
not a consensus hot path (validators are ed25519/sr25519; this key type
serves app/account use, matching its role in the Go reference). Batches of secp256k1 lanes
verify on the host, one key at a time (crypto/batch.py host_verify).
"""

from __future__ import annotations

import hashlib
import hmac
import os

from . import PrivKey, PubKey, register_pubkey

KEY_TYPE = "secp256k1"
PUBKEY_SIZE = 33
PRIVKEY_SIZE = 32
SIGNATURE_SIZE = 64

# Curve parameters.
_P = 2**256 - 2**32 - 977
_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
_GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
_GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8


def _inv(a: int, m: int) -> int:
    return pow(a, m - 2, m)


def _pt_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2) % _P == 0:
            return None
        lam = (3 * x1 * x1) * _inv(2 * y1, _P) % _P
    else:
        lam = (y2 - y1) * _inv(x2 - x1, _P) % _P
    x3 = (lam * lam - x1 - x2) % _P
    return (x3, (lam * (x1 - x3) - y1) % _P)


def _pt_mul(k: int, p):
    acc = None
    add = p
    while k:
        if k & 1:
            acc = _pt_add(acc, add)
        add = _pt_add(add, add)
        k >>= 1
    return acc


_G = (_GX, _GY)


def _compress(pt) -> bytes:
    x, y = pt
    return bytes([2 + (y & 1)]) + x.to_bytes(32, "big")


def _decompress(b: bytes):
    if len(b) != PUBKEY_SIZE or b[0] not in (2, 3):
        return None
    x = int.from_bytes(b[1:], "big")
    if x >= _P:
        return None
    y2 = (x * x * x + 7) % _P
    y = pow(y2, (_P + 1) // 4, _P)
    if (y * y) % _P != y2:
        return None
    if (y & 1) != (b[0] & 1):
        y = _P - y
    return (x, y)


def _ripemd160(data: bytes) -> bytes:
    try:
        h = hashlib.new("ripemd160")
        h.update(data)
        return h.digest()
    except ValueError:
        return _ripemd160_py(data)


def _ripemd160_py(data: bytes) -> bytes:
    """Pure-Python RIPEMD-160 (OpenSSL 3 often ships without it)."""
    def rol(x, n):
        return ((x << n) | (x >> (32 - n))) & 0xFFFFFFFF

    r1 = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
          7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8,
          3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12,
          1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2,
          4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13]
    r2 = [5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12,
          6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2,
          15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13,
          8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14,
          12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11]
    s1 = [11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8,
          7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12,
          11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5,
          11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12,
          9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6]
    s2 = [8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6,
          9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11,
          9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5,
          15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8,
          8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11]
    k1 = [0x00000000, 0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xA953FD4E]
    k2 = [0x50A28BE6, 0x5C4DD124, 0x6D703EF3, 0x7A6D76E9, 0x00000000]

    def f(j, x, y, z):
        if j < 16:
            return x ^ y ^ z
        if j < 32:
            return (x & y) | (~x & z)
        if j < 48:
            return (x | ~y) ^ z
        if j < 64:
            return (x & z) | (y & ~z)
        return x ^ (y | ~z)

    msg = bytearray(data)
    bitlen = len(data) * 8
    msg.append(0x80)
    while len(msg) % 64 != 56:
        msg.append(0)
    msg += bitlen.to_bytes(8, "little")
    h = [0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0]
    for off in range(0, len(msg), 64):
        x = [int.from_bytes(msg[off + 4 * i: off + 4 * i + 4], "little")
             for i in range(16)]
        al, bl, cl, dl, el = h
        ar, br, cr, dr, er = h
        for j in range(80):
            t = (rol((al + f(j, bl, cl, dl) + x[r1[j]] + k1[j // 16])
                     & 0xFFFFFFFF, s1[j]) + el) & 0xFFFFFFFF
            al, el, dl, cl, bl = el, dl, rol(cl, 10), bl, t
            t = (rol((ar + f(79 - j, br, cr, dr) + x[r2[j]] + k2[j // 16])
                     & 0xFFFFFFFF, s2[j]) + er) & 0xFFFFFFFF
            ar, er, dr, cr, br = er, dr, rol(cr, 10), br, t
        t = (h[1] + cl + dr) & 0xFFFFFFFF
        h[1] = (h[2] + dl + er) & 0xFFFFFFFF
        h[2] = (h[3] + el + ar) & 0xFFFFFFFF
        h[3] = (h[4] + al + br) & 0xFFFFFFFF
        h[4] = (h[0] + bl + cr) & 0xFFFFFFFF
        h[0] = t
    return b"".join(v.to_bytes(4, "little") for v in h)


def _rfc6979_k(x: int, h1: bytes) -> int:
    """Deterministic nonce (RFC 6979, SHA-256)."""
    v = b"\x01" * 32
    k = b"\x00" * 32
    x_b = x.to_bytes(32, "big")
    k = hmac.new(k, v + b"\x00" + x_b + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x_b + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        cand = int.from_bytes(v, "big")
        if 1 <= cand < _N:
            return cand
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


class Secp256k1PubKey(PubKey):
    __slots__ = ("_b", "_addr", "_pt", "_openssl_key")

    def __init__(self, b: bytes):
        if len(b) != PUBKEY_SIZE:
            raise ValueError(f"secp256k1 pubkey must be {PUBKEY_SIZE} bytes")
        self._b = bytes(b)
        self._addr: bytes | None = None
        self._pt = _decompress(self._b)  # None for invalid encodings
        self._openssl_key = None  # lazy OpenSSL handle (fast verify)

    def address(self) -> bytes:
        if self._addr is None:
            self._addr = _ripemd160(hashlib.sha256(self._b).digest())
        return self._addr

    def bytes(self) -> bytes:
        return self._b

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        if len(sig) != SIGNATURE_SIZE or self._pt is None:
            return False
        r = int.from_bytes(sig[:32], "big")
        s = int.from_bytes(sig[32:], "big")
        if not (1 <= r < _N and 1 <= s < _N):
            return False
        if s > _N // 2:
            return False  # reject malleable high-S (Go reference parity)
        fast = self._verify_openssl(msg, r, s)
        if fast is not None:
            return fast
        e = int.from_bytes(hashlib.sha256(msg).digest(), "big") % _N
        w = _inv(s, _N)
        u1 = (e * w) % _N
        u2 = (r * w) % _N
        pt = _pt_add(_pt_mul(u1, _G), _pt_mul(u2, self._pt))
        if pt is None:
            return False
        return pt[0] % _N == r

    def _verify_openssl(self, msg: bytes, r: int, s: int) -> bool | None:
        """OpenSSL fast path (~100x the pure-Python loop); None means
        unavailable — fall back to the oracle. Semantics identical:
        standard ECDSA accept/reject (range and low-S already checked
        by the caller; both implementations hash with SHA-256)."""
        try:
            from cryptography.exceptions import InvalidSignature
            from cryptography.hazmat.primitives import hashes
            from cryptography.hazmat.primitives.asymmetric import ec
            from cryptography.hazmat.primitives.asymmetric.utils import (
                encode_dss_signature,
            )
        except ImportError:  # pragma: no cover
            return None
        pk = self._openssl_key
        if pk is None:
            try:
                pk = ec.EllipticCurvePublicKey.from_encoded_point(
                    ec.SECP256K1(), self._b)
                self._openssl_key = pk
            except Exception:
                return None
        try:
            pk.verify(encode_dss_signature(r, s), msg,
                      ec.ECDSA(hashes.SHA256()))
            return True
        except InvalidSignature:
            return False
        except Exception:  # pragma: no cover - unexpected backend issue
            return None

    @property
    def type_name(self) -> str:
        return KEY_TYPE

    def __repr__(self) -> str:
        return f"Secp256k1PubKey({self._b.hex()[:16]}…)"


class Secp256k1PrivKey(PrivKey):
    __slots__ = ("_d", "_pub")

    def __init__(self, b: bytes):
        if len(b) != PRIVKEY_SIZE:
            raise ValueError(f"secp256k1 privkey must be {PRIVKEY_SIZE} bytes")
        d = int.from_bytes(b, "big")
        if not (1 <= d < _N):
            raise ValueError("secp256k1 privkey out of range")
        self._d = d
        self._pub = Secp256k1PubKey(_compress(_pt_mul(d, _G)))

    @classmethod
    def generate(cls) -> "Secp256k1PrivKey":
        while True:
            b = os.urandom(PRIVKEY_SIZE)
            d = int.from_bytes(b, "big")
            if 1 <= d < _N:
                return cls(b)

    @classmethod
    def from_secret(cls, secret: bytes) -> "Secp256k1PrivKey":
        """Deterministic key (Go GenPrivKeySecp256k1: SHA-256 of
        the secret, adjusted into range)."""
        d = int.from_bytes(hashlib.sha256(secret).digest(), "big") % (_N - 1)
        return cls((d + 1).to_bytes(32, "big"))

    def bytes(self) -> bytes:
        return self._d.to_bytes(32, "big")

    def sign(self, msg: bytes) -> bytes:
        h1 = hashlib.sha256(msg).digest()
        e = int.from_bytes(h1, "big") % _N
        while True:
            k = _rfc6979_k(self._d, h1)
            pt = _pt_mul(k, _G)
            r = pt[0] % _N
            if r == 0:
                h1 = hashlib.sha256(h1).digest()
                continue
            s = (_inv(k, _N) * (e + r * self._d)) % _N
            if s == 0:
                h1 = hashlib.sha256(h1).digest()
                continue
            if s > _N // 2:
                s = _N - s  # lower-S normalization
            return r.to_bytes(32, "big") + s.to_bytes(32, "big")

    def pub_key(self) -> Secp256k1PubKey:
        return self._pub

    @property
    def type_name(self) -> str:
        return KEY_TYPE


register_pubkey(KEY_TYPE, Secp256k1PubKey)
