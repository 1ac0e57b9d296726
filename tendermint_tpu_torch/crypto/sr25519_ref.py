"""Pure-Python sr25519 (schnorrkel) — the host oracle.

Reference: crypto/sr25519/pubkey.go:34-61 and privkey.go (via
ChainSafe/go-schnorrkel, which mirrors Rust `schnorrkel`); the port's
copy of the JAX package's crypto/sr25519_ref.py, built on the port's
ed25519_ref:

  - Keys/points live on ristretto255 (RFC 9496): the prime-order
    quotient group over edwards25519. Decode/encode implemented here on
    top of the integer curve arithmetic in ed25519_ref.
  - Challenges come from Merlin transcripts (crypto/merlin.py):
    verification builds SigningContext([], msg), then
    proto-name "Schnorr-sig", commits pk and R, and draws a 64-byte
    challenge scalar "sign:c" reduced mod L.
  - Signature layout: R (32, ristretto) || s (32, scalar LE) with the
    schnorrkel marker bit (byte 63, bit 7) SET on the wire and cleared
    before use; s must be canonical (< L).
  - MiniSecretKey -> SecretKey expansion "ExpandEd25519":
    h = SHA-512(mini); key = clamp(h[:32]) >> 3 (divide by cofactor),
    nonce = h[32:]; public = [key]B encoded as ristretto.

Verify checks encode([s]B - [k]A) == R_bytes — equality of ristretto
ENCODINGS, exactly like schnorrkel (the quotient makes torsion
components irrelevant).

Signing uses a deterministic nonce (SHA-512 of nonce||pub||msg||ctx);
schnorrkel's is randomized, but any nonce yields interoperable
signatures. The fixed-base multiplies go through ed25519_ref's comb
(``base_mult``): the same points, so the same bytes as the JAX
package's ``sign``, several times faster.
"""

from __future__ import annotations

import functools
import hashlib

from . import ed25519_ref as ed
from .merlin import Transcript

P = ed.P
L = ed.L
D = ed.D
SQRT_M1 = ed.SQRT_M1

SIGNATURE_SIZE = 64
PUBKEY_SIZE = 32


def _is_negative(x: int) -> bool:
    return (x % P) & 1 == 1


def _ct_abs(x: int) -> int:
    x %= P
    return P - x if _is_negative(x) else x


def _sqrt_ratio_m1(u: int, v: int) -> tuple[bool, int]:
    """(was_square, sqrt(u/v)-ish) per RFC 9496 §4.2."""
    u %= P
    v %= P
    v3 = (v * v * v) % P
    v7 = (v3 * v3 * v) % P
    r = (u * v3 * pow((u * v7) % P, (P - 5) // 8, P)) % P
    check = (v * r * r) % P
    correct = check == u
    flipped = check == (P - u) % P
    flipped_i = check == (P - u) * SQRT_M1 % P
    if flipped or flipped_i:
        r = (r * SQRT_M1) % P
    return (correct or flipped), _ct_abs(r)


@functools.cache
def _invsqrt_a_minus_d() -> int:
    """1/sqrt(a - d) with a = -1 (a constant of RFC 9496)."""
    ok, r = _sqrt_ratio_m1(1, (-1 - D) % P)
    assert ok
    return r


def ristretto_decode(b: bytes):
    """32 bytes -> extended point, or None if invalid (RFC 9496 §4.3.1)."""
    if len(b) != 32:
        return None
    s = int.from_bytes(b, "little")
    if s >= P:  # non-canonical
        return None
    if _is_negative(s):
        return None
    ss = (s * s) % P
    u1 = (1 - ss) % P
    u2 = (1 + ss) % P
    u2_sqr = (u2 * u2) % P
    v = (-(D * u1 * u1) - u2_sqr) % P
    was_square, invsqrt = _sqrt_ratio_m1(1, (v * u2_sqr) % P)
    den_x = (invsqrt * u2) % P
    den_y = (invsqrt * den_x * v) % P
    x = _ct_abs((2 * s * den_x) % P)
    y = (u1 * den_y) % P
    t = (x * y) % P
    if not was_square or _is_negative(t) or y == 0:
        return None
    return (x, y, 1, t)


def ristretto_encode(pt) -> bytes:
    """Extended point -> canonical 32-byte encoding (RFC 9496 §4.3.2)."""
    x0, y0, z0, t0 = pt
    u1 = ((z0 + y0) * (z0 - y0)) % P
    u2 = (x0 * y0) % P
    _, invsqrt = _sqrt_ratio_m1(1, (u1 * u2 * u2) % P)
    den1 = (invsqrt * u1) % P
    den2 = (invsqrt * u2) % P
    z_inv = (den1 * den2 * t0) % P
    rotate = _is_negative((t0 * z_inv) % P)
    if rotate:
        x = (y0 * SQRT_M1) % P
        y = (x0 * SQRT_M1) % P
        den_inv = (den1 * _invsqrt_a_minus_d()) % P
    else:
        x = x0
        y = y0
        den_inv = den2
    if _is_negative((x * z_inv) % P):
        y = (P - y) % P
    s = _ct_abs((den_inv * (z0 - y)) % P)
    return s.to_bytes(32, "little")


def challenge(public_key: bytes, r_bytes: bytes, msg: bytes,
              ctx: bytes = b"") -> int:
    """The schnorrkel challenge k: schnorrkel.NewSigningContext(ctx, msg)
    (the reference passes ctx = [], crypto/sr25519/pubkey.go:50), then
    proto-name, sign:pk and sign:R, and 64 bytes of "sign:c" mod L. The
    signer and the verifier build the same transcript."""
    t = Transcript(b"SigningContext")
    t.append_message(b"", ctx)
    t.append_message(b"sign-bytes", msg)
    t.append_message(b"proto-name", b"Schnorr-sig")
    t.append_message(b"sign:pk", public_key)
    t.append_message(b"sign:R", r_bytes)
    return int.from_bytes(t.challenge_bytes(b"sign:c", 64), "little") % L


def expand_ed25519(mini: bytes) -> tuple[int, bytes]:
    """MiniSecretKey -> (scalar key, 32-byte nonce)."""
    h = hashlib.sha512(mini).digest()
    key = bytearray(h[:32])
    key[0] &= 248
    key[31] &= 63
    key[31] |= 64
    scalar = int.from_bytes(bytes(key), "little") >> 3  # divide by cofactor
    return scalar, h[32:]


def public_key_from_mini(mini: bytes) -> bytes:
    scalar, _ = expand_ed25519(mini)
    return ristretto_encode(ed.base_mult(scalar))


def nonce_scalar(nonce: bytes, pub: bytes, msg: bytes, ctx: bytes) -> int:
    """The deterministic signing nonce r (schnorrkel randomizes it)."""
    return int.from_bytes(
        hashlib.sha512(nonce + pub + msg + ctx).digest(), "little") % L


def finish_signature(big_r: bytes, k: int, key: int, r: int) -> bytes:
    """R || (k * key + r mod L) with the schnorrkel marker bit set."""
    s = (k * key + r) % L
    sig = bytearray(big_r + s.to_bytes(32, "little"))
    sig[63] |= 128
    return bytes(sig)


def sign(mini: bytes, msg: bytes, ctx: bytes = b"") -> bytes:
    key, nonce = expand_ed25519(mini)
    pub = ristretto_encode(ed.base_mult(key))
    r = nonce_scalar(nonce, pub, msg, ctx)
    big_r = ristretto_encode(ed.base_mult(r))
    return finish_signature(big_r, challenge(pub, big_r, msg, ctx), key, r)


def verify(public_key: bytes, msg: bytes, sig: bytes,
           ctx: bytes = b"") -> bool:
    if len(sig) != SIGNATURE_SIZE or len(public_key) != PUBKEY_SIZE:
        return False
    if sig[63] & 128 == 0:
        return False  # not schnorrkel-marked
    a_pt = ristretto_decode(public_key)
    if a_pt is None:
        return False
    r_bytes = sig[:32]
    s_bytes = bytearray(sig[32:])
    s_bytes[63 - 32] &= 0x7F
    s = int.from_bytes(bytes(s_bytes), "little")
    if s >= L:
        return False
    k = challenge(public_key, r_bytes, msg, ctx)
    # R' = [s]B - [k]A; accept iff encode(R') == R_bytes.
    neg_a = ed.pt_neg(a_pt)
    rp = ed.pt_add(ed.base_mult(s), ed.scalar_mult(k, neg_a))
    return ristretto_encode(rp) == r_bytes
