"""Batched ristretto255 (RFC 9496) decode and equality — the plain
PyTorch version of ``csrc/ristretto.cuh``.

Replaces the reference's tendermint_tpu/crypto/tpu/ristretto.py
(``sqrt_ratio_m1:30``, ``decode:48``, ``equal:77``, ``_abs``) on the
selected field (crypto/cuda/fieldsel.py). Decode costs one
sqrt-ratio exponentiation per lane, the same pow_2_252_m3 chain as
edwards decompression. Encoding never runs on the device: sr25519
verification needs only "encode(V) == R_bytes", which over the
quotient group is ristretto EQUALITY of V and decode(R_bytes):

    eq(P1, P2) := X1*Y2 == Y1*X2  or  Y1*Y2 == X1*X2.

The host checks the encodings' bytes (canonical s < p, s even) and
passes the result as ``pre_ok``; a lane that fails any check comes back
as the identity with ok = False. ``*_branches`` return the individual
conditions, so tests and chip_smoke.py can show which branch each lane
takes.
"""

from __future__ import annotations

import torch

from . import edwards as ed
from .fieldsel import F as fe


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x|: negate when the canonical representative is odd."""
    return torch.where((fe.parity(x) == 1)[None], fe.neg(x), x)


def sqrt_ratio_m1_branches(u: torch.Tensor, v: torch.Tensor):
    """RFC 9496 §4.2's candidate root of u/v over (NLIMB, N) limbs and its
    three tests: (r, correct, flipped, flipped_i), where v * r^2 is u,
    -u and -u * sqrt(-1) respectively."""
    n, dev = u.shape[-1], u.device
    v3 = fe.mul(fe.sqr(v), v)
    v7 = fe.mul(fe.sqr(v3), v)
    r = fe.mul(fe.mul(u, v3), fe.pow_2_252_m3(fe.mul(u, v7)))
    check = fe.mul(v, fe.sqr(r))
    neg_u = fe.neg(u)
    correct = fe.eq(check, u)
    flipped = fe.eq(check, neg_u)
    flipped_i = fe.eq(check, fe.mul(neg_u, fe.const(fe.SQRT_M1, n, dev)))
    return r, correct, flipped, flipped_i


def sqrt_ratio_m1(u: torch.Tensor, v: torch.Tensor):
    """RFC 9496 §4.2 SQRT_RATIO_M1: (was_square (N,) bool, the
    non-negative root (NLIMB, N))."""
    n, dev = u.shape[-1], u.device
    r, correct, flipped, flipped_i = sqrt_ratio_m1_branches(u, v)
    r = torch.where((flipped | flipped_i)[None],
                    fe.mul(r, fe.const(fe.SQRT_M1, n, dev)), r)
    return correct | flipped, _abs(r)


def _decode_terms(s: torch.Tensor):
    """decode's field terms before the square root: 1, u1 = 1 - s^2,
    u2 = 1 + s^2, v = -(D * u1^2) - u2^2, and u2^2."""
    n, dev = s.shape[-1], s.device
    one = fe.const(1, n, dev)
    ss = fe.sqr(s)
    u1 = fe.sub(one, ss)
    u2 = fe.add(one, ss)
    u2s = fe.sqr(u2)
    v = fe.sub(fe.neg(fe.mul(fe.const(fe.D, n, dev), fe.sqr(u1))), u2s)
    return one, u1, u2, v, u2s


def decode_ratio_branches(s: torch.Tensor):
    """The (correct, flipped, flipped_i) tests of decode's square root
    for (NLIMB, N) encodings s."""
    one, _u1, _u2, v, u2s = _decode_terms(s)
    return sqrt_ratio_m1_branches(one, fe.mul(v, u2s))[1:]


def decode(s: torch.Tensor, pre_ok: torch.Tensor):
    """RFC 9496 §4.3.1 DECODE of (NLIMB, N) limbs of the encodings.
    Returns (Point with Z = 1, ok); a failed lane is the identity."""
    one, u1, u2, v, u2s = _decode_terms(s)
    was_square, invsqrt = sqrt_ratio_m1(one, fe.mul(v, u2s))
    den_x = fe.mul(invsqrt, u2)
    den_y = fe.mul(fe.mul(invsqrt, den_x), v)
    x = _abs(fe.mul(fe.add(s, s), den_x))
    y = fe.mul(u1, den_y)
    t = fe.mul(x, y)
    ok = was_square & (fe.parity(t) == 0) & ~fe.is_zero(y) & pre_ok
    x = torch.where(ok[None], x, torch.zeros_like(x))
    y = torch.where(ok[None], y, one)
    return ed.Point(x, y, one, fe.mul(x, y)), ok


def equal_branches(p: ed.Point, q: ed.Point):
    """(X1*Y2 == Y1*X2, Y1*Y2 == X1*X2) per lane."""
    return (fe.eq(fe.mul(p.x, q.y), fe.mul(p.y, q.x)),
            fe.eq(fe.mul(p.y, q.y), fe.mul(p.x, q.x)))


def equal(p: ed.Point, q: ed.Point) -> torch.Tensor:
    """Ristretto equality (projective; no encode needed)."""
    xy, yy = equal_branches(p, q)
    return xy | yy
