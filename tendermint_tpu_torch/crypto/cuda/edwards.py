"""Batched edwards25519 point arithmetic — the plain PyTorch version of
``csrc/edwards.cuh``.

Points are (X, Y, Z, T) tuples of (NLIMB, N) limb tensors of the
selected field (crypto/cuda/fieldsel.py), extended
coordinates with x = X/Z, y = Y/Z, T = XY/Z. The formulas are the
reference's exactly (tendermint_tpu/crypto/tpu/edwards.py: complete
add-2008-hwcd-3 and dbl-2008-hwcd for a = -1), so every intermediate
point, and every comb-table entry, equals the reference's mod p
coordinate by coordinate.

Decompression is ZIP-215: y is the 255-bit value as given (y >= p is
accepted), x = 0 with sign 1 is accepted, and a lane that fails
carries the identity with ok = False.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .fieldsel import F as fe


class Point(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    t: torch.Tensor


def identity(n: int, device) -> Point:
    return Point(fe.const(0, n, device), fe.const(1, n, device),
                 fe.const(1, n, device), fe.const(0, n, device))


def neg(p: Point) -> Point:
    return Point(fe.neg(p.x), p.y, p.z, fe.neg(p.t))


def add(p: Point, q: Point) -> Point:
    """Complete unified addition (add-2008-hwcd-3, a=-1)."""
    n = p.x.shape[-1]
    a = fe.mul(fe.sub(p.y, p.x), fe.sub(q.y, q.x))
    b = fe.mul(fe.add(p.y, p.x), fe.add(q.y, q.x))
    c = fe.mul(fe.mul(p.t, q.t), fe.const(fe.D2, n, p.x.device))
    zz = fe.mul(p.z, q.z)
    d = fe.add(zz, zz)
    e = fe.sub(b, a)
    f = fe.sub(d, c)
    g = fe.add(d, c)
    h = fe.add(b, a)
    return Point(fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), fe.mul(e, h))


def add_z1(p: Point, qx, qy, qt) -> Point:
    """Add a point with Z = 1 (a precomputed affine entry)."""
    n = p.x.shape[-1]
    a = fe.mul(fe.sub(p.y, p.x), fe.sub(qy, qx))
    b = fe.mul(fe.add(p.y, p.x), fe.add(qy, qx))
    c = fe.mul(fe.mul(p.t, qt), fe.const(fe.D2, n, p.x.device))
    d = fe.add(p.z, p.z)
    e = fe.sub(b, a)
    f = fe.sub(d, c)
    g = fe.add(d, c)
    h = fe.add(b, a)
    return Point(fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), fe.mul(e, h))


def double(p: Point) -> Point:
    """dbl-2008-hwcd for a = -1, as the reference writes it."""
    a = fe.sqr(p.x)
    b = fe.sqr(p.y)
    zz = fe.sqr(p.z)
    c = fe.add(zz, zz)
    h = fe.add(a, b)
    e = fe.sub(h, fe.sqr(fe.add(p.x, p.y)))
    g = fe.sub(a, b)
    f = fe.add(c, g)
    return Point(fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), fe.mul(e, h))


def is_identity(p: Point) -> torch.Tensor:
    """(N,) bool: X == 0 and Y == Z (mod p)."""
    return fe.is_zero(p.x) & fe.is_zero(fe.sub(p.y, p.z))


def decompress(y: torch.Tensor, sign: torch.Tensor) -> tuple[Point, torch.Tensor]:
    """ZIP-215 decompression. y: (NLIMB, N) exact limbs of the low 255
    bits; sign: (N,) int64 top bit. Returns (Point with Z = 1, ok)."""
    n, dev = y.shape[-1], y.device
    one = fe.const(1, n, dev)
    yy = fe.sqr(y)
    u = fe.sub(yy, one)
    v = fe.add(fe.mul(yy, fe.const(fe.D, n, dev)), one)
    v3 = fe.mul(fe.sqr(v), v)
    v7 = fe.mul(fe.sqr(v3), v)
    t = fe.pow_2_252_m3(fe.mul(u, v7))
    x = fe.mul(fe.mul(u, v3), t)
    vxx = fe.mul(v, fe.sqr(x))
    ok1 = fe.eq(vxx, u)
    ok2 = fe.eq(vxx, fe.neg(u))
    x = torch.where(ok2[None], fe.mul(x, fe.const(fe.SQRT_M1, n, dev)), x)
    ok = ok1 | ok2
    flip = fe.parity(x) != sign
    x = torch.where(flip[None], fe.neg(x), x)
    x = torch.where(ok[None], x, fe.const(0, n, dev))
    y = torch.where(ok[None], y, one)
    return Point(x, y, one, fe.mul(x, y)), ok


def decompress_bytes(rows: torch.Tensor) -> tuple[Point, torch.Tensor]:
    """(32, N) int64 encoding bytes -> decompress of (y, sign)."""
    sign = rows[31] >> 7
    y_rows = torch.cat([rows[:31], (rows[31] & 0x7F)[None]])
    return decompress(fe.limbs_from_bytes(y_rows), sign)


def select(table: torch.Tensor, digit: torch.Tensor) -> Point:
    """Per-lane lookup. table: (W, 4, NLIMB, N); digit: (N,) in [0, W)."""
    lanes = torch.arange(table.shape[-1], device=table.device)
    sel = table[digit, :, :, lanes].permute(1, 2, 0)  # (4, NLIMB, N)
    return Point(sel[0], sel[1], sel[2], sel[3])


def select_const(table: torch.Tensor, digit: torch.Tensor):
    """Shared-table lookup. table: (W, 3, NLIMB) (x, y, xy with Z = 1)
    in the table dtype; digit: (N,) -> (x, y, t) as (NLIMB, N) limbs."""
    sel = table[digit].to(fe.DTYPE).permute(1, 2, 0)  # (3, NLIMB, N)
    return sel[0], sel[1], sel[2]


def build_window_table(p: Point, width: int = 16) -> torch.Tensor:
    """[0..width-1] * P as a (width, 4, NLIMB, N) tensor (entry 0 =
    identity)."""
    n = p.x.shape[-1]
    entries = [identity(n, p.x.device), p]
    for _ in range(width - 2):
        entries.append(add(entries[-1], p))
    return torch.stack([torch.stack(list(e)) for e in entries])
