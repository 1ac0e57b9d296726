"""GF(2^255-19) arithmetic on batched float32 limb tensors — the plain
PyTorch version of ``csrc/field_f32.cuh``, the field that
``TM_TPU_FIELD=f32`` selects (crypto/cuda/fieldsel.py).

Representation (the reference's, tendermint_tpu/crypto/tpu/field_f32.py,
and the CUDA header's): a batch is a (32, N) float32 tensor, limb i of
weight 2^(8i), lanes on the trailing axis. Limbs are SIGNED: any
integer-valued limb vector whose value is congruent to the element.
Every value is an integer below 2^24 in magnitude, so every product,
sum, floor and power-of-two scaling is exact in IEEE float32 whatever
the order of the operations: this module, the reference and the
kernels give the same limbs, lane for lane.

Bounds (the reference's; its tests drive the all-max patterns):

- REDUCED: |limb| <= 680. ``mul``/``sqr`` take REDUCED inputs, so a
  schoolbook column is at most 32 * 680^2 < 2^24, and return REDUCED.
- ``add``/``sub``/``neg`` take REDUCED and return REDUCED after one
  carry pass; carries are floor divisions, so negative limbs borrow.
- A carry is c = floor(x * 2^-8), r = x - 256c; a carry out of limb 31
  (weight 2^256 = 38 mod p) re-enters as 38c split over limbs 0 and 1.
- ``canonical`` runs in int32 and returns the unique representative in
  [0, p) with limbs in [0, 256).

The public names are those of crypto/cuda/field.py, so every plain
kernel module runs unchanged on either field.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

P = 2**255 - 19
NLIMB = 32
BITS = 8
MASK = (1 << BITS) - 1
FOLD = 38  # 2^(8*32) = 2^256 = 38 (mod p)
REDUCED_BOUND = 681  # |limb| <= 680
# The limbs of the plain version and of a table in device memory.
DTYPE = torch.float32
TABLE_DTYPE = torch.float32
# Limbs per coordinate of the reference's tables under TM_TPU_FIELD=f32
# (the same layout: 4 x 32 floats fill its 128-wide row).
REF_NLIMB = 32

D = (-121665 * pow(121666, P - 2, P)) % P
D2 = (2 * D) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)

_INV256 = 2.0 ** -BITS


def to_limbs(x: int) -> np.ndarray:
    """Python int in [0, 2^256) -> (32,) float32 limbs in [0, 256)."""
    assert 0 <= x < 1 << (BITS * NLIMB)
    return np.array([(x >> (BITS * i)) & MASK for i in range(NLIMB)],
                    np.float32)


def from_limbs(limbs) -> list[int] | int:
    """(32,) or (32, N) limbs -> Python int(s) (not reduced mod p)."""
    arr = np.asarray(limbs.cpu() if torch.is_tensor(limbs) else limbs)
    ints = np.rint(arr).astype(np.int64)
    if arr.ndim == 1:
        return sum(int(ints[i]) << (BITS * i) for i in range(arr.shape[0]))
    return [sum(int(ints[i, n]) << (BITS * i) for i in range(arr.shape[0]))
            for n in range(arr.shape[1])]


@functools.cache
def _const_limbs(device: str, x: int) -> torch.Tensor:
    return torch.as_tensor(to_limbs(x % P), device=device)


def const(x: int, n: int, device) -> torch.Tensor:
    """A constant element broadcast over N lanes, (32, N) float32 (a
    view)."""
    return _const_limbs(str(device), x)[:, None].expand(NLIMB, n)


def limbs_from_bytes(rows: torch.Tensor) -> torch.Tensor:
    """(32, N) integer little-endian byte rows, top bit already cleared
    -> (32, N) limbs: a byte row is a limb row, so this is a cast."""
    return rows.to(DTYPE)


def from_reference(limbs: np.ndarray) -> np.ndarray:
    """Elements held in the reference's f32 layout (..., 32): the same
    limbs."""
    return np.asarray(limbs, np.float32)


def _carry_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact (floor(x / 256), x mod 256) with the remainder in [0, 256)."""
    c = torch.floor(x * _INV256)
    return c, x - c * 256.0


def _fold_top(r: torch.Tensor, ctop: torch.Tensor) -> torch.Tensor:
    """Fold a carry of weight 2^256 back in as 38c over limbs 0 and 1."""
    hi, lo = _carry_split(ctop * float(FOLD))
    return torch.cat([(r[0] + lo)[None], (r[1] + hi)[None], r[2:]])


def _pass32(x: torch.Tensor) -> torch.Tensor:
    """One parallel carry pass over the 32 limbs, with the top fold."""
    c, r = _carry_split(x)
    r = torch.cat([r[:1], r[1:] + c[:-1]])
    return _fold_top(r, c[-1])


def add(a, b):
    return _pass32(a + b)


def sub(a, b):
    return _pass32(a - b)


def neg(a):
    return _pass32(-a)


@functools.cache
def _columns(device: str) -> torch.Tensor:
    """(1024,) column i + j of the product limb pair (i, j)."""
    i = torch.arange(NLIMB, device=device)
    return (i[:, None] + i[None, :]).reshape(-1)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product of REDUCED inputs into 63 columns (each below
    2^24 in magnitude, so exact in any order), then ``_reduce63``."""
    n = a.shape[-1]
    prod = (a[:, None, :] * b[None, :, :]).reshape(NLIMB * NLIMB, n)
    cols = torch.zeros((2 * NLIMB - 1, n), dtype=DTYPE, device=a.device)
    cols.index_add_(0, _columns(str(a.device)), prod)
    return _reduce63(cols)


def sqr(a: torch.Tensor) -> torch.Tensor:
    """a^2. The reference (and the kernel) sum doubled cross terms and
    the diagonal per column; the columns are the same exact integers as
    mul(a, a)'s, so the limbs are too."""
    return mul(a, a)


def _reduce63(c: torch.Tensor) -> torch.Tensor:
    """(63, N) schoolbook columns (|col| < 2^24) -> REDUCED (32, N): a
    carry pass into 64 limbs, limbs 32..63 folded by 38 (split, with the
    top spill folded once more), then two parallel passes."""
    cc, r = _carry_split(c)
    r = torch.cat([r[:1], r[1:] + cc[:-1], cc[-1:]])  # (64, N)
    hi, lo = _carry_split(r[NLIMB:] * float(FOLD))
    hi2, lo2 = _carry_split(hi[-1] * float(FOLD))
    d0 = r[0] + lo[0] + lo2
    d1 = r[1] + lo[1] + hi[0] + hi2
    rest = r[2:NLIMB] + lo[2:] + hi[1:-1]
    d = torch.cat([d0[None], d1[None], rest])
    return _pass32(_pass32(d))


def _ripple(x: list) -> tuple[list, torch.Tensor]:
    """Exact sequential carry in int32: limbs in [0, 256) and the signed
    out-carry (an arithmetic shift floors, so borrows propagate)."""
    out = []
    carry = torch.zeros_like(x[0])
    for limb in x:
        v = limb + carry
        carry = v >> BITS
        out.append(v & MASK)
    return out, carry


def canonical(x: torch.Tensor) -> torch.Tensor:
    """Unique representative in [0, p), limbs in [0, 256), as float32.

    In int32: a ripple, three folds of the out-carry (38c into limb 0)
    each followed by a ripple, bit 255 folded as 19, one more ripple;
    then X >= p iff X + 19 >= 2^255 (the reference's steps)."""
    l, c = _ripple(list(x.to(torch.int32).unbind(0)))
    for _ in range(3):
        l[0] = l[0] + FOLD * c
        l, c = _ripple(l)
    hb = l[31] >> 7
    l[0] = l[0] + 19 * hb
    l[31] = l[31] & 0x7F
    l, _ = _ripple(l)
    t = list(l)
    t[0] = t[0] + 19
    t, _ = _ripple(t)
    ge = (t[31] >> 7) > 0
    t[31] = t[31] & 0x7F
    return torch.where(ge[None], torch.stack(t), torch.stack(l)).to(DTYPE)


def is_zero(a) -> torch.Tensor:
    return (canonical(a) == 0).all(dim=0)


def eq(a, b) -> torch.Tensor:
    return is_zero(sub(a, b))


def parity(a) -> torch.Tensor:
    return canonical(a)[0].to(torch.int32) & 1


def nsquare(a, n: int):
    for _ in range(n):
        a = sqr(a)
    return a


def pow_2_252_m3(z):
    """z^(2^252 - 3): the reference's addition chain (11 multiplies +
    252 squarings)."""
    z2 = sqr(z)
    z9 = mul(sqr(sqr(z2)), z)
    z11 = mul(z9, z2)
    z_5_0 = mul(sqr(z11), z9)
    z_10_0 = mul(nsquare(z_5_0, 5), z_5_0)
    z_20_0 = mul(nsquare(z_10_0, 10), z_10_0)
    z_40_0 = mul(nsquare(z_20_0, 20), z_20_0)
    z_50_0 = mul(nsquare(z_40_0, 10), z_10_0)
    z_100_0 = mul(nsquare(z_50_0, 50), z_50_0)
    z_200_0 = mul(nsquare(z_100_0, 100), z_100_0)
    z_250_0 = mul(nsquare(z_200_0, 50), z_50_0)
    return mul(nsquare(z_250_0, 2), z)
