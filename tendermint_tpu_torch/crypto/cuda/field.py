"""GF(2^255-19) arithmetic on batched int64 limb tensors — the plain
PyTorch version of ``csrc/field.cuh``.

Representation (the same in both): ten signed limbs in radix 2^25.5
(ref10's layout), limb i of weight 2^OFFS[i] with OFFS = 0, 26, 51, 77,
..., 230, alternating 26- and 25-bit widths. A batch is a (10, N)
int64 tensor, lanes on the trailing axis. The CUDA kernels hold the
limbs as int32 and form every product as int32 x int32 -> int64; the
integers are the same, so a lane can be compared limb by limb.

Bounds (every op keeps them; ``carry`` establishes them):

- LOOSE: every limb in (-2^26, 2^26). Every op here returns LOOSE.
- ``mul`` takes LOOSE inputs. A column is at most 10 terms of
  38 * 2^26 * 2^26 (the x2 of odd*odd limbs and the x19 wrap), so it
  stays below 380 * 2^52 < 2^61: int64 never overflows.
- ``canonical`` takes LOOSE input and returns the unique
  representative in [0, p), with exact limbs.

The reference (tendermint_tpu/crypto/tpu/field.py) uses 22 limbs of 12
bits; the two agree on canonical values, not on limbs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

P = 2**255 - 19
NLIMB = 10
WIDTHS = (26, 25, 26, 25, 26, 25, 26, 25, 26, 25)
OFFS = (0, 26, 51, 77, 102, 128, 153, 179, 204, 230)
# The limbs of the plain version and of a table in device memory.
DTYPE = torch.int64
TABLE_DTYPE = torch.int32
# Limbs per coordinate of the reference's tables (its default field,
# 22 twelve-bit limbs), which from_reference re-encodes.
REF_NLIMB = 22

D = (-121665 * pow(121666, P - 2, P)) % P
D2 = (2 * D) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)

# mul: product f_i * g_j lands in column (i + j) % 10, times 2 when
# both i and j are odd (the half bits of radix 2^25.5) and times 19
# when i + j >= 10 (2^255 = 19 mod p). Written per output column k:
# the g limb j = (k - i) % 10 meets f_i with coefficient _COEF[i, k].
_GIDX = np.array([[(k - i) % NLIMB for k in range(NLIMB)]
                  for i in range(NLIMB)], np.int64)
_COEF = np.array([[(2 if (i & 1 and j & 1) else 1) * (19 if i + j >= NLIMB else 1)
                   for j in (_GIDX[i, k] for k in range(NLIMB))]
                  for i in range(NLIMB)], np.int64)
# sqr: the same columns with each cross product a_i * a_j (i < j) taken
# once and doubled (csrc/field.cuh fe_sqr): 55 terms (i, j, column,
# coefficient), the column sums the same integers as mul(a, a)'s.
_SQ_I, _SQ_J, _SQ_COL, _SQ_COEF = (np.array(c, np.int64) for c in zip(*[
    (i, j, (i + j) % NLIMB, (2 if i < j else 1) * (2 if i & 1 and j & 1 else 1)
     * (19 if i + j >= NLIMB else 1))
    for i in range(NLIMB) for j in range(i, NLIMB)]))


def to_limbs(x: int) -> np.ndarray:
    """Python int in [0, 2^255) -> (10,) int64 exact limbs."""
    assert 0 <= x < 1 << 255
    return np.array([(x >> OFFS[i]) & ((1 << WIDTHS[i]) - 1)
                     for i in range(NLIMB)], np.int64)


def from_limbs(limbs) -> list[int] | int:
    """(10,) or (10, N) limbs -> Python int(s) (not reduced mod p)."""
    arr = np.asarray(limbs.cpu() if torch.is_tensor(limbs) else limbs)
    if arr.ndim == 1:
        return sum(int(arr[i]) << OFFS[i] for i in range(NLIMB))
    return [sum(int(arr[i, n]) << OFFS[i] for i in range(NLIMB))
            for n in range(arr.shape[1])]


@functools.cache
def _const_limbs(device: str, x: int) -> torch.Tensor:
    return torch.as_tensor(to_limbs(x % P), device=device)


@functools.cache
def _sqr_tables(device: str) -> tuple[torch.Tensor, ...]:
    return tuple(torch.as_tensor(t, device=device)
                 for t in (_SQ_I, _SQ_J, _SQ_COL, _SQ_COEF))


@functools.cache
def _mul_tables(device: str) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.as_tensor(_GIDX.reshape(-1), device=device),
            torch.as_tensor(_COEF, device=device))


def const(x: int, n: int, device) -> torch.Tensor:
    """A constant element broadcast over N lanes, (10, N) int64 (a view)."""
    return _const_limbs(str(device), x)[:, None].expand(NLIMB, n)


def carry(h: torch.Tensor) -> torch.Tensor:
    """One sequential floor-carry pass (arithmetic shift for the carry,
    a mask for the remainder) 0..9 with the top carry folded
    back as 19*c into limb 0, then one more limb 0 -> 1 carry. Output
    limbs lie in [0, 2^w) except limb 1, which may be off by the last
    carry: LOOSE for any column sums below 2^62."""
    h = list(h.unbind(0))
    for i in range(NLIMB):
        w = WIDTHS[i]
        c = h[i] >> w
        h[i] = h[i] & ((1 << w) - 1)
        if i < NLIMB - 1:
            h[i + 1] = h[i + 1] + c
        else:
            h[0] = h[0] + 19 * c
    c = h[0] >> 26
    h[0] = h[0] & ((1 << 26) - 1)
    h[1] = h[1] + c
    return torch.stack(h)


def add(a, b):
    return carry(a + b)


def sub(a, b):
    return carry(a - b)


def neg(a):
    return carry(-a)


def mul(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Schoolbook product of LOOSE inputs, then ``carry``."""
    n = f.shape[-1]
    gidx, coef = _mul_tables(str(f.device))
    gg = g.index_select(0, gidx).view(NLIMB, NLIMB, n)
    h = (f[:, None, :] * gg * coef[:, :, None]).sum(dim=0)
    return carry(h)


def sqr(a: torch.Tensor) -> torch.Tensor:
    """Square of a LOOSE input with symmetric column sums (55 products,
    csrc/field.cuh fe_sqr), then ``carry``: the limbs of mul(a, a)."""
    si, sj, col, coef = _sqr_tables(str(a.device))
    terms = a.index_select(0, si) * a.index_select(0, sj) * coef[:, None]
    h = torch.zeros_like(a).index_add_(0, col, terms)
    return carry(h)


def _pass(h: list) -> list:
    """Exact floor-carry pass with the top fold (canonical's step)."""
    for i in range(NLIMB):
        w = WIDTHS[i]
        c = h[i] >> w
        h[i] = h[i] & ((1 << w) - 1)
        if i < NLIMB - 1:
            h[i + 1] = h[i + 1] + c
        else:
            h[0] = h[0] + 19 * c
    return h


def canonical(x: torch.Tensor) -> torch.Tensor:
    """Unique representative in [0, p), exact limbs.

    Two passes bring a LOOSE value X (|X| < 2^258) to exact limbs with
    value in [0, 2^255): after the first, X1 = R + 19c lies in
    [-152, 2^255 + 152); the second's top carry is -1, 0 or 1 and in
    each case leaves every limb in range. Then X >= p iff X + 19 >=
    2^255: add 19, ripple, and keep the sum minus 2^255 when the top
    carry is set."""
    h = _pass(_pass(list(x.unbind(0))))
    t = list(h)
    t[0] = t[0] + 19
    for i in range(NLIMB - 1):
        c = t[i] >> WIDTHS[i]
        t[i] = t[i] & ((1 << WIDTHS[i]) - 1)
        t[i + 1] = t[i + 1] + c
    ge = (t[9] >> 25) > 0
    t[9] = t[9] & ((1 << 25) - 1)
    return torch.where(ge[None], torch.stack(t), torch.stack(h))


def is_zero(a) -> torch.Tensor:
    return (canonical(a) == 0).all(dim=0)


def eq(a, b) -> torch.Tensor:
    return is_zero(sub(a, b))


def parity(a) -> torch.Tensor:
    return canonical(a)[0] & 1


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


def limbs_from_bytes(rows: torch.Tensor) -> torch.Tensor:
    """(32, N) int64 little-endian byte rows, top bit already cleared
    -> (10, N) exact limbs of the 255-bit integer (values >= p stay
    unreduced, as ZIP-215 decompression wants)."""
    out = []
    for i in range(NLIMB):
        j, s = divmod(OFFS[i], 8)
        v = torch.zeros_like(rows[0])
        for k in range(5):
            if j + k < 32:
                v = v | (rows[j + k] << (8 * k))
        out.append((v >> s) & ((1 << WIDTHS[i]) - 1))
    return torch.stack(out)


def from_radix12(limbs: np.ndarray) -> np.ndarray:
    """Re-encode elements held as (..., 22) non-negative 12-bit-radix
    limbs (the reference's layout, limbs below 2^15) as (..., 10)
    int32 canonical limbs of this representation.

    Vectorized: normalize the 22 limbs to exact 12-bit digits (the
    value is below 2^267), cut the low 255 bits into this layout, fold
    the bits above 255 back as 19 * hi, and canonicalize."""
    a = np.asarray(limbs, np.int64)
    shape = a.shape[:-1]
    a = a.reshape(-1, 22).T.copy()  # (22, M)
    for k in range(21):
        a[k + 1] += a[k] >> 12
        a[k] &= 4095
    top = a[21] >> 12  # weight 2^264
    a[21] &= 4095
    out = np.zeros((NLIMB, a.shape[1]), np.int64)
    for i in range(NLIMB):
        lo, w = OFFS[i], WIDTHS[i]
        for k in range(22):
            kb = 12 * k
            if kb + 12 <= lo or kb >= lo + w:
                continue
            part = a[k] >> (lo - kb) if kb < lo else a[k] << (kb - lo)
            out[i] |= part & ((1 << w) - 1)
    hi = (a[21] >> 3) + (top << 9)  # bits 255.. (2^255 = 19 mod p)
    out[0] += 19 * hi
    canon = canonical(torch.from_numpy(out)).numpy()
    return canon.T.reshape(shape + (NLIMB,)).astype(np.int32)


from_reference = from_radix12
