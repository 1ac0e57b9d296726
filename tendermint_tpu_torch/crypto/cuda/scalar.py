"""Challenge-scalar folding and digit recoding — the plain PyTorch
version of ``csrc/scalar.cuh``.

The challenge k = SHA-512(R||A||M) is not reduced mod L. The verified
equation is cofactored ([8][S]B == [8]R + [8][k]A), the group order is
8L, so any k' = k (mod L) gives the same verdict. The digest is folded
once through a (43 x 22) table of 2^(12i) mod L into the plain integer

    k' = sum_w chunk_w * (2^(12w) mod L)      (chunk_w: 12-bit digits)

which is below 2^270 and so has 69 nibbles. The port computes exactly
this integer (not another representative), so its nibbles and signed
digits equal the reference's (tendermint_tpu/crypto/tpu/scalar.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import ed25519_ref as ref

BITS = 12
MASK = (1 << BITS) - 1
DIGITS_K = 69  # folded challenge < 2^271 -> 69 nibbles
FOLD_ROWS = 43  # 12-bit chunks of the 512-bit digest (43*12 = 516)
FOLD_LIMBS = 22  # 12-bit limbs of each 2^(12w) mod L (< 2^253)


@functools.cache
def fold_table_mod_l() -> np.ndarray:
    """(43, 22) int32: 12-bit limbs of 2^(12*i) mod L."""
    tab = np.zeros((FOLD_ROWS, FOLD_LIMBS), np.int32)
    for i in range(FOLD_ROWS):
        v = pow(2, BITS * i, ref.L)
        for j in range(FOLD_LIMBS):
            tab[i, j] = v & MASK
            v >>= BITS
    tab.setflags(write=False)
    return tab


def _chunks12(rows: torch.Tensor, n: int) -> torch.Tensor:
    """(nbytes, N) int64 bytes (LE) -> (n, N) 12-bit digits."""
    out = []
    for k in range(n):
        j, s = divmod(BITS * k, 8)
        v = rows[j] >> s
        if j + 1 < rows.shape[0]:
            v = v | (rows[j + 1] << (8 - s))
        out.append(v & MASK)
    return torch.stack(out)


def fold_digest(digest_rows: torch.Tensor) -> torch.Tensor:
    """(64, N) int64 digest bytes (LE) -> (69, N) int64 nibbles of k',
    MSB-first (the reference's order)."""
    chunks = _chunks12(digest_rows, FOLD_ROWS)  # (43, N)
    tab = torch.as_tensor(np.array(fold_table_mod_l()), dtype=torch.int64,
                          device=digest_rows.device)
    acc = (tab[:, :, None] * chunks[:, None, :]).sum(dim=0)  # (22, N) < 2^30
    limbs = list(acc.unbind(0)) + [torch.zeros_like(acc[0])]
    for i in range(FOLD_LIMBS):  # exact: a plain integer, no wrap
        limbs[i + 1] = limbs[i + 1] + (limbs[i] >> BITS)
        limbs[i] = limbs[i] & MASK
    nibs = [(limb >> s) & 15 for limb in limbs for s in (0, 4, 8)]
    return torch.stack(nibs[::-1])  # (69, N) MSB-first


def bytes_to_nibbles(byte_rows: torch.Tensor) -> torch.Tensor:
    """(nbytes, N) int64 bytes (LE) -> (2*nbytes, N) nibbles, LSB-first."""
    out = []
    for j in range(byte_rows.shape[0]):
        out.append(byte_rows[j] & 15)
        out.append(byte_rows[j] >> 4)
    return torch.stack(out)


def recode_signed(nibs_lsb: torch.Tensor) -> torch.Tensor:
    """(69, N) nibbles LSB-first -> digits in [-8, 8] with
    sum d_w 16^w unchanged: a window emits d - 16 and carries 1 when
    nibble + carry >= 8. The folded value is < 2^271, so the top
    nibble is 0 and the last digit is at most 1 (no carry out)."""
    c = torch.zeros_like(nibs_lsb[0])
    out = []
    for w in range(nibs_lsb.shape[0]):
        t = nibs_lsb[w] + c
        c = (t >= 8).to(t.dtype)
        out.append(t - 16 * c)
    return torch.stack(out)
