"""SHA-512 over per-lane padded blocks — the plain PyTorch version of
``csrc/sha512.cuh``.

The ed25519 challenge k = SHA-512(R || A || M) is hashed on the device
for every lane. The host pads (``pad_messages``: 0x80, zeros, 128-bit
big-endian bit length) and reports each lane's block count; the device
runs every lane through its own number of compression rounds.

Here 64-bit words are (hi, lo) pairs of 32-bit halves held in int64
tensors, so every sum is exact and no shift ever reaches the sign bit
(the CUDA version works on uint64_t directly; both compute the same
function bit for bit).
"""

from __future__ import annotations

import numpy as np
import torch

_IV = [
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B,
    0xA54FF53A5F1D36F1, 0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
]

_K = [
    0x428A2F98D728AE22, 0x7137449123EF65CD, 0xB5C0FBCFEC4D3B2F, 0xE9B5DBA58189DBBC,
    0x3956C25BF348B538, 0x59F111F1B605D019, 0x923F82A4AF194F9B, 0xAB1C5ED5DA6D8118,
    0xD807AA98A3030242, 0x12835B0145706FBE, 0x243185BE4EE4B28C, 0x550C7DC3D5FFB4E2,
    0x72BE5D74F27B896F, 0x80DEB1FE3B1696B1, 0x9BDC06A725C71235, 0xC19BF174CF692694,
    0xE49B69C19EF14AD2, 0xEFBE4786384F25E3, 0x0FC19DC68B8CD5B5, 0x240CA1CC77AC9C65,
    0x2DE92C6F592B0275, 0x4A7484AA6EA6E483, 0x5CB0A9DCBD41FBD4, 0x76F988DA831153B5,
    0x983E5152EE66DFAB, 0xA831C66D2DB43210, 0xB00327C898FB213F, 0xBF597FC7BEEF0EE4,
    0xC6E00BF33DA88FC2, 0xD5A79147930AA725, 0x06CA6351E003826F, 0x142929670A0E6E70,
    0x27B70A8546D22FFC, 0x2E1B21385C26C926, 0x4D2C6DFC5AC42AED, 0x53380D139D95B3DF,
    0x650A73548BAF63DE, 0x766A0ABB3C77B2A8, 0x81C2C92E47EDAEE6, 0x92722C851482353B,
    0xA2BFE8A14CF10364, 0xA81A664BBC423001, 0xC24B8B70D0F89791, 0xC76C51A30654BE30,
    0xD192E819D6EF5218, 0xD69906245565A910, 0xF40E35855771202A, 0x106AA07032BBD1B8,
    0x19A4C116B8D2D0C8, 0x1E376C085141AB53, 0x2748774CDF8EEB99, 0x34B0BCB5E19B48A8,
    0x391C0CB3C5C95A63, 0x4ED8AA4AE3418ACB, 0x5B9CCA4F7763E373, 0x682E6FF3D6B2B8A3,
    0x748F82EE5DEFB2FC, 0x78A5636F43172F60, 0x84C87814A1F0AB72, 0x8CC702081A6439EC,
    0x90BEFFFA23631E28, 0xA4506CEBDE82BDE9, 0xBEF9A3F7B2C67915, 0xC67178F2E372532B,
    0xCA273ECEEA26619C, 0xD186B8C721C0C207, 0xEADA7DD6CDE0EB1E, 0xF57D4F7FEE6ED178,
    0x06F067AA72176FBA, 0x0A637DC5A2C898A6, 0x113F9804BEF90DAE, 0x1B710B35131C471B,
    0x28DB77F523047D84, 0x32CAAB7B40C72493, 0x3C9EBE0A15C9BEBC, 0x431D67C49C100D4C,
    0x4CC5D4BECB3E42B6, 0x597F299CFC657E2A, 0x5FCB6FAB3AD6FAEC, 0x6C44198C4A475817,
]


def pad_messages(msgs: list[bytes], prefix_len: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """SHA-512-pad variable-length messages into a (N, B*128 - prefix_len)
    uint8 buffer, assuming `prefix_len` fixed bytes (e.g. R||A = 64) will
    be prepended on device. Returns (padded, nblocks).

    From 256 messages up it is one pass of the port's C packer
    (``native/pack.c``, built at first use); below that, or with no C
    compiler, the numpy path: one np.repeat + one fancy-index scatter,
    no per-message Python beyond the b"".join. Both give the same bytes
    and int32 block counts.
    """
    n = len(msgs)
    lens = np.fromiter(map(len, msgs), np.int64, count=n)
    total_lens = lens + prefix_len
    # blocks: content + 1 (0x80) + 16 (length) rounded up to 128
    nblocks = (total_lens + 1 + 16 + 127) // 128
    max_blocks = int(nblocks.max()) if n else 1
    width = max_blocks * 128 - prefix_len
    if n >= 256:
        # Native path (native/pack.c): one C pass replaces the numpy
        # scatter or group fill and the tail writes; host packing runs
        # ahead of the launch, on the commit's latency.
        from ...native import lib as _native_lib

        L = _native_lib()
        if L is not None:
            flat = np.frombuffer(b"".join(msgs), np.uint8)
            starts = np.zeros(n, np.int64)
            np.cumsum(lens[:-1], out=starts[1:])
            out = np.zeros((n, width), np.uint8)
            nb = np.empty(n, np.int64)
            L.tm_pack_pad(flat, starts, np.ascontiguousarray(lens),
                          n, width, prefix_len, out, nb)
            return out, nb.astype(np.int32)  # the numpy path's dtype
    out = np.zeros((n, width), np.uint8)
    uniq = np.unique(lens) if n else lens
    if n and uniq.size <= 8:
        # Fast path: few distinct lengths (a commit's vote sign-bytes
        # differ only in varint-timestamp width, 2-3 values) — one bulk
        # reshape+copy per length group instead of the per-byte scatter
        # (8 ms -> ~1 ms at 10,240 lanes; the scatter was the single
        # largest host cost in the verify hot path).
        for length in uniq.tolist():
            if not length:
                continue
            mask = lens == length
            ii = np.nonzero(mask)[0]
            block = np.frombuffer(
                b"".join(msgs[i] for i in ii), np.uint8
            ).reshape(ii.size, length)
            out[mask, :length] = block
    else:
        flat = np.frombuffer(b"".join(msgs), np.uint8)
        if flat.size:
            rows = np.repeat(np.arange(n), lens)
            starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
            cols = np.arange(flat.size) - np.repeat(starts, lens)
            out[rows, cols] = flat
    out[np.arange(n), lens] = 0x80
    # 128-bit big-endian bit length at the end of each lane's final block;
    # bit lengths here always fit 4 bytes (messages < 512 MiB).
    bitlen = (total_lens * 8).astype(np.uint64)
    end = nblocks * 128 - prefix_len  # exclusive end col of final block
    for i in range(4):
        out[np.arange(n), end - 1 - i] = ((bitlen >> np.uint64(8 * i)) & np.uint64(0xFF)).astype(np.uint8)
    return out, nblocks.astype(np.int32)


_M32 = 0xFFFFFFFF


def _halves(vals) -> np.ndarray:
    a = np.asarray(vals, np.uint64)
    return np.stack([(a >> np.uint64(32)).astype(np.int64),
                     (a & np.uint64(_M32)).astype(np.int64)], axis=-1)


def _add(*pairs):
    """Sum of (hi, lo) pairs mod 2^64."""
    lo = sum(p[1] for p in pairs)
    hi = sum(p[0] for p in pairs) + (lo >> 32)
    return hi & _M32, lo & _M32


def _ror(x, r: int):
    h, l = x
    if r >= 32:
        h, l, r = l, h, r - 32
    if r == 0:
        return h, l
    return (((h >> r) | (l << (32 - r))) & _M32,
            ((l >> r) | (h << (32 - r))) & _M32)


def _shr(x, r: int):
    h, l = x
    return h >> r, ((l >> r) | (h << (32 - r))) & _M32


def _xor3(a, b, c):
    return a[0] ^ b[0] ^ c[0], a[1] ^ b[1] ^ c[1]


def bytes_to_words(msg_bytes: torch.Tensor) -> torch.Tensor:
    """(N, B*128) uint8 -> (B, 16, 2, N) int64 big-endian word halves."""
    n, width = msg_bytes.shape
    x = msg_bytes.to(torch.int64).reshape(n, width // 128, 16, 8)
    hi = (x[..., 0] << 24) | (x[..., 1] << 16) | (x[..., 2] << 8) | x[..., 3]
    lo = (x[..., 4] << 24) | (x[..., 5] << 16) | (x[..., 6] << 8) | x[..., 7]
    return torch.stack([hi, lo], dim=3).permute(1, 2, 3, 0)


def compress_blocks(words: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """words (B, 16, 2, N) int64 halves, nblocks (N,) -> (8, 2, N) digest
    state; a lane's state freezes after its own last block."""
    dev = words.device
    b_total, _, _, n = words.shape
    kc = torch.as_tensor(_halves(_K), device=dev)
    iv = torch.as_tensor(_halves(_IV), device=dev)
    state = [(iv[i, 0].expand(n), iv[i, 1].expand(n)) for i in range(8)]
    for bi in range(b_total):
        w = [(words[bi, t, 0], words[bi, t, 1]) for t in range(16)]
        a, b, c, d, e, f, g, h = state
        for t in range(80):
            if t >= 16:
                w15, w2 = w[t - 15], w[t - 2]
                s0 = _xor3(_ror(w15, 1), _ror(w15, 8), _shr(w15, 7))
                s1 = _xor3(_ror(w2, 19), _ror(w2, 61), _shr(w2, 6))
                w.append(_add(w[t - 16], s0, w[t - 7], s1))
            S1 = _xor3(_ror(e, 14), _ror(e, 18), _ror(e, 41))
            ch = ((e[0] & f[0]) ^ (~e[0] & _M32 & g[0]),
                  (e[1] & f[1]) ^ (~e[1] & _M32 & g[1]))
            t1 = _add(h, S1, ch, (kc[t, 0], kc[t, 1]), w[t])
            S0 = _xor3(_ror(a, 28), _ror(a, 34), _ror(a, 39))
            maj = ((a[0] & b[0]) ^ (a[0] & c[0]) ^ (b[0] & c[0]),
                   (a[1] & b[1]) ^ (a[1] & c[1]) ^ (b[1] & c[1]))
            t2 = _add(S0, maj)
            h, g, f, e, d, c, b, a = g, f, e, _add(d, t1), c, b, a, _add(t1, t2)
        active = bi < nblocks
        new = [_add(s, v) for s, v in zip(state, (a, b, c, d, e, f, g, h))]
        state = [(torch.where(active, nv[0], s[0]), torch.where(active, nv[1], s[1]))
                 for nv, s in zip(new, state)]
    return torch.stack([torch.stack(s) for s in state])


def digest_bytes_le(state: torch.Tensor) -> torch.Tensor:
    """(8, 2, N) digest state -> (64, N) int64 digest bytes in order
    (row j = byte j; the digest read as a little-endian integer)."""
    rows = []
    for wi in range(8):
        for part in (0, 1):
            word = state[wi, part]
            for shift in (24, 16, 8, 0):
                rows.append((word >> shift) & 0xFF)
    return torch.stack(rows)
