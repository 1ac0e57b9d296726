// K2's byte rule: one byte of a lane's canonical vote sign bytes with
// the SHA-512 tail, shared by K3/K5's structured form (xverify.cu) and
// K7 (arena_verify.cu), the two kernels that assemble the sign bytes
// inside their verify launch.
//
// Replaces the per-byte body of tendermint_tpu/crypto/tpu/expanded.py
// assemble_core: msg = patch[:a] || pre[g] || patch[a:plen] || suf[g],
// then 0x80 and the SHA-512 length tail (a 16-byte big-endian bit
// length of 64 + mlen, whose low two bytes only are nonzero) at the end
// of block nblocks, with nblocks = (64 + mlen + 17 + 127) / 128 and
// mlen = plen + pre_len + suf_len. Plain PyTorch version:
// crypto/cuda/expanded.py assemble_plain.
#pragma once
#include <stdint.h>

#define TM_PATCH_W 24
#define TM_PRE_W 128
#define TM_SUF_W 64

static __device__ __forceinline__ int tm_clip(int c, int hi) {
  return c < 0 ? 0 : (c > hi ? hi : c);
}

// SHA-512 blocks of R || A || M for a message of mlen bytes.
static __device__ __forceinline__ int tm_msg_blocks(int mlen) {
  return (64 + mlen + 17 + 127) / 128;
}

// Byte j of a lane's message row. pre_g / suf_g are the lane's template
// rows (group g), prow its patch row, a its split, plen its patch length.
static __device__ __forceinline__ uint8_t tm_msg_byte(
    const uint8_t* pre_g, int pre_len, const uint8_t* suf_g, int suf_len,
    const uint8_t* prow, int a, int plen, int j) {
  const int c1 = a + pre_len;
  const int c2 = c1 + (plen - a);
  const int c3 = c2 + suf_len;  // = mlen
  int v;
  if (j < a)
    v = prow[tm_clip(j, TM_PATCH_W - 1)];
  else if (j < c1)
    v = pre_g[tm_clip(j - a, TM_PRE_W - 1)];
  else if (j < c2)
    v = prow[tm_clip(a + (j - c1), TM_PATCH_W - 1)];
  else if (j < c3)
    v = suf_g[tm_clip(j - c2, TM_SUF_W - 1)];
  else
    v = 0;
  if (j == c3) v = 0x80;
  const int nb = tm_msg_blocks(c3);
  const int bitlen = (64 + c3) * 8;
  const int k = 15 - (j - (nb * 128 - 16 - 64));
  if (k >= 0 && k < 16) v = k < 4 ? (bitlen >> (8 * k)) & 0xFF : 0;
  return (uint8_t)v;
}
