// K3's per-lane body: verify one lane against its key's comb table,
// shared by K3 (xverify.cu) and K5 (shard_verify.cu).
//
// Replaces the per-lane arithmetic of tendermint_tpu/crypto/tpu/expanded.py
// _xcore: SHA-512(R || A || M); the fold to k' and its signed recode to
// 69 digits in [-8, 8]; ZIP-215 decompress of R; 69 windows of (signed
// table entry |d_w|, added with its sign) and of the fixed-base comb
// [S]B; + (-R); x8; identity check. Plain PyTorch version:
// crypto/cuda/expanded.py xverify_plain. The 69 entries are read
// straight from the table in device memory (no staging).
#pragma once
#include "common.cuh"
#include "edwards.cuh"
#include "scalar.cuh"
#include "sha512.cuh"

// pub: the key's 32 bytes; sig: 64 signature bytes; msg: the SHA-padded
// message row of `width` bytes (any address space) with nb blocks; tab:
// the key's 69 x 9 table entries. True iff R decodes and
// [8]([S]B - [k]A - R) is the identity; the caller ANDs s_ok and key_ok.
static __device__ __forceinline__ bool tm_xverify_lane(
    const uint8_t* pub, const uint8_t* sig, const uint8_t* msg, int width,
    int nb, const fe_limb* __restrict__ tab,
    const fe_limb* __restrict__ btab) {
  const int maxb = (64 + width) / 128;
  if (nb > maxb) nb = maxb;
  uint8_t dig[64];
  sha512_lane(sig, pub, msg, nb, dig);
  int8_t d[69];
  fold_digest(dig, d);
  recode_signed(d);
  ge r;
  const bool r_ok = ge_decompress(r, sig);
  ge_neg(r, r);
  ge acc_a, acc_b, e;
  ge_identity(acc_a);
  ge_identity(acc_b);
#pragma unroll 1
  for (int w = 0; w < TM_WINDOWS; ++w) {
    const int dw = d[w];
    const int mag = dw < 0 ? -dw : dw;
    ge_load(e, tab + (w * TM_ENTRIES + mag) * TM_ENTRY_INTS);
    if (dw < 0) {
      fe_neg(e.X, e.X);
      fe_neg(e.T, e.T);
    }
    ge_add(acc_a, acc_a, e);
    ge_add_comb(acc_b, btab, w, s_nibble(sig + 32, w));
  }
  ge_add(acc_a, acc_a, acc_b);
  ge_add(acc_a, acc_a, r);
  ge_double(acc_a, acc_a);
  ge_double(acc_a, acc_a);
  ge_double(acc_a, acc_a);
  return ge_is_identity(acc_a) && r_ok;
}
