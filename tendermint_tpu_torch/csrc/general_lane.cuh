// K4's per-lane body: verify one lane that carries its own public key,
// shared by K4 (general_verify.cu) and K7 (arena_verify.cu).
//
// Replaces the per-lane arithmetic of tendermint_tpu/crypto/tpu/verify.py
// general_core: SHA-512(R || A || M); the fold to k' (69 nibbles);
// ZIP-215 decompress of A and R; a 16-entry window table of -A; 69
// windows MSB-first of (4 doublings + table add) for [k](-A), beside the
// fixed-base comb [S]B; + (-R); x8; identity check; AND with a_ok, r_ok
// and s_ok. Plain PyTorch version: crypto/cuda/verify.py
// general_verify_plain. The per-lane table (16 points, 2.5 KB) lives in
// local memory, L1-cached, and is indexed by the lane's digit.
#pragma once
#include "common.cuh"
#include "edwards.cuh"
#include "scalar.cuh"
#include "sha512.cuh"

// pub: 32 key bytes; sig: 64 signature bytes; msg: the SHA-padded
// message row of `width` bytes (any address space) with nb blocks.
static __device__ __forceinline__ bool tm_verify_lane(
    const uint8_t* pub, const uint8_t* sig, const uint8_t* msg, int width,
    int nb, bool s_ok, const fe_limb* __restrict__ btab) {
  const int maxb = (64 + width) / 128;
  if (nb > maxb) nb = maxb;
  uint8_t dig[64];
  sha512_lane(sig, pub, msg, nb, dig);
  int8_t k[69];
  fold_digest(dig, k);
  ge a, r;
  const bool a_ok = ge_decompress(a, pub);
  const bool r_ok = ge_decompress(r, sig);
  ge_neg(a, a);
  ge_neg(r, r);
  ge tbl[16];
  ge_identity(tbl[0]);
  tbl[1] = a;
#pragma unroll 1
  for (int j = 2; j < 16; ++j) ge_add(tbl[j], tbl[j - 1], a);
  ge acc_a, acc_b;
  ge_identity(acc_a);
  ge_identity(acc_b);
#pragma unroll 1
  for (int w = 0; w < TM_WINDOWS; ++w) {
    ge_double(acc_a, acc_a);
    ge_double(acc_a, acc_a);
    ge_double(acc_a, acc_a);
    ge_double(acc_a, acc_a);
    ge_add(acc_a, acc_a, tbl[k[TM_WINDOWS - 1 - w]]);
    ge_add_comb(acc_b, btab, w, s_nibble(sig + 32, w));
  }
  ge_add(acc_a, acc_a, acc_b);
  ge_add(acc_a, acc_a, r);
  ge_double(acc_a, acc_a);
  ge_double(acc_a, acc_a);
  ge_double(acc_a, acc_a);
  return ge_is_identity(acc_a) && a_ok && r_ok && s_ok;
}
