// K9: the sr25519 (schnorrkel) group equation, one lane per thread.
//
// Replaces tendermint_tpu/crypto/tpu/sr_verify.py _kernel (:51, body
// :59-96) with ristretto.py's sqrt_ratio_m1/decode/equal (ristretto.cuh).
// Per lane: ristretto-decode A and R; a 16-entry window table of -A in
// local memory (as general_lane.cuh builds it); 64 windows of [k](-A),
// MSB first, 4 doublings and a table add each, beside the fixed-base
// comb [s]B over the first 64 windows of b_comb_tables, LSB first;
// V = the two sums; verdict = ristretto_equal(V, R) & a_ok & r_ok &
// s_ok. The Merlin challenges k, the marker strip and the byte checks
// (s < L, encodings < p and even) run on the host
// (crypto/cuda/sr_verify.py). Plain PyTorch version: sr_verify_plain.
//
// Bound on the H100: operations. Per lane the function needs two
// ristretto decodes (two pow_2_252_m3 chains, ~255 squarings and ~30
// multiplies each), the table's 14 adds, 4 doublings per window below
// k's top nonzero nibble, an add per nonzero nibble of k and of s, the
// final add and the equality's 4 multiplies: ~3e5 int32 products a
// lane. Bytes per lane are ~200 (A, R, the two scalars' nibbles, three
// flags), far below the operation time. Design: the simple one-thread-
// per-lane shape of K4, sharing its __device__ functions; the digits
// arrive as (64, N) nibble rows so neighbouring threads read
// neighbouring bytes.
// The f32 build (-DTM_FIELD_F32, TM_TPU_FIELD=f32) compiles this source
// on field_f32.cuh: the same steps, bound by FP32 FMAs (1,024 a
// multiply, 528 a squaring) in place of the int32 products, with
// a per-lane table of 16 x 512 B.
#include "common.cuh"
#include "ristretto.cuh"

#define SR_WINDOWS 64

__global__ void k_sr_verify(const uint8_t* __restrict__ ab,
                            const uint8_t* __restrict__ rb,
                            const uint8_t* __restrict__ kdig,
                            const uint8_t* __restrict__ sdig,
                            const uint8_t* __restrict__ a_pre,
                            const uint8_t* __restrict__ r_pre,
                            const uint8_t* __restrict__ s_ok,
                            const fe_limb* __restrict__ btab, int n,
                            uint8_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  ge a, r;
  const bool a_ok = rs_decode(a, ab + 32 * (long)i, a_pre[i] != 0);
  const bool r_ok = rs_decode(r, rb + 32 * (long)i, r_pre[i] != 0);
  ge_neg(a, a);
  ge tbl[16];
  ge_identity(tbl[0]);
  tbl[1] = a;
#pragma unroll 1
  for (int j = 2; j < 16; ++j) ge_add(tbl[j], tbl[j - 1], a);
  ge acc_a, acc_b;
  ge_identity(acc_a);
  ge_identity(acc_b);
#pragma unroll 1
  for (int w = 0; w < SR_WINDOWS; ++w) {
    ge_double(acc_a, acc_a);
    ge_double(acc_a, acc_a);
    ge_double(acc_a, acc_a);
    ge_double(acc_a, acc_a);
    ge_add(acc_a, acc_a, tbl[kdig[(long)(SR_WINDOWS - 1 - w) * n + i]]);
    ge_add_comb(acc_b, btab, w, sdig[(long)w * n + i]);
  }
  ge_add(acc_a, acc_a, acc_b);
  out[i] = (rs_equal(acc_a, r) && a_ok && r_ok && s_ok[i] != 0) ? 1 : 0;
}

extern "C" int tm_sr_verify(const void* ab, const void* rb, const void* kdig,
                            const void* sdig, const void* a_pre,
                            const void* r_pre, const void* s_ok,
                            const void* btab, int n, void* out, void* stream) {
  if (n <= 0) return 0;
  k_sr_verify<<<tm_blocks(n), TM_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)ab, (const uint8_t*)rb, (const uint8_t*)kdig,
      (const uint8_t*)sdig, (const uint8_t*)a_pre, (const uint8_t*)r_pre,
      (const uint8_t*)s_ok, (const fe_limb*)btab, n, (uint8_t*)out);
  return (int)cudaGetLastError();
}
