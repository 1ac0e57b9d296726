// GF(2^255-19) arithmetic on float32 limbs, one element per thread: the
// field of the f32 build (-DTM_FIELD_F32, TM_TPU_FIELD=f32).
//
// Replaces the traced field ops of tendermint_tpu/crypto/tpu/field_f32.py
// (mul:131, sqr:159, _reduce63:180, _pass32:108, canonical:217,
// pow_2_252_m3:264). The plain PyTorch version is
// crypto/cuda/field_f32.py; both keep the reference's layout and carry
// steps, so a lane can be compared with either limb for limb.
//
// Representation: 32 signed float32 limbs, limb i of weight 2^(8i).
// Every value is an integer below 2^24 in magnitude, so every product,
// sum, floor and power-of-two scaling is exact in IEEE float32, in any
// order and with or without FMA contraction (an exact result is
// representable): build without --use_fast_math, nothing else. Bounds:
// REDUCED is |limb| <= 680; fe_mul/fe_sqr take REDUCED and return
// REDUCED (a column is at most 32 * 680^2 < 2^24); fe_add/fe_sub/fe_neg
// take REDUCED and return REDUCED after one carry pass. A carry is
// c = floor(x * 2^-8), r = x - 256c; a carry out of limb 31 (weight
// 2^256 = 38 mod p) re-enters as 38c split over limbs 0 and 1.
//
// Bound on the H100: operations, FP32 FMAs: 1,024 a multiply (a 32 x 32
// schoolbook) and 528 a squaring (doubled cross terms), against 100 and
// 55 int32 products in field.cuh; the card runs FP32 at twice its
// int32 rate (128 against 64 lanes an SM). A point is 4 x 32 floats, so
// a kernel's stack frame is ~3x the i32 build's.
#pragma once
#include <stdint.h>

// The layout the tables take (common.cuh TM_ENTRY_INTS, edwards.cuh).
#define FE_NLIMB 32
typedef float fe_limb;

struct fe {
  float v[32];
};

#define FE_INV256 0.00390625f

// One parallel carry pass over the 32 limbs (every carry from the
// limbs as given), with the top carry folded in as 38c over limbs 0, 1.
static __device__ __forceinline__ void fe_pass32(float x[32]) {
  float c[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    c[i] = floorf(x[i] * FE_INV256);
    x[i] = x[i] - c[i] * 256.f;
  }
#pragma unroll
  for (int i = 31; i > 0; --i) x[i] += c[i - 1];
  const float t = c[31] * 38.f;
  const float hi = floorf(t * FE_INV256);
  x[0] += t - hi * 256.f;
  x[1] += hi;
}

static __device__ __forceinline__ void fe_set(fe& out, const float c[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) out.v[i] = c[i];
}

static __device__ __forceinline__ void fe_zero(fe& out) {
#pragma unroll
  for (int i = 0; i < 32; ++i) out.v[i] = 0.f;
}

static __device__ __forceinline__ void fe_one(fe& out) {
  fe_zero(out);
  out.v[0] = 1.f;
}

static __device__ __forceinline__ void fe_add(fe& out, const fe& a, const fe& b) {
  float x[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] = a.v[i] + b.v[i];
  fe_pass32(x);
#pragma unroll
  for (int i = 0; i < 32; ++i) out.v[i] = x[i];
}

static __device__ __forceinline__ void fe_sub(fe& out, const fe& a, const fe& b) {
  float x[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] = a.v[i] - b.v[i];
  fe_pass32(x);
#pragma unroll
  for (int i = 0; i < 32; ++i) out.v[i] = x[i];
}

static __device__ __forceinline__ void fe_neg(fe& out, const fe& a) {
  float x[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] = -a.v[i];
  fe_pass32(x);
#pragma unroll
  for (int i = 0; i < 32; ++i) out.v[i] = x[i];
}

// 63 schoolbook columns -> REDUCED: a carry pass into 64 limbs, limbs
// 32..63 folded by 38 (each split into lo + 256 hi so nothing
// re-overflows; the top hi folded by 38 once more), then two passes.
static __device__ __forceinline__ void fe_reduce63(fe& out, const float h[63]) {
  float r[64];
  float prev = 0.f;
#pragma unroll
  for (int k = 0; k < 63; ++k) {
    const float c = floorf(h[k] * FE_INV256);
    r[k] = (h[k] - c * 256.f) + prev;
    prev = c;
  }
  r[63] = prev;
  float d[32];
  float hi_prev = 0.f;
#pragma unroll
  for (int m = 0; m < 32; ++m) {
    const float t = r[32 + m] * 38.f;
    const float hi = floorf(t * FE_INV256);
    d[m] = r[m] + (t - hi * 256.f) + hi_prev;
    hi_prev = hi;
  }
  const float t2 = hi_prev * 38.f;
  const float hi2 = floorf(t2 * FE_INV256);
  d[0] += t2 - hi2 * 256.f;
  d[1] += hi2;
  fe_pass32(d);
  fe_pass32(d);
#pragma unroll
  for (int i = 0; i < 32; ++i) out.v[i] = d[i];
}

// 32 x 32 schoolbook, 1,024 FMAs into 63 column accumulators.
static __device__ __forceinline__ void fe_mul_inline(fe& out, const fe& f, const fe& g) {
  float h[63];
#pragma unroll
  for (int k = 0; k < 63; ++k) h[k] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float fi = f.v[i];
#pragma unroll
    for (int j = 0; j < 32; ++j) h[i + j] = fmaf(fi, g.v[j], h[i + j]);
  }
  fe_reduce63(out, h);
}

// Squaring with doubled cross terms: 528 FMAs, the same columns (exact
// integers) as fe_mul(out, a, a), so the same limbs.
static __device__ __forceinline__ void fe_sqr_inline(fe& out, const fe& a) {
  float h[63];
#pragma unroll
  for (int k = 0; k < 63; ++k) h[k] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float ai = a.v[i];
    const float a2 = ai + ai;
    h[2 * i] = fmaf(ai, ai, h[2 * i]);
#pragma unroll
    for (int j = i + 1; j < 32; ++j) h[i + j] = fmaf(a2, a.v[j], h[i + j]);
  }
  fe_reduce63(out, h);
}

// fe_mul and fe_sqr: the bodies above, out of line, as field.cuh's
// (called from every point op); K4's and K9's chains call the inline
// bodies.
static __device__ __noinline__ void fe_mul(fe& out, const fe& f, const fe& g) {
  fe_mul_inline(out, f, g);
}

static __device__ __noinline__ void fe_sqr(fe& out, const fe& a) { fe_sqr_inline(out, a); }

// Exact sequential carry in int32 (an arithmetic shift floors, so
// borrows propagate): limbs in [0, 256), returns the signed out-carry.
static __device__ __forceinline__ int32_t fe_ripple(int32_t l[32]) {
  int32_t carry = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int32_t v = l[i] + carry;
    carry = v >> 8;
    l[i] = v & 0xFF;
  }
  return carry;
}

// Unique representative in [0, p), in int32: a ripple, three folds of
// the out-carry (38c into limb 0) with a ripple each, bit 255 folded as
// 19 and a ripple; then X >= p iff X + 19 >= 2^255 (the reference's
// steps, field_f32.py:217).
static __device__ __noinline__ void fe_canonical(fe& out, const fe& x) {
  int32_t l[32], t[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) l[i] = (int32_t)x.v[i];
  int32_t c = fe_ripple(l);
#pragma unroll 1
  for (int k = 0; k < 3; ++k) {
    l[0] += 38 * c;
    c = fe_ripple(l);
  }
  const int32_t hb = l[31] >> 7;
  l[0] += 19 * hb;
  l[31] &= 0x7F;
  fe_ripple(l);
#pragma unroll
  for (int i = 0; i < 32; ++i) t[i] = l[i];
  t[0] += 19;
  fe_ripple(t);
  const bool ge = (t[31] >> 7) > 0;
  t[31] &= 0x7F;
#pragma unroll
  for (int i = 0; i < 32; ++i) out.v[i] = (float)(ge ? t[i] : l[i]);
}

static __device__ __forceinline__ bool fe_is_zero(const fe& a) {
  fe c;
  fe_canonical(c, a);
  bool zero = true;
#pragma unroll
  for (int i = 0; i < 32; ++i) zero = zero && c.v[i] == 0.f;
  return zero;
}

static __device__ __forceinline__ bool fe_eq(const fe& a, const fe& b) {
  fe d;
  fe_sub(d, a, b);
  return fe_is_zero(d);
}

static __device__ __forceinline__ int fe_parity(const fe& a) {
  fe c;
  fe_canonical(c, a);
  return (int)c.v[0] & 1;
}

// The low 255 bits of a 32-byte little-endian encoding: a byte is a
// limb (the top bit is the caller's sign bit and is masked off here).
static __device__ __forceinline__ void fe_frombytes(fe& out, const uint8_t* s) {
#pragma unroll
  for (int i = 0; i < 32; ++i) out.v[i] = (float)(i == 31 ? s[i] & 0x7F : s[i]);
}

static __device__ __forceinline__ void fe_load(fe& out, const fe_limb* src) {
#pragma unroll
  for (int i = 0; i < 32; ++i) out.v[i] = src[i];
}

static __device__ __forceinline__ void fe_store(fe_limb* dst, const fe& a) {
#pragma unroll
  for (int i = 0; i < 32; ++i) dst[i] = a.v[i];
}

// Curve constants, canonical limbs (crypto/cuda/field_f32.py to_limbs).
static __device__ __forceinline__ void fe_const_d(fe& out) {
  const float c[32] = {163, 120, 89,  19,  202, 77,  235, 117, 171, 216, 65,
                       65,  77,  10,  112, 0,   152, 232, 121, 119, 121, 64,
                       199, 140, 115, 254, 111, 43,  238, 108, 3,   82};
  fe_set(out, c);
}

static __device__ __forceinline__ void fe_const_d2(fe& out) {
  const float c[32] = {89,  241, 178, 38,  148, 155, 214, 235, 86,  177, 131,
                       130, 154, 20,  224, 0,   48,  209, 243, 238, 242, 128,
                       142, 25,  231, 252, 223, 86,  220, 217, 6,   36};
  fe_set(out, c);
}

static __device__ __forceinline__ void fe_const_sqrtm1(fe& out) {
  const float c[32] = {176, 160, 14,  74,  39,  27,  238, 196, 120, 228, 47,
                       173, 6,   24,  67,  47,  167, 215, 251, 61,  153, 0,
                       77,  43,  11,  223, 193, 79,  128, 36,  131, 43};
  fe_set(out, c);
}

#include "fe_pow.cuh"
