// GF(2^255-19) arithmetic, one element per thread (B1 of the port).
//
// Replaces the traced field ops of tendermint_tpu/crypto/tpu/field.py
// (mul, sqr, _reduce43, carry_lookahead, canonical, pow_2_252_m3).
// The plain PyTorch version is crypto/cuda/field.py; both use the same
// representation and the same integer arithmetic, so a lane can be
// compared with it limb by limb.
//
// Representation: ten signed int32 limbs in radix 2^25.5 (ref10's
// layout), limb i of weight 2^OFFS[i], OFFS = 0,26,51,77,...,230,
// widths alternating 26 and 25 bits. Every op returns LOOSE limbs, all
// in (-2^26, 2^26). A product is int32 x int32 -> int64 (one IMAD.WIDE
// on the card, which has no 64x64 multiply); a column of mul is at most
// 10 terms of 38 * 2^52, below 2^61, so int64 never overflows.
#pragma once
#include <stdint.h>

// The layout the tables take (common.cuh TM_ENTRY_INTS, edwards.cuh).
#define FE_NLIMB 10
typedef int32_t fe_limb;

struct fe {
  int32_t v[10];
};

static __device__ __forceinline__ int fe_width(int i) { return (i & 1) ? 25 : 26; }

// Sequential floor carry 0..9 (arithmetic shift for the carry, a mask
// for the remainder), top carry folded back as 19*c into limb 0, then
// one more limb 0 -> 1 carry.
static __device__ __forceinline__ void fe_carry(fe& out, int64_t h[10]) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const int w = fe_width(i);
    const int64_t c = h[i] >> w;
    h[i] &= ((int64_t)1 << w) - 1;
    if (i < 9)
      h[i + 1] += c;
    else
      h[0] += 19 * c;
  }
  const int64_t c = h[0] >> 26;
  h[0] &= ((int64_t)1 << 26) - 1;
  h[1] += c;
#pragma unroll
  for (int i = 0; i < 10; ++i) out.v[i] = (int32_t)h[i];
}

static __device__ __forceinline__ void fe_set(fe& out, const int32_t c[10]) {
#pragma unroll
  for (int i = 0; i < 10; ++i) out.v[i] = c[i];
}

static __device__ __forceinline__ void fe_zero(fe& out) {
#pragma unroll
  for (int i = 0; i < 10; ++i) out.v[i] = 0;
}

static __device__ __forceinline__ void fe_one(fe& out) {
  fe_zero(out);
  out.v[0] = 1;
}

static __device__ __forceinline__ void fe_add(fe& out, const fe& a, const fe& b) {
  int64_t h[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) h[i] = (int64_t)a.v[i] + b.v[i];
  fe_carry(out, h);
}

static __device__ __forceinline__ void fe_sub(fe& out, const fe& a, const fe& b) {
  int64_t h[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) h[i] = (int64_t)a.v[i] - b.v[i];
  fe_carry(out, h);
}

static __device__ __forceinline__ void fe_neg(fe& out, const fe& a) {
  int64_t h[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) h[i] = -(int64_t)a.v[i];
  fe_carry(out, h);
}

// Schoolbook product: f_i * g_j lands in column (i + j) % 10, doubled
// when i and j are both odd, times 19 when i + j >= 10.
static __device__ __forceinline__ void fe_mul_inline(fe& out, const fe& f, const fe& g) {
  int64_t h[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) h[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
#pragma unroll
    for (int j = 0; j < 10; ++j) {
      const int32_t a = ((i & 1) && (j & 1)) ? 2 * f.v[i] : f.v[i];
      const int32_t b = (i + j >= 10) ? 19 * g.v[j] : g.v[j];
      h[(i + j) % 10] += (int64_t)a * b;
    }
  }
  fe_carry(out, h);
}

// Squaring: fe_mul(out, a, a)'s columns with each cross product
// a_i * a_j (i < j) formed once and doubled, 55 products in place of
// 100. The column sums are the same integers, so the limbs are
// fe_mul's. Operands stay in int32: the left one carries the factors
// 2 (cross) and 2 (odd * odd), at most 4 * 2^26; the right one the 19
// of a wrapped column, below 19 * 2^26 < 2^31.
static __device__ __forceinline__ void fe_sqr_inline(fe& out, const fe& f) {
  int64_t h[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) h[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
#pragma unroll
    for (int j = i; j < 10; ++j) {
      const int m = (i < j ? 2 : 1) * (((i & 1) && (j & 1)) ? 2 : 1);
      const int32_t a = m * f.v[i];
      const int32_t b = (i + j >= 10) ? 19 * f.v[j] : f.v[j];
      h[(i + j) % 10] += (int64_t)a * b;
    }
  }
  fe_carry(out, h);
}

// fe_mul and fe_sqr: the bodies above, out of line (they are called
// from every point op, and inlining them everywhere multiplies the
// build time). The 4-thread chains of K4 and K9 (chain_x4.cuh) call
// the inline bodies, so that their one coordinate a thread stays in
// registers.
static __device__ __noinline__ void fe_mul(fe& out, const fe& f, const fe& g) {
  fe_mul_inline(out, f, g);
}

static __device__ __noinline__ void fe_sqr(fe& out, const fe& a) { fe_sqr_inline(out, a); }

// One exact floor-carry pass with the top fold (canonical's step).
static __device__ __forceinline__ void fe_pass(int64_t h[10]) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const int w = fe_width(i);
    const int64_t c = h[i] >> w;
    h[i] &= ((int64_t)1 << w) - 1;
    if (i < 9)
      h[i + 1] += c;
    else
      h[0] += 19 * c;
  }
}

// Unique representative in [0, p): two passes give exact limbs of a
// value in [0, 2^255); then X >= p iff X + 19 >= 2^255.
static __device__ __noinline__ void fe_canonical(fe& out, const fe& x) {
  int64_t h[10], t[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) h[i] = x.v[i];
  fe_pass(h);
  fe_pass(h);
#pragma unroll
  for (int i = 0; i < 10; ++i) t[i] = h[i];
  t[0] += 19;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const int w = fe_width(i);
    const int64_t c = t[i] >> w;
    t[i] &= ((int64_t)1 << w) - 1;
    t[i + 1] += c;
  }
  const bool ge = (t[9] >> 25) > 0;
  t[9] &= ((int64_t)1 << 25) - 1;
#pragma unroll
  for (int i = 0; i < 10; ++i) out.v[i] = (int32_t)(ge ? t[i] : h[i]);
}

static __device__ __forceinline__ bool fe_is_zero(const fe& a) {
  fe c;
  fe_canonical(c, a);
  int32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) acc |= c.v[i];
  return acc == 0;
}

static __device__ __forceinline__ bool fe_eq(const fe& a, const fe& b) {
  fe d;
  fe_sub(d, a, b);
  return fe_is_zero(d);
}

static __device__ __forceinline__ int fe_parity(const fe& a) {
  fe c;
  fe_canonical(c, a);
  return c.v[0] & 1;
}

// Exact limbs of the low 255 bits of a 32-byte little-endian encoding
// (the top bit is the caller's sign bit and is masked off here).
static __device__ __forceinline__ void fe_frombytes(fe& out, const uint8_t* s) {
  const int offs[10] = {0, 26, 51, 77, 102, 128, 153, 179, 204, 230};
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const int j = offs[i] >> 3, sh = offs[i] & 7;
    uint64_t v = 0;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      if (j + k < 32) {
        uint64_t byte = s[j + k];
        if (j + k == 31) byte &= 0x7F;
        v |= byte << (8 * k);
      }
    }
    out.v[i] = (int32_t)((v >> sh) & ((1u << fe_width(i)) - 1));
  }
}

static __device__ __forceinline__ void fe_load(fe& out, const fe_limb* src) {
#pragma unroll
  for (int i = 0; i < 10; ++i) out.v[i] = src[i];
}

static __device__ __forceinline__ void fe_store(fe_limb* dst, const fe& a) {
#pragma unroll
  for (int i = 0; i < 10; ++i) dst[i] = a.v[i];
}

// Curve constants, exact limbs (crypto/cuda/field.py to_limbs).
static __device__ __forceinline__ void fe_const_d(fe& out) {
  const int32_t c[10] = {56195235, 13857412, 51736253, 6949390, 114729,
                         24766616, 60832955, 30306712, 48412415, 21499315};
  fe_set(out, c);
}

static __device__ __forceinline__ void fe_const_d2(fe& out) {
  const int32_t c[10] = {45281625, 27714825, 36363642, 13898781, 229458,
                         15978800, 54557047, 27058993, 29715967, 9444199};
  fe_set(out, c);
}

static __device__ __forceinline__ void fe_const_sqrtm1(fe& out) {
  const int32_t c[10] = {34513072, 25610706, 9377949, 3500415, 12389472,
                         33281959, 41962654, 31548777, 326685, 11406482};
  fe_set(out, c);
}

#include "fe_pow.cuh"
