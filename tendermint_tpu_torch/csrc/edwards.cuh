// edwards25519 point arithmetic, one point per thread (B4 of the port),
// on the field the build selects: field_f32.cuh under -DTM_FIELD_F32
// (TM_TPU_FIELD=f32, crypto/cuda/kernels.py), else field.cuh.
//
// Replaces tendermint_tpu/crypto/tpu/edwards.py (add, add_z1, double,
// decompress, select/select_const, build_window_table). The plain
// PyTorch version is crypto/cuda/edwards.py. The formulas are the
// reference's exactly (add-2008-hwcd-3, dbl-2008-hwcd, a = -1), so every
// point, and every comb-table entry, equals the reference's mod p
// coordinate by coordinate. Every op may write its result over an
// input: inputs are read in full before the first output limb.
#pragma once
#ifdef TM_FIELD_F32
#include "field_f32.cuh"
#else
#include "field.cuh"
#endif

struct ge {
  fe X, Y, Z, T;
};

static __device__ __forceinline__ void ge_identity(ge& p) {
  fe_zero(p.X);
  fe_one(p.Y);
  fe_one(p.Z);
  fe_zero(p.T);
}

static __device__ __forceinline__ void ge_neg(ge& r, const ge& p) {
  fe_neg(r.X, p.X);
  r.Y = p.Y;
  r.Z = p.Z;
  fe_neg(r.T, p.T);
}

// Complete unified addition (add-2008-hwcd-3, a = -1).
static __device__ __noinline__ void ge_add(ge& r, const ge& p, const ge& q) {
  fe a, b, c, d, e, f, g, h, t;
  fe_sub(a, p.Y, p.X);
  fe_sub(t, q.Y, q.X);
  fe_mul(a, a, t);
  fe_add(b, p.Y, p.X);
  fe_add(t, q.Y, q.X);
  fe_mul(b, b, t);
  fe_mul(c, p.T, q.T);
  fe_const_d2(t);
  fe_mul(c, c, t);
  fe_mul(t, p.Z, q.Z);
  fe_add(d, t, t);
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  fe_mul(r.T, e, h);
}

// Addition of a point with Z = 1 (an affine comb entry x, y, xy).
static __device__ __noinline__ void ge_add_z1(ge& r, const ge& p, const fe& qx,
                                       const fe& qy, const fe& qt) {
  fe a, b, c, d, e, f, g, h, t;
  fe_sub(a, p.Y, p.X);
  fe_sub(t, qy, qx);
  fe_mul(a, a, t);
  fe_add(b, p.Y, p.X);
  fe_add(t, qy, qx);
  fe_mul(b, b, t);
  fe_mul(c, p.T, qt);
  fe_const_d2(t);
  fe_mul(c, c, t);
  fe_add(d, p.Z, p.Z);
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  fe_mul(r.T, e, h);
}

// dbl-2008-hwcd for a = -1, as the reference writes it.
static __device__ __noinline__ void ge_double(ge& r, const ge& p) {
  fe a, b, c, e, f, g, h, t;
  fe_sqr(a, p.X);
  fe_sqr(b, p.Y);
  fe_sqr(t, p.Z);
  fe_add(c, t, t);
  fe_add(h, a, b);
  fe_add(t, p.X, p.Y);
  fe_sqr(t, t);
  fe_sub(e, h, t);
  fe_sub(g, a, b);
  fe_add(f, c, g);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  fe_mul(r.T, e, h);
}

// X == 0 and Y == Z (mod p).
static __device__ __forceinline__ bool ge_is_identity(const ge& p) {
  fe t;
  fe_sub(t, p.Y, p.Z);
  return fe_is_zero(p.X) && fe_is_zero(t);
}

// ZIP-215 decompression of a 32-byte encoding: y is the low 255 bits
// as given (y >= p accepted), x = 0 with sign 1 accepted. A failed
// encoding yields the identity and false.
static __device__ __noinline__ bool ge_decompress(ge& r, const uint8_t* s) {
  fe y, one, yy, u, v, v3, v7, t, x, vxx, nu, k;
  fe_frombytes(y, s);
  const int sign = s[31] >> 7;
  fe_one(one);
  fe_sqr(yy, y);
  fe_sub(u, yy, one);
  fe_const_d(k);
  fe_mul(v, yy, k);
  fe_add(v, v, one);
  fe_sqr(t, v);
  fe_mul(v3, t, v);
  fe_sqr(t, v3);
  fe_mul(v7, t, v);
  fe_mul(t, u, v7);
  fe_pow22523(t, t);
  fe_mul(x, u, v3);
  fe_mul(x, x, t);
  fe_sqr(t, x);
  fe_mul(vxx, v, t);
  const bool ok1 = fe_eq(vxx, u);
  fe_neg(nu, u);
  const bool ok2 = fe_eq(vxx, nu);
  if (ok2) {
    fe_const_sqrtm1(k);
    fe_mul(x, x, k);
  }
  const bool ok = ok1 || ok2;
  if (fe_parity(x) != sign) fe_neg(x, x);
  if (!ok) {
    fe_zero(x);
    y = one;
  }
  r.X = x;
  r.Y = y;
  r.Z = one;
  fe_mul(r.T, x, y);
  return ok;
}

// One table entry of 4 coordinates x FE_NLIMB limbs.
static __device__ __forceinline__ void ge_load(ge& p, const fe_limb* src) {
  fe_load(p.X, src);
  fe_load(p.Y, src + FE_NLIMB);
  fe_load(p.Z, src + 2 * FE_NLIMB);
  fe_load(p.T, src + 3 * FE_NLIMB);
}

static __device__ __forceinline__ void ge_store(fe_limb* dst, const ge& p) {
  fe_store(dst, p.X);
  fe_store(dst + FE_NLIMB, p.Y);
  fe_store(dst + 2 * FE_NLIMB, p.Z);
  fe_store(dst + 3 * FE_NLIMB, p.T);
}

// acc += the fixed-base comb entry btab[w][digit] (x, y, xy; Z = 1),
// btab laid out (69, 16, 3, FE_NLIMB).
static __device__ __forceinline__ void ge_add_comb(ge& acc, const fe_limb* btab, int w,
                                            int digit) {
  const fe_limb* e = btab + (w * 16 + digit) * 3 * FE_NLIMB;
  fe bx, by, bt;
  fe_load(bx, e);
  fe_load(by, e + FE_NLIMB);
  fe_load(bt, e + 2 * FE_NLIMB);
  ge_add_z1(acc, acc, bx, by, bt);
}
