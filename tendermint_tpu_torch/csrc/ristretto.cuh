// ristretto255 (RFC 9496) decode and equality, one lane per thread
// (B10 of the port).
//
// Replaces tendermint_tpu/crypto/tpu/ristretto.py (sqrt_ratio_m1:30,
// decode:48, equal:77, _abs) on the fe/ge types of edwards.cuh and
// the field header it selects (field.cuh, or field_f32.cuh). Plain
// PyTorch version: crypto/cuda/ristretto.py, the same steps in the same
// order, so a lane's limbs match it exactly.
// Encoding never runs here: sr25519 verification needs only ristretto
// equality of V and decode(R), X1*Y2 == Y1*X2 or Y1*Y2 == X1*X2.
//
// The host checks each encoding's bytes (< p, even) and passes the
// result as pre_ok: fe_frombytes masks bit 255 as ed25519 decoding
// does, so an encoding >= 2^255 is only caught by that check. Parities
// (_abs, the t test) are those of the canonical value, not of the raw
// limbs.
#pragma once
#include "edwards.cuh"

// |x|: negate when the canonical representative is odd.
static __device__ __forceinline__ void rs_abs(fe& out, const fe& x) {
  if (fe_parity(x))
    fe_neg(out, x);
  else
    out = x;
}

// RFC 9496 §4.2 SQRT_RATIO_M1: r = the non-negative root of u/v, or of
// sqrt(-1) * u/v; returns was_square = correct | flipped (not
// flipped_i). The root is multiplied by sqrt(-1) when flipped or
// flipped_i holds.
static __device__ __noinline__ bool rs_sqrt_ratio_m1(fe& r, const fe& u,
                                                     const fe& v) {
  fe v3, v7, t, check, nu, i;
  fe_sqr(t, v);
  fe_mul(v3, t, v);
  fe_sqr(t, v3);
  fe_mul(v7, t, v);
  fe_mul(t, u, v7);
  fe_pow22523(t, t);
  fe_mul(r, u, v3);
  fe_mul(r, r, t);
  fe_sqr(t, r);
  fe_mul(check, v, t);
  fe_neg(nu, u);
  const bool correct = fe_eq(check, u);
  const bool flipped = fe_eq(check, nu);
  fe_const_sqrtm1(i);
  fe_mul(t, nu, i);
  const bool flipped_i = fe_eq(check, t);
  if (flipped || flipped_i) fe_mul(r, r, i);
  rs_abs(r, r);
  return correct || flipped;
}

// RFC 9496 §4.3.1 DECODE of a 32-byte encoding whose byte checks gave
// pre_ok. A lane that fails any check yields the identity and false.
static __device__ __noinline__ bool rs_decode(ge& p, const uint8_t* enc,
                                              bool pre_ok) {
  fe s, one, ss, u1, u2, u2s, v, t, k, invsqrt, den_x, den_y, x, y;
  fe_frombytes(s, enc);
  fe_one(one);
  fe_sqr(ss, s);
  fe_sub(u1, one, ss);
  fe_add(u2, one, ss);
  fe_sqr(u2s, u2);
  // v = -(D * u1^2) - u2^2
  fe_const_d(k);
  fe_sqr(t, u1);
  fe_mul(t, k, t);
  fe_neg(t, t);
  fe_sub(v, t, u2s);
  fe_mul(t, v, u2s);
  const bool was_square = rs_sqrt_ratio_m1(invsqrt, one, t);
  fe_mul(den_x, invsqrt, u2);
  fe_mul(den_y, invsqrt, den_x);
  fe_mul(den_y, den_y, v);
  fe_add(t, s, s);
  fe_mul(x, t, den_x);
  rs_abs(x, x);
  fe_mul(y, u1, den_y);
  fe_mul(t, x, y);
  const bool ok = was_square && fe_parity(t) == 0 && !fe_is_zero(y) && pre_ok;
  if (!ok) {
    fe_zero(x);
    y = one;
  }
  p.X = x;
  p.Y = y;
  p.Z = one;
  fe_mul(p.T, x, y);
  return ok;
}

// Ristretto equality, projective, both branches (never encodes).
static __device__ __noinline__ bool rs_equal(const ge& p, const ge& q) {
  fe a, b;
  fe_mul(a, p.X, q.Y);
  fe_mul(b, p.Y, q.X);
  const bool xy = fe_eq(a, b);
  fe_mul(a, p.Y, q.Y);
  fe_mul(b, p.X, q.X);
  return xy || fe_eq(a, b);
}
