// The 4-thread chain: a point's four coordinates on four consecutive
// threads of a warp (thread q = 0..3 of the group holds X, Y, Z, T;
// `lead` is the group's first lane in the warp), each product of a
// round of a point op on its own thread, the operands passed by
// __shfl_sync. Every thread of the warp must take part (full mask).
//
// The formulas and their operand order are edwards.cuh's (dbl-2008-hwcd,
// add-2008-hwcd-3), so a point op here gives ge_double's and ge_add's
// limbs exactly; only which thread computes which product changes.
// Used by K1's chain (build_tables.cu) with the out-of-line field calls,
// and by K4 and K9 (verify_x4.cuh) with the inline ones: the template
// parameter F.
#pragma once
#include "edwards.cuh"

static __device__ __forceinline__ void fe_shfl(fe& out, const fe& x, int src) {
#pragma unroll
  for (int i = 0; i < FE_NLIMB; ++i) out.v[i] = __shfl_sync(0xffffffffu, x.v[i], src);
}

// out = c ? a : b, limb by limb (no divergence, no local copy).
static __device__ __forceinline__ void fe_pick(fe& out, bool c, const fe& a, const fe& b) {
#pragma unroll
  for (int i = 0; i < FE_NLIMB; ++i) out.v[i] = c ? a.v[i] : b.v[i];
}

// The field calls a chain makes: fe_calls out of line (K1), or
// fe_calls_inline.
struct fe_calls {
  static __device__ __forceinline__ void mul(fe& o, const fe& a, const fe& b) { fe_mul(o, a, b); }
  static __device__ __forceinline__ void sqr(fe& o, const fe& a) { fe_sqr(o, a); }
};

struct fe_calls_inline {
  static __device__ __forceinline__ void mul(fe& o, const fe& a, const fe& b) {
    fe_mul_inline(o, a, b);
  }
  static __device__ __forceinline__ void sqr(fe& o, const fe& a) { fe_sqr_inline(o, a); }
};

// Round two of both point ops, from e, f, g, h: X = e f, Y = g h,
// Z = f g, T = e h on threads 0..3.
template <class F>
static __device__ __forceinline__ void ge_round2_x4(fe& mine, int q, const fe& e,
                                                    const fe& f, const fe& g,
                                                    const fe& h) {
  fe m1, m2;
  fe_pick(m1, q == 1, g, f);
  fe_pick(m1, q == 0 || q == 3, e, m1);
  fe_pick(m2, q == 2, g, h);
  fe_pick(m2, q == 0, f, m2);
  F::mul(mine, m1, m2);
}

// mine: coordinate q of P; afterwards of 2P. dbl-2008-hwcd as
// ge_double writes it: round one X^2, Y^2, Z^2, (X + Y)^2.
template <class F>
static __device__ __forceinline__ void ge_double_x4_with(fe& mine, int q, int lead) {
  fe x, y, op, r;
  fe_shfl(x, mine, lead);
  fe_shfl(y, mine, lead + 1);
  fe_add(op, x, y);
  fe_pick(op, q < 3, mine, op);
  F::sqr(r, op);
  fe a, b, t, u, c, h, e, g, f;
  fe_shfl(a, r, lead);
  fe_shfl(b, r, lead + 1);
  fe_shfl(t, r, lead + 2);
  fe_shfl(u, r, lead + 3);
  fe_add(c, t, t);
  fe_add(h, a, b);
  fe_sub(e, h, u);
  fe_sub(g, a, b);
  fe_add(f, c, g);
  ge_round2_x4<F>(mine, q, e, f, g, h);
}

static __device__ __forceinline__ void ge_double_x4(fe& mine, int q, int lead) {
  ge_double_x4_with<fe_calls>(mine, q, lead);
}

// mine: coordinate q of P; afterwards of P + Q. op is thread q's
// operand of Q in round one: Y2 - X2, Y2 + X2, T2, Z2 on threads 0..3
// (x4_operand in verify_x4.cuh). add-2008-hwcd-3 as ge_add writes it:
// round one a = (Y1 - X1) op, b = (Y1 + X1) op, T1 op, Z1 op; then
// c = (T1 T2) 2d (thread 2's value, formed on all four); round two.
template <class F>
static __device__ __forceinline__ void ge_add_x4(fe& mine, int q, int lead, const fe& op) {
  fe sw, s, t, m1, r, cd;
  fe_shfl(sw, mine, lead + (q ^ 1));  // Y1, X1, T1, Z1 on threads 0..3
  fe_sub(s, sw, mine);
  fe_add(t, mine, sw);
  fe_pick(m1, q == 1, t, sw);
  fe_pick(m1, q == 0, s, m1);
  F::mul(r, m1, op);
  fe_const_d2(t);
  F::mul(cd, r, t);
  fe a, b, c, zz, d, e, f, g, h;
  fe_shfl(a, r, lead);
  fe_shfl(b, r, lead + 1);
  fe_shfl(c, cd, lead + 2);
  fe_shfl(zz, r, lead + 3);
  fe_add(d, zz, zz);
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  ge_round2_x4<F>(mine, q, e, f, g, h);
}
