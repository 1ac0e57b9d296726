// z^(2^252 - 3) on the fe type of the field header that includes this
// one (field.cuh or field_f32.cuh): the reference's addition chain
// (tendermint_tpu/crypto/tpu/field.py, field_f32.py pow_2_252_m3), 11
// multiplies and 252 squarings, the same in either field.
#pragma once

static __device__ __forceinline__ void fe_nsquare(fe& out, const fe& a, int n) {
  out = a;
#pragma unroll 1
  for (int i = 0; i < n; ++i) fe_sqr(out, out);
}

// z^(2^252 - 3): the reference's addition chain.
static __device__ __noinline__ void fe_pow22523(fe& out, const fe& z) {
  fe z2, z9, z11, z_5_0, z_10_0, z_20_0, z_40_0, z_50_0, z_100_0, z_200_0,
      z_250_0, t;
  fe_sqr(z2, z);
  fe_sqr(t, z2);
  fe_sqr(t, t);
  fe_mul(z9, t, z);
  fe_mul(z11, z9, z2);
  fe_sqr(t, z11);
  fe_mul(z_5_0, t, z9);
  fe_nsquare(t, z_5_0, 5);
  fe_mul(z_10_0, t, z_5_0);
  fe_nsquare(t, z_10_0, 10);
  fe_mul(z_20_0, t, z_10_0);
  fe_nsquare(t, z_20_0, 20);
  fe_mul(z_40_0, t, z_20_0);
  fe_nsquare(t, z_40_0, 10);
  fe_mul(z_50_0, t, z_10_0);
  fe_nsquare(t, z_50_0, 50);
  fe_mul(z_100_0, t, z_50_0);
  fe_nsquare(t, z_100_0, 100);
  fe_mul(z_200_0, t, z_100_0);
  fe_nsquare(t, z_200_0, 50);
  fe_mul(z_250_0, t, z_50_0);
  fe_nsquare(t, z_250_0, 2);
  fe_mul(out, t, z);
}
