// K9: the sr25519 (schnorrkel) group equation.
//
// Replaces tendermint_tpu/crypto/tpu/sr_verify.py _kernel (:51, body
// :59-96) with ristretto.py's sqrt_ratio_m1/decode/equal (ristretto.cuh).
// Per lane: ristretto-decode A and R; the challenge's 64 nibbles
// recoded to signed digits in [-8, 8] (k < L: nibble 63 is at most 1,
// so the recode's carry out of window 63 is 0 for the host's
// challenges; it is kept as a 65th digit all the same); [k](-A) by
// windows MSB first, 4 doublings and a signed add from a 9-entry table
// of -A, beside the fixed-base comb [s]B over the first 64 windows of
// b_comb_tables; V = the two sums; verdict = ristretto_equal(V, R) &
// a_ok & r_ok & s_ok. The Merlin challenges k, the marker strip and the
// byte checks (s < L, encodings < p and even) run on the host
// (crypto/cuda/sr_verify.py). Plain PyTorch version: sr_verify_plain
// (the same verdicts; its [k](-A) runs over a 16-entry table and k's
// nibbles).
//
// Bound on the H100: operations. Per lane the function needs two
// ristretto decodes (two pow_2_252_m3 chains, ~255 squarings and ~30
// multiplies each), the table's adds, 4 doublings per window below k's
// top nonzero nibble, an add per nonzero nibble of k and of s, the
// final add and the equality's 4 multiplies: ~3e5 int32 products a
// lane. Bytes per lane are ~200 (A, R, the two scalars' nibbles, three
// flags), far below the operation time.
// Design: the block body of verify_x4.cuh (K4 shares it), TM_X4_LANES
// lanes a block: [k](-A) on four threads a lane, its table in shared
// memory, while the digits warp recodes k, the R warp decodes R and
// the comb warps sum [s]B. The digits arrive as (64, N) nibble rows,
// so neighbouring threads read neighbouring bytes. A lane whose s_ok,
// a_pre or r_pre is false is dead: as in K4, only a block with no live
// lane skips the curve work; in another block a dead lane's chain
// threads still decode A and run the windows on zero digits, and its
// verdict is false either way.
// What holds it back now: as K4, the chain's latency (~980 dependent
// rounds: the decode of A, then 64 windows); 5,120 lanes are 160
// blocks, one wave at two an SM (i32), two waves at one (f32).
// The f32 build (-DTM_FIELD_F32, TM_TPU_FIELD=f32) compiles this source
// on field_f32.cuh: the same steps, bound by FP32 FMAs (1,024 a
// multiply, 528 a squaring) in place of the int32 products, with table
// entries of 512 B.
#include "ristretto.cuh"
#include "scalar.cuh"
#include "verify_x4.cuh"

#define SR_WINDOWS 64
#define SR_SMEM TM_X4_SMEM(1)  // one slot more: R

__global__ void __launch_bounds__(TM_X4_THREADS, TM_X4_MIN_BLOCKS)
    k_sr_verify(const uint8_t* __restrict__ ab, const uint8_t* __restrict__ rb,
                const uint8_t* __restrict__ kdig, const uint8_t* __restrict__ sdig,
                const uint8_t* __restrict__ a_pre, const uint8_t* __restrict__ r_pre,
                const uint8_t* __restrict__ s_ok, const fe_limb* __restrict__ btab,
                int n, uint8_t* __restrict__ out) {
  __shared__ int8_t dig[TM_WINDOWS][TM_X4_LANES];
  __shared__ uint8_t r_ok[TM_X4_LANES];
  extern __shared__ __align__(16) unsigned char tm_dyn[];
  fe_limb* tab = reinterpret_cast<fe_limb*>(tm_dyn);
  fe_limb* slots = tab + TM_ENTRIES * TM_X4_POINT_LIMBS;
  fe_limb* r_slot = slots + TM_X4_COMB_WARPS * TM_X4_POINT_LIMBS;
  const x4_thread t = x4_me();
  const long i = (long)blockIdx.x * TM_X4_LANES + t.l;
  const bool in = t.serves && i < n;
  const bool live = in && s_ok[i] && a_pre[i] && r_pre[i];
  if (!__syncthreads_or(live)) {
    if (t.chain && t.q == 0 && in) out[i] = 0;
    return;
  }
  const long c = i < n ? i : n - 1;  // a lane past n reads lane n - 1's bytes
  fe mine;  // a chain thread's coordinate
  bool a_ok = false;
  if (t.chain) {
    ge a;
    a_ok = rs_decode(a, ab + 32 * c, a_pre[c] != 0);
    ge_neg(a, a);
    x4_coordinate(mine, a, t.q);
    x4_chain(mine, t, tab, dig, SR_WINDOWS);
  } else if (t.warp == TM_X4_CHAIN_WARPS) {  // the digits
    if (t.serves) {
      int8_t d[TM_WINDOWS];
#pragma unroll 1
      for (int w = 0; w < TM_WINDOWS; ++w)
        d[w] = (live && w < SR_WINDOWS) ? kdig[(long)w * n + i] & 15 : 0;
      recode_signed(d);  // d[64]: the carry out of window 63
#pragma unroll 1
      for (int w = 0; w <= SR_WINDOWS; ++w) dig[w][t.l] = d[w];
    }
    __syncwarp();
    x4_bar_arrive(TM_X4_DIGIT_BAR, TM_X4_DIGIT_BAR_THREADS);
  } else if (t.warp == TM_X4_CHAIN_WARPS + 1) {  // R
    ge r, acc;
    ge_identity(r);
    bool ok = false;
    if (live) ok = rs_decode(r, rb + 32 * i, r_pre[i] != 0);
    if (t.serves) {
      r_ok[t.l] = ok;
      ge_store_x4(r_slot, t.l, r);
    }
    ge_identity(acc);
    x4_sum_slots(acc, t, slots);
  } else {  // the comb windows
    ge acc;
    ge_identity(acc);
    if (live)
      x4_comb(acc, btab, t.warp - TM_X4_CHAIN_WARPS - 2,
              [&](int w) { return sdig[(long)w * n + i] & 15; });
    x4_comb_done(acc, t, slots);
  }
  __syncthreads();  // slot 0 holds [s]B, r_slot R, r_ok is set
  if (!t.chain) return;
  x4_add_slot(mine, t, slots);
  const bool eq = x4_rs_equal(mine, t, r_slot);
  if (t.q == 0 && in) out[i] = (live && eq && a_ok && r_ok[t.l]) ? 1 : 0;
}

extern "C" int tm_sr_verify(const void* ab, const void* rb, const void* kdig,
                            const void* sdig, const void* a_pre,
                            const void* r_pre, const void* s_ok,
                            const void* btab, int n, void* out, void* stream) {
  if (n <= 0) return 0;
  const int rc = x4_smem(k_sr_verify, SR_SMEM);
  if (rc) return rc;
  k_sr_verify<<<(unsigned)x4_blocks(n), TM_X4_THREADS, SR_SMEM,
                (cudaStream_t)stream>>>(
      (const uint8_t*)ab, (const uint8_t*)rb, (const uint8_t*)kdig,
      (const uint8_t*)sdig, (const uint8_t*)a_pre, (const uint8_t*)r_pre,
      (const uint8_t*)s_ok, (const fe_limb*)btab, n, (uint8_t*)out);
  return (int)cudaGetLastError();
}

// The launch's shape at n lanes (common.cuh tm_shape).
extern "C" int tm_sr_verify_shape(int n, int* out) {
  const int rc = x4_smem(k_sr_verify, SR_SMEM);
  if (rc) return rc;
  return tm_shape(k_sr_verify, x4_blocks(n), TM_X4_THREADS, SR_SMEM, out);
}
