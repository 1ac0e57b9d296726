// K4: verify lanes that each carry their own public key.
//
// Replaces tendermint_tpu/crypto/tpu/verify.py general_core (jitted as
// _kernel). Per lane: SHA-512(R || A || M); the fold to k' (69 nibbles)
// and its signed recode to 69 digits in [-8, 8]; ZIP-215 decompress of
// A and R; [k](-A) by 69 windows MSB-first (4 doublings and a signed
// add from a 9-entry table of -A), beside the fixed-base comb [S]B;
// + (-R); x8; identity check; AND with a_ok, r_ok and s_ok. Plain
// PyTorch version: crypto/cuda/verify.py general_verify_plain (the same
// verdicts; its [k](-A) runs over a 16-entry table and k's nibbles).
//
// Bound on the H100: operations. Per lane the function needs two
// decompressions (255 squarings, 19 multiplies each), the table's adds,
// 4 doublings per window below k's top nonzero nibble (about 68), an
// add per nonzero nibble of k and of S, and the tail: at 100 products
// a multiply and 55 a squaring, ~3.2e5 products per lane. Bytes per
// lane are ~300 (key, signature, message), far below the operation
// time.
// Design: the block body of verify_x4.cuh (K9 shares it), TM_X4_LANES
// lanes a block: [k](-A) on four threads a lane, its table in shared
// memory, while the digits warp hashes, folds and recodes, the R warp
// decompresses R, and the comb warps sum [S]B. A block with no live
// lane (s_ok false) does no curve work. In a block with any live lane,
// a dead lane's R and comb threads skip theirs, but its chain threads
// still decompress A and run the windows on zero digits; its verdict is
// false either way. K7 and K8's verify (arena_verify.cu) run the same
// body, with the arena's sign bytes assembled by the digits warp.
// What holds it back now: the chain's latency. A lane's [k](-A) is
// ~1,050 dependent rounds (the decode of A, then 68 windows of 4
// doublings of two rounds and an add of three), each a multiply,
// shuffled operands and carried sums in order. At 128 lanes (4 blocks)
// the kernel takes one block's latency; at 8,192 (256 blocks, two an
// SM) one wave. The f32 build fits one block an SM (251 registers), so
// 8,192 lanes run two waves (PERF.md sections 6 and 7).
// The f32 build (-DTM_FIELD_F32, TM_TPU_FIELD=f32) compiles this source
// on field_f32.cuh: the same steps, bound by FP32 FMAs (1,024 a
// multiply, 528 a squaring) in place of the int32 products, with table
// entries of 512 B.
#include "scalar.cuh"
#include "sha512.cuh"
#include "verify_x4.cuh"

#define K4_SMEM TM_X4_SMEM(0)

__global__ void __launch_bounds__(TM_X4_THREADS, TM_X4_MIN_BLOCKS)
    k_general_verify(const uint8_t* __restrict__ ab, const uint8_t* __restrict__ sb,
                     const uint8_t* __restrict__ msg, int width,
                     const int32_t* __restrict__ nblocks,
                     const uint8_t* __restrict__ s_ok, const fe_limb* __restrict__ btab,
                     int n, uint8_t* __restrict__ out) {
  __shared__ int8_t dig[TM_WINDOWS][TM_X4_LANES];
  __shared__ uint8_t r_ok[TM_X4_LANES];
  extern __shared__ __align__(16) unsigned char tm_dyn[];
  fe_limb* tab = reinterpret_cast<fe_limb*>(tm_dyn);
  fe_limb* slots = tab + TM_ENTRIES * TM_X4_POINT_LIMBS;
  const x4_thread t = x4_me();
  const long i = (long)blockIdx.x * TM_X4_LANES + t.l;
  const bool in = t.serves && i < n;
  const bool live = in && s_ok[i];
  if (!__syncthreads_or(live)) {
    if (t.chain && t.q == 0 && in) out[i] = 0;
    return;
  }
  const long c = i < n ? i : n - 1;  // a lane past n reads lane n - 1's bytes
  const uint8_t* pub = ab + 32 * c;
  const uint8_t* sig = sb + 64 * c;
  fe mine;  // a chain thread's coordinate
  bool a_ok = false;
  if (t.chain) {
    ge a;
    a_ok = ge_decompress(a, pub);
    ge_neg(a, a);
    x4_coordinate(mine, a, t.q);
    x4_chain(mine, t, tab, dig, TM_WINDOWS - 1);
  } else if (t.warp == TM_X4_CHAIN_WARPS) {  // the digits
    if (t.serves) {
      int8_t d[TM_WINDOWS];
      if (live) {
        const int maxb = (64 + width) / 128, nb = nblocks[i];
        uint8_t h[64];
        sha512_lane(sig, pub, msg + (long)width * i, nb > maxb ? maxb : nb, h);
        fold_digest(h, d);
        recode_signed(d);
      } else {
#pragma unroll 1
        for (int w = 0; w < TM_WINDOWS; ++w) d[w] = 0;
      }
#pragma unroll 1
      for (int w = 0; w < TM_WINDOWS; ++w) dig[w][t.l] = d[w];
    }
    __syncwarp();
    x4_bar_arrive(TM_X4_DIGIT_BAR, TM_X4_DIGIT_BAR_THREADS);
  } else if (t.warp == TM_X4_CHAIN_WARPS + 1) {  // R
    ge acc;
    ge_identity(acc);
    bool ok = false;
    if (live) {
      ok = ge_decompress(acc, sig);
      ge_neg(acc, acc);
    }
    if (t.serves) r_ok[t.l] = ok;
    x4_sum_slots(acc, t, slots);
  } else {  // the comb windows
    ge acc;
    ge_identity(acc);
    if (live)
      x4_comb(acc, btab, t.warp - TM_X4_CHAIN_WARPS - 2,
              [&](int w) { return s_nibble(sig + 32, w); });
    x4_comb_done(acc, t, slots);
  }
  __syncthreads();  // slot 0 holds -R + [S]B, r_ok is set
  if (!t.chain) return;
  x4_add_slot(mine, t, slots);
#pragma unroll 1
  for (int k = 0; k < 3; ++k) ge_double_x4_once(mine, t.q, t.lead);
  const bool ident = x4_is_identity(mine, t.lead);
  if (t.q == 0 && in) out[i] = (live && ident && a_ok && r_ok[t.l]) ? 1 : 0;
}

extern "C" int tm_general_verify(const void* ab, const void* sb, const void* msg,
                                 int width, const void* nblocks,
                                 const void* s_ok, const void* btab, int n,
                                 void* out, void* stream) {
  if (n <= 0) return 0;
  const int rc = x4_smem(k_general_verify, K4_SMEM);
  if (rc) return rc;
  k_general_verify<<<(unsigned)x4_blocks(n), TM_X4_THREADS, K4_SMEM,
                     (cudaStream_t)stream>>>(
      (const uint8_t*)ab, (const uint8_t*)sb, (const uint8_t*)msg, width,
      (const int32_t*)nblocks, (const uint8_t*)s_ok, (const fe_limb*)btab, n,
      (uint8_t*)out);
  return (int)cudaGetLastError();
}

// The launch's shape at n lanes (common.cuh tm_shape).
extern "C" int tm_general_verify_shape(int n, int* out) {
  const int rc = x4_smem(k_general_verify, K4_SMEM);
  if (rc) return rc;
  return tm_shape(k_general_verify, x4_blocks(n), TM_X4_THREADS, K4_SMEM, out);
}
