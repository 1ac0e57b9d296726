// K7: verify every active lane of the speculation arena.
//
// Replaces tendermint_tpu/crypto/tpu/resident.py _arena_kernel: the
// structured assembly (expanded.py assemble_core, K2 here) in front of
// the general verify body (verify.py general_core, K4 here) over the
// arena's resident per-lane buffers — key bytes ab, signature rows sb,
// s_ok, timestamp patches (patch, split, patch_len) and template group —
// with the shared templates (pre, pre_len, suf, suf_len) and the
// fixed-base comb btab, masked by `active`. Plain PyTorch version:
// crypto/cuda/resident.py arena_verify_plain. It is also K8's verify
// (resident.py mesh_arena_verify, replacing _mesh_arena_kernel): one
// launch per device over its contiguous block of arena shards, each
// shard's known-answer sentinel an ordinary active lane of the block.
//
// Bound on the H100: operations — K4's count for each active lane
// (two decompressions, the 14-add table of -A, the doublings below k's
// top nibble, an add per nonzero nibble of k and of S, the tail),
// ~3.2e5 int32 products a lane. Bytes per lane are ~140 (key,
// signature, patch, three ints, two flags), far below that.
// Design: K4's block body (verify_x4.cuh), TM_X4_LANES lanes a block:
// [k](-A) on four threads a lane, its table in shared memory, while
// the digits warp assembles, hashes, folds and recodes, the R warp
// decompresses R and the comb warps sum [S]B. A lane is live when it is
// active and its s_ok holds. The digits warp builds a live lane's
// `width` sign bytes with K2's byte rule (sign_bytes.cuh) into a row of
// the block's dynamic shared memory (TM_ARENA_ROW bytes, an odd number
// of words, so the 32 rows start in 32 banks) and hashes that row, so
// the message goes neither to global nor to local memory. A block with
// no live lane writes false for its lanes and returns before any curve
// work; in a block with a live lane, a dead lane's chain threads still
// decompress A and run the windows on zero digits, and its verdict is
// false either way. The reference computes every lane and then masks;
// the verdicts are the same.
// What holds it back now: K4's, the chain's latency (~1,050 dependent
// rounds a lane), and residency: 12,288 lanes are 384 blocks, of which
// the active ones (321 at 10,241 active lanes) run in two waves at two
// blocks an SM (i32), three at one (f32).
// The f32 build (-DTM_FIELD_F32, TM_TPU_FIELD=f32) compiles this source
// on field_f32.cuh: the same steps, bound by FP32 FMAs (1,024 a
// multiply, 528 a squaring) in place of the int32 products, with table
// entries of 512 B.
#include "scalar.cuh"
#include "sha512.cuh"
#include "sign_bytes.cuh"
#include "verify_x4.cuh"

#define TM_ARENA_MAX_W 192
// a lane's message row in shared memory: 49 words, odd, so the 32
// lanes' rows start in 32 different banks
#define TM_ARENA_ROW (TM_ARENA_MAX_W + 4)
// K4's table and comb slots, then the message rows, which the digits
// warp writes while the chain and comb warps use the former
#define K7_ROWS_AT TM_X4_SMEM(0)
#define K7_SMEM (K7_ROWS_AT + (size_t)TM_X4_LANES * TM_ARENA_ROW)
static_assert(K7_SMEM + TM_WINDOWS * TM_X4_LANES + TM_X4_LANES <= 232448,
              "K7 shared memory above the SM's 227 KB");

__global__ void __launch_bounds__(TM_X4_THREADS, TM_X4_MIN_BLOCKS)
    k_arena_verify(const uint8_t* __restrict__ ab, const uint8_t* __restrict__ sb,
                   const uint8_t* __restrict__ s_ok,
                   const uint8_t* __restrict__ active,
                   const uint8_t* __restrict__ pre,
                   const int32_t* __restrict__ pre_len,
                   const uint8_t* __restrict__ suf,
                   const int32_t* __restrict__ suf_len,
                   const uint8_t* __restrict__ patch,
                   const int32_t* __restrict__ split,
                   const int32_t* __restrict__ patch_len,
                   const int32_t* __restrict__ group,
                   const fe_limb* __restrict__ btab, int n, int width,
                   uint8_t* __restrict__ out) {
  __shared__ int8_t dig[TM_WINDOWS][TM_X4_LANES];
  __shared__ uint8_t r_ok[TM_X4_LANES];
  extern __shared__ __align__(16) unsigned char tm_dyn[];
  fe_limb* tab = reinterpret_cast<fe_limb*>(tm_dyn);
  fe_limb* slots = tab + TM_ENTRIES * TM_X4_POINT_LIMBS;
  const x4_thread t = x4_me();
  const long i = (long)blockIdx.x * TM_X4_LANES + t.l;
  const bool in = t.serves && i < n;
  const bool live = in && active[i] && s_ok[i];
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
        const int g = group[i];
        const uint8_t* pre_g = pre + g * TM_PRE_W;
        const uint8_t* suf_g = suf + g * TM_SUF_W;
        const int pl = pre_len[g], sl = suf_len[g];
        const int a = split[i], plen = patch_len[i];
        const uint8_t* prow = patch + i * TM_PATCH_W;
        uint8_t* m = tm_dyn + K7_ROWS_AT + t.l * TM_ARENA_ROW;
#pragma unroll 1
        for (int j = 0; j < width; ++j)
          m[j] = tm_msg_byte(pre_g, pl, suf_g, sl, prow, a, plen, j);
        const int maxb = (64 + width) / 128, nb = tm_msg_blocks(plen + pl + sl);
        uint8_t h[64];
        sha512_lane(sig, pub, m, nb > maxb ? maxb : nb, h);
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

extern "C" int tm_arena_verify(const void* ab, const void* sb, const void* s_ok,
                               const void* active, const void* pre,
                               const void* pre_len, const void* suf,
                               const void* suf_len, const void* patch,
                               const void* split, const void* patch_len,
                               const void* group, const void* btab, int n,
                               int width, void* out, void* stream) {
  if (n <= 0) return 0;
  if (width < 64 || width > TM_ARENA_MAX_W) return (int)cudaErrorInvalidValue;
  const int rc = x4_smem(k_arena_verify, K7_SMEM);
  if (rc) return rc;
  k_arena_verify<<<(unsigned)x4_blocks(n), TM_X4_THREADS, K7_SMEM,
                   (cudaStream_t)stream>>>(
      (const uint8_t*)ab, (const uint8_t*)sb, (const uint8_t*)s_ok,
      (const uint8_t*)active, (const uint8_t*)pre, (const int32_t*)pre_len,
      (const uint8_t*)suf, (const int32_t*)suf_len, (const uint8_t*)patch,
      (const int32_t*)split, (const int32_t*)patch_len, (const int32_t*)group,
      (const fe_limb*)btab, n, width, (uint8_t*)out);
  return (int)cudaGetLastError();
}

// The launch's shape at n lanes (common.cuh tm_shape).
extern "C" int tm_arena_verify_shape(int n, int* out) {
  const int rc = x4_smem(k_arena_verify, K7_SMEM);
  if (rc) return rc;
  return tm_shape(k_arena_verify, x4_blocks(n), TM_X4_THREADS, K7_SMEM, out);
}
