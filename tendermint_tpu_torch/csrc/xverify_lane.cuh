// K3's lane body, block-cooperative: verify TM_XV_LANES lanes against
// their keys' comb tables with TM_XV_WARPS warps, the body of K3's and
// K5's kernel (xverify.cu).
//
// Replaces the per-lane arithmetic of tendermint_tpu/crypto/tpu/expanded.py
// _xcore: SHA-512(R || A || M); the fold to k' and its signed recode to
// 69 digits in [-8, 8]; ZIP-215 decompress of R; 69 windows of (signed
// table entry |d_w|, added with its sign) and of the fixed-base comb
// [S]B; + (-R); x8; identity check. Plain PyTorch version:
// crypto/cuda/expanded.py xverify_plain.
//
// Design: lane l of the block is thread l of every warp, so no warp
// diverges by role. With W = TM_XV_WARPS:
// - phase A, before the digits exist: warp 0 runs SHA-512, the fold and
//   the recode for its 32 lanes and writes each lane's 69 digits to
//   shared memory (in the structured form it assembles its lanes'
//   messages there first, xverify.cu); warp 1 decompresses R and starts its sum at -R; warps 2..W-1
//   sum the comb windows of [S]B, 64 / (W - 2) each (windows 64..68 of
//   S are 0), which need only S;
// - phase B: warps 0 and 2..W-1 (W - 1 warps) sum the [k]A windows,
//   69 / (W - 1) each, the table entries read straight from device
//   memory. Warp 0 starts as soon as it has written the digits; warps
//   2..W-1 wait for them on named barrier 1 (barrier.arrive by warp 0,
//   barrier.sync by them) after their comb windows. Warp 1 has no [k]A
//   window: its decompress is the longest phase-A task;
// - the reduction: the W partial sums meet in a tree through shared
//   memory (warp w + h adds into warp w for h = W/2, W/4, .., 1); warp 0
//   multiplies by 8 and checks for the identity.
// The sum's order differs from the plain version's; add-2008-hwcd-3 is
// complete and ge_is_identity projective, so no verdict can change.
// The verdict is ANDed with r_ok here and with s_ok and key_ok by the
// caller, which passes live = s_ok && key_ok: a dead lane does no curve
// work, and a block of dead lanes returns before any.
// Shared memory a block: the digits (69 x 32 B) and r_ok (32 B)
// static; the tree's W/2 partial points per lane dynamic, lane-minor
// (limb k of lane l at k * 32 + l, so a warp's accesses hit 32 banks):
// W/2 x 32 x 160 B = 20 KB in i32 or x 512 B = 64 KB in f32 at W = 8
// (above 48 KB: cudaFuncSetAttribute before each launch); the
// structured form's assembled messages alias that buffer in phase A.
#pragma once
#include "common.cuh"
#include "edwards.cuh"
#include "scalar.cuh"
#include "sha512.cuh"

static_assert(TM_XV_WARPS >= 4 && (TM_XV_WARPS & (TM_XV_WARPS - 1)) == 0,
              "TM_XV_WARPS: a power of two, at least 4");

// Dynamic shared bytes of the tree's partial points.
#define TM_XV_POINT_BYTES \
  ((size_t)(TM_XV_WARPS / 2) * TM_XV_LANES * TM_ENTRY_INTS * sizeof(fe_limb))

// Named barrier 1 between warp 0 (arrives once the digits are in
// shared memory) and the comb warps (wait for them). It is reached from
// two branches, so the non-aligned forms (as verify_x4.cuh's).
#define TM_XV_DIGIT_BAR_THREADS (32 * (TM_XV_WARPS - 1))

static __device__ __forceinline__ void tm_digits_arrive() {
  asm volatile("barrier.arrive 1, %0;" ::"r"(TM_XV_DIGIT_BAR_THREADS) : "memory");
}

static __device__ __forceinline__ void tm_digits_wait() {
  asm volatile("barrier.sync 1, %0;" ::"r"(TM_XV_DIGIT_BAR_THREADS) : "memory");
}

// A point in the lane-minor shared layout: limb k at p[k * TM_XV_LANES].
static __device__ __forceinline__ void ge_store_lanes(fe_limb* p, const ge& a) {
#pragma unroll
  for (int i = 0; i < FE_NLIMB; ++i) {
    p[i * TM_XV_LANES] = a.X.v[i];
    p[(FE_NLIMB + i) * TM_XV_LANES] = a.Y.v[i];
    p[(2 * FE_NLIMB + i) * TM_XV_LANES] = a.Z.v[i];
    p[(3 * FE_NLIMB + i) * TM_XV_LANES] = a.T.v[i];
  }
}

static __device__ __forceinline__ void ge_load_lanes(ge& a, const fe_limb* p) {
#pragma unroll
  for (int i = 0; i < FE_NLIMB; ++i) {
    a.X.v[i] = p[i * TM_XV_LANES];
    a.Y.v[i] = p[(FE_NLIMB + i) * TM_XV_LANES];
    a.Z.v[i] = p[(2 * FE_NLIMB + i) * TM_XV_LANES];
    a.T.v[i] = p[(3 * FE_NLIMB + i) * TM_XV_LANES];
  }
}

// Windows [lo, hi) of part `part` of `parts` over n windows.
static __device__ __forceinline__ void tm_slice(int part, int parts, int n,
                                                int& lo, int& hi) {
  lo = part * n / parts;
  hi = (part + 1) * n / parts;
}

// Called by every thread of the block, none returned early. Thread l of
// each warp serves lane l: live (s_ok && key_ok, and in range), pub the
// key's 32 bytes, sig the 64 signature bytes, tab the key's 69 x 9
// entries; warp 0 alone reads msg (the SHA-padded row of `width` bytes
// with nb blocks, in any address space). dig, r_ok: the block's static
// shared arrays; pts: its dynamic shared buffer (TM_XV_POINT_BYTES,
// free to reuse once phase A is over). Returns, in warp 0, whether R
// decodes and [8]([S]B - [k]A - R) is the identity (false for a dead
// lane); in the other warps false.
static __device__ __forceinline__ bool tm_xverify_block(
    bool live, const uint8_t* pub, const uint8_t* sig, const uint8_t* msg,
    int width, int nb, const fe_limb* __restrict__ tab,
    const fe_limb* __restrict__ btab, int8_t (*dig)[TM_XV_LANES],
    uint8_t* r_ok, fe_limb* pts) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ge acc;
  ge_identity(acc);
  int lo, hi;
  if (warp == 0) {
    if (live) {
      const int maxb = (64 + width) / 128;
      uint8_t h[64];
      sha512_lane(sig, pub, msg, nb > maxb ? maxb : nb, h);
      int8_t d[TM_WINDOWS];
      fold_digest(h, d);
      recode_signed(d);
#pragma unroll 1
      for (int w = 0; w < TM_WINDOWS; ++w) dig[w][lane] = d[w];
    }
    __syncwarp();
    tm_digits_arrive();
  } else if (warp == 1) {
    bool ok = false;
    if (live) {
      ok = ge_decompress(acc, sig);
      ge_neg(acc, acc);
    }
    r_ok[lane] = ok;
  } else {
    if (live) {
      tm_slice(warp - 2, TM_XV_WARPS - 2, 64, lo, hi);
#pragma unroll 1
      for (int w = lo; w < hi; ++w) ge_add_comb(acc, btab, w, s_nibble(sig + 32, w));
    }
    tm_digits_wait();
  }
  if (warp != 1 && live) {
    tm_slice(warp == 0 ? 0 : warp - 1, TM_XV_WARPS - 1, TM_WINDOWS, lo, hi);
    ge e;
#pragma unroll 1
    for (int w = lo; w < hi; ++w) {
      const int dw = dig[w][lane];
      const int mag = dw < 0 ? -dw : dw;
      ge_load(e, tab + (w * TM_ENTRIES + mag) * TM_ENTRY_INTS);
      if (dw < 0) {
        fe_neg(e.X, e.X);
        fe_neg(e.T, e.T);
      }
      ge_add(acc, acc, e);
    }
  }
  __syncthreads();  // phase A's shared messages are dead from here
#pragma unroll 1
  for (int half = TM_XV_WARPS / 2; half > 0; half >>= 1) {
    fe_limb* slot = pts + (size_t)(warp & (half - 1)) * TM_ENTRY_INTS * TM_XV_LANES + lane;
    if (warp >= half && warp < 2 * half && live) ge_store_lanes(slot, acc);
    __syncthreads();
    if (warp < half && live) {
      ge q;
      ge_load_lanes(q, slot);
      ge_add(acc, acc, q);
    }
    __syncthreads();
  }
  if (warp != 0 || !live) return false;
  ge_double(acc, acc);
  ge_double(acc, acc);
  ge_double(acc, acc);
  return ge_is_identity(acc) && r_ok[lane];
}
