// K3: verify lanes against an expanded validator set's comb tables.
//
// Replaces tendermint_tpu/crypto/tpu/expanded.py _xcore (jitted as
// _xkernel, and as the verify half of _skernel). Per lane: the key
// bytes by index; SHA-512(R || A || M); the fold to k' and its signed
// recode to 69 digits in [-8, 8]; ZIP-215 decompress of R; 69 windows
// of (signed table entry |d_w| of key idx, added with its sign) and of
// the fixed-base comb [S]B; + (-R); x8; identity check; AND with r_ok,
// s_ok and key_ok[idx]. Plain PyTorch version:
// crypto/cuda/expanded.py xverify_plain.
//
// Bound on the H100: operations. Per lane the function needs the R
// decompress (255 squarings, 19 multiplies), a 9-multiply add per
// nonzero signed digit of k (up to 69), an 8-multiply comb add per
// nonzero nibble of S (up to 64), two adds and three doublings: at 100
// products a multiply and 55 a squaring, ~1.3e5 products per lane,
// ~1.3e9 at 10,240 lanes, against the card's int32 rate. Bytes: the
// table entries it gathers, up to 69 * 160 B = 11 KB per lane (113 MB
// at 10,240 lanes, ~34 us at 3.35 TB/s), plus the message.
// Design: (n + 31) / 32 blocks of TM_XV_WARPS = 8 warps, 32 lanes a
// block, one lane a thread of each warp, running the block-cooperative
// body of xverify_lane.cuh (K5 shares it): one warp hashes, one
// decompresses R, six sum the comb windows of [S]B; then seven sum the
// [k]A windows and the eight partial sums meet in a shared-memory
// tree. A lane's serial path falls from ~1,400 field operations to
// ~250 (the R decompress or a slice of windows, the tree, x8), on 8
// threads a lane. A lane whose s_ok or key_ok is false does no curve
// work (the verdict is false either way), and a block of such lanes
// none at all. Shared memory a block: 2,240 B static, 20,480 B
// dynamic in i32 and 65,536 B in f32 (xverify_lane.cuh).
// What holds it back now: residency and its longest warp. At 128
// registers a thread (i32) two blocks, 16 warps, fit an SM, so 10,240
// lanes (320 blocks) run in two waves; the f32 build's 255 registers
// fit one block, three waves. A block takes as long as its longest
// warp, the R decompress's 255 squarings or a comb warp's ~11 comb and
// ~10 table windows, each field call through local memory (PERF.md
// section 6: one K5 shard, 96 blocks in one wave, takes a third
// of K3's time).
// The f32 build (-DTM_FIELD_F32, TM_TPU_FIELD=f32) compiles this source
// on field_f32.cuh: the same steps, bound by FP32 FMAs (1,024 a
// multiply, 528 a squaring) in place of the int32 products, with
// table entries of 512 B (up to 35 KB gathered a lane).
#include "xverify_lane.cuh"

__global__ void __launch_bounds__(TM_XV_THREADS, TM_XV_MIN_BLOCKS)
    k_xverify(const int32_t* __restrict__ idx, const uint8_t* __restrict__ akeys,
              const uint8_t* __restrict__ sb, const uint8_t* __restrict__ msg,
              int width, const int32_t* __restrict__ nblocks,
              const uint8_t* __restrict__ s_ok, const uint8_t* __restrict__ key_ok,
              const fe_limb* __restrict__ tables, const fe_limb* __restrict__ btab,
              int n, uint8_t* __restrict__ out) {
  __shared__ int8_t dig[TM_WINDOWS][TM_XV_LANES];
  __shared__ uint8_t r_ok[TM_XV_LANES];
  extern __shared__ __align__(16) unsigned char tm_dyn[];
  const int lane = threadIdx.x & 31;
  const long i = (long)blockIdx.x * TM_XV_LANES + lane;
  const bool in = i < n;
  const int key = in ? idx[i] : 0;
  const bool live = in && s_ok[i] && key_ok[key];
  if (!__syncthreads_or(live)) {
    if (threadIdx.x < 32 && in) out[i] = 0;
    return;
  }
  const bool ok = tm_xverify_block(
      live, akeys + 32 * (long)key, sb + 64 * i, msg + (long)width * i, width,
      in ? nblocks[i] : 0,
      tables + (long)key * TM_WINDOWS * TM_ENTRIES * TM_ENTRY_INTS, btab, dig,
      r_ok, reinterpret_cast<fe_limb*>(tm_dyn));
  if (threadIdx.x < 32 && in) out[i] = ok ? 1 : 0;
}

static long k3_blocks(int n) { return ((long)n + TM_XV_LANES - 1) / TM_XV_LANES; }

// Above 48 KB, dynamic shared memory needs the attribute, on the
// current device.
static int k3_smem(size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      k_xverify, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

extern "C" int tm_xverify(const void* idx, const void* akeys, const void* sb,
                          const void* msg, int width, const void* nblocks,
                          const void* s_ok, const void* key_ok,
                          const void* tables, const void* btab, int n,
                          void* out, void* stream) {
  if (n <= 0) return 0;
  const int rc = k3_smem(TM_XV_POINT_BYTES);
  if (rc) return rc;
  k_xverify<<<(unsigned)k3_blocks(n), TM_XV_THREADS, TM_XV_POINT_BYTES,
              (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const uint8_t*)akeys, (const uint8_t*)sb,
      (const uint8_t*)msg, width, (const int32_t*)nblocks,
      (const uint8_t*)s_ok, (const uint8_t*)key_ok, (const fe_limb*)tables,
      (const fe_limb*)btab, n, (uint8_t*)out);
  return (int)cudaGetLastError();
}

// The launch's shape at n lanes (common.cuh tm_shape).
extern "C" int tm_xverify_shape(int n, int* out) {
  const int rc = k3_smem(TM_XV_POINT_BYTES);
  if (rc) return rc;
  return tm_shape(k_xverify, k3_blocks(n), TM_XV_THREADS, TM_XV_POINT_BYTES,
                  out);
}
