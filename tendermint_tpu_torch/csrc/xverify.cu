// K3 and K5: verify lanes against an expanded validator set's comb
// tables, the whole set on one card (K3) or one shard's key range of
// key-range-sharded tables (K5, launched once per mesh entry on the
// entry's device and stream). One kernel, one export: K3 and K5 differ
// only in the tables they are given and in the launch counter of their
// wrapper (crypto/cuda/expanded.py xverify, shard_verify).
//
// Replaces tendermint_tpu/crypto/tpu/expanded.py _xcore (jitted as
// _xkernel and _xkernel_sharded) and, in the structured form, _skernel
// and _skernel_sharded, which trace assemble_core (K2) into the verify
// program. Per lane: the key bytes by index; the message, either as a
// SHA-padded row with its block count (msg, nblocks: the bytes form),
// or (msg NULL: the structured form) assembled in the block's shared
// memory with K2's byte rule (sign_bytes.cuh) from the commit's
// templates (pre, pre_len, suf, suf_len) and the lane's timestamp patch
// (patch, split, patch_len, group), so no (N, width) message tensor is
// written to device memory and K2 is no launch of its own;
// SHA-512(R || A || M); the fold to k' and its signed recode to 69
// digits in [-8, 8]; ZIP-215 decompress of R; 69 windows of (signed
// table entry |d_w| of key idx, added with its sign) and of the
// fixed-base comb [S]B; + (-R); x8; identity check; AND with r_ok, s_ok
// and key_ok[idx]. Plain PyTorch versions: crypto/cuda/expanded.py
// xverify_plain, and assemble_plain before it in the structured form
// (shard_verify_plain).
//
// Bound on the H100: operations. Per lane whose verdict is not already
// false: the R decompress (255 squarings, 19 multiplies), a 9-multiply
// add per nonzero signed digit of k (up to 69), an 8-multiply comb add
// per nonzero nibble of S (up to 64), two adds and three doublings: at
// 100 products a multiply and 55 a squaring, ~1.3e5 products per lane,
// ~1.3e9 at 10,240 lanes, against the card's int32 rate. Bytes: the
// table entries it gathers, up to 69 * 160 B = 11 KB per lane (113 MB
// at 10,240 lanes, ~34 us at 3.35 TB/s), plus the message or the patch.
// Design: (n + 31) / 32 blocks of TM_XV_WARPS = 8 warps, 32 lanes a
// block, one lane a thread of each warp, running the block-cooperative
// body of xverify_lane.cuh: one warp hashes, one decompresses R, six
// sum the comb windows of [S]B; then seven sum the [k]A windows and the
// eight partial sums meet in a shared-memory tree. In the structured
// form the hashing warp first assembles each of its live lanes' rows,
// byte by byte, into the dynamic buffer at TM_XV_ROW bytes a row, and
// hashes it from there, while the R and comb warps start at once: the
// assembly stays off the block's critical path (spread over all the
// warps before phase A, with one __syncthreads(), it made K3 4-5%
// slower at 10,240 lanes in i32: PERF.md section 6). A dead lane (s_ok
// or key_ok false, or past n) gets no row and does no curve work (the
// verdict is false either way), and a block of dead lanes none at all.
// Shared memory a block: 2,240 B static; dynamic, the larger of the
// tree's points (20,480 B in i32, 65,536 B in f32) and the 32 message
// rows (14,464 B), which alias them.
// What holds it back now: residency and its longest warp. At 128
// registers a thread (i32) two blocks, 16 warps, fit an SM, so 10,240
// lanes (320 blocks) run in two waves; the f32 build's 255 registers
// fit one block, three waves. A block takes as long as its longest
// warp, the R decompress's 255 squarings or a comb warp's ~11 comb and
// ~10 table windows, each field call through local memory. One K5
// shard, 96 blocks in one wave, takes a third of K3's time.
// The f32 build (-DTM_FIELD_F32, TM_TPU_FIELD=f32) compiles this source
// on field_f32.cuh: the same steps, bound by FP32 FMAs (1,024 a
// multiply, 528 a squaring) in place of the int32 products, with
// table entries of 512 B (up to 35 KB gathered a lane).
#include "sign_bytes.cuh"
#include "xverify_lane.cuh"

// The structured form's widest message row, and a row's stride in
// shared memory: 113 words, odd, so the 32 rows start in 32 banks.
#define TM_XV_MAX_W 448
#define TM_XV_ROW (TM_XV_MAX_W + 4)

static size_t xv_dyn_bytes(bool structured) {
  const size_t msgs = structured ? (size_t)TM_XV_LANES * TM_XV_ROW : 0;
  return msgs > TM_XV_POINT_BYTES ? msgs : TM_XV_POINT_BYTES;
}

__global__ void __launch_bounds__(TM_XV_THREADS, TM_XV_MIN_BLOCKS) k_xverify(
    const int32_t* __restrict__ idx, const uint8_t* __restrict__ akeys,
    const uint8_t* __restrict__ sb, const uint8_t* __restrict__ s_ok,
    const uint8_t* __restrict__ key_ok, const fe_limb* __restrict__ tables,
    const fe_limb* __restrict__ btab, const uint8_t* __restrict__ msg,
    const int32_t* __restrict__ nblocks, const uint8_t* __restrict__ pre,
    const int32_t* __restrict__ pre_len, const uint8_t* __restrict__ suf,
    const int32_t* __restrict__ suf_len, const uint8_t* __restrict__ patch,
    const int32_t* __restrict__ split, const int32_t* __restrict__ patch_len,
    const int32_t* __restrict__ group, int width, int n,
    uint8_t* __restrict__ out) {
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
  const uint8_t* row = nullptr;
  int nb = 0;
  if (threadIdx.x < 32 && live) {  // the hashing warp's message
    if (msg != nullptr) {
      row = msg + (long)width * i;
      nb = nblocks[i];
    } else {  // K2: the lane's sign bytes, assembled in shared memory
      const int g = group[i];
      const uint8_t* pre_g = pre + g * TM_PRE_W;
      const uint8_t* suf_g = suf + g * TM_SUF_W;
      const int pl = pre_len[g], sl = suf_len[g];
      const int a = split[i], plen = patch_len[i];
      const uint8_t* prow = patch + i * TM_PATCH_W;
      uint8_t* m = tm_dyn + lane * TM_XV_ROW;
#pragma unroll 1
      for (int j = 0; j < width; ++j)
        m[j] = tm_msg_byte(pre_g, pl, suf_g, sl, prow, a, plen, j);
      row = m;
      nb = tm_msg_blocks(plen + pl + sl);
    }
  }
  const bool ok = tm_xverify_block(
      live, akeys + 32 * (long)key, sb + 64 * i, row, width, nb,
      tables + (long)key * TM_WINDOWS * TM_ENTRIES * TM_ENTRY_INTS, btab, dig,
      r_ok, reinterpret_cast<fe_limb*>(tm_dyn));
  if (threadIdx.x < 32 && in) out[i] = ok ? 1 : 0;
}

static long xv_blocks(int n) { return ((long)n + TM_XV_LANES - 1) / TM_XV_LANES; }

// Above 48 KB, dynamic shared memory needs the attribute, on the
// current device.
static int xv_smem(size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      k_xverify, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// K3's and K5's launch: msg and nblocks (the bytes form), or (msg NULL)
// the eight template and patch arrays (the structured form).
extern "C" int tm_xverify(
    const void* idx, const void* akeys, const void* sb, const void* s_ok,
    const void* key_ok, const void* tables, const void* btab, const void* msg,
    const void* nblocks, const void* pre, const void* pre_len,
    const void* suf, const void* suf_len, const void* patch,
    const void* split, const void* patch_len, const void* group, int width,
    int n, void* out, void* stream) {
  if (n <= 0) return 0;
  if (msg == nullptr && (width < 64 || width > TM_XV_MAX_W))
    return (int)cudaErrorInvalidValue;
  const size_t dyn = xv_dyn_bytes(msg == nullptr);
  const int rc = xv_smem(dyn);
  if (rc) return rc;
  k_xverify<<<(unsigned)xv_blocks(n), TM_XV_THREADS, dyn,
              (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const uint8_t*)akeys, (const uint8_t*)sb,
      (const uint8_t*)s_ok, (const uint8_t*)key_ok, (const fe_limb*)tables,
      (const fe_limb*)btab, (const uint8_t*)msg, (const int32_t*)nblocks,
      (const uint8_t*)pre, (const int32_t*)pre_len, (const uint8_t*)suf,
      (const int32_t*)suf_len, (const uint8_t*)patch, (const int32_t*)split,
      (const int32_t*)patch_len, (const int32_t*)group, width, n,
      (uint8_t*)out);
  return (int)cudaGetLastError();
}

// The launch's shape at n lanes, in the structured form or not
// (common.cuh tm_shape).
extern "C" int tm_xverify_shape(int n, int structured, int* out) {
  const size_t dyn = xv_dyn_bytes(structured != 0);
  const int rc = xv_smem(dyn);
  if (rc) return rc;
  return tm_shape(k_xverify, xv_blocks(n), TM_XV_THREADS, dyn, out);
}
