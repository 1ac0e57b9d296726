// K5: verify one shard's lanes against its key range of sharded comb
// tables; launched once per mesh entry, on the entry's device and stream.
//
// Replaces tendermint_tpu/crypto/tpu/expanded.py _xkernel_sharded and
// _skernel_sharded, which vmap K3's body (and, in the structured form,
// K2's assembly before it) over a leading device axis. Per lane: a
// local key index into this shard's K keys, the signature row and s_ok;
// the message either as a SHA-padded row with its block count (msg,
// nblocks: the _xkernel_sharded form), or (msg NULL: the _skernel_sharded
// form) assembled with K2's byte rule (sign_bytes.cuh) from the
// commit's templates (pre, pre_len, suf, suf_len, every shard's whole)
// and its timestamp patch (patch, split, patch_len, group), so no
// (N, width) message buffer goes to global memory; then K3's body
// (xverify_lane.cuh); AND with s_ok and key_ok. A lane whose s_ok or
// key_ok is false (pad lanes: s_ok 0) returns false without the curve
// work; the verdict is the same. Plain PyTorch version:
// crypto/cuda/expanded.py shard_verify_plain.
//
// Bound on the H100: operations, as K3's — per lane whose verdict is not
// already false: the R decompress (255 squarings, 19 multiplies), a
// 9-multiply add per nonzero signed digit of k, an 8-multiply comb add
// per nonzero nibble of S, two adds and three doublings (~1.3e5 int32
// products). Bytes: the table entries a lane gathers (up to 69 * 160 B)
// and ~100 B of lane data.
// Design: K3's (xverify.cu): (n + 31) / 32 blocks of TM_XV_WARPS x 32
// threads, 32 lanes a block, the block-cooperative body. In the
// structured form the hashing warp first assembles its lanes' messages
// into the block's dynamic shared memory (a row of TM_SHARD_ROW bytes a
// lane, 14 KB a block, aliasing the reduction's points), where the lane
// used to build a 448-byte local array. A block whose 32 lanes all have
// s_ok or key_ok false writes its verdicts and returns before any work.
// At 3,072 lanes a shard that is 96 blocks, one wave with one block on
// each of 96 SMs; four shards on four streams take 384 blocks, two
// waves of two blocks an SM. Bound, like K3, by a block's longest warp
// (the R decompress, or a comb warp's windows) and by residency.
// The f32 build (-DTM_FIELD_F32, TM_TPU_FIELD=f32) compiles this source
// on field_f32.cuh: the same steps, bound by FP32 FMAs (1,024 a
// multiply, 528 a squaring) in place of the int32 products, with
// table entries of 512 B.
#include "sign_bytes.cuh"
#include "xverify_lane.cuh"

#define TM_SHARD_MAX_W 448
// a lane's message row in shared memory: 113 words, odd, so the 32
// lanes' rows start in 32 different banks
#define TM_SHARD_ROW (TM_SHARD_MAX_W + 4)

static size_t k5_dyn_bytes(bool structured) {
  const size_t msgs = structured ? (size_t)TM_XV_LANES * TM_SHARD_ROW : 0;
  return msgs > TM_XV_POINT_BYTES ? msgs : TM_XV_POINT_BYTES;
}

__global__ void __launch_bounds__(TM_XV_THREADS, TM_XV_MIN_BLOCKS) k_shard_verify(
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
    } else {
      const int g = group[i];
      const uint8_t* pre_g = pre + g * TM_PRE_W;
      const uint8_t* suf_g = suf + g * TM_SUF_W;
      const int pl = pre_len[g], sl = suf_len[g];
      const int a = split[i], plen = patch_len[i];
      const uint8_t* prow = patch + i * TM_PATCH_W;
      uint8_t* m = tm_dyn + lane * TM_SHARD_ROW;
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

static long k5_blocks(int n) { return ((long)n + TM_XV_LANES - 1) / TM_XV_LANES; }

// Above 48 KB, dynamic shared memory needs the attribute, on the
// current device.
static int k5_smem(size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      k_shard_verify, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// msg and nblocks, or (msg NULL) the eight template and patch arrays.
extern "C" int tm_shard_verify(
    const void* idx, const void* akeys, const void* sb, const void* s_ok,
    const void* key_ok, const void* tables, const void* btab, const void* msg,
    const void* nblocks, const void* pre, const void* pre_len,
    const void* suf, const void* suf_len, const void* patch,
    const void* split, const void* patch_len, const void* group, int width,
    int n, void* out, void* stream) {
  if (n <= 0) return 0;
  if (msg == nullptr && (width < 64 || width > TM_SHARD_MAX_W))
    return (int)cudaErrorInvalidValue;
  const size_t dyn = k5_dyn_bytes(msg == nullptr);
  const int rc = k5_smem(dyn);
  if (rc) return rc;
  k_shard_verify<<<(unsigned)k5_blocks(n), TM_XV_THREADS, dyn,
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
extern "C" int tm_shard_verify_shape(int n, int structured, int* out) {
  const size_t dyn = k5_dyn_bytes(structured != 0);
  const int rc = k5_smem(dyn);
  if (rc) return rc;
  return tm_shape(k_shard_verify, k5_blocks(n), TM_XV_THREADS, dyn, out);
}
