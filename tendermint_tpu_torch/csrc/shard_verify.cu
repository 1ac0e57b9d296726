// K5: verify one shard's lanes against its key range of sharded comb
// tables; launched once per mesh entry, on the entry's device and stream.
//
// Replaces tendermint_tpu/crypto/tpu/expanded.py _xkernel_sharded and
// _skernel_sharded, which vmap K3's body (and, in the structured form,
// K2's assembly before it) over a leading device axis. Per lane: a
// local key index into this shard's K keys, the signature row and s_ok;
// the message either as a SHA-padded row with its block count (msg,
// nblocks: the _xkernel_sharded form), or (msg NULL: the _skernel_sharded
// form) assembled by the lane itself with K2's byte rule
// (sign_bytes.cuh) from the commit's templates (pre, pre_len, suf,
// suf_len, every shard's whole) and its timestamp patch (patch, split,
// patch_len, group) into a local array, so no (N, width) message buffer
// goes to global memory; then K3's per-lane body (xverify_lane.cuh);
// AND with s_ok and key_ok. A lane whose s_ok or key_ok is false (pad
// lanes: s_ok 0) returns false without the curve work; the verdict is
// the same. Plain PyTorch version: crypto/cuda/expanded.py
// shard_verify_plain.
//
// Bound on the H100: operations, as K3's — per lane whose verdict is not
// already false: the R decompress (255 squarings, 19 multiplies), a
// 9-multiply add per nonzero signed digit of k, an 8-multiply comb add
// per nonzero nibble of S, two adds and three doublings (~1.3e5 int32
// products). Bytes: the table entries a lane gathers (up to 69 * 160 B)
// and ~100 B of lane data. Design: one thread per lane, as K3.
// The f32 build (-DTM_FIELD_F32, TM_TPU_FIELD=f32) compiles this source
// on field_f32.cuh: the same steps, bound by FP32 FMAs (1,024 a
// multiply, 528 a squaring) in place of the int32 products, with
// table entries of 512 B.
#include "sign_bytes.cuh"
#include "xverify_lane.cuh"

#define TM_SHARD_MAX_W 448

__global__ void k_shard_verify(
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
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int key = idx[i];
  if (!s_ok[i] || !key_ok[key]) {
    out[i] = 0;
    return;
  }
  uint8_t m[TM_SHARD_MAX_W];
  const uint8_t* row;
  int nb;
  if (msg != nullptr) {
    row = msg + (long)width * i;
    nb = nblocks[i];
  } else {
    const int g = group[i];
    const uint8_t* pre_g = pre + g * TM_PRE_W;
    const uint8_t* suf_g = suf + g * TM_SUF_W;
    const int pl = pre_len[g], sl = suf_len[g];
    const int a = split[i], plen = patch_len[i];
    const uint8_t* prow = patch + (long)i * TM_PATCH_W;
#pragma unroll 1
    for (int j = 0; j < width; ++j)
      m[j] = tm_msg_byte(pre_g, pl, suf_g, sl, prow, a, plen, j);
    row = m;
    nb = tm_msg_blocks(plen + pl + sl);
  }
  out[i] = tm_xverify_lane(
               akeys + 32 * (long)key, sb + 64 * (long)i, row, width, nb,
               tables + (long)key * TM_WINDOWS * TM_ENTRIES * TM_ENTRY_INTS,
               btab)
               ? 1
               : 0;
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
  k_shard_verify<<<tm_blocks(n), TM_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const uint8_t*)akeys, (const uint8_t*)sb,
      (const uint8_t*)s_ok, (const uint8_t*)key_ok, (const fe_limb*)tables,
      (const fe_limb*)btab, (const uint8_t*)msg, (const int32_t*)nblocks,
      (const uint8_t*)pre, (const int32_t*)pre_len, (const uint8_t*)suf,
      (const int32_t*)suf_len, (const uint8_t*)patch, (const int32_t*)split,
      (const int32_t*)patch_len, (const int32_t*)group, width, n,
      (uint8_t*)out);
  return (int)cudaGetLastError();
}
