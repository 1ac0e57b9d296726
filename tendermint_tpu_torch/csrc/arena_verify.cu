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
// One thread per lane, fused: a lane assembles its sign bytes with
// K2's byte rule (sign_bytes.cuh) into a `width`-byte array of its own,
// in registers and local memory, and runs K4's per-lane body
// (general_lane.cuh) on it; the message never goes to global memory.
// The reference computes every lane and then masks; this kernel
// returns false for an inactive lane without computing it. The
// verdicts are the same.
//
// Bound on the H100: operations — K4's count for each active lane
// (two decompressions, the 14-add table of -A, the doublings below k's
// top nibble, an add per nonzero nibble of k and of S, the tail),
// ~3.2e5 int32 products a lane. Bytes per lane are ~140 (key,
// signature, patch, three ints, two flags), far below that.
// The f32 build (-DTM_FIELD_F32, TM_TPU_FIELD=f32) compiles this source
// on field_f32.cuh: the same steps, bound by FP32 FMAs (1,024 a
// multiply, 528 a squaring) in place of the int32 products, with
// a per-lane table of 16 x 512 B.
#include "general_lane.cuh"
#include "sign_bytes.cuh"

#define TM_ARENA_MAX_W 192

__global__ void k_arena_verify(const uint8_t* __restrict__ ab,
                               const uint8_t* __restrict__ sb,
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
                               const fe_limb* __restrict__ btab, int n,
                               int width, uint8_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (!active[i]) {
    out[i] = 0;
    return;
  }
  const int g = group[i];
  const uint8_t* pre_g = pre + g * TM_PRE_W;
  const uint8_t* suf_g = suf + g * TM_SUF_W;
  const int pl = pre_len[g], sl = suf_len[g];
  const int a = split[i], plen = patch_len[i];
  const uint8_t* prow = patch + (long)i * TM_PATCH_W;
  uint8_t m[TM_ARENA_MAX_W];
#pragma unroll 1
  for (int j = 0; j < width; ++j)
    m[j] = tm_msg_byte(pre_g, pl, suf_g, sl, prow, a, plen, j);
  out[i] = tm_verify_lane(ab + 32 * (long)i, sb + 64 * (long)i, m, width,
                          tm_msg_blocks(plen + pl + sl), s_ok[i] != 0, btab)
               ? 1
               : 0;
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
  k_arena_verify<<<tm_blocks(n), TM_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)ab, (const uint8_t*)sb, (const uint8_t*)s_ok,
      (const uint8_t*)active, (const uint8_t*)pre, (const int32_t*)pre_len,
      (const uint8_t*)suf, (const int32_t*)suf_len, (const uint8_t*)patch,
      (const int32_t*)split, (const int32_t*)patch_len, (const int32_t*)group,
      (const fe_limb*)btab, n, width, (uint8_t*)out);
  return (int)cudaGetLastError();
}
