// K2: each lane's canonical vote sign bytes, assembled on the card.
//
// Replaces tendermint_tpu/crypto/tpu/expanded.py assemble_core (traced
// into _skernel): msg[lane] = patch[:split] || pre[group] ||
// patch[split:patch_len] || suf[group], then 0x80 and the SHA-512
// length tail at the end of block nblocks — the byte rule of
// sign_bytes.cuh, which K7 shares. Plain PyTorch version:
// crypto/cuda/expanded.py assemble_plain.
//
// Bound on the H100: bytes. It writes N * width bytes (10,240 x 192 =
// 1.97 MB) and reads per lane a 24-byte patch and three ints; the
// templates (32 x 192 B) stay in L1/L2. ~0.6 us of HBM time at
// 3.35 TB/s, so the launch itself dominates. Design: one thread per
// output byte, neighbouring threads on neighbouring bytes, so the
// stores coalesce.
#include "common.cuh"
#include "sign_bytes.cuh"

__global__ void k_assemble(const uint8_t* __restrict__ pre,
                           const int32_t* __restrict__ pre_len,
                           const uint8_t* __restrict__ suf,
                           const int32_t* __restrict__ suf_len,
                           const uint8_t* __restrict__ patch,
                           const int32_t* __restrict__ split,
                           const int32_t* __restrict__ patch_len,
                           const int32_t* __restrict__ group, int n, int width,
                           uint8_t* __restrict__ msg,
                           int32_t* __restrict__ nblocks) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)n * width) return;
  const int lane = (int)(idx / width), j = (int)(idx % width);
  const int g = group[lane];
  const int pl = pre_len[g], sl = suf_len[g], plen = patch_len[lane];
  msg[idx] = tm_msg_byte(pre + g * TM_PRE_W, pl, suf + g * TM_SUF_W, sl,
                         patch + (long)lane * TM_PATCH_W, split[lane], plen, j);
  if (j == 0) nblocks[lane] = tm_msg_blocks(plen + pl + sl);
}

extern "C" int tm_assemble(const void* pre, const void* pre_len, const void* suf,
                           const void* suf_len, const void* patch,
                           const void* split, const void* patch_len,
                           const void* group, int n, int width, void* msg,
                           void* nblocks, void* stream) {
  if (n <= 0) return 0;
  k_assemble<<<tm_blocks((long)n * width), TM_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)pre, (const int32_t*)pre_len, (const uint8_t*)suf,
      (const int32_t*)suf_len, (const uint8_t*)patch, (const int32_t*)split,
      (const int32_t*)patch_len, (const int32_t*)group, n, width,
      (uint8_t*)msg, (int32_t*)nblocks);
  return (int)cudaGetLastError();
}
