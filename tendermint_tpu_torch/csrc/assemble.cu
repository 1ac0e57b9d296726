// K2: each lane's canonical vote sign bytes, assembled on the card.
//
// Replaces tendermint_tpu/crypto/tpu/expanded.py assemble_core (traced
// into _skernel): msg[lane] = patch[:split] || pre[group] ||
// patch[split:patch_len] || suf[group], then 0x80 and the SHA-512
// length tail (a 16-byte big-endian bit length of 64 + mlen, whose low
// two bytes only are nonzero) at the end of block nblocks, with
// nblocks = (64 + mlen + 17 + 127) / 128. Plain PyTorch version:
// crypto/cuda/expanded.py assemble_plain.
//
// Bound on the H100: bytes. It writes N * width bytes (10,240 x 192 =
// 1.97 MB) and reads per lane a 24-byte patch and three ints; the
// templates (32 x 192 B) stay in L1/L2. ~0.6 us of HBM time at
// 3.35 TB/s, so the launch itself dominates. Design: one thread per
// output byte, neighbouring threads on neighbouring bytes, so the
// stores coalesce.
#include "common.cuh"

#define TM_PATCH_W 24
#define TM_PRE_W 128
#define TM_SUF_W 64

__device__ __forceinline__ int tm_clip(int c, int hi) {
  return c < 0 ? 0 : (c > hi ? hi : c);
}

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
  const int a = split[lane];
  const int b = patch_len[lane] - a;
  const int c1 = a + pre_len[g];
  const int c2 = c1 + b;
  const int c3 = c2 + suf_len[g];  // = mlen
  const uint8_t* prow = patch + (long)lane * TM_PATCH_W;
  int v;
  if (j < a)
    v = prow[tm_clip(j, TM_PATCH_W - 1)];
  else if (j < c1)
    v = pre[g * TM_PRE_W + tm_clip(j - a, TM_PRE_W - 1)];
  else if (j < c2)
    v = prow[tm_clip(a + (j - c1), TM_PATCH_W - 1)];
  else if (j < c3)
    v = suf[g * TM_SUF_W + tm_clip(j - c2, TM_SUF_W - 1)];
  else
    v = 0;
  if (j == c3) v = 0x80;
  const int nb = (64 + c3 + 17 + 127) / 128;
  const int bitlen = (64 + c3) * 8;
  const int k = 15 - (j - (nb * 128 - 16 - 64));
  if (k >= 0 && k < 16) v = k < 4 ? (bitlen >> (8 * k)) & 0xFF : 0;
  msg[idx] = (uint8_t)v;
  if (j == 0) nblocks[lane] = nb;
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
