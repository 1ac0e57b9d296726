// K4: verify lanes that each carry their own public key.
//
// Replaces tendermint_tpu/crypto/tpu/verify.py general_core (jitted as
// _kernel). Per lane: SHA-512(R || A || M); the fold to k' (69 nibbles);
// ZIP-215 decompress of A and R; a 16-entry window table of -A; 69
// windows MSB-first of (4 doublings + table add) for [k](-A), beside
// the fixed-base comb [S]B; + (-R); x8; identity check; AND with a_ok,
// r_ok and s_ok. Plain PyTorch version: crypto/cuda/verify.py
// general_verify_plain.
//
// Bound on the H100: operations. Per lane the function needs two
// decompressions (255 squarings, 19 multiplies each), the table's 14
// adds, 4 doublings per window below k's top nonzero nibble (about
// 68), an add per nonzero nibble of k and of S, and the tail: at 100
// products a multiply and 55 a squaring, ~3.2e5 products per lane.
// Bytes per lane are ~300 (key, signature, message), far below the
// operation time. Design: one thread per lane running the per-lane body
// of general_lane.cuh, which K7 shares.
// The f32 build (-DTM_FIELD_F32, TM_TPU_FIELD=f32) compiles this source
// on field_f32.cuh: the same steps, bound by FP32 FMAs (1,024 a
// multiply, 528 a squaring) in place of the int32 products, with
// a per-lane table of 16 x 512 B.
#include "general_lane.cuh"

__global__ void k_general_verify(const uint8_t* __restrict__ ab,
                                 const uint8_t* __restrict__ sb,
                                 const uint8_t* __restrict__ msg, int width,
                                 const int32_t* __restrict__ nblocks,
                                 const uint8_t* __restrict__ s_ok,
                                 const fe_limb* __restrict__ btab, int n,
                                 uint8_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = tm_verify_lane(ab + 32 * (long)i, sb + 64 * (long)i,
                          msg + (long)width * i, width, nblocks[i],
                          s_ok[i] != 0, btab)
               ? 1
               : 0;
}

extern "C" int tm_general_verify(const void* ab, const void* sb, const void* msg,
                                 int width, const void* nblocks,
                                 const void* s_ok, const void* btab, int n,
                                 void* out, void* stream) {
  if (n <= 0) return 0;
  k_general_verify<<<tm_blocks(n), TM_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)ab, (const uint8_t*)sb, (const uint8_t*)msg, width,
      (const int32_t*)nblocks, (const uint8_t*)s_ok, (const fe_limb*)btab, n,
      (uint8_t*)out);
  return (int)cudaGetLastError();
}
