// K1: per-key signed comb tables for an expanded validator set.
//
// Replaces tendermint_tpu/crypto/tpu/expanded.py _builder().build: for
// key v, ZIP-215 decompress A_v, then T[v, w, j] = j * 16^w * (-A_v) for
// w < 69, j <= 8, plus ok[v]. Plain PyTorch version:
// crypto/cuda/expanded.py build_tables_plain.
//
// Bound on the H100: operations. Per key the function needs a
// decompress (255 squarings, 19 multiplies), 69 windows of 7 adds (9
// multiplies each) and 68 x 4 doublings between them (4 squarings, 4
// multiplies): at 100 int32 x int32 -> int64 products a multiply and 55
// a squaring, ~6.2e5 products per key, 6.3e9 at 10,240 keys, against
// the card's int32 rate. This kernel does more: its fe_sqr reuses
// fe_mul, and it doubles once more after the last window. The table it
// writes (621 entries of 160 B = 99 KB per key) is the byte term and is
// far smaller.
// Design: one thread per key, no shared memory, each entry written
// once in its final compact layout (4 x 10 int32, not the reference's
// 128-int TPU row). The whole set is built in one launch: 10,240 keys
// make 1.0 GB of tables, and 80 GB leaves no reason to chunk. Low
// occupancy (10,240 threads) and register spills are expected here and
// recorded, not fixed.
// The f32 build (-DTM_FIELD_F32, TM_TPU_FIELD=f32) compiles this source
// on field_f32.cuh: the same steps, bound by FP32 FMAs (1,024 a
// multiply, 528 a squaring) in place of the int32 products, with
// entries of 4 x 32 float32 limbs (512 B, 318 KB a key, 3.26 GB at
// 10,240 keys).
#include "common.cuh"
#include "edwards.cuh"

__global__ void k_build_tables(const uint8_t* __restrict__ akeys,
                               fe_limb* __restrict__ tables,
                               uint8_t* __restrict__ ok, int nkeys) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= nkeys) return;
  ge a;
  const bool okv = ge_decompress(a, akeys + 32 * (long)v);
  ge base, e;
  ge_neg(base, a);
  fe_limb* out = tables + (long)v * TM_WINDOWS * TM_ENTRIES * TM_ENTRY_INTS;
#pragma unroll 1
  for (int w = 0; w < TM_WINDOWS; ++w) {
    fe_limb* row = out + w * TM_ENTRIES * TM_ENTRY_INTS;
    ge_identity(e);
    ge_store(row, e);
    e = base;
    ge_store(row + TM_ENTRY_INTS, e);
#pragma unroll 1
    for (int j = 2; j < TM_ENTRIES; ++j) {
      ge_add(e, e, base);
      ge_store(row + j * TM_ENTRY_INTS, e);
    }
#pragma unroll 1
    for (int k = 0; k < 4; ++k) ge_double(base, base);
  }
  ok[v] = okv ? 1 : 0;
}

extern "C" int tm_build_tables(const void* akeys, void* tables, void* ok,
                               int nkeys, void* stream) {
  if (nkeys <= 0) return 0;
  k_build_tables<<<tm_blocks(nkeys), TM_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)akeys, (fe_limb*)tables, (uint8_t*)ok, nkeys);
  return (int)cudaGetLastError();
}

extern "C" const char* tm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Wait for the stream; its code names a fault inside a kernel queued on
// it (or an earlier one: such errors are sticky), which the launch's
// own cudaGetLastError() cannot see. crypto/cuda/kernels.py classifies.
extern "C" int tm_sync(void* stream) {
  return (int)cudaStreamSynchronize((cudaStream_t)stream);
}
