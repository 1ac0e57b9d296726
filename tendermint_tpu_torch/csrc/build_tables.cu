// K1: per-key signed comb tables for an expanded validator set.
//
// Replaces tendermint_tpu/crypto/tpu/expanded.py _builder().build: for
// key v, ZIP-215 decompress A_v, then T[v, w, j] = j * 16^w * (-A_v) for
// w < 69, j <= 8, plus ok[v]. Plain PyTorch version:
// crypto/cuda/expanded.py build_tables_plain; every entry equals it limb
// for limb (the same formulas in the same order per entry).
//
// Bound on the H100: operations, near its bytes. Per key the function
// needs a decompress (255 squarings, 19 multiplies), 69 windows of 7
// adds (9 multiplies each) and 68 x 4 doublings between them (4
// squarings, 4 multiplies): at 100 int32 x int32 -> int64 products a
// multiply and 55 a squaring (fe_sqr, field.cuh), ~6.2e5 products a
// key, 6.3e9 at 10,240 keys, 0.38 ms at the card's int32 rate. The
// table it writes (621 entries of 160 B = 99 KB a key, 1.02 GB at
// 10,240 keys) takes 0.30 ms at 3.35 TB/s.
//
// Design: two launches on the caller's stream, each checked with
// cudaGetLastError().
// 1. k_build_chain, TM_K1_PER_KEY = 4 threads a key (8 keys a warp):
//    each thread decompresses its key (the same serial chain on all
//    four, so no thread waits for another), then runs the 68 x 4
//    doublings base_w = 16^w * (-A). A doubling is two rounds of four
//    independent products (X^2, Y^2, Z^2, (X+Y)^2, then e*f, g*h, f*g,
//    e*h): thread q computes product q of each round, with its
//    operands passed by __shfl_sync, and after the second round holds
//    coordinate q of base_w. base_w is entry T[v, w, 1], so thread q
//    stores its coordinate there. The serial path is the decompress
//    and 2 x 272 products, ~820 field operations, against ~6,800 a key
//    in one thread.
// 2. k_build_rows, one thread a (key, window) row, row t = v * 69 + w
//    (706,560 threads at 10,240 keys): entry 0 the identity, entries
//    2..8 by seven ge_add(e, e, base) from the stored base, as the
//    plain version orders them. Consecutive threads own consecutive
//    rows (1,440 B each in i32, 4,608 B in f32), and each entry goes
//    through a per-warp stage in shared memory, so that the warp
//    stores (and loads the bases) in 16-byte chunks that cover whole
//    entries. Shared memory: 128 x (4 x NLIMB + 4) limbs a block,
//    22,528 B in i32, 67,584 B in f32 (above 48 KB:
//    cudaFuncSetAttribute).
// Two launches, not one with chain warps feeding row warps through
// shared memory: the row work is ~5x the chain's and needs every
// window's base, which the chain makes one after another; a second
// launch spreads the rows over every SM, where one launch would tie
// each block's row warps to its own chain.
// Not bound by the stores: staging them moved the rows launch by a
// tenth (PERF.md section 6, the K1 row). The suspect is the field calls: the
// rows keep ~36 warps an SM with a 640-byte stack frame a thread (the
// out-of-line fe_mul takes and returns its operands through local
// memory), far more than the SM's L1 holds. The chain is the
// decompress and 272 doublings in a row, at ~10 warps an SM (f32: two
// waves, since at 253 registers a thread only 8 warps an SM fit).
// The f32 build (-DTM_FIELD_F32, TM_TPU_FIELD=f32) compiles this source
// on field_f32.cuh: the same steps, bound by FP32 FMAs (1,024 a
// multiply, 528 a squaring) in place of the int32 products, with
// entries of 4 x 32 float32 limbs (512 B, 318 KB a key, 3.26 GB at
// 10,240 keys).
#include "chain_x4.cuh"
#include "common.cuh"

__global__ void __launch_bounds__(TM_K1_THREADS)
    k_build_chain(const uint8_t* __restrict__ akeys, fe_limb* __restrict__ tables,
                  uint8_t* __restrict__ ok, int nkeys) {
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const int q = threadIdx.x & 3;
  const int lead = (threadIdx.x & 31) & ~3;
  // pad threads redo the last key and store nothing, so every thread
  // of the warp takes part in the shuffles
  const bool real = t / TM_K1_PER_KEY < nkeys;
  const long v = real ? t / TM_K1_PER_KEY : nkeys - 1;
  ge a;
  const bool okv = ge_decompress(a, akeys + 32 * v);
  ge_neg(a, a);
  fe mine;
  fe_pick(mine, q == 2, a.Z, a.T);
  fe_pick(mine, q == 1, a.Y, mine);
  fe_pick(mine, q == 0, a.X, mine);
  fe_limb* out = tables + v * TM_WINDOWS * TM_ENTRIES * TM_ENTRY_INTS +
                 TM_ENTRY_INTS + q * FE_NLIMB;
  if (real) fe_store(out, mine);
#pragma unroll 1
  for (int w = 1; w < TM_WINDOWS; ++w) {
#pragma unroll 1
    for (int k = 0; k < 4; ++k) ge_double_x4(mine, q, lead);
    if (real) fe_store(out + w * TM_ENTRIES * TM_ENTRY_INTS, mine);
  }
  if (real && q == 0) ok[v] = okv ? 1 : 0;
}

struct __align__(16) tm_vec4 {
  fe_limb x[4];
};

// The rows launch stages each entry of a warp's 32 rows in shared
// memory, lane-major, TM_K1_STAGE limbs a lane (4 of padding keep every
// lane's 16-byte chunks in other banks).
#define TM_K1_STAGE (TM_ENTRY_INTS + 4)
#define TM_K1_ROW_SMEM ((size_t)TM_K1_THREADS * TM_K1_STAGE * sizeof(fe_limb))
#define TM_K1_CHUNKS (TM_ENTRY_INTS / 4)  // 16-byte chunks an entry
#define TM_K1_ROW_INTS (TM_ENTRIES * TM_ENTRY_INTS)

// An entry into the lane's stage row in 16-byte stores.
static __device__ __forceinline__ void ge_store_wide(fe_limb* dst, const ge& p) {
  fe_limb w[TM_ENTRY_INTS];
#pragma unroll
  for (int i = 0; i < FE_NLIMB; ++i) {
    w[i] = p.X.v[i];
    w[FE_NLIMB + i] = p.Y.v[i];
    w[2 * FE_NLIMB + i] = p.Z.v[i];
    w[3 * FE_NLIMB + i] = p.T.v[i];
  }
  tm_vec4* d = reinterpret_cast<tm_vec4*>(dst);
#pragma unroll
  for (int k = 0; k < TM_K1_CHUNKS; ++k) {
    tm_vec4 v;
#pragma unroll
    for (int l = 0; l < 4; ++l) v.x[l] = w[4 * k + l];
    d[k] = v;
  }
}

// Entry j of the warp's rows t0 .. t0 + 31 (those below nrows) between
// the stage and the table, in 16-byte chunks: consecutive lanes move
// consecutive chunks, so each instruction covers whole spans of one or
// two entries.
static __device__ __forceinline__ void rows_out(fe_limb* tables, long t0, long nrows,
                                                int j, const fe_limb* stage, int lane) {
#pragma unroll 1
  for (int c = lane; c < 32 * TM_K1_CHUNKS; c += 32) {
    const int e = c / TM_K1_CHUNKS, q = c % TM_K1_CHUNKS;
    if (t0 + e < nrows)
      *reinterpret_cast<tm_vec4*>(tables + (t0 + e) * TM_K1_ROW_INTS +
                                  j * TM_ENTRY_INTS + 4 * q) =
          *reinterpret_cast<const tm_vec4*>(stage + e * TM_K1_STAGE + 4 * q);
  }
}

static __device__ __forceinline__ void rows_in(const fe_limb* tables, long t0, long nrows,
                                               int j, fe_limb* stage, int lane) {
#pragma unroll 1
  for (int c = lane; c < 32 * TM_K1_CHUNKS; c += 32) {
    const int e = c / TM_K1_CHUNKS, q = c % TM_K1_CHUNKS;
    if (t0 + e < nrows)
      *reinterpret_cast<tm_vec4*>(stage + e * TM_K1_STAGE + 4 * q) =
          *reinterpret_cast<const tm_vec4*>(tables + (t0 + e) * TM_K1_ROW_INTS +
                                            j * TM_ENTRY_INTS + 4 * q);
  }
}

__global__ void __launch_bounds__(TM_K1_THREADS)
    k_build_rows(fe_limb* __restrict__ tables, int nkeys) {
  extern __shared__ __align__(16) unsigned char tm_dyn[];
  const long nrows = (long)nkeys * TM_WINDOWS;
  const int lane = threadIdx.x & 31;
  const long t0 = (long)blockIdx.x * blockDim.x + (threadIdx.x & ~31);  // t = v * 69 + w
  if (t0 >= nrows) return;  // the whole warp
  fe_limb* stage = reinterpret_cast<fe_limb*>(tm_dyn) + (threadIdx.x & ~31) * TM_K1_STAGE;
  fe_limb* mine = stage + lane * TM_K1_STAGE;
  // lanes past the last row compute on stale stage limbs and store nothing
  ge base, e;
  rows_in(tables, t0, nrows, 1, stage, lane);
  __syncwarp();
  ge_load(base, mine);
  __syncwarp();
  ge_identity(e);
  ge_store_wide(mine, e);
  __syncwarp();
  rows_out(tables, t0, nrows, 0, stage, lane);
  e = base;
#pragma unroll 1
  for (int j = 2; j < TM_ENTRIES; ++j) {
    ge_add(e, e, base);
    __syncwarp();
    ge_store_wide(mine, e);
    __syncwarp();
    rows_out(tables, t0, nrows, j, stage, lane);
  }
}

static long k1_chain_blocks(int nkeys) {
  return ((long)nkeys * TM_K1_PER_KEY + TM_K1_THREADS - 1) / TM_K1_THREADS;
}

static long k1_row_blocks(int nkeys) {
  return ((long)nkeys * TM_WINDOWS + TM_K1_THREADS - 1) / TM_K1_THREADS;
}

// Above 48 KB (the f32 build's 66 KB), dynamic shared memory needs the
// attribute, on the current device.
static int k1_row_smem() {
  if (TM_K1_ROW_SMEM <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      k_build_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TM_K1_ROW_SMEM);
}

extern "C" int tm_build_tables(const void* akeys, void* tables, void* ok,
                               int nkeys, void* stream) {
  if (nkeys <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  k_build_chain<<<(unsigned)k1_chain_blocks(nkeys), TM_K1_THREADS, 0, s>>>(
      (const uint8_t*)akeys, (fe_limb*)tables, (uint8_t*)ok, nkeys);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int rc2 = k1_row_smem();
  if (rc2) return rc2;
  k_build_rows<<<(unsigned)k1_row_blocks(nkeys), TM_K1_THREADS, TM_K1_ROW_SMEM,
                 s>>>((fe_limb*)tables, nkeys);
  return (int)cudaGetLastError();
}

// The two launches' shapes at nkeys keys: TM_SHAPE_INTS ints each
// (common.cuh tm_shape), the chain's then the rows'.
extern "C" int tm_build_tables_shape(int nkeys, int* out) {
  const int rc = tm_shape(k_build_chain, k1_chain_blocks(nkeys), TM_K1_THREADS,
                          0, out);
  if (rc) return rc;
  const int rc2 = k1_row_smem();
  if (rc2) return rc2;
  return tm_shape(k_build_rows, k1_row_blocks(nkeys), TM_K1_THREADS,
                  TM_K1_ROW_SMEM, out + TM_SHAPE_INTS);
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
