// K6: splice delta rows into the speculation arena's resident lane
// buffers in place, and clear the arena's active mask.
//
// Replaces tendermint_tpu/crypto/tpu/resident.py _splice_fn (a donated
// jit scatter of k delta rows into seven resident (N, ...) arrays) and
// _clear_fn (active = 0 but the sentinel lane 0). Donation becomes
// in-place writes here: the resident buffers keep their addresses.
// Plain PyTorch versions: crypto/cuda/resident.py splice_plain and
// clear_plain. tm_splice is also K8's splice (resident.py mesh_splice:
// once per device, into its contiguous block of arena shards, at block
// positions), and k_mesh_clear below is K8's clear.
//
// The k delta rows arrive as ONE packed byte buffer (one host-to-device
// copy), 105 bytes a row, laid out as sections:
//   int32 pos[k], split[k], patch_len[k], group[k]   (16k bytes)
//   uint8 sig[k][64], patch[k][24], s_ok[k]           (89k bytes)
// and tm_splice writes, for each row r, slot pos[r] of sb (64 B), patch
// (24 B), s_ok, split, patch_len and group, and sets active[pos[r]] = 1.
// The host keeps one row per slot (the last, as the reference's scatter
// does), so no two threads write one byte. The port does not pad deltas
// to powers of two: CUDA does not recompile per shape.
//
// Bound on the H100: bytes. A splice reads the 105 B of each delta row
// and writes 102 B into the buffers: ~0.2 MB for a 1,024-row burst,
// ~60 ns at 3.35 TB/s, so launch latency dominates. Design: one thread
// per written element (93 a row: 64 signature bytes, 24 patch bytes,
// s_ok, three ints, active), neighbouring threads on neighbouring bytes
// of a row, so reads and writes coalesce.
#include "common.cuh"

#define TM_SIG_W 64
#define TM_PATCH_W 24
#define TM_ROW_COLS 93

__global__ void k_splice(const uint8_t* __restrict__ packed, int k, int n,
                         uint8_t* __restrict__ sb, uint8_t* __restrict__ s_ok,
                         uint8_t* __restrict__ patch,
                         int32_t* __restrict__ split,
                         int32_t* __restrict__ patch_len,
                         int32_t* __restrict__ group,
                         uint8_t* __restrict__ active) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)k * TM_ROW_COLS) return;
  const int row = (int)(idx / TM_ROW_COLS), col = (int)(idx % TM_ROW_COLS);
  const int32_t* ints = (const int32_t*)packed;
  const long pos = ints[row];
  if (pos < 0 || pos >= n) return;  // the host checks slots; never write out of bounds
  const uint8_t* bytes = packed + 16L * k;
  if (col < TM_SIG_W) {
    sb[TM_SIG_W * pos + col] = bytes[(long)TM_SIG_W * row + col];
  } else if (col < TM_SIG_W + TM_PATCH_W) {
    const int c = col - TM_SIG_W;
    patch[TM_PATCH_W * pos + c] =
        bytes[(long)TM_SIG_W * k + (long)TM_PATCH_W * row + c];
  } else if (col == 88) {
    s_ok[pos] = bytes[(long)(TM_SIG_W + TM_PATCH_W) * k + row];
  } else if (col == 89) {
    split[pos] = ints[k + row];
  } else if (col == 90) {
    patch_len[pos] = ints[2L * k + row];
  } else if (col == 91) {
    group[pos] = ints[3L * k + row];
  } else {
    active[pos] = 1;
  }
}

__global__ void k_clear(uint8_t* __restrict__ active, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) active[i] = i == 0 ? 1 : 0;
}

// K8's clear (replaces resident.py _mesh_clear_fn: every shard's lanes
// inactive but its own sentinel). A device's arena shards lie in one
// contiguous block of `per` lanes a shard, each shard's sentinel at its
// first lane, so a lane stays active iff i % per == 0. Launched once per
// device over its whole block. Plain version: crypto/cuda/resident.py
// mesh_clear_plain. Bound: bytes (one byte written a lane); launch
// latency dominates at arena sizes.
__global__ void k_mesh_clear(uint8_t* __restrict__ active, int per, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) active[i] = i % per == 0 ? 1 : 0;
}

extern "C" int tm_splice(const void* packed, int k, int n, void* sb, void* s_ok,
                         void* patch, void* split, void* patch_len, void* group,
                         void* active, void* stream) {
  if (k <= 0) return 0;
  k_splice<<<tm_blocks((long)k * TM_ROW_COLS), TM_THREADS, 0,
             (cudaStream_t)stream>>>(
      (const uint8_t*)packed, k, n, (uint8_t*)sb, (uint8_t*)s_ok,
      (uint8_t*)patch, (int32_t*)split, (int32_t*)patch_len, (int32_t*)group,
      (uint8_t*)active);
  return (int)cudaGetLastError();
}

extern "C" int tm_clear(void* active, int n, void* stream) {
  if (n <= 0) return 0;
  k_clear<<<tm_blocks(n), TM_THREADS, 0, (cudaStream_t)stream>>>(
      (uint8_t*)active, n);
  return (int)cudaGetLastError();
}

extern "C" int tm_mesh_clear(void* active, int per, int n, void* stream) {
  if (n <= 0 || per <= 0) return 0;
  k_mesh_clear<<<tm_blocks(n), TM_THREADS, 0, (cudaStream_t)stream>>>(
      (uint8_t*)active, per, n);
  return (int)cudaGetLastError();
}
