// K6: splice delta rows into the speculation arena's resident lane
// buffers in place, and clear the arena's active mask.
//
// Replaces tendermint_tpu/crypto/tpu/resident.py _splice_fn (a donated
// jit scatter of k delta rows into seven resident (N, ...) arrays) and
// _clear_fn (active = 0 but the sentinel lane 0). Donation becomes
// in-place writes here: the resident buffers keep their addresses.
// Plain PyTorch versions: crypto/cuda/resident.py splice_plain and
// clear_plain. Both kernels are also K8's (resident.py mesh_splice and
// mesh_clear, replacing _mesh_splice_fn and _mesh_clear_fn): once per
// device, into its contiguous block of arena shards, at block positions.
//
// The k delta rows arrive as ONE packed byte buffer (one host-to-device
// copy), 105 bytes a row, laid out as sections:
//   int32 pos[k], split[k], patch_len[k], group[k]   (16k bytes)
//   uint8 sig[k][64], patch[k][24], s_ok[k]           (89k bytes)
// and k_splice writes, for each row r, slot pos[r] of sb (64 B), patch
// (24 B), s_ok, split, patch_len and group, and sets active[pos[r]] = 1.
// The host keeps one row per slot (the last, as the reference's scatter
// does), so no two threads write one byte; a row whose pos is out of
// range writes nothing. The port does not pad deltas to powers of two:
// CUDA does not recompile per shape.
//
// Bound on the H100: bytes, and below them the launch. A splice reads
// the 105 B of each delta row and writes 102 B into the buffers: ~0.2
// MB for a 1,024-row burst, ~60 ns at 3.35 TB/s. Design: TM_SPLICE_PARTS
// = 8 threads a row, each one aligned chunk: four copy the signature as
// 16-byte words, three the patch as 8-byte words, one the s_ok flag,
// the three ints and the active flag. The sections start at 16k and 80k
// (16- and 8-byte aligned for any k), a row's chunks at 64r and 24r
// within them, and the destinations at sb + 64 pos and patch + 24 pos;
// the buffers' bases are 16-byte aligned (resident.py checks each
// arena's once, at construction, and the wrapper each caller's). Index
// math is 32-bit, with shifts: at 1,024 rows, 8,192 threads, one wave.
//
// k_clear is K6's clear (per = n: only lane 0 stays active) and K8's
// (per = a shard's lanes: each shard's sentinel, its first lane, stays
// active): active[i] = (i % per == 0), 16 bytes a thread where n allows.
#include "common.cuh"

#define TM_SPLICE_PARTS 8
#define TM_SPLICE_THREADS 256
// k and n at most this: every byte offset below fits 32 bits
#define TM_SPLICE_MAX (1 << 24)

__global__ void k_splice(const uint8_t* __restrict__ packed, unsigned k,
                         unsigned n, uint8_t* __restrict__ sb,
                         uint8_t* __restrict__ s_ok,
                         uint8_t* __restrict__ patch,
                         int32_t* __restrict__ split,
                         int32_t* __restrict__ patch_len,
                         int32_t* __restrict__ group,
                         uint8_t* __restrict__ active) {
  const unsigned t = blockIdx.x * TM_SPLICE_THREADS + threadIdx.x;
  const unsigned row = t >> 3, part = t & 7;
  if (row >= k) return;
  const int32_t* ints = reinterpret_cast<const int32_t*>(packed);
  const int p = ints[row];
  if (p < 0 || (unsigned)p >= n) return;  // never write out of bounds
  const unsigned pos = (unsigned)p;
  if (part < 4) {
    const uint4* src = reinterpret_cast<const uint4*>(packed + (k << 4) + (row << 6));
    reinterpret_cast<uint4*>(sb + (pos << 6))[part] = src[part];
  } else if (part < 7) {
    const uint2* src = reinterpret_cast<const uint2*>(packed + 80u * k + 24u * row);
    reinterpret_cast<uint2*>(patch + 24u * pos)[part - 4] = src[part - 4];
  } else {
    s_ok[pos] = packed[104u * k + row] != 0;
    split[pos] = ints[k + row];
    patch_len[pos] = ints[(k << 1) + row];
    group[pos] = ints[3u * k + row];
    active[pos] = 1;
  }
}

__global__ void k_clear(uint8_t* __restrict__ active, unsigned per, unsigned n) {
  const unsigned lo = (blockIdx.x * TM_THREADS + threadIdx.x) << 4;
  if (lo >= n) return;
  // the first lane at or after lo that starts a shard; the next ones
  // follow every per lanes (none more within 16 lanes when per >= 16)
  const unsigned r = lo % per;
  unsigned next = r == 0 ? lo : lo + (per - r);
  if (lo + 16 <= n) {
    unsigned long long a = 0, b = 0;  // lanes lo..lo+7, lo+8..lo+15
    for (; next < lo + 16; next += per) {
      const unsigned k = next - lo;
      if (k < 8)
        a |= 1ull << (8 * k);
      else
        b |= 1ull << (8 * (k - 8));
    }
    *reinterpret_cast<uint4*>(active + lo) =
        make_uint4((unsigned)a, (unsigned)(a >> 32), (unsigned)b, (unsigned)(b >> 32));
    return;
  }
  for (unsigned i = lo; i < n; ++i) {
    const bool on = i == next;
    if (on) next += per;
    active[i] = on;
  }
}

static bool tm_aligned(const void* p, unsigned a) {
  return ((uintptr_t)p & (a - 1)) == 0;
}

extern "C" int tm_splice(const void* packed, int k, int n, void* sb, void* s_ok,
                         void* patch, void* split, void* patch_len, void* group,
                         void* active, void* stream) {
  if (k <= 0) return 0;
  if (k > TM_SPLICE_MAX || n < 0 || n > TM_SPLICE_MAX)
    return (int)cudaErrorInvalidValue;
  if (!tm_aligned(packed, 16) || !tm_aligned(sb, 16) || !tm_aligned(patch, 8))
    return (int)cudaErrorMisalignedAddress;
  const unsigned threads = (unsigned)k * TM_SPLICE_PARTS;
  k_splice<<<(threads + TM_SPLICE_THREADS - 1) / TM_SPLICE_THREADS,
             TM_SPLICE_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, (unsigned)k, (unsigned)n, (uint8_t*)sb,
      (uint8_t*)s_ok, (uint8_t*)patch, (int32_t*)split, (int32_t*)patch_len,
      (int32_t*)group, (uint8_t*)active);
  return (int)cudaGetLastError();
}

extern "C" int tm_clear(void* active, int per, int n, void* stream) {
  if (n <= 0) return 0;
  if (per <= 0 || n % per) return (int)cudaErrorInvalidValue;
  if (!tm_aligned(active, 16)) return (int)cudaErrorMisalignedAddress;
  k_clear<<<tm_blocks(((long)n + 15) / 16), TM_THREADS, 0,
            (cudaStream_t)stream>>>((uint8_t*)active, (unsigned)per,
                                    (unsigned)n);
  return (int)cudaGetLastError();
}
