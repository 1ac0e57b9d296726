// K3: verify lanes against an expanded validator set's comb tables.
//
// Replaces tendermint_tpu/crypto/tpu/expanded.py _xcore (jitted as
// _xkernel, and as the verify half of _skernel). Per lane: the key
// bytes by index; SHA-512(R || A || M); the fold to k' and its signed
// recode to 69 digits in [-8, 8]; ZIP-215 decompress of R; 69 windows
// of (signed table entry |d_w| of key idx, added with its sign) and of
// the fixed-base comb [S]B; + (-R); x8; identity check; AND with r_ok,
// s_ok and key_ok[idx]. Plain PyTorch version:
// crypto/cuda/expanded.py xverify_plain.
//
// Bound on the H100: operations. Per lane the function needs the R
// decompress (255 squarings, 19 multiplies), a 9-multiply add per
// nonzero signed digit of k (up to 69), an 8-multiply comb add per
// nonzero nibble of S (up to 64), two adds and three doublings: at 100
// products a multiply and 55 a squaring, ~1.3e5 products per lane,
// ~1.3e9 at 10,240 lanes, against the card's int32 rate. This kernel
// also adds zero digits and squares with fe_mul. Bytes: the table
// entries it gathers, up to 69 * 160 B = 11 KB per lane (113 MB at
// 10,240 lanes, ~34 us at 3.35 TB/s), plus the message.
// Design: one thread per lane running the per-lane body of
// xverify_lane.cuh, which K5 shares; field multiplies out of line.
// The f32 build (-DTM_FIELD_F32, TM_TPU_FIELD=f32) compiles this source
// on field_f32.cuh: the same steps, bound by FP32 FMAs (1,024 a
// multiply, 528 a squaring) in place of the int32 products, with
// table entries of 512 B (up to 35 KB gathered a lane).
#include "xverify_lane.cuh"

__global__ void k_xverify(const int32_t* __restrict__ idx,
                          const uint8_t* __restrict__ akeys,
                          const uint8_t* __restrict__ sb,
                          const uint8_t* __restrict__ msg, int width,
                          const int32_t* __restrict__ nblocks,
                          const uint8_t* __restrict__ s_ok,
                          const uint8_t* __restrict__ key_ok,
                          const fe_limb* __restrict__ tables,
                          const fe_limb* __restrict__ btab, int n,
                          uint8_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int key = idx[i];
  const bool ok = tm_xverify_lane(
      akeys + 32 * (long)key, sb + 64 * (long)i, msg + (long)width * i, width,
      nblocks[i], tables + (long)key * TM_WINDOWS * TM_ENTRIES * TM_ENTRY_INTS,
      btab);
  out[i] = (ok && s_ok[i] && key_ok[key]) ? 1 : 0;
}

extern "C" int tm_xverify(const void* idx, const void* akeys, const void* sb,
                          const void* msg, int width, const void* nblocks,
                          const void* s_ok, const void* key_ok,
                          const void* tables, const void* btab, int n,
                          void* out, void* stream) {
  if (n <= 0) return 0;
  k_xverify<<<tm_blocks(n), TM_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const uint8_t*)akeys, (const uint8_t*)sb,
      (const uint8_t*)msg, width, (const int32_t*)nblocks,
      (const uint8_t*)s_ok, (const uint8_t*)key_ok, (const fe_limb*)tables,
      (const fe_limb*)btab, n, (uint8_t*)out);
  return (int)cudaGetLastError();
}
