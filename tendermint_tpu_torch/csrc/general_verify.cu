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
// operation time. Design:
// one thread per lane; the per-lane table (16 points, 2.5 KB) lives in
// local memory, L1-cached, and is indexed by the lane's digit.
#include "common.cuh"
#include "edwards.cuh"
#include "scalar.cuh"
#include "sha512.cuh"

__global__ void k_general_verify(const uint8_t* __restrict__ ab,
                                 const uint8_t* __restrict__ sb,
                                 const uint8_t* __restrict__ msg, int width,
                                 const int32_t* __restrict__ nblocks,
                                 const uint8_t* __restrict__ s_ok,
                                 const int32_t* __restrict__ btab, int n,
                                 uint8_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint8_t* pub = ab + 32 * (long)i;
  const uint8_t* sig = sb + 64 * (long)i;
  int nb = nblocks[i];
  const int maxb = (64 + width) / 128;
  if (nb > maxb) nb = maxb;
  uint8_t dig[64];
  sha512_lane(sig, pub, msg + (long)width * i, nb, dig);
  int8_t k[69];
  fold_digest(dig, k);
  ge a, r;
  const bool a_ok = ge_decompress(a, pub);
  const bool r_ok = ge_decompress(r, sig);
  ge_neg(a, a);
  ge_neg(r, r);
  ge tbl[16];
  ge_identity(tbl[0]);
  tbl[1] = a;
#pragma unroll 1
  for (int j = 2; j < 16; ++j) ge_add(tbl[j], tbl[j - 1], a);
  ge acc_a, acc_b;
  ge_identity(acc_a);
  ge_identity(acc_b);
#pragma unroll 1
  for (int w = 0; w < TM_WINDOWS; ++w) {
    ge_double(acc_a, acc_a);
    ge_double(acc_a, acc_a);
    ge_double(acc_a, acc_a);
    ge_double(acc_a, acc_a);
    ge_add(acc_a, acc_a, tbl[k[TM_WINDOWS - 1 - w]]);
    ge_add_comb(acc_b, btab, w, s_nibble(sig + 32, w));
  }
  ge_add(acc_a, acc_a, acc_b);
  ge_add(acc_a, acc_a, r);
  ge_double(acc_a, acc_a);
  ge_double(acc_a, acc_a);
  ge_double(acc_a, acc_a);
  out[i] = (ge_is_identity(acc_a) && a_ok && r_ok && s_ok[i]) ? 1 : 0;
}

extern "C" int tm_general_verify(const void* ab, const void* sb, const void* msg,
                                 int width, const void* nblocks,
                                 const void* s_ok, const void* btab, int n,
                                 void* out, void* stream) {
  if (n <= 0) return 0;
  k_general_verify<<<tm_blocks(n), TM_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)ab, (const uint8_t*)sb, (const uint8_t*)msg, width,
      (const int32_t*)nblocks, (const uint8_t*)s_ok, (const int32_t*)btab, n,
      (uint8_t*)out);
  return (int)cudaGetLastError();
}
