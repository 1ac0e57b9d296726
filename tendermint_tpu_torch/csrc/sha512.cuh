// SHA-512 of one lane's R || A || M (B2 of the port).
//
// Replaces tendermint_tpu/crypto/tpu/sha512.py compress_blocks (there
// traced into every verify program as (hi, lo) uint32 pairs). The
// plain PyTorch version is crypto/cuda/sha512.py. One thread hashes one
// lane: the host has padded M (0x80, zeros, 128-bit length) for a
// 64-byte prefix and reports the lane's block count; R and A are read
// from the signature row and the key row, so the full message is
// never copied.
#pragma once
#include <stdint.h>

static __constant__ uint64_t SHA512_K[80] = {
    0x428a2f98d728ae22ULL, 0x7137449123ef65cdULL, 0xb5c0fbcfec4d3b2fULL,
    0xe9b5dba58189dbbcULL, 0x3956c25bf348b538ULL, 0x59f111f1b605d019ULL,
    0x923f82a4af194f9bULL, 0xab1c5ed5da6d8118ULL, 0xd807aa98a3030242ULL,
    0x12835b0145706fbeULL, 0x243185be4ee4b28cULL, 0x550c7dc3d5ffb4e2ULL,
    0x72be5d74f27b896fULL, 0x80deb1fe3b1696b1ULL, 0x9bdc06a725c71235ULL,
    0xc19bf174cf692694ULL, 0xe49b69c19ef14ad2ULL, 0xefbe4786384f25e3ULL,
    0x0fc19dc68b8cd5b5ULL, 0x240ca1cc77ac9c65ULL, 0x2de92c6f592b0275ULL,
    0x4a7484aa6ea6e483ULL, 0x5cb0a9dcbd41fbd4ULL, 0x76f988da831153b5ULL,
    0x983e5152ee66dfabULL, 0xa831c66d2db43210ULL, 0xb00327c898fb213fULL,
    0xbf597fc7beef0ee4ULL, 0xc6e00bf33da88fc2ULL, 0xd5a79147930aa725ULL,
    0x06ca6351e003826fULL, 0x142929670a0e6e70ULL, 0x27b70a8546d22ffcULL,
    0x2e1b21385c26c926ULL, 0x4d2c6dfc5ac42aedULL, 0x53380d139d95b3dfULL,
    0x650a73548baf63deULL, 0x766a0abb3c77b2a8ULL, 0x81c2c92e47edaee6ULL,
    0x92722c851482353bULL, 0xa2bfe8a14cf10364ULL, 0xa81a664bbc423001ULL,
    0xc24b8b70d0f89791ULL, 0xc76c51a30654be30ULL, 0xd192e819d6ef5218ULL,
    0xd69906245565a910ULL, 0xf40e35855771202aULL, 0x106aa07032bbd1b8ULL,
    0x19a4c116b8d2d0c8ULL, 0x1e376c085141ab53ULL, 0x2748774cdf8eeb99ULL,
    0x34b0bcb5e19b48a8ULL, 0x391c0cb3c5c95a63ULL, 0x4ed8aa4ae3418acbULL,
    0x5b9cca4f7763e373ULL, 0x682e6ff3d6b2b8a3ULL, 0x748f82ee5defb2fcULL,
    0x78a5636f43172f60ULL, 0x84c87814a1f0ab72ULL, 0x8cc702081a6439ecULL,
    0x90befffa23631e28ULL, 0xa4506cebde82bde9ULL, 0xbef9a3f7b2c67915ULL,
    0xc67178f2e372532bULL, 0xca273eceea26619cULL, 0xd186b8c721c0c207ULL,
    0xeada7dd6cde0eb1eULL, 0xf57d4f7fee6ed178ULL, 0x06f067aa72176fbaULL,
    0x0a637dc5a2c898a6ULL, 0x113f9804bef90daeULL, 0x1b710b35131c471bULL,
    0x28db77f523047d84ULL, 0x32caab7b40c72493ULL, 0x3c9ebe0a15c9bebcULL,
    0x431d67c49c100d4cULL, 0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL,
    0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL,
};

static __device__ __forceinline__ uint64_t sha_rotr(uint64_t x, int n) {
  return (x >> n) | (x << (64 - n));
}

// Byte p of R || A || M.
static __device__ __forceinline__ uint64_t sha_byte(const uint8_t* r, const uint8_t* a,
                                             const uint8_t* m, int p) {
  return p < 32 ? r[p] : (p < 64 ? a[p - 32] : m[p - 64]);
}

// out[0..63] = SHA-512 digest bytes of the first nblocks blocks.
static __device__ __noinline__ void sha512_lane(const uint8_t* r, const uint8_t* a,
                                         const uint8_t* m, int nblocks,
                                         uint8_t out[64]) {
  uint64_t H[8] = {
      0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL,
      0x3c6ef372fe94f82bULL, 0xa54ff53a5f1d36f1ULL,
      0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
      0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL,
  };
#pragma unroll 1
  for (int blk = 0; blk < nblocks; ++blk) {
    uint64_t W[16];
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      uint64_t w = 0;
      const int base = blk * 128 + 8 * t;
#pragma unroll
      for (int k = 0; k < 8; ++k) w = (w << 8) | sha_byte(r, a, m, base + k);
      W[t] = w;
    }
    uint64_t va = H[0], vb = H[1], vc = H[2], vd = H[3];
    uint64_t ve = H[4], vf = H[5], vg = H[6], vh = H[7];
#pragma unroll 1
    for (int t0 = 0; t0 < 80; t0 += 16) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (t0 > 0) {
          const uint64_t w15 = W[(j + 1) & 15], w2 = W[(j + 14) & 15];
          const uint64_t s0 = sha_rotr(w15, 1) ^ sha_rotr(w15, 8) ^ (w15 >> 7);
          const uint64_t s1 = sha_rotr(w2, 19) ^ sha_rotr(w2, 61) ^ (w2 >> 6);
          W[j] = W[j] + s0 + W[(j + 9) & 15] + s1;
        }
        const uint64_t S1 = sha_rotr(ve, 14) ^ sha_rotr(ve, 18) ^ sha_rotr(ve, 41);
        const uint64_t ch = (ve & vf) ^ (~ve & vg);
        const uint64_t t1 = vh + S1 + ch + SHA512_K[t0 + j] + W[j];
        const uint64_t S0 = sha_rotr(va, 28) ^ sha_rotr(va, 34) ^ sha_rotr(va, 39);
        const uint64_t mj = (va & vb) ^ (va & vc) ^ (vb & vc);
        const uint64_t t2 = S0 + mj;
        vh = vg;
        vg = vf;
        vf = ve;
        ve = vd + t1;
        vd = vc;
        vc = vb;
        vb = va;
        va = t1 + t2;
      }
    }
    H[0] += va;
    H[1] += vb;
    H[2] += vc;
    H[3] += vd;
    H[4] += ve;
    H[5] += vf;
    H[6] += vg;
    H[7] += vh;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int k = 0; k < 8; ++k) out[8 * i + k] = (uint8_t)(H[i] >> (56 - 8 * k));
}
