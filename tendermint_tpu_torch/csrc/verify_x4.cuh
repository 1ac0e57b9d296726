// The block body shared by K4 (general_verify.cu), K9 (sr_verify.cu)
// and K7 (arena_verify.cu, K8's verify too): TM_X4_LANES lanes a block
// that each carry their own key, [k](-A) on a
// 4-thread chain a lane (chain_x4.cuh) while other warps do the rest.
//
// [k](-A) runs over a variable base, so its windows cannot be split
// over warps as K3/K5 split theirs (warp p's slice would first need
// [16^lo_p](-A), the same chain of doublings). The parallelism comes
// from two places:
// - inside a point op: the four threads of a lane each hold one
//   coordinate and compute one product of each round (a doubling is two
//   rounds, an add three), so the lane's serial path of ~2,800 field
//   operations falls to ~760 rounds;
// - across roles, one warp a role, lane l being thread l of each role
//   warp (so no warp diverges by role):
//   - chain warps 0 .. TM_X4_CHAIN_WARPS - 1, lane l on threads
//     4 (l mod 8) .. + 3 of warp l / 8: decode A (the four threads run
//     the same decode, so none waits for another), build the lane's
//     signed table j (-A), j = 0..8, in shared memory, wait for the
//     digits (named barrier 1), run the windows MSB first: 4 doublings
//     and the entry |d_w| added with the digit's sign (-X, -T);
//   - the digits warp: the lane's signed digits into shared memory
//     (K4: SHA-512, the fold and the recode; K7: the same after it
//     assembles the lane's sign bytes; K9: the recode of the host's
//     nibbles), then arrives on named barrier 1;
//   - the comb warps: contiguous slices of the 64 comb windows of [S]B
//     (they need only S), each partial sum into a shared slot, then
//     arrive on named barrier 2;
//   - the R warp: decodes R, waits on named barrier 2 and sums the comb
//     warps' partial sums (K4 onto -R) into slot 0.
//   Each role's branch ends there; one __syncthreads() that every
//   thread of the block reaches follows the branches, and after it the
//   chain threads add slot 0 and finish the lane's check. The named
//   barriers are met from different branches, so they use the
//   non-aligned barrier.arrive / barrier.sync.
// The sum's order differs from the plain versions'; add-2008-hwcd-3 is
// complete and both checks (the identity, ristretto equality) are
// projective, so no verdict can change.
//
// Shared memory a block: the digits (69 x TM_X4_LANES bytes) and r_ok
// static; dynamic (TM_X4_SMEM), the table's 9 entries, TM_X4_COMB_WARPS
// point slots and the kernel's own (K9: R) in the x4 layout (limb k of
// coordinate c of lane l at p[(k * TM_X4_LANES + l) * 4 + c]: a chain
// warp's 32 threads read 32 consecutive words): at 32 lanes and 8 warps
// K4 11 x 5,120 B = 55 KB in i32 and x 16,384 B = 176 KB in f32, K9 one
// slot more, K7 K4's and its 32 message rows of 196 B (6,272 B) after
// them (above 48 KB: cudaFuncSetAttribute before each launch). The
// chain's field calls are inline (fe_calls_inline), its coordinate in
// registers.
#pragma once
#include "chain_x4.cuh"
#include "common.cuh"

static_assert(TM_X4_LANES == 8 || TM_X4_LANES == 16 || TM_X4_LANES == 32,
              "TM_X4_LANES: 8, 16 or 32");
static_assert(TM_X4_COMB_WARPS >= 1, "TM_X4_WARPS: at least one comb warp");
static_assert(TM_X4_THREADS <= 1024, "TM_X4_WARPS: at most 32 warps");

#define TM_X4_POINT_LIMBS (4 * FE_NLIMB * TM_X4_LANES)
// Dynamic shared bytes with `extra` point slots of the kernel's own.
#define TM_X4_SMEM(extra)                                          \
  ((size_t)(TM_ENTRIES + TM_X4_COMB_WARPS + (extra)) * TM_X4_POINT_LIMBS * \
   sizeof(fe_limb))
static_assert(TM_X4_SMEM(1) + TM_WINDOWS * TM_X4_LANES + TM_X4_LANES <= 232448,
              "K4/K9 shared memory above the SM's 227 KB");

// Named barrier 1: the digits warp arrives once the digits are in
// shared memory, the chain warps wait. Named barrier 2: the comb warps
// arrive once their partial sums are stored, the R warp waits. Each is
// reached from two branches, so the non-aligned forms.
#define TM_X4_DIGIT_BAR 1
#define TM_X4_DIGIT_BAR_THREADS (32 * (TM_X4_CHAIN_WARPS + 1))
#define TM_X4_COMB_BAR 2
#define TM_X4_COMB_BAR_THREADS (32 * (TM_X4_COMB_WARPS + 1))

static __device__ __forceinline__ void x4_bar_arrive(int id, int threads) {
  asm volatile("barrier.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

static __device__ __forceinline__ void x4_bar_sync(int id, int threads) {
  asm volatile("barrier.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Who a thread is: its warp, its lane in the warp, the block's lane it
// serves (l), and for a chain thread its coordinate q and the first
// lane of its four. An off-path warp's threads past TM_X4_LANES serve
// no lane.
struct x4_thread {
  int warp, l, q, lead;
  bool chain, serves;
};

static __device__ __forceinline__ x4_thread x4_me() {
  x4_thread t;
  const int lane = threadIdx.x & 31;
  t.warp = threadIdx.x >> 5;
  t.chain = t.warp < TM_X4_CHAIN_WARPS;
  t.q = lane & 3;
  t.lead = lane & ~3;
  t.l = t.chain ? t.warp * 8 + (lane >> 2) : lane;
  t.serves = t.l < TM_X4_LANES;
  return t;
}

static __device__ __forceinline__ void x4_load(fe& out, const fe_limb* p, int l, int c) {
#pragma unroll
  for (int k = 0; k < FE_NLIMB; ++k) out.v[k] = p[(k * TM_X4_LANES + l) * 4 + c];
}

static __device__ __forceinline__ void x4_store(fe_limb* p, int l, int c, const fe& a) {
#pragma unroll
  for (int k = 0; k < FE_NLIMB; ++k) p[(k * TM_X4_LANES + l) * 4 + c] = a.v[k];
}

static __device__ __forceinline__ void ge_store_x4(fe_limb* p, int l, const ge& a) {
  x4_store(p, l, 0, a.X);
  x4_store(p, l, 1, a.Y);
  x4_store(p, l, 2, a.Z);
  x4_store(p, l, 3, a.T);
}

static __device__ __forceinline__ void ge_load_x4(ge& a, const fe_limb* p, int l) {
  x4_load(a.X, p, l, 0);
  x4_load(a.Y, p, l, 1);
  x4_load(a.Z, p, l, 2);
  x4_load(a.T, p, l, 3);
}

// Coordinate q of a point held whole.
static __device__ __forceinline__ void x4_coordinate(fe& mine, const ge& a, int q) {
  fe_pick(mine, q == 2, a.Z, a.T);
  fe_pick(mine, q == 1, a.Y, mine);
  fe_pick(mine, q == 0, a.X, mine);
}

// Coordinate q of the point at p, negated (-X, -T) when neg.
static __device__ __forceinline__ void x4_entry(fe& mine, const fe_limb* p, int l, int q,
                                                bool neg) {
  fe v, nv;
  x4_load(v, p, l, q);
  fe_neg(nv, v);
  fe_pick(mine, neg && (q == 0 || q == 3), nv, v);
}

// Thread q's round-one operand (ge_add_x4) of the point at p, negated
// when neg: Y2 - X2, Y2 + X2, T2, Z2 for q = 0..3, formed as ge_add
// forms them from (-X2, Y2, Z2, -T2).
static __device__ __forceinline__ void x4_operand(fe& op, const fe_limb* p, int l, int q,
                                                  bool neg) {
  fe u, v, nu, s, t;
  x4_load(u, p, l, q < 2 ? 0 : 5 - q);  // X, X, T, Z
  x4_load(v, p, l, q < 2 ? 1 : 5 - q);  // Y, Y, T, Z
  fe_neg(nu, u);
  fe_pick(u, neg && q != 3, nu, u);
  fe_sub(s, v, u);
  fe_add(t, v, u);
  fe_pick(op, q == 1, t, u);
  fe_pick(op, q == 0, s, op);
}

// The chain's point ops outside the window loop (the table's adds, the
// final add and x8), out of line so that each inline field call is
// compiled once for them.
static __device__ __noinline__ void ge_add_x4_once(fe& mine, int q, int lead, const fe& op) {
  ge_add_x4<fe_calls_inline>(mine, q, lead, op);
}

static __device__ __noinline__ void ge_double_x4_once(fe& mine, int q, int lead) {
  ge_double_x4_with<fe_calls_inline>(mine, q, lead);
}

// The chain threads' part. mine: coordinate q of -A on entry, of
// [k](-A) on return, for k's signed digits dig[0..top] (LSB first, in
// [-8, 8]). Builds the lane's table in tab, entries j (-A) for
// j = 0..8 as build_window_table orders them (entry j = entry j-1 + (-A)),
// then waits for the digits.
static __device__ __forceinline__ void x4_chain(fe& mine, const x4_thread& t, fe_limb* tab,
                                                const int8_t (*dig)[TM_X4_LANES], int top) {
  fe e, zero, one, op;
  fe_zero(zero);
  fe_one(one);
  fe_pick(e, t.q == 1 || t.q == 2, one, zero);  // the identity
  x4_store(tab, t.l, t.q, e);
  x4_store(tab + TM_X4_POINT_LIMBS, t.l, t.q, mine);
  __syncwarp();
  x4_operand(op, tab + TM_X4_POINT_LIMBS, t.l, t.q, false);
  e = mine;
#pragma unroll 1
  for (int j = 2; j < TM_ENTRIES; ++j) {
    ge_add_x4_once(e, t.q, t.lead, op);
    x4_store(tab + j * TM_X4_POINT_LIMBS, t.l, t.q, e);
  }
  __syncwarp();
  x4_bar_sync(TM_X4_DIGIT_BAR, TM_X4_DIGIT_BAR_THREADS);
  int d = dig[top][t.l];
  x4_entry(mine, tab + (d < 0 ? -d : d) * TM_X4_POINT_LIMBS, t.l, t.q, d < 0);
#pragma unroll 1
  for (int w = top - 1; w >= 0; --w) {
#pragma unroll 1
    for (int k = 0; k < 4; ++k) ge_double_x4_with<fe_calls_inline>(mine, t.q, t.lead);
    d = dig[w][t.l];
    x4_operand(op, tab + (d < 0 ? -d : d) * TM_X4_POINT_LIMBS, t.l, t.q, d < 0);
    ge_add_x4<fe_calls_inline>(mine, t.q, t.lead, op);
  }
}

// The chain threads, after the block's __syncthreads(): mine += slot 0
// (the R warp's sum).
static __device__ __forceinline__ void x4_add_slot(fe& mine, const x4_thread& t,
                                                   const fe_limb* slot) {
  fe op;
  x4_operand(op, slot, t.l, t.q, false);
  ge_add_x4_once(mine, t.q, t.lead, op);
}

// ge_is_identity of the lane's point, on thread q = 0 (X == 0, Y == Z).
static __device__ __forceinline__ bool x4_is_identity(const fe& mine, int lead) {
  fe y, z, d;
  fe_shfl(y, mine, lead + 1);
  fe_shfl(z, mine, lead + 2);
  fe_sub(d, y, z);
  return fe_is_zero(mine) && fe_is_zero(d);
}

// rs_equal of the lane's point V and the point at r (R), on thread
// q = 0: X1 Y2 == Y1 X2 or Y1 Y2 == X1 X2, one product a thread.
static __device__ __forceinline__ bool x4_rs_equal(const fe& mine, const x4_thread& t,
                                                   const fe_limb* r) {
  fe x1, y1, x2, y2, m1, m2, p, a, b, c, d;
  fe_shfl(x1, mine, t.lead);
  fe_shfl(y1, mine, t.lead + 1);
  x4_load(x2, r, t.l, 0);
  x4_load(y2, r, t.l, 1);
  fe_pick(m1, t.q == 0 || t.q == 3, x1, y1);
  fe_pick(m2, t.q == 0 || t.q == 2, y2, x2);
  fe_mul_inline(p, m1, m2);
  fe_shfl(a, p, t.lead);
  fe_shfl(b, p, t.lead + 1);
  fe_shfl(c, p, t.lead + 2);
  fe_shfl(d, p, t.lead + 3);
  return fe_eq(a, b) || fe_eq(c, d);
}

// A comb warp (part of TM_X4_COMB_WARPS): acc += its slice of the comb
// windows of [S]B; nib(w) is nibble w of S. Out of line because of a
// fault of nvcc 12.9's device front end (cicc): with this loop inlined
// into the kernel, it gives ge_add_comb's local bx the stack slot of
// the live acc. The PTX then stores the entry's x over acc.X and passes
// one address as p and qx to ge_add_z1, so every comb add is wrong
// (-Xptxas -O0 keeps the fault: it is in the PTX). Out of line, the
// slots are distinct and the sums right (so they are with a copy of acc
// as p); PERF.md section 7. One call a comb warp, so the call costs
// nothing.
template <class Nib>
static __device__ __noinline__ void x4_comb(ge& acc, const fe_limb* __restrict__ btab,
                                            int part, Nib nib) {
  const int lo = part * 64 / TM_X4_COMB_WARPS, hi = (part + 1) * 64 / TM_X4_COMB_WARPS;
#pragma unroll 1
  for (int w = lo; w < hi; ++w) ge_add_comb(acc, btab, w, nib(w));
}

// A comb warp's end: its partial sum into its slot, then it arrives on
// named barrier 2.
static __device__ __forceinline__ void x4_comb_done(const ge& acc, const x4_thread& t,
                                                    fe_limb* slots) {
  if (t.serves)
    ge_store_x4(slots + (t.warp - TM_X4_CHAIN_WARPS - 2) * TM_X4_POINT_LIMBS, t.l, acc);
  __syncwarp();
  x4_bar_arrive(TM_X4_COMB_BAR, TM_X4_COMB_BAR_THREADS);
}

// The R warp, after its decode: waits for the comb warps and stores
// acc + their partial sums into slot 0.
static __device__ __forceinline__ void x4_sum_slots(ge& acc, const x4_thread& t,
                                                    fe_limb* slots) {
  __syncwarp();
  x4_bar_sync(TM_X4_COMB_BAR, TM_X4_COMB_BAR_THREADS);
  if (!t.serves) return;
  ge p;
#pragma unroll 1
  for (int c = 0; c < TM_X4_COMB_WARPS; ++c) {
    ge_load_x4(p, slots + c * TM_X4_POINT_LIMBS, t.l);
    ge_add(acc, acc, p);
  }
  ge_store_x4(slots, t.l, acc);
}

static long x4_blocks(int n) { return ((long)n + TM_X4_LANES - 1) / TM_X4_LANES; }

// Above 48 KB, dynamic shared memory needs the attribute, on the
// current device.
template <class K>
static int x4_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}
