// Launch helpers and launch shapes shared by the kernel sources.
//
// Design: the kernels that are not redesigned run one thread per lane
// (or key) in blocks of TM_THREADS. K1, K3/K5 and K4/K9 spread each key
// and each lane over many threads:
// - K1 (build_tables.cu): a chain launch of TM_K1_PER_KEY threads a key
//   (the four products of a doubling on four threads of one warp), then
//   a row launch of one thread a (key, window) pair, both in blocks of
//   TM_K1_THREADS;
// - K3/K5 (xverify_lane.cuh): a block of TM_XV_WARPS warps serves
//   TM_XV_LANES lanes, one lane a thread of each warp; the warps split
//   the lane's windows and reduce their partial sums in shared memory;
// - K4/K9 and K7 (verify_x4.cuh): a block of TM_X4_WARPS warps serves
//   TM_X4_LANES lanes, [k](-A) on four threads a lane, the digits, R
//   and the comb windows of [S]B on other warps, one thread a lane.
// TM_XV_WARPS and TM_X4_WARPS are the field's: at most 256 threads a
// block under f32, whose build uses 254-255 registers a thread (65,536
// a block at most).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

// One thread per lane (or key), small blocks so that the ~10k lanes of
// a commit spread over all 132 SMs (the kernels not redesigned).
#define TM_THREADS 64

static inline unsigned tm_blocks(long n) {
  return (unsigned)((n + TM_THREADS - 1) / TM_THREADS);
}

#define TM_WINDOWS 69
#define TM_ENTRIES 9
// One table entry: 4 coordinates x FE_NLIMB limbs of type fe_limb (the
// field header's: 10 int32, or 32 float under -DTM_FIELD_F32).
#define TM_ENTRY_INTS (4 * FE_NLIMB)

// K1: threads a key in the chain launch (one per product of a
// doubling's round), and threads a block in both launches.
#define TM_K1_PER_KEY 4
#define TM_K1_THREADS 128

// K3/K5: lanes a block (one a thread of each warp) and warps a block.
// The warp count was chosen by CUDA-event time at the main path's
// shapes (K3 at 10,240 lanes, K5 at 3,072 lanes a shard on one stream
// and on four, by sweep_warps.py): PERF.md section 6.
#define TM_XV_LANES 32
#ifdef TM_FIELD_F32
#ifndef TM_XV_WARPS
#define TM_XV_WARPS 8
#endif
#define TM_XV_MIN_BLOCKS 1
#else
#ifndef TM_XV_WARPS
#define TM_XV_WARPS 8
#endif
// 16 resident warps an SM at most 128 registers a thread
#define TM_XV_MIN_BLOCKS (16 / TM_XV_WARPS > 0 ? 16 / TM_XV_WARPS : 1)
#endif
#define TM_XV_THREADS (TM_XV_WARPS * 32)

// K4/K9 and K7 (verify_x4.cuh): lanes a block and warps a block. The warps
// of a block: TM_X4_CHAIN_WARPS chain warps (four threads a lane, eight
// lanes a warp), the digits warp, the R warp, and the comb warps (one
// lane a thread of each). The defaults were chosen by CUDA-event time
// at the main path's shapes (K4 at 128 and 8,192 lanes, K9 at 5,120):
// PERF.md section 6.
#ifndef TM_X4_LANES
#define TM_X4_LANES 32
#endif
#ifndef TM_X4_WARPS
#define TM_X4_WARPS 8
#endif
#define TM_X4_CHAIN_WARPS (TM_X4_LANES / 8)
#define TM_X4_COMB_WARPS (TM_X4_WARPS - TM_X4_CHAIN_WARPS - 2)
#define TM_X4_THREADS (TM_X4_WARPS * 32)
#ifdef TM_FIELD_F32
#define TM_X4_MIN_BLOCKS 1
#else
// 16 resident warps an SM at most 128 registers a thread
#define TM_X4_MIN_BLOCKS (16 / TM_X4_WARPS > 0 ? 16 / TM_X4_WARPS : 1)
#endif

// The shape of a launch, as the *_shape exports report it: blocks,
// threads a block, dynamic shared bytes, resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers a thread,
// local (stack) bytes a thread, static shared bytes.
#define TM_SHAPE_INTS 7

template <class K>
static inline int tm_shape(K kernel, long blocks, int threads, size_t dyn,
                           int* out) {
  cudaFuncAttributes attr;
  int rc = (int)cudaFuncGetAttributes(&attr, kernel);
  if (rc) return rc;
  int per_sm = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, dyn);
  if (rc) return rc;
  out[0] = (int)blocks;
  out[1] = threads;
  out[2] = (int)dyn;
  out[3] = per_sm;
  out[4] = attr.numRegs;
  out[5] = (int)attr.localSizeBytes;
  out[6] = (int)attr.sharedSizeBytes;
  return 0;
}
