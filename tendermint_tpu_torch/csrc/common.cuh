// Launch helpers shared by the kernel sources.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

// One thread per lane (or key), small blocks so that the ~10k lanes of
// a commit spread over all 132 SMs.
#define TM_THREADS 64

static inline unsigned tm_blocks(long n) {
  return (unsigned)((n + TM_THREADS - 1) / TM_THREADS);
}

#define TM_WINDOWS 69
#define TM_ENTRIES 9
// One table entry: 4 coordinates x FE_NLIMB limbs of type fe_limb (the
// field header's: 10 int32, or 32 float under -DTM_FIELD_F32).
#define TM_ENTRY_INTS (4 * FE_NLIMB)
