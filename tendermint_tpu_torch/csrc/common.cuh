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
#define TM_ENTRY_INTS 40  // 4 coordinates x 10 limbs
