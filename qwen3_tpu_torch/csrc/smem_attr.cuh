// Dynamic shared memory past 48 KB: a kernel's limit must be raised first,
// once per device and size.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

// Raises `kernel`'s dynamic shared memory limit to `bytes` when that is past
// 48 KB and past what `set` (the largest size set so far, per device)
// holds. Returns a cudaError_t as an int (0 = ready to launch).
template <typename K>
inline int allow_smem(K kernel, size_t bytes, size_t (&set)[16]) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 16 && set[dev] >= bytes) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess && dev < 16) set[dev] = bytes;
  return (int)e;
}
