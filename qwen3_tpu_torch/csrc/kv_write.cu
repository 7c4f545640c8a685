// In-place per-slot KV-cache row writes for Hopper (sm_90a), bound to Python
// through ctypes.
//
// Replaces the TPU kernel qwen3_tpu/ops/pallas/kv_write.py::kv_write_rows
// (body _kernel): for every slot b, in one launch,
//
//   cache[layer, b, positions[b]] = rows[b].astype(cache.dtype)
//
// cache [L, B, S, KV, D] f32 or bf16, rows [B, KV, D] f32, positions [B]
// int32 on the device. bf16 rounds to nearest even (__float2bfloat16_rn), as
// JAX's astype does. The caller clamps the positions into [0, S); the kernel
// clamps them again, as the plain version does, so that a stray index stays
// inside the buffer. Slots write disjoint rows (b differs), so equal
// positions in two slots do not race.
//
// Bound: bytes, each row read once as f32 and written once in the cache's
// type (B * KV * D * (4 + 4 or 2) bytes: 384-512 KB at qwen3-0.6b's B = 64
// serving cache), so at these sizes the launch itself is most of the time.
// One block per slot; a warp reads 128 contiguous bytes of the row and writes
// 128 or 64 contiguous bytes of the cache.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void kv_write_rows_kernel(T* __restrict__ cache,
                                     const float* __restrict__ rows,
                                     const int* __restrict__ positions,
                                     int layer, int B, int S, int row) {
  const int b = blockIdx.x;
  const int pos = min(max(positions[b], 0), S - 1);
  T* dst = cache + (((size_t)layer * B + b) * S + pos) * (size_t)row;
  const float* src = rows + (size_t)b * row;
  for (int i = threadIdx.x; i < row; i += blockDim.x) store(dst + i, src[i]);
}

}  // namespace

extern "C" {

// cache[layer, b, positions[b], :] = rows[b, :] for b < B; row = KV * D
// values; bf16 != 0 for a bf16 cache, else f32. Launches on `stream` and
// returns cudaGetLastError() (0 = launched).
int kv_write_rows(void* cache, const void* rows, const void* positions,
                  int layer, int B, int S, int row, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rows);
  const int* p = static_cast<const int*>(positions);
  if (bf16)
    kv_write_rows_kernel<<<B, 256, 0, s>>>(
        static_cast<__nv_bfloat16*>(cache), r, p, layer, B, S, row);
  else
    kv_write_rows_kernel<<<B, 256, 0, s>>>(static_cast<float*>(cache), r, p,
                                           layer, B, S, row);
  return (int)cudaGetLastError();
}

}  // extern "C"
