// In-place per-slot KV-cache row writes for Hopper (sm_90a), bound to Python
// through ctypes.
//
// Replaces the TPU kernel qwen3_tpu/ops/pallas/kv_write.py::kv_write_rows
// (body _kernel): for every slot b, in one launch,
//
//   cache[layer, b, positions[b]] = rows[b].astype(cache.dtype)
//
// cache [L, B, S, KV, D] f32 or bf16, rows [B, KV, D] f32, positions [B]
// int32 or int64 on the device, read as stored. bf16 rounds to nearest even
// (__float2bfloat16_rn), as JAX's astype does. The kernel alone clamps the
// positions into [0, S) (the wrapper passes them on as they are), as the
// plain version does on the CPU, so that a stray index stays inside the
// buffer. Slots write disjoint rows (b differs), so equal positions in two
// slots do not race.
//
// Bound: bytes, each row read once as f32 and written once in the cache's
// type (B * KV * D * (4 + 4 or 2) bytes: 384-512 KB at qwen3-0.6b's B = 64
// serving cache, 0.12-0.15 us at 3.35 TB/s), so the time is the launch.
// The first design made three launches a call (the wrapper's int32 cast
// and clamp of the positions, then one block a slot with 4-byte loads:
// 9.9 us a call where one index_put_ takes 7.5; an NVIDIA H100 80GB HBM3 at
// 700 W, chip_smoke.py). Now the wrapper makes no device op, and the one
// kernel spreads the B rows over blocks of kThreads threads, a thread four
// consecutive values: one 16-byte load, one 16-byte (f32) or 8-byte (bf16)
// store, so 64 slots of 1024 values make 128 blocks, one an SM. A row whose
// length is not a multiple of 4 (or whose rows are not 16-byte aligned)
// takes scalar loads and stores, the same values.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const unsigned lo =
      (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v.x)) |
      ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v.y)) << 16);
  const unsigned hi =
      (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v.z)) |
      ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v.w)) << 16);
  *reinterpret_cast<uint2*>(p) = make_uint2(lo, hi);
}

// Thread i of the grid writes values 4 (i % q) .. + 3 of slot i / q, q =
// ceil(row / 4) quads a row.
template <typename T, typename P, bool VEC>
__global__ void __launch_bounds__(kThreads)
kv_write_rows_kernel(T* __restrict__ cache, const float* __restrict__ rows,
                     const P* __restrict__ positions, int layer, int B, int S,
                     int row) {
  const int q = (row + 3) / 4;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= B * q) return;
  const int b = i / q, v = 4 * (i - b * q);
  const long long p = positions[b];
  const int pos = (int)(p < 0 ? 0 : p > S - 1 ? S - 1 : p);
  T* dst = cache + (((size_t)layer * B + b) * S + pos) * (size_t)row + v;
  const float* src = rows + (size_t)b * row + v;
  if (VEC) {
    store4(dst, __ldg(reinterpret_cast<const float4*>(src)));
  } else {
    for (int e = 0; e < 4 && v + e < row; ++e) store1(dst + e, __ldg(src + e));
  }
}

template <typename T, typename P>
int launch(T* cache, const float* rows, const P* positions, int layer, int B,
           int S, int row, cudaStream_t s) {
  const unsigned blocks =
      (unsigned)(((size_t)B * ((row + 3) / 4) + kThreads - 1) / kThreads);
  if (row % 4 == 0 &&
      ((uintptr_t)cache | (uintptr_t)rows) % 16 == 0)
    kv_write_rows_kernel<T, P, true>
        <<<blocks, kThreads, 0, s>>>(cache, rows, positions, layer, B, S, row);
  else
    kv_write_rows_kernel<T, P, false>
        <<<blocks, kThreads, 0, s>>>(cache, rows, positions, layer, B, S, row);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pos(T* cache, const float* rows, const void* positions, int pos64,
               int layer, int B, int S, int row, cudaStream_t s) {
  if (pos64)
    return launch(cache, rows, static_cast<const int64_t*>(positions), layer,
                  B, S, row, s);
  return launch(cache, rows, static_cast<const int32_t*>(positions), layer, B,
                S, row, s);
}

}  // namespace

extern "C" {

// cache[layer, b, positions[b], :] = rows[b, :] for b < B; row = KV * D
// values; bf16 != 0 for a bf16 cache, else f32; pos64 != 0 for int64
// positions, else int32. One launch on `stream`; returns cudaGetLastError()
// (0 = launched).
int kv_write_rows(void* cache, const void* rows, const void* positions,
                  int layer, int B, int S, int row, int bf16, int pos64,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rows);
  if (bf16)
    return launch_pos(static_cast<__nv_bfloat16*>(cache), r, positions, pos64,
                      layer, B, S, row, s);
  return launch_pos(static_cast<float*>(cache), r, positions, pos64, layer, B,
                    S, row, s);
}

}  // extern "C"
