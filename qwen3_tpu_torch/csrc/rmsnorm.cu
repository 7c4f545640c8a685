// RMSNorm with a fixed reduction order for Hopper (sm_90a), bound to Python
// through ctypes.
//
// The port's own kernel: the JAX package leaves the norms to XLA
// (qwen3_tpu/ops/norms.py::rmsnorm and ::rms_inv), and no Pallas kernel
// computes them. Per row of n values (x f32 or bf16):
//
//   inv = rsqrt(mean(x^2) + eps)           (rms_inv: inv, f32 [rows])
//   out = (w * (x * inv)).to(x.dtype)      (rmsnorm: w f32 [n])
//
// Why a kernel. The plain chain (x*x, torch.mean, + eps, rsqrt, two
// products, the cast) is 5-7 PyTorch kernels a call, and torch.mean on the
// card picks its reduction order by the number of rows, so a row's bits
// could follow the batch it sits in. Here a row's order is a function of n
// alone, and so is the launch's shape a row:
//  - TR = 32 threads a row (one warp) up to n = 1024, TR = 128 above;
//  - the row is cut into 4-value chunks, chunk c to thread c % TR; each
//    thread sums the squares of its chunks' values in index order as one
//    chain (every product and sum rounded, -fmad=false and intrinsics);
//  - a warp adds its lanes' sums by a __shfl_xor tree (offsets 16 .. 1,
//    lane l adding lane l ^ off to its own), and with TR = 128 the four
//    warps' sums add as (s0 + s2) + (s1 + s3);
//  - mean = sum * (1 / n), the reciprocal rounded once, as torch.mean's
//    CUDA reduction scales its sum; then + eps and rsqrtf, the rsqrt that
//    torch.rsqrt runs on the card.
// So only the sum's order differs from the plain chain on the card, and
// ops/cuda/norms.py::rms_inv_ordered, a plain version in this order, gives
// the same bits. rmsnorm computes inv exactly as rms_inv does and then
// __fmul_rn(w, __fmul_rn(x, inv)), so w * (x * rms_inv(x)) equals
// rmsnorm(x, w) bit for bit (the fused matmul's "norm" prologue).
//
// Bound: bytes (x read once, w read once, out written once; at qwen3-0.6b's
// decode one row of 1024 values, so the time is the launch). One launch
// replaces the chain's kernels.
//
// Rows: x's leading dimensions as at most two strided levels, [R0, R1] with
// element strides (s0, s1) and the last dimension contiguous, so that the
// q and k heads of a fused qkv output normalize in place as views. out and
// inv are contiguous. A row whose values are not 16-byte (f32) or 8-byte
// (bf16) aligned takes scalar loads: the same chunks, the same order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;     // a block: 4 rows of 32 threads, or 1 of 128
constexpr int kNarrowRow = 1024;  // rows up to this width take one warp

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The 4 values of chunk c of a row (zeros past n, which leave a sum of
// squares unchanged: it is never -0).
template <typename T>
__device__ __forceinline__ void chunk4(const T* row, int c, int n, bool vec,
                                       float (&v)[4]) {
  if (vec) {
    if constexpr (sizeof(T) == 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(row) + c);
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(row) + c);
      v[0] = __uint_as_float(q.x << 16);
      v[1] = __uint_as_float(q.x & 0xffff0000u);
      v[2] = __uint_as_float(q.y << 16);
      v[3] = __uint_as_float(q.y & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = 4 * c + e < n ? to_f32(row[4 * c + e]) : 0.f;
  }
}

__device__ __forceinline__ void store4(float* p, int c, int n, bool vec,
                                       const float (&v)[4]) {
  if (vec) {
    reinterpret_cast<float4*>(p)[c] = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (4 * c + e < n) p[4 * c + e] = v[e];
  }
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, int c, int n,
                                       bool vec, const float (&v)[4]) {
  if (vec) {
    unsigned h[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      h[e] = __bfloat16_as_ushort(__float2bfloat16_rn(v[e]));
    reinterpret_cast<uint2*>(p)[c] =
        make_uint2(h[0] | (h[1] << 16), h[2] | (h[3] << 16));
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (4 * c + e < n) p[4 * c + e] = __float2bfloat16_rn(v[e]);
  }
}

// Row r of the grid: block r / (kThreads / TR), threads TR a row. w non-null
// (NORM) writes out; inv non-null writes the row's factor.
template <int TR, typename T, bool NORM>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ out, float* __restrict__ inv_out, int rows,
               int n, int r1, long long s0, long long s1, int vec, float eps) {
  constexpr int W = TR / 32;   // warps a row
  const int t = threadIdx.x % TR;
  const int r = blockIdx.x * (kThreads / TR) + threadIdx.x / TR;
  if (r >= rows) return;       // a whole row's threads leave together
  const T* row = x + (long long)(r / r1) * s0 + (long long)(r % r1) * s1;
  const int nc = (n + 3) / 4;
  float acc = 0.f;
#pragma unroll 4
  for (int c = t; c < nc; c += TR) {
    float v[4];
    chunk4(row, c, n, vec, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc = __fadd_rn(acc, __fmul_rn(v[e], v[e]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if constexpr (W > 1) {
    static_assert(W == 4, "a wide row takes four warps");
    __shared__ float wsum[W];
    if ((threadIdx.x & 31) == 0) wsum[t >> 5] = acc;
    __syncthreads();
    acc = __fadd_rn(__fadd_rn(wsum[0], wsum[2]), __fadd_rn(wsum[1], wsum[3]));
  }
  const float ms = __fmul_rn(acc, __frcp_rn((float)n));
  const float inv = rsqrtf(__fadd_rn(ms, eps));
  if (inv_out != nullptr && t == 0) inv_out[r] = inv;
  if constexpr (NORM) {
    T* dst = out + (long long)r * n;
    for (int c = t; c < nc; c += TR) {
      float v[4], g[4], o[4];
      chunk4(row, c, n, vec, v);
      chunk4(w, c, n, vec, g);
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = __fmul_rn(g[e], __fmul_rn(v[e], inv));
      store4(dst, c, n, vec, o);
    }
  }
}

template <int TR, typename T>
int launch_rmsnorm(const void* x, const void* w, void* out, void* inv,
                   int rows, int n, int r1, long long s0, long long s1,
                   int vec, float eps, cudaStream_t s) {
  constexpr int per_block = kThreads / TR;   // rows a block
  const unsigned grid = (unsigned)((rows + per_block - 1) / per_block);
  const T* xp = static_cast<const T*>(x);
  const float* wp = static_cast<const float*>(w);
  float* ip = static_cast<float*>(inv);
  if (w != nullptr)
    rmsnorm_kernel<TR, T, true><<<grid, kThreads, 0, s>>>(
        xp, wp, static_cast<T*>(out), ip, rows, n, r1, s0, s1, vec, eps);
  else
    rmsnorm_kernel<TR, T, false><<<grid, kThreads, 0, s>>>(
        xp, nullptr, nullptr, ip, rows, n, r1, s0, s1, vec, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// rows rows of n values of x (f32, or bf16 when bf16 != 0), row r at element
// (r / r1) * s0 + (r % r1) * s1. w (f32 [n]) non-null writes out (x's dtype,
// [rows, n] contiguous) = rmsnorm(x, w); inv non-null writes f32 [rows] =
// rms_inv(x). vec != 0: every row and w 16-byte (f32) or 8-byte (bf16)
// aligned and n % 4 == 0. Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
int rmsnorm(const void* x, const void* w, void* out, void* inv, int rows,
            int n, int r1, long long s0, long long s1, int bf16, int vec,
            float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || n <= 0 || r1 <= 0) return (int)cudaErrorInvalidValue;
  if (n <= kNarrowRow)
    return bf16 ? launch_rmsnorm<32, __nv_bfloat16>(x, w, out, inv, rows, n,
                                                    r1, s0, s1, vec, eps, s)
                : launch_rmsnorm<32, float>(x, w, out, inv, rows, n, r1, s0,
                                            s1, vec, eps, s);
  return bf16 ? launch_rmsnorm<128, __nv_bfloat16>(x, w, out, inv, rows, n, r1,
                                                   s0, s1, vec, eps, s)
              : launch_rmsnorm<128, float>(x, w, out, inv, rows, n, r1, s0, s1,
                                           vec, eps, s);
}

}  // extern "C"
