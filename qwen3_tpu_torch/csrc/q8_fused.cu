// The prologue-fused Q8_0 matmul for Hopper (sm_90a), bound to Python through
// ctypes.
//
// Replaces the TPU kernel qwen3_tpu/ops/pallas/q8_matmul.py::q8_matmul_fused
// (body _kernel_fused), which QWEN3_TPU_FUSE=1 runs for every matmul of modes
// pallas and pallas-fast. Per row the kernel computes the matmul's input h
// from its raw activations:
//
//   prologue "norm":   h[k] = nw[k] * (x[k] * inv)      (inv = rms_inv(x), per row)
//   prologue "swiglu": h[k] = (g * sigmoid(g)) * u,  g = x[k], u = x[n + k]
//                      (the gate and up halves of one [b, 2n] w13 output),
//                      sigmoid(g) = 1 / (1 + expf(-g))
//   prologue "none":   h[k] = x[k]
//
// then either the exact matmul (exact = 1: h quantized per group as
// ops/q8.py::quantize_act does, s = absmax / 127 or 1e-6, q = sign(r) *
// floor(|r| + 0.5) clamped to 127 with r = h / s, then the Q8_0 x Q8_0 group
// dots and the scale-and-sum of csrc/q8_matmul.cu's q8q8 kernels) or the fast
// one (exact = 0: h rounded to bf16 against bf16(f32(wq) * ws), per-group
// sequential fp32 sums, the groups in order, as the q8_fast kernel). Every
// step is the port's unfused chain (rmsnorm / swiglu -> quantize_act or
// round_bf16 -> the q8q8 or fast kernel) in the same fp32 order, with explicit
// round-to-nearest intrinsics: fused and unfused give the same bits, and a
// row's bits do not depend on the other rows of the call. The sigmoid is
// PyTorch's CUDA formula, 1 / (1 + exp(-g)) with expf and a true division;
// this file builds with nvcc's default contraction setting, as PyTorch's own
// kernels do, and spells every other product and sum with an intrinsic.
//
// Layout: x f32 [b, n] ([b, 2n] for swiglu), inv f32 [b], nw f32 [n],
// wq int8 [d, n], ws f32 [d, n / G], out f32 [b, d].
//
// Bound: at decode (b <= 8) the weight bytes over the memory rate; at b = 512
// the operations (int8 or bf16) over their peak. Design: a block owns BM rows
// x 64 columns with 256 threads, as the unfused tile kernels; per chunk of
// kc = min(G, 64) k it computes the prologue for its rows and stages h
// (quantized to int8, or rounded to bf16) beside the weights in shared
// memory. The exact path first takes each row's group absmax (one pass over
// the group's h, a warp or 4 lanes a row), so h is computed twice per group;
// both passes, like the prologue of every column block, read the raw
// activations from L2. The prologue is O(b n) work per 64 columns, small next
// to the weight stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Prologue { kNone = 0, kNorm = 1, kSwiglu = 2 };

constexpr int kCols = 64, kThreads = 256, kMaxChunk = 64;
constexpr int kPadWords = kMaxChunk / 4 + 1;

template <int PRO>
__device__ __forceinline__ float prologue(const float* __restrict__ x,
                                          const float* __restrict__ inv,
                                          const float* __restrict__ nw, int r,
                                          int k, int n) {
  if (PRO == kNorm)
    return __fmul_rn(nw[k], __fmul_rn(x[(size_t)r * n + k], inv[r]));
  if (PRO == kSwiglu) {
    const float g = x[(size_t)r * 2 * n + k];
    const float u = x[(size_t)r * 2 * n + n + k];
    const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-g)));
    return __fmul_rn(__fmul_rn(g, sig), u);
  }
  return x[(size_t)r * n + k];
}

// quantize_act's rounding of one value against its group scale
__device__ __forceinline__ int8_t quantize(float h, float s) {
  const float r = __fdiv_rn(h, s);
  const float m = fminf(floorf(__fadd_rn(fabsf(r), 0.5f)), 127.f);
  return (int8_t)(r < 0.f ? -(int)m : (int)m);
}

template <int BM, int TM, int TN, int PRO>
__global__ void __launch_bounds__(kThreads)
fused_exact_kernel(const float* __restrict__ x, const float* __restrict__ inv,
                   const float* __restrict__ nw, const int8_t* __restrict__ wq,
                   const float* __restrict__ ws, float* __restrict__ out,
                   int b, int n, int d, int G, int gpt) {
  constexpr int TY = BM / TM, TX = kThreads / TY, TPR = kThreads / BM;
  static_assert(TX * TN == kCols, "a block owns 64 columns");
  __shared__ int x_sm[BM][kPadWords];
  __shared__ int w_sm[kCols][kPadWords];
  __shared__ float xs_sm[BM];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int r0 = blockIdx.y * BM, c0 = blockIdx.x * kCols;
  const int kc = min(G, kMaxChunk), chunks = G / kc, vec = kc / 16;
  const int ng = n / G;
  float acc[TM][TN], o[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = o[i][j] = 0.f;

  for (int g = 0; g < ng; ++g) {
    {  // the group's scale per row: TPR lanes of one warp per row
      const int r = tid / TPR, lane = tid % TPR;
      float m = 0.f;
      if (r0 + r < b)
        for (int k = lane; k < G; k += TPR)
          m = fmaxf(m, fabsf(prologue<PRO>(x, inv, nw, r0 + r, g * G + k, n)));
      for (int off = TPR / 2; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (lane == 0) xs_sm[r] = m == 0.f ? 1e-6f : __fdiv_rn(m, 127.f);
    }
    int dot[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) dot[i][j] = 0;
    for (int ch = 0; ch < chunks; ++ch) {
      const int k0 = g * G + ch * kc;
      __syncthreads();  // xs_sm written; the last chunk's tiles read
      for (int e = tid; e < BM * kc; e += kThreads) {
        const int r = e / kc, kk = e % kc;
        int8_t q = 0;
        if (r0 + r < b)
          q = quantize(prologue<PRO>(x, inv, nw, r0 + r, k0 + kk, n), xs_sm[r]);
        reinterpret_cast<int8_t*>(&x_sm[r][0])[kk] = q;
      }
      for (int e = tid; e < kCols * vec; e += kThreads) {
        const int c = e / vec, v = e % vec;
        int4 wv = make_int4(0, 0, 0, 0);
        if (c0 + c < d)
          wv = __ldg(reinterpret_cast<const int4*>(wq + (size_t)(c0 + c) * n +
                                                   k0) + v);
        int* wd = &w_sm[c][4 * v];
        wd[0] = wv.x; wd[1] = wv.y; wd[2] = wv.z; wd[3] = wv.w;
      }
      __syncthreads();
      for (int w = 0; w < kc / 4; ++w) {
        int xr[TM], wr[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) xr[i] = x_sm[ty + TY * i][w];
#pragma unroll
        for (int j = 0; j < TN; ++j) wr[j] = w_sm[tx + TX * j][w];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) dot[i][j] = __dp4a(xr[i], wr[j], dot[i][j]);
      }
    }
    float sx[TM], sw[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) sx[i] = xs_sm[ty + TY * i];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = c0 + tx + TX * j;
      sw[j] = c < d ? ws[(size_t)c * ng + g] : 0.f;
    }
    __syncthreads();  // xs_sm read before the next group's scales
    const bool tile_end = (g + 1) % gpt == 0;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(__int2float_rn(dot[i][j]),
                                                   __fmul_rn(sx[i], sw[j])));
        if (tile_end) {
          o[i][j] = __fadd_rn(o[i][j], acc[i][j]);
          acc[i][j] = 0.f;
        }
      }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + ty + TY * i;
    if (r >= b) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = c0 + tx + TX * j;
      if (c < d) out[(size_t)r * d + c] = o[i][j];
    }
  }
}

template <int BM, int TM, int TN, int PRO>
__global__ void __launch_bounds__(kThreads)
fused_fast_kernel(const float* __restrict__ x, const float* __restrict__ inv,
                  const float* __restrict__ nw, const int8_t* __restrict__ wq,
                  const float* __restrict__ ws, float* __restrict__ out,
                  int b, int n, int d, int G) {
  constexpr int TY = BM / TM, TX = kThreads / TY;
  static_assert(TX * TN == kCols, "a block owns 64 columns");
  __shared__ float x_sm[BM][kMaxChunk + 1];
  __shared__ float w_sm[kCols][kMaxChunk + 1];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int r0 = blockIdx.y * BM, c0 = blockIdx.x * kCols;
  const int kc = min(G, kMaxChunk), chunks = G / kc, wv = kc / 16;
  const int ng = n / G;
  float o[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) o[i][j] = 0.f;

  for (int g = 0; g < ng; ++g) {
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
    for (int ch = 0; ch < chunks; ++ch) {
      const int k0 = g * G + ch * kc;
      for (int e = tid; e < BM * kc; e += kThreads) {
        const int r = e / kc, kk = e % kc;
        float h = 0.f;
        if (r0 + r < b)
          h = __bfloat162float(__float2bfloat16_rn(
              prologue<PRO>(x, inv, nw, r0 + r, k0 + kk, n)));
        x_sm[r][kk] = h;
      }
      for (int e = tid; e < kCols * wv; e += kThreads) {
        const int c = e / wv, v = e % wv;
        int4 raw = make_int4(0, 0, 0, 0);
        float sc = 0.f;
        if (c0 + c < d) {
          raw = __ldg(reinterpret_cast<const int4*>(wq + (size_t)(c0 + c) * n +
                                                    k0) + v);
          sc = ws[(size_t)(c0 + c) * ng + g];
        }
        const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int i = 0; i < 16; ++i)
          w_sm[c][16 * v + i] = __bfloat162float(
              __float2bfloat16_rn(__fmul_rn((float)q[i], sc)));
      }
      __syncthreads();
      for (int kk = 0; kk < kc; ++kk) {
        float xr[TM], wr[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) xr[i] = x_sm[ty + TY * i][kk];
#pragma unroll
        for (int j = 0; j < TN; ++j) wr[j] = w_sm[tx + TX * j][kk];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) s[i][j] = __fmaf_rn(xr[i], wr[j], s[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) o[i][j] = __fadd_rn(o[i][j], s[i][j]);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + ty + TY * i;
    if (r >= b) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = c0 + tx + TX * j;
      if (c < d) out[(size_t)r * d + c] = o[i][j];
    }
  }
}

template <int BM, int TM, int TN, int PRO>
int launch(const float* x, const float* inv, const float* nw,
           const int8_t* wq, const float* ws, float* out, int b, int n, int d,
           int G, int gpt, int exact, cudaStream_t s) {
  const dim3 blocks((unsigned)((d + kCols - 1) / kCols),
                    (unsigned)((b + BM - 1) / BM));
  if (exact)
    fused_exact_kernel<BM, TM, TN, PRO><<<blocks, kThreads, 0, s>>>(
        x, inv, nw, wq, ws, out, b, n, d, G, gpt);
  else
    fused_fast_kernel<BM, TM, TN, PRO><<<blocks, kThreads, 0, s>>>(
        x, inv, nw, wq, ws, out, b, n, d, G);
  return (int)cudaGetLastError();
}

template <int PRO>
int launch_rows(const float* x, const float* inv, const float* nw,
                const int8_t* wq, const float* ws, float* out, int b, int n,
                int d, int G, int gpt, int exact, cudaStream_t s) {
  if (b <= 8)
    return launch<8, 1, 2, PRO>(x, inv, nw, wq, ws, out, b, n, d, G, gpt,
                                exact, s);
  return launch<64, 4, 4, PRO>(x, inv, nw, wq, ws, out, b, n, d, G, gpt,
                               exact, s);
}

}  // namespace

extern "C" {

// out = fused(x, inv, nw, wq, ws): prologue 0 none, 1 norm, 2 swiglu; exact
// 1 (Q8_0 x Q8_0, gpt groups per k-tile) or 0 (bf16). x f32 [b, n] (swiglu:
// [b, 2n]), inv f32 [b] and nw f32 [n] (norm only; otherwise ignored), wq int8
// [d, n], ws f32 [d, n / G], out f32 [b, d]. Launches on `stream` and returns
// cudaGetLastError() (0 = launched; cudaErrorInvalidValue for an unknown
// prologue).
int q8_fused_matmul(const void* x, const void* inv, const void* nw,
                    const void* wq, const void* ws, void* out, int b, int n,
                    int d, int group_size, int gpt, int prologue, int exact,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* invf = static_cast<const float*>(inv);
  const float* nwf = static_cast<const float*>(nw);
  const int8_t* wq8 = static_cast<const int8_t*>(wq);
  const float* wsf = static_cast<const float*>(ws);
  float* o = static_cast<float*>(out);
  switch (prologue) {
    case kNone:
      return launch_rows<kNone>(xf, invf, nwf, wq8, wsf, o, b, n, d,
                                group_size, gpt, exact, s);
    case kNorm:
      return launch_rows<kNorm>(xf, invf, nwf, wq8, wsf, o, b, n, d,
                                group_size, gpt, exact, s);
    case kSwiglu:
      return launch_rows<kSwiglu>(xf, invf, nwf, wq8, wsf, o, b, n, d,
                                  group_size, gpt, exact, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
