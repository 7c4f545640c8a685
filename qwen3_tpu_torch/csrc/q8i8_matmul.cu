// The pallas-int8 mode's matmul for Hopper (sm_90a), bound to Python through
// ctypes.
//
// Replaces the TPU kernels qwen3_tpu/ops/pallas/q8_matmul.py::
// q8i8_matmul_stacked (every layer matmul) and ::q8i8_matmul_tiled (the
// classifier), whose body is _kernel_q8i8. With tk = _pick_tile(n, 8 * G, 512)
// (512 at every qwen3 width; the whole axis when no multiple of 8 * G up to
// 512 divides n) and nt = n / tk k-tiles, both compute
//
//   s8[t, c]   = max over the tile's groups g of ws[c, g]
//   w8[c, k]   = sign(wf) * floor(|wf| + 0.5),  wf = f32(wq[c, k]) * (ws[c, g] / s8[t, c])
//   out[b, c]  = sum over k-tiles t, in order from 0, of
//                f32(int32 sum_{k in t} xq[b, k] * w8[c, k]) * (xs[b, t] * s8[t, c])
//
// where xq/xs are the activations quantized per (row, k-tile) (quantize_act
// at group tk, done by the wrapper). The weight tile is requantized to one
// int8 scale per (k-tile, column) inside the kernel, as the TPU kernel does in
// VMEM; no second int8 copy of the weights exists. The ratio is a true IEEE
// division, every product and sum rounds as written (__fmul_rn, __fadd_rn),
// and the int32 dot is exact (|dot| <= 512 * 127^2 < 2^24, so its conversion
// to f32 is exact too): the kernel is bit-equal to its plain version,
// ops/cuda/q8_matmul.py::q8i8_matmul_plain, and a row's bits do not depend on
// the other rows of the call.
//
// Layout (the checkpoint's own, row-major per output column):
//   xq int8 [b, n]    xs f32 [b, n / tk]
//   wq int8 [d, n]    ws f32 [d, n / G]   (stacked: [L, d, n], [L, d, n / G])
//   out f32 [b, d]
//
// Bound: at decode (b <= 8) the weight bytes (1 + 4 / G bytes a weight) over
// the memory rate; at b = 512 the int8 operations over the int8 peak. Design:
// a block owns BM rows x 64 columns with 256 threads. Per k-tile it first
// takes the 64 columns' s8; then, per 64-byte chunk of k, it stages the
// activations [BM][64] and the requantized weights [64][64] as int8 in shared
// memory (rows padded to 17 words so a warp's column reads hit distinct
// banks), and each thread runs TM x TN __dp4a dot chains (BM = 8: row ty,
// columns tx and tx + 32; BM = 64: rows ty + 16 i, columns tx + 16 j). The
// requantization costs one division per 16 weights and a few operations per
// weight, once per BM rows. Each weight byte is read once per BM rows. No
// tensor cores yet (an int8 mma.sync would give the same bits: the dot is
// exact in any order).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 64, kThreads = 256, kChunk = 64, kPad = kChunk / 4 + 1;

__device__ __forceinline__ int8_t requant(int8_t q, float ratio) {
  const float wf = __fmul_rn((float)q, ratio);
  const int m = (int)floorf(__fadd_rn(fabsf(wf), 0.5f));
  return (int8_t)(wf < 0.f ? -m : m);
}

template <int BM, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
q8i8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
            const int8_t* __restrict__ wq, const float* __restrict__ ws,
            float* __restrict__ out, int b, int n, int d, int G, int tk) {
  constexpr int TY = BM / TM, TX = kThreads / TY;
  static_assert(TX * TN == kCols, "a block owns 64 columns");
  __shared__ int x_sm[BM][kPad];
  __shared__ int w_sm[kCols][kPad];
  __shared__ float s8_sm[kCols];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int r0 = blockIdx.y * BM, c0 = blockIdx.x * kCols;
  const int ng = n / G, gpt = tk / G, nt = n / tk;
  float o[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) o[i][j] = 0.f;

  for (int t = 0; t < nt; ++t) {
    __syncthreads();  // the last tile's s8 has been read
    if (tid < kCols) {
      float m = 0.f;
      if (c0 + tid < d) {
        const float* srow = ws + (size_t)(c0 + tid) * ng + (size_t)t * gpt;
        m = srow[0];
        for (int g = 1; g < gpt; ++g) m = fmaxf(m, srow[g]);
      }
      s8_sm[tid] = m;
    }
    __syncthreads();
    int dot[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) dot[i][j] = 0;
    for (int k0 = t * tk; k0 < (t + 1) * tk; k0 += kChunk) {
      for (int e = tid; e < BM * 4; e += kThreads) {
        const int r = e / 4, v = e % 4;
        int4 xv = make_int4(0, 0, 0, 0);
        if (r0 + r < b)
          xv = __ldg(reinterpret_cast<const int4*>(xq + (size_t)(r0 + r) * n +
                                                   k0) + v);
        int* xd = &x_sm[r][4 * v];
        xd[0] = xv.x; xd[1] = xv.y; xd[2] = xv.z; xd[3] = xv.w;
      }
      for (int e = tid; e < kCols * 4; e += kThreads) {
        const int c = e / 4, v = e % 4;
        int4 packed = make_int4(0, 0, 0, 0);
        if (c0 + c < d) {
          const int k = k0 + 16 * v;
          const int4 raw = __ldg(reinterpret_cast<const int4*>(
              wq + (size_t)(c0 + c) * n + k));
          const float ratio =
              __fdiv_rn(ws[(size_t)(c0 + c) * ng + k / G], s8_sm[c]);
          const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
          int8_t* w8 = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
          for (int i = 0; i < 16; ++i) w8[i] = requant(q[i], ratio);
        }
        int* wd = &w_sm[c][4 * v];
        wd[0] = packed.x; wd[1] = packed.y; wd[2] = packed.z; wd[3] = packed.w;
      }
      __syncthreads();
#pragma unroll
      for (int w = 0; w < kChunk / 4; ++w) {
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
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = r0 + ty + TY * i;
      const float sx = r < b ? xs[(size_t)r * nt + t] : 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float s8 = s8_sm[tx + TX * j];
        o[i][j] = __fadd_rn(o[i][j], __fmul_rn(__int2float_rn(dot[i][j]),
                                               __fmul_rn(sx, s8)));
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

template <int BM, int TM, int TN>
int launch(const void* xq, const void* xs, const void* wq, const void* ws,
           void* out, int b, int n, int d, int G, int tk, cudaStream_t s) {
  const dim3 blocks((unsigned)((d + kCols - 1) / kCols),
                    (unsigned)((b + BM - 1) / BM));
  q8i8_kernel<BM, TM, TN><<<blocks, kThreads, 0, s>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const int8_t*>(wq), static_cast<const float*>(ws),
      static_cast<float*>(out), b, n, d, G, tk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out = q8i8(xq, xs, wq, ws): xq int8 [b, n] and xs f32 [b, n / tk] (the
// activations quantized per (row, k-tile)), wq int8 [d, n], ws f32 [d, n / G],
// out f32 [b, d]; tk divides n and is a multiple of 64 and of G. Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
int q8i8_matmul(const void* xq, const void* xs, const void* wq,
                const void* ws, void* out, int b, int n, int d,
                int group_size, int tk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 8)
    return launch<8, 1, 2>(xq, xs, wq, ws, out, b, n, d, group_size, tk, s);
  return launch<64, 4, 4>(xq, xs, wq, ws, out, b, n, d, group_size, tk, s);
}

// The same against layer `layer` of stacked weights [L, d, n] / [L, d, n/G].
int q8i8_matmul_stacked(const void* xq, const void* xs, const void* wq,
                        const void* ws, int layer, void* out, int b, int n,
                        int d, int group_size, int tk, void* stream) {
  const size_t off = (size_t)layer * (size_t)d * (size_t)n;
  const int8_t* wl = static_cast<const int8_t*>(wq) + off;
  const float* sl = static_cast<const float*>(ws) + off / group_size;
  return q8i8_matmul(xq, xs, wl, sl, out, b, n, d, group_size, tk, stream);
}

}  // extern "C"
