// Q8_0 x Q8_0 matmul for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the TPU kernels qwen3_tpu/ops/pallas/q8_matmul.py::q8_q8_matmul_stacked
// (every layer matmul: wqkv, wo, w13, w2) and ::q8_q8_matmul_tiled (the
// classifier). Both compute one function:
//
//   out[b, c] = sum over k-tiles t, in order, of
//               acc_t = sum over the tile's groups g, in order, of
//                       f32(int32 sum_{k in g} xq[b, k] * wq[c, k]) * (xs[b, g] * ws[c, g])
//
// with tk = _pick_tile(n, 8 * G, 512) bytes per k-tile (512 on every real
// preset), acc_t starting at 0 and out starting at 0. The group dots are exact
// integers (|dot| <= 64 * 127 * 127 < 2^24), so lanes may split them in any
// order; the fp32 scale-and-sum keeps the order above with explicit
// round-to-nearest intrinsics (no FMA contraction), so the kernel is bit-equal
// to its plain PyTorch version (ops/cuda/q8_matmul.py::q8q8_matmul_plain).
//
// Layout (the checkpoint's own, row-major per output column):
//   xq  int8 [b, n]        xs  f32 [b, n/G]
//   wq  int8 [d, n]        ws  f32 [d, n/G]      (stacked: [L, d, n], [L, d, n/G])
//   out f32  [b, d]
//
// Bound: weight bytes. Each weight costs 1 + 4/G bytes (1.0625 at G = 64) and
// is used b times; decode (b = 1) does 2 operations per weight byte, far below
// the card's ratio, so the time floor is the weight bytes over the memory rate.
// Two kernels, picked by b:
//  - b == 1 (decode, and the classifier's last-position row in prefill): a
//    GEMV that streams each weight byte once per call, one warp per output
//    column; each lane loads 16 contiguous weight bytes per
//    iteration, so one warp-iteration reads a 512-byte run of the column.
//    Lanes of a group combine their __dp4a partial sums by shuffles, and lane
//    0 gathers the group terms in order.
//  - b > 1 (prefill blocks): a block owns a 64-row x 64-column output tile.
//    Per group it stages the tile's activations and weights (up to 64 bytes
//    of k) in shared memory, and each of its 256 threads runs 4 x 4 outputs:
//    __dp4a group dots from shared memory, then the ordered scale-and-sum in
//    registers. Each weight byte is read from device memory once per 64 rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int dot16(const int4 w, const int4 x, int acc) {
  acc = __dp4a(w.x, x.x, acc);
  acc = __dp4a(w.y, x.y, acc);
  acc = __dp4a(w.z, x.z, acc);
  acc = __dp4a(w.w, x.w, acc);
  return acc;
}

// b == 1 path: one warp per output column, 16 bytes per lane per iteration.
// Requires G a power of two in [16, 512] and n % G == 0, so every 512-byte
// chunk holds whole groups and the lanes of a group are aligned.
__global__ void q8q8_gemv_kernel(const int8_t* __restrict__ xq,
                                 const float* __restrict__ xs,
                                 const int8_t* __restrict__ wq,
                                 const float* __restrict__ ws,
                                 float* __restrict__ out, int b, int n, int d,
                                 int G, int gpt) {
  const int c = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= d) return;  // uniform over the warp
  const int ng = n / G;
  const int lpg = G >> 4;     // lanes per group
  const int gpc = 512 / G;    // groups per 512-byte chunk
  const int8_t* wrow = wq + (size_t)c * n;
  const float* wsrow = ws + (size_t)c * ng;
  for (int r = 0; r < b; ++r) {
    const int8_t* xrow = xq + (size_t)r * n;
    const float* xsrow = xs + (size_t)r * ng;
    float acc = 0.f, o = 0.f;
    for (int k0 = 0; k0 < n; k0 += 512) {
      const int k = k0 + lane * 16;
      int dot = 0;
      if (k < n) {
        const int4 w = __ldg(reinterpret_cast<const int4*>(wrow + k));
        const int4 x = __ldg(reinterpret_cast<const int4*>(xrow + k));
        dot = dot16(w, x, 0);
      }
      for (int off = lpg >> 1; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      float term = 0.f;
      if (k < n) {
        const int g = k / G;
        term = __fmul_rn(__int2float_rn(dot), __fmul_rn(xsrow[g], wsrow[g]));
      }
      const int g0 = k0 / G;
      const int here = min(gpc, ng - g0);
      for (int j = 0; j < here; ++j) {
        const float t = __shfl_sync(0xffffffffu, term, j * lpg);
        acc = __fadd_rn(acc, t);
        if ((g0 + j + 1) % gpt == 0) {
          o = __fadd_rn(o, acc);
          acc = 0.f;
        }
      }
    }
    if (lane == 0) out[(size_t)r * d + c] = o;
  }
}

// b > 1 path: one block per 64 x 64 output tile, 256 threads, thread (ty, tx)
// owns rows ty + 16 i and columns tx + 16 j (i, j < 4). k advances one group
// at a time, in chunks of kc = min(G, 64) bytes staged in shared memory (rows
// padded to 17 words, so the column reads of a warp hit distinct banks).
// Requires G a power of two in [16, 512] and n % G == 0.
constexpr int kTile = 64, kMaxChunk = 64, kPadWords = kMaxChunk / 4 + 1;

__global__ void __launch_bounds__(256)
q8q8_tile_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                 const int8_t* __restrict__ wq, const float* __restrict__ ws,
                 float* __restrict__ out, int b, int n, int d, int G,
                 int gpt) {
  __shared__ int x_sm[kTile][kPadWords];
  __shared__ int w_sm[kTile][kPadWords];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int r0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  const int kc = min(G, kMaxChunk);
  const int chunks = G / kc;   // chunks per group
  const int vec = kc / 16;     // int4 loads per row per chunk
  const int ng = n / G;
  float acc[4][4], o[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = o[i][j] = 0.f;

  for (int g = 0; g < ng; ++g) {
    int dot[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dot[i][j] = 0;
    for (int ch = 0; ch < chunks; ++ch) {
      const int k0 = g * G + ch * kc;
      for (int e = tid; e < kTile * vec; e += blockDim.x) {
        const int r = e / vec, v = e % vec;
        int4 xv = make_int4(0, 0, 0, 0), wv = make_int4(0, 0, 0, 0);
        if (r0 + r < b)
          xv = __ldg(reinterpret_cast<const int4*>(xq + (size_t)(r0 + r) * n +
                                                   k0) + v);
        if (c0 + r < d)
          wv = __ldg(reinterpret_cast<const int4*>(wq + (size_t)(c0 + r) * n +
                                                   k0) + v);
        int* xd = &x_sm[r][4 * v];
        int* wd = &w_sm[r][4 * v];
        xd[0] = xv.x; xd[1] = xv.y; xd[2] = xv.z; xd[3] = xv.w;
        wd[0] = wv.x; wd[1] = wv.y; wd[2] = wv.z; wd[3] = wv.w;
      }
      __syncthreads();
      for (int w = 0; w < kc / 4; ++w) {
        int xr[4], wr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xr[i] = x_sm[ty + 16 * i][w];
#pragma unroll
        for (int j = 0; j < 4; ++j) wr[j] = w_sm[tx + 16 * j][w];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dot[i][j] = __dp4a(xr[i], wr[j], dot[i][j]);
      }
      __syncthreads();
    }
    float sx[4], sw[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + ty + 16 * i;
      sx[i] = r < b ? xs[(size_t)r * ng + g] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      sw[j] = c < d ? ws[(size_t)c * ng + g] : 0.f;
    }
    const bool tile_end = (g + 1) % gpt == 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(__int2float_rn(dot[i][j]),
                                                   __fmul_rn(sx[i], sw[j])));
        if (tile_end) {
          o[i][j] = __fadd_rn(o[i][j], acc[i][j]);
          acc[i][j] = 0.f;
        }
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= b) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < d) out[(size_t)r * d + c] = o[i][j];
    }
  }
}

}  // namespace

extern "C" {

// out = q8q8(xq, xs, wq, ws); gpt = groups per k-tile. Launches on `stream`
// and returns cudaGetLastError() as an int (0 = launched).
int q8q8_matmul(const void* xq, const void* xs, const void* wq,
                const void* ws, void* out, int b, int n, int d,
                int group_size, int gpt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xq8 = static_cast<const int8_t*>(xq);
  const float* xsf = static_cast<const float*>(xs);
  const int8_t* wq8 = static_cast<const int8_t*>(wq);
  const float* wsf = static_cast<const float*>(ws);
  float* o = static_cast<float*>(out);
  if (b == 1) {
    const int threads = 256;  // 8 columns per block
    const unsigned blocks = (unsigned)(((size_t)d * 32 + threads - 1) / threads);
    q8q8_gemv_kernel<<<blocks, threads, 0, s>>>(xq8, xsf, wq8, wsf, o, b, n, d,
                                                group_size, gpt);
  } else {
    const dim3 blocks((unsigned)((d + kTile - 1) / kTile),
                      (unsigned)((b + kTile - 1) / kTile));
    q8q8_tile_kernel<<<blocks, 256, 0, s>>>(xq8, xsf, wq8, wsf, o, b, n, d,
                                            group_size, gpt);
  }
  return (int)cudaGetLastError();
}

// The same against layer `layer` of stacked weights [L, d, n] / [L, d, n/G].
int q8q8_matmul_stacked(const void* xq, const void* xs, const void* wq,
                        const void* ws, int layer, void* out, int b, int n,
                        int d, int group_size, int gpt, void* stream) {
  const size_t off = (size_t)layer * (size_t)d * (size_t)n;
  const int8_t* wl = static_cast<const int8_t*>(wq) + off;
  const float* sl = static_cast<const float*>(ws) + off / group_size;
  return q8q8_matmul(xq, xs, wl, sl, out, b, n, d, group_size, gpt, stream);
}

}  // extern "C"
