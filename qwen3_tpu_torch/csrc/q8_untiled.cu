// Untiled Q8_0 matmuls on contraction-leading weights for Hopper (sm_90a),
// bound to Python through ctypes.
//
// Replaces two TPU kernels of qwen3_tpu/ops/pallas/q8_matmul.py that take the
// weights as w_q int8 [n, d], w_s f32 [n/G, d] (the contraction leading, not
// the port's row-major [d, n]):
//
//  - q8_q8_matmul_pallas (body _kernel_q8q8): int8 activations xq [b, n] with
//    f32 group scales xs [b, n/G];
//      out[r, c] = sum over k-tiles t, in order, of
//                  acc_t = sum over the tile's groups g, in order, of
//                          f32(int32 sum_{k in g} xq[r, k] * wq[k, c]) * (xs[r, g] * ws[g, c])
//    acc_t and out start at 0. The group dots are exact integers, so lanes
//    may split them in any order; the scale-and-sum rounds every product and
//    every sum as written (intrinsics, -fmad=false), so the kernel is
//    bit-equal to ops/cuda/q8_matmul.py::q8_q8_matmul_pallas_plain.
//  - q8_matmul_pallas (body _kernel): activations x [b, n] (f32; bf16 values
//    arrive widened to f32) times the dequantized weights in compute type
//    f32 (true fp32, no TF32) or bf16, summed in fp32:
//      prescale:  w = cd(f32(wq) * ws), out = sum over tiles t of dot_t(cd(x), w)
//      postscale: out = sum over tiles t of sum over the tile's groups g of
//                       dot_g(cd(x), cd(wq)) * ws[g, c]
//    where cd rounds to the compute type. Each dot is a sequential fmaf chain
//    in k order; XLA's (and the plain version's torch.matmul) sum in another
//    order, so this one is held to a tolerance (chip_smoke.py and
//    tests/test_torch_cuda.py state it). With bf16 the products of two bf16
//    values are exact in fp32.
//
// k-tiles: tk = _pick_tile(n, 8 * G, block_k), the TPU kernel's, picked by the
// wrapper and passed as gpt = tk / G groups a tile. Columns are independent,
// so the TPU's column tile (block_d) changes no number and has no role here.
//
// Bound: weight bytes at small b (each weight costs 1 + 4/G bytes and is used
// b times), operations at large b. Two designs:
//  - b > 8 (and q8_q8_matmul_pallas at every b): a tile kernel. A block owns
//    BM rows x 64 columns with 256 threads, BM = 8 for b <= 8 (thread (ty,
//    tx) owns row ty and columns tx, tx + 32) and 64 above (rows ty + 16 i,
//    columns tx + 16 j, i, j < 4), and walks k in chunks of kc = min(G, 64)
//    staged in shared memory. The weight chunk [kc, 64] is read along d (a
//    warp reads 128 contiguous bytes of a weight row); the int8 kernel
//    transposes each 4 x 4 byte block with __byte_perm so that one word
//    holds 4 consecutive k of one column for __dp4a. Each row's arithmetic
//    is the same at any BM, so a row's bits do not depend on its
//    batch-mates. When the row and column blocks alone would not fill the
//    card (small b, narrow d), the k-tiles also split across blocks: block
//    z computes acc_z into part[z], and a second kernel sums the tiles in
//    order (out = ((0 + acc_0) + acc_1) + ...), the same sums as one block
//    walking every tile.
//  - q8_matmul_pallas at b <= 8 (decode): q8_untiled_gemv_kernel. The tile
//    kernel's first design here (8 rows a block, 7 of them zeros at b = 1,
//    one 4-byte weight load a thread a k-row, two barriers a chunk and no
//    load in flight) took 3.74 ms a token's 113 matrices where F.linear
//    takes 1.14 and the bytes 0.19 (qwen3-0.6b in f32 prescale, an NVIDIA
//    H100 80GB HBM3 at 700 W, chip_smoke.py). The function fixes each (row,
//    column)'s sum over a k-tile as one fmaf chain in k order, so the
//    parallelism is d x (k-tiles) chains, each 512 long: a lane owns one
//    column (32 columns a warp, a k-row's 32 contiguous bytes) and its R =
//    b (rounded up to 1, 2, 4 or 8) rows' chains, and the warps of a block
//    take the k-tiles of its 32 columns (warp w: tiles w, w + warps, ...),
//    so wo and w2 run 4-6 warps on each of 32 blocks and the classifier 2
//    on each of 4748. Each warp streams its tiles through its own cp.async
//    ring of kUgRing stages of 128 k-rows (64 at b > 2; the weights, the
//    rows' activations and the stage's group scales, 16-byte copies) with
//    kUgRing - 1 stages in flight before any FMA, waits on its own copies
//    and a __syncwarp, so no barrier couples the warps; an int8 weight
//    becomes f32 by one integer add and one exact fadd. The tiles' sums
//    land in shared memory and are added in tile order after one barrier:
//    the tile kernel's arithmetic, the same bits at any b.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_attr.cuh"

namespace {

constexpr int kCols = 64, kThreads = 256, kMaxChunk = 64;
constexpr int kPadWords = kMaxChunk / 4 + 1;

// rows a[i] hold columns 0..3 of k-row i; word j of the result holds k-rows
// 0..3 of column j
__device__ __forceinline__ void transpose4x4(const int a[4], int c[4]) {
  const int t0 = __byte_perm(a[0], a[1], 0x5140);
  const int t1 = __byte_perm(a[0], a[1], 0x7362);
  const int t2 = __byte_perm(a[2], a[3], 0x5140);
  const int t3 = __byte_perm(a[2], a[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// Requires G a power of two in [16, 512], n % G == 0, d % 4 == 0.
template <int BM, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
q8q8_untiled_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                    const int8_t* __restrict__ wq,
                    const float* __restrict__ ws, float* __restrict__ out,
                    int b, int n, int d, int G, int gpt, int split) {
  constexpr int TY = BM / TM, TX = kThreads / TY;
  static_assert(TX * TN == kCols, "a block owns 64 columns");
  __shared__ int x_sm[BM][kPadWords];
  __shared__ int w_sm[kCols][kPadWords];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int r0 = blockIdx.y * BM, c0 = blockIdx.x * kCols;
  const int kc = min(G, kMaxChunk);
  const int chunks = G / kc;   // chunks per group
  const int xv = kc / 16;      // int4 loads per activation row per chunk
  const int ng = n / G;
  const int t_begin = split ? (int)blockIdx.z : 0;
  const int t_end = split ? t_begin + 1 : ng / gpt;
  float o[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) o[i][j] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    for (int gi = 0; gi < gpt; ++gi) {
      const int g = t * gpt + gi;
      int dot[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) dot[i][j] = 0;
      for (int ch = 0; ch < chunks; ++ch) {
        const int k0 = g * G + ch * kc;
        for (int e = tid; e < BM * xv; e += kThreads) {
          const int r = e / xv, v = e % xv;
          int4 xw = make_int4(0, 0, 0, 0);
          if (r0 + r < b)
            xw = __ldg(reinterpret_cast<const int4*>(xq + (size_t)(r0 + r) * n +
                                                     k0) + v);
          int* xd = &x_sm[r][4 * v];
          xd[0] = xw.x; xd[1] = xw.y; xd[2] = xw.z; xd[3] = xw.w;
        }
        // item (kq, cq): k-rows k0 + 4 kq .. + 3 of columns c0 + 4 cq .. + 3
        for (int e = tid; e < (kc / 4) * (kCols / 4); e += kThreads) {
          const int kq = e / (kCols / 4), cq = e % (kCols / 4);
          const int c = c0 + 4 * cq;
          int a[4] = {0, 0, 0, 0}, cw[4];
          if (c < d) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              a[i] = __ldg(reinterpret_cast<const int*>(
                  wq + (size_t)(k0 + 4 * kq + i) * d + c));
          }
          transpose4x4(a, cw);
#pragma unroll
          for (int j = 0; j < 4; ++j) w_sm[4 * cq + j][kq] = cw[j];
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
            for (int j = 0; j < TN; ++j)
              dot[i][j] = __dp4a(xr[i], wr[j], dot[i][j]);
        }
        __syncthreads();
      }
      float sx[TM], sw[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = r0 + ty + TY * i;
        sx[i] = r < b ? xs[(size_t)r * ng + g] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = c0 + tx + TX * j;
        sw[j] = c < d ? ws[(size_t)g * d + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = __fadd_rn(acc[i][j],
                                __fmul_rn(__int2float_rn(dot[i][j]),
                                          __fmul_rn(sx[i], sw[j])));
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) o[i][j] = __fadd_rn(o[i][j], acc[i][j]);
  }
  float* dst = out + (split ? (size_t)t_begin * b * d : 0);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + ty + TY * i;
    if (r >= b) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = c0 + tx + TX * j;
      if (c < d) dst[(size_t)r * d + c] = o[i][j];
    }
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Requires G a power of two in [16, 512], n % G == 0, d % 4 == 0.
template <int BM, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
q8_untiled_kernel(const float* __restrict__ x, const int8_t* __restrict__ wq,
                  const float* __restrict__ ws, float* __restrict__ out, int b,
                  int n, int d, int G, int gpt, int bf16, int postscale,
                  int split) {
  constexpr int TY = BM / TM, TX = kThreads / TY;
  static_assert(TX * TN == kCols, "a block owns 64 columns");
  __shared__ float x_sm[BM][kMaxChunk + 1];
  __shared__ float w_sm[kMaxChunk][kCols + 1];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int r0 = blockIdx.y * BM, c0 = blockIdx.x * kCols;
  const int kc = min(G, kMaxChunk);
  const int chunks = G / kc;
  const int xv = kc / 4;       // float4 loads per activation row per chunk
  const int ng = n / G;
  const int t_begin = split ? (int)blockIdx.z : 0;
  const int t_end = split ? t_begin + 1 : ng / gpt;
  float o[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) o[i][j] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    for (int gi = 0; gi < gpt; ++gi) {
      const int g = t * gpt + gi;
      float s[TM][TN];   // postscale: the group's dot
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
      for (int ch = 0; ch < chunks; ++ch) {
        const int k0 = g * G + ch * kc;
        for (int e = tid; e < BM * xv; e += kThreads) {
          const int r = e / xv, v = e % xv;
          float4 xw = make_float4(0.f, 0.f, 0.f, 0.f);
          if (r0 + r < b)
            xw = __ldg(reinterpret_cast<const float4*>(x + (size_t)(r0 + r) * n +
                                                       k0) + v);
          if (bf16) {
            xw.x = round_bf16(xw.x); xw.y = round_bf16(xw.y);
            xw.z = round_bf16(xw.z); xw.w = round_bf16(xw.w);
          }
          float* xd = &x_sm[r][4 * v];
          xd[0] = xw.x; xd[1] = xw.y; xd[2] = xw.z; xd[3] = xw.w;
        }
        // item (kr, cq): k-row k0 + kr, columns c0 + 4 cq .. + 3
        for (int e = tid; e < kc * (kCols / 4); e += kThreads) {
          const int kr = e / (kCols / 4), cq = e % (kCols / 4);
          const int c = c0 + 4 * cq;
          float wv[4] = {0.f, 0.f, 0.f, 0.f};
          if (c < d) {
            const char4 q = __ldg(reinterpret_cast<const char4*>(
                wq + (size_t)(k0 + kr) * d + c));
            wv[0] = (float)q.x; wv[1] = (float)q.y;
            wv[2] = (float)q.z; wv[3] = (float)q.w;
            if (!postscale) {
              const float4 sc = __ldg(reinterpret_cast<const float4*>(
                  ws + (size_t)g * d + c));
              wv[0] = __fmul_rn(wv[0], sc.x); wv[1] = __fmul_rn(wv[1], sc.y);
              wv[2] = __fmul_rn(wv[2], sc.z); wv[3] = __fmul_rn(wv[3], sc.w);
              if (bf16) {
#pragma unroll
                for (int j = 0; j < 4; ++j) wv[j] = round_bf16(wv[j]);
              }
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) w_sm[kr][4 * cq + j] = wv[j];
        }
        __syncthreads();
        for (int kk = 0; kk < kc; ++kk) {
          float xr[TM], wr[TN];
#pragma unroll
          for (int i = 0; i < TM; ++i) xr[i] = x_sm[ty + TY * i][kk];
#pragma unroll
          for (int j = 0; j < TN; ++j) wr[j] = w_sm[kk][tx + TX * j];
          if (postscale) {
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
              for (int j = 0; j < TN; ++j) s[i][j] = fmaf(xr[i], wr[j], s[i][j]);
          } else {
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
              for (int j = 0; j < TN; ++j)
                acc[i][j] = fmaf(xr[i], wr[j], acc[i][j]);
          }
        }
        __syncthreads();
      }
      if (postscale) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int c = c0 + tx + TX * j;
          const float sc = c < d ? ws[(size_t)g * d + c] : 0.f;
#pragma unroll
          for (int i = 0; i < TM; ++i)
            acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(s[i][j], sc));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) o[i][j] = __fadd_rn(o[i][j], acc[i][j]);
  }
  float* dst = out + (split ? (size_t)t_begin * b * d : 0);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + ty + TY * i;
    if (r >= b) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = c0 + tx + TX * j;
      if (c < d) dst[(size_t)r * d + c] = o[i][j];
    }
  }
}

// out[i] = ((0 + part[0][i]) + part[1][i]) + ... over nt tiles, in order
__global__ void sum_tiles_kernel(const float* __restrict__ part,
                                 float* __restrict__ out, int nt,
                                 size_t count) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float o = 0.f;
  for (int t = 0; t < nt; ++t) o = __fadd_rn(o, part[(size_t)t * count + i]);
  out[i] = o;
}

// grid of (column blocks, row blocks, k-tiles when split); `part` non-null
// splits the tiles across blocks and sums them into `out` after
dim3 grid_of(int b, int d, int bm, int nt, bool split) {
  return dim3((unsigned)((d + kCols - 1) / kCols), (unsigned)((b + bm - 1) / bm),
              split ? (unsigned)nt : 1u);
}

int sum_tiles(const float* part, float* out, int nt, size_t count,
              cudaStream_t s) {
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  sum_tiles_kernel<<<(unsigned)((count + 255) / 256), 256, 0, s>>>(part, out,
                                                                   nt, count);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- the GEMV, b <= 8 ----

__device__ __forceinline__ void ug_copy16(unsigned dst, const void* src,
                                          bool on) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(on ? 16 : 0));
}

__device__ __forceinline__ void ug_copy4(unsigned dst, const void* src,
                                         bool on) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(on ? 4 : 0));
}

__device__ __forceinline__ void ug_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void ug_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A stage: K = ug_k(R) k-rows of the warp's 32 columns (32 bytes a row),
// the R rows' activations over those k ([R][K] f32), and the scales of the
// stage's groups (up to K / 16 rows of 32 f32); kUgRing = 4 stages a warp.
// Fewer, longer stages wait less (128 rows at b <= 2, where the
// activations are few; 64 above).
constexpr int kUgRing = 4, kUgMaxWarps = 8;

__host__ __device__ constexpr int ug_k(int R) { return R <= 2 ? 128 : 64; }
__host__ __device__ constexpr int ug_stage_bytes(int R) {
  return ug_k(R) * 32 + R * ug_k(R) * 4 + (ug_k(R) / 16) * 32 * 4;
}

// Four k-steps of a lane's R chains from a landed stage: k0 + kk .. + 3,
// the group's scale taken where a group starts, the postscaled group sums
// added where one ends.
template <int R, int K, bool BF16, bool POST>
__device__ __forceinline__ void ug_step4(const int8_t* wst, const float* xst,
                                         const float* sst, int k0, int kk,
                                         int G, int lg, int lane, float& sc,
                                         float (&acc)[R], float (&sg)[R]) {
  const int k = k0 + kk;
  if ((k & (G - 1)) == 0)   // a group starts: its scale
    sc = sst[32 * ((k >> lg) - (k0 >> lg)) + lane];
  float4 xv[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    xv[r] = *reinterpret_cast<const float4*>(xst + r * K + kk);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int qv = wst[(kk + e) * 32 + lane];
    const float f = __fadd_rn(__int_as_float(0x4B400000 + qv), -12582912.f);
    const float w = POST ? f : BF16 ? round_bf16(__fmul_rn(f, sc))
                                    : __fmul_rn(f, sc);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float xe = e == 0 ? xv[r].x : e == 1 ? xv[r].y
                     : e == 2 ? xv[r].z : xv[r].w;
      if (POST)
        sg[r] = fmaf(xe, w, sg[r]);
      else
        acc[r] = fmaf(xe, w, acc[r]);
    }
  }
  if (POST && ((k + 4) & (G - 1)) == 0) {   // a group ends
#pragma unroll
    for (int r = 0; r < R; ++r) {
      acc[r] = __fadd_rn(acc[r], __fmul_rn(sg[r], sc));
      sg[r] = 0.f;
    }
  }
}

// Requires b <= R, G a power of two in [16, 512], n % G == 0, d % 4 == 0,
// tk a multiple of G and of 16. Block: nw = min(nt, kUgMaxWarps) warps over
// columns 32 blockIdx.x + lane.
template <int R, bool BF16, bool POST>
__global__ void __launch_bounds__(32 * kUgMaxWarps, 1)
q8_untiled_gemv_kernel(const float* __restrict__ x,
                       const int8_t* __restrict__ wq,
                       const float* __restrict__ ws, float* __restrict__ out,
                       int b, int n, int d, int G, int tk, int nt) {
  constexpr int S = kUgRing, K = ug_k(R), SB = ug_stage_bytes(R);
  constexpr int WB = K * 32, XB = R * K * 4;
  extern __shared__ int4 ug_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  char* ring = reinterpret_cast<char*>(ug_smem) + (size_t)warp * S * SB;
  // the k-tiles' sums, [nt][R][32]
  float* tsum = reinterpret_cast<float*>(reinterpret_cast<char*>(ug_smem) +
                                         (size_t)nw * S * SB);
  const unsigned ring_s = (unsigned)__cvta_generic_to_shared(ring);
  const int c0 = blockIdx.x * 32, col = c0 + lane;
  const bool vec16 = (d & 15) == 0;   // a k-row's 32 bytes in 16-byte copies
  const int lg = 31 - __clz(G), ng = n / G;
  const int nsl = G < K ? K / G : 1;   // groups a stage
  const int nsk = (tk + K - 1) / K;    // stages a k-tile
  const int mine = warp < nt ? (nt - warp + nw - 1) / nw : 0;
  const int total = mine * nsk;              // this warp's stages

  auto load = [&](int q) {   // called for q = 0, 1, 2, ... in order
    if (q < total) {
      const int sub = q % nsk, t = warp + nw * (q / nsk);
      const int k0 = t * tk + sub * K, rows = min(K, tk - sub * K);
      const unsigned base = ring_s + (q % S) * SB;
      if (vec16) {
#pragma unroll
        for (int i = 0; i < WB / 16 / 32; ++i) {
          const int e = lane + 32 * i, r = e >> 1, h = e & 1;
          const bool on = r < rows && c0 + 16 * h < d;
          ug_copy16(base + 16 * e,
                    on ? (const void*)(wq + (size_t)(k0 + r) * d + c0 + 16 * h)
                       : (const void*)wq,
                    on);
        }
      } else {
#pragma unroll
        for (int i = 0; i < WB / 4 / 32; ++i) {
          const int e = lane + 32 * i, r = e >> 3, wd = e & 7;
          const bool on = r < rows && c0 + 4 * wd < d;
          ug_copy4(base + 4 * e,
                   on ? (const void*)(wq + (size_t)(k0 + r) * d + c0 + 4 * wd)
                      : (const void*)wq,
                   on);
        }
      }
#pragma unroll
      for (int i = 0; i < (R * K / 4 + 31) / 32; ++i) {
        const int e = lane + 32 * i, r = e / (K / 4), p = e % (K / 4);
        if (e < R * K / 4) {
          const bool on = r < b && 4 * p < rows;
          ug_copy16(base + WB + 16 * e,
                    on ? (const void*)(x + (size_t)r * n + k0 + 4 * p)
                       : (const void*)x,
                    on);
        }
      }
      // the stage's group scales, 16 bytes a copy
      for (int e = lane; e < 8 * nsl; e += 32) {
        const int j = e >> 3, p = e & 7, g = (k0 >> lg) + j;
        const bool on = (j << lg) < rows && g < ng && c0 + 4 * p < d;
        ug_copy16(base + WB + XB + 16 * e,
                  on ? (const void*)(ws + (size_t)g * d + c0 + 4 * p)
                     : (const void*)ws,
                  on);
      }
    }
    ug_commit();
  };

  float acc[R], sg[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = sg[r] = 0.f;
  float sc = 0.f;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) load(s);
  for (int q = 0; q < total; ++q) {
    ug_wait<S - 2>();   // this lane's copies of stage q have landed
    char* st = ring + (q % S) * SB;
    float* xst = reinterpret_cast<float*>(st + WB);
    if (BF16) {   // round the activations this lane copied, in place
#pragma unroll
      for (int i = 0; i < (R * K / 4 + 31) / 32; ++i) {
        const int e = lane + 32 * i;
        if (e < R * K / 4) {
          float4 v = *reinterpret_cast<float4*>(xst + 4 * e);
          v.x = round_bf16(v.x); v.y = round_bf16(v.y);
          v.z = round_bf16(v.z); v.w = round_bf16(v.w);
          *reinterpret_cast<float4*>(xst + 4 * e) = v;
        }
      }
    }
    __syncwarp();   // every lane's copies visible; slot q - 1 is free again
    load(q + S - 1);
    const int sub = q % nsk, t = warp + nw * (q / nsk);
    const int k0 = t * tk + sub * K, rows = min(K, tk - sub * K);
    const int8_t* wst = reinterpret_cast<const int8_t*>(st);
    const float* sst = reinterpret_cast<const float*>(st + WB + XB);
    // a full stage unrolled, so its shared loads issue ahead of the chain
    if (rows == K) {
#pragma unroll
      for (int kk = 0; kk < K; kk += 4)
        ug_step4<R, K, BF16, POST>(wst, xst, sst, k0, kk, G, lg, lane, sc, acc,
                                sg);
    } else {
      for (int kk = 0; kk < rows; kk += 4)
        ug_step4<R, K, BF16, POST>(wst, xst, sst, k0, kk, G, lg, lane, sc, acc,
                                sg);
    }
    if (sub == nsk - 1) {   // the k-tile's end
#pragma unroll
      for (int r = 0; r < R; ++r) {
        tsum[((size_t)t * R + r) * 32 + lane] = acc[r];
        acc[r] = 0.f;
      }
    }
  }
  ug_wait<0>();
  __syncthreads();
  // out = ((0 + tile 0) + tile 1) + ..., in tile order
  for (int e = threadIdx.x; e < R * 32; e += blockDim.x) {
    const int r = e >> 5, l = e & 31;
    float o = 0.f;
    for (int t = 0; t < nt; ++t) o = __fadd_rn(o, tsum[((size_t)t * R + r) * 32 + l]);
    if (r < b && c0 + l < d) out[(size_t)r * d + c0 + l] = o;
  }
}

template <int R, bool BF16, bool POST>
int launch_untiled_gemv(const float* x, const int8_t* wq, const float* ws,
                        float* out, int b, int n, int d, int G, int gpt,
                        cudaStream_t s) {
  static size_t set[16] = {};
  const int tk = gpt * G, nt = n / tk;
  const int nw = min(nt, kUgMaxWarps);
  const size_t smem = (size_t)nw * kUgRing * ug_stage_bytes(R) +
                      sizeof(float) * (size_t)nt * R * 32;
  auto kernel = q8_untiled_gemv_kernel<R, BF16, POST>;
  const int err = allow_smem(kernel, smem, set);
  if (err) return err;
  kernel<<<(unsigned)((d + 31) / 32), 32 * nw, smem, s>>>(x, wq, ws, out, b, n,
                                                          d, G, tk, nt);
  return (int)cudaGetLastError();
}

template <bool BF16, bool POST>
int untiled_gemv_rows(const float* x, const int8_t* wq, const float* ws,
                      float* out, int b, int n, int d, int G, int gpt,
                      cudaStream_t s) {
  if (b <= 1)
    return launch_untiled_gemv<1, BF16, POST>(x, wq, ws, out, b, n, d, G, gpt,
                                              s);
  if (b <= 2)
    return launch_untiled_gemv<2, BF16, POST>(x, wq, ws, out, b, n, d, G, gpt,
                                              s);
  if (b <= 4)
    return launch_untiled_gemv<4, BF16, POST>(x, wq, ws, out, b, n, d, G, gpt,
                                              s);
  if (b <= 8)
    return launch_untiled_gemv<8, BF16, POST>(x, wq, ws, out, b, n, d, G, gpt,
                                              s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// out = q8_q8_matmul_pallas(xq, xs, wq, ws): xq int8 [b, n], xs f32 [b, n/G],
// wq int8 [n, d], ws f32 [n/G, d], out f32 [b, d]; gpt groups a k-tile.
// part: null, or f32 [n / (gpt G), b, d] scratch to split the k-tiles over
// blocks. Launches on `stream` and returns cudaGetLastError() (0 = launched).
int q8q8_untiled(const void* xq, const void* xs, const void* wq,
                 const void* ws, void* out, void* part, int b, int n, int d,
                 int group_size, int gpt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nt = n / group_size / gpt;
  const bool split = part != nullptr;
  float* dst = static_cast<float*>(split ? part : out);
  const int8_t* x8 = static_cast<const int8_t*>(xq);
  const float* xsf = static_cast<const float*>(xs);
  const int8_t* w8 = static_cast<const int8_t*>(wq);
  const float* wsf = static_cast<const float*>(ws);
  if (b <= 8)
    q8q8_untiled_kernel<8, 1, 2><<<grid_of(b, d, 8, nt, split), kThreads, 0, s>>>(
        x8, xsf, w8, wsf, dst, b, n, d, group_size, gpt, (int)split);
  else
    q8q8_untiled_kernel<64, 4, 4><<<grid_of(b, d, 64, nt, split), kThreads, 0,
                                    s>>>(x8, xsf, w8, wsf, dst, b, n, d,
                                         group_size, gpt, (int)split);
  if (!split) return (int)cudaGetLastError();
  return sum_tiles(dst, static_cast<float*>(out), nt, (size_t)b * d, s);
}

// out = q8_matmul_pallas(x, wq, ws): x f32 [b, n], wq int8 [n, d], ws f32
// [n/G, d], out f32 [b, d]; bf16 != 0 computes in bf16, postscale != 0
// scales each group's dot after it. gemv != 0 (b <= 8) runs the GEMV, one
// launch, and ignores part; else the tile kernel, with gpt and part as for
// q8q8_untiled.
int q8_untiled(const void* x, const void* wq, const void* ws, void* out,
               void* part, int b, int n, int d, int group_size, int gpt,
               int bf16, int postscale, int gemv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int8_t* w8 = static_cast<const int8_t*>(wq);
  const float* wsf = static_cast<const float*>(ws);
  if (gemv) {
    float* o = static_cast<float*>(out);
    if (bf16)
      return postscale ? untiled_gemv_rows<true, true>(xf, w8, wsf, o, b, n, d,
                                                       group_size, gpt, s)
                       : untiled_gemv_rows<true, false>(xf, w8, wsf, o, b, n,
                                                        d, group_size, gpt, s);
    return postscale ? untiled_gemv_rows<false, true>(xf, w8, wsf, o, b, n, d,
                                                      group_size, gpt, s)
                     : untiled_gemv_rows<false, false>(xf, w8, wsf, o, b, n, d,
                                                       group_size, gpt, s);
  }
  const int nt = n / group_size / gpt;
  const bool split = part != nullptr;
  float* dst = static_cast<float*>(split ? part : out);
  if (b <= 8)
    q8_untiled_kernel<8, 1, 2><<<grid_of(b, d, 8, nt, split), kThreads, 0, s>>>(
        xf, w8, wsf, dst, b, n, d, group_size, gpt, bf16, postscale,
        (int)split);
  else
    q8_untiled_kernel<64, 4, 4><<<grid_of(b, d, 64, nt, split), kThreads, 0,
                                  s>>>(xf, w8, wsf, dst, b, n, d, group_size,
                                       gpt, bf16, postscale, (int)split);
  if (!split) return (int)cudaGetLastError();
  return sum_tiles(dst, static_cast<float*>(out), nt, (size_t)b * d, s);
}

}  // extern "C"
