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
//    bit-equal to ops/cuda/q8_matmul.py::q8_q8_matmul_pallas_plain. It is
//    row 1's function (csrc/q8_matmul.cu) on the weights' transpose.
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
// b times), operations at large b.
//
// q8_q8_matmul_pallas. Its first design, an 8-row (b <= 8) or 64-row __dp4a
// tile on CUDA cores (one 4-byte weight load a thread a k-row, two
// barriers a chunk, no load in flight), took 2.16 ms a token's 113
// matrices at b = 1 where F.linear takes 1.11 (qwen3-0.6b, an NVIDIA H100
// 80GB HBM3 at 700 W, chip_smoke.py). Now, on the route
// ops/cuda/q8_matmul.py::plan_untiled_q8q8 gives:
//  - up to UNTILED_Q8Q8_GEMV_ROWS rows, q8q8_untiled_gemv_kernel, one
//    launch. A block owns 32 columns and all of k; its warps (up to 16)
//    split k in units of whole stages and whole groups (128 k-rows, 64 at b
//    > 2, or G), each through its own cp.async ring (the weights, the rows'
//    int8 activations and both group scales), so that a layer matrix's
//    warps hold about one stage each, all in flight at once, and no barrier
//    couples the warps until the end. A column's k is strided by d in this
//    layout, so a lane reads the words of 4 k-rows x 4 columns (k-rows
//    swizzled in the stage so that a warp's 32 reads hit 32 banks),
//    transposes them with __byte_perm into words of 4 k a column and runs
//    __dp4a against the activation word: lane (q, w) holds the partial dots
//    of columns 4 w .. + 3 over k-quad q of every 16 k. At a group's end two
//    shuffle rounds leave lane (q, w) the whole dot of column 4 w + q (a
//    reduce-scatter of exact integers), and it parks the group's term
//    f32(dot) * (xs * ws) in shared memory; after one barrier a thread a
//    (row, column) adds the terms in group order within each k-tile and the
//    tiles in order. Its first design gave a warp whole k-tiles, acc_t in
//    registers: 4 stages in a row a warp, about 11 us a layer matrix
//    whatever its size.
//  - above, q8q8_mma_kernel of q8_kernels.cuh (row 1's tile path: mma.sync
//    s8, the ordered epilogue in the fragments, plan_q8q8's tiles and
//    k-split) with the weights staged as [k][cols] bytes (kWCols): its B
//    fragments come from ldmatrix .trans and __byte_perm (see there), its
//    epilogue and sum order are row 1's, so its bits are those of row 1 on
//    w_q.T by construction.
// Every route computes each row alone in the same order, so no route, b or
// split changes a bit.
//
// q8_matmul_pallas:
//  - b > 8: a tile kernel. A block owns 64 rows x 64 columns with 256
//    threads (thread (ty, tx) owns rows ty + 16 i, columns tx + 16 j, i, j
//    < 4) and walks k in chunks of kc = min(G, 64) staged in shared memory,
//    the weight chunk [kc, 64] read along d. Each row's arithmetic is the
//    same at any b, so a row's bits do not depend on its batch-mates. When
//    the row and column blocks alone would not fill the card, the k-tiles
//    also split across blocks: block z computes acc_z into part[z], and a
//    second kernel sums the tiles in order (out = ((0 + acc_0) + acc_1) +
//    ...), the same sums as one block walking every tile.
//  - b <= 8 (decode): q8_untiled_gemv_kernel. The tile kernel's first design
//    here (8 rows a block, 7 of them zeros at b = 1, one 4-byte weight load
//    a thread a k-row, two barriers a chunk and no load in flight) took
//    3.74 ms a token's 113 matrices where F.linear takes 1.14 and the bytes
//    0.19 (qwen3-0.6b in f32 prescale, an NVIDIA H100 80GB HBM3 at 700 W,
//    chip_smoke.py). The function fixes each (row, column)'s sum over a
//    k-tile as one fmaf chain in k order, so the parallelism is d x
//    (k-tiles) chains, each 512 long: a lane owns one column (32 columns a
//    warp, a k-row's 32 contiguous bytes) and its R = b (rounded up to 1,
//    2, 4 or 8) rows' chains, and the warps of a block take the k-tiles of
//    its 32 columns (warp w: tiles w, w + warps, ...), so wo and w2 run 4-6
//    warps on each of 32 blocks and the classifier 2 on each of 4748. Each
//    warp streams its tiles through its own cp.async ring of kUgRing stages
//    of 128 k-rows (64 at b > 2; the weights, the rows' activations and the
//    stage's group scales, 16-byte copies) with kUgRing - 1 stages in
//    flight before any FMA, waits on its own copies and a __syncwarp, so no
//    barrier couples the warps; an int8 weight becomes f32 by one integer
//    add and one exact fadd. The tiles' sums land in shared memory and are
//    added in tile order after one barrier: the tile kernel's arithmetic,
//    the same bits at any b.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "q8_kernels.cuh"

namespace {

constexpr int kCols = 64, kThreads = 256;

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
          cp_async16_s(base + 16 * e,
                    on ? (const void*)(wq + (size_t)(k0 + r) * d + c0 + 16 * h)
                       : (const void*)wq,
                    on);
        }
      } else {
#pragma unroll
        for (int i = 0; i < WB / 4 / 32; ++i) {
          const int e = lane + 32 * i, r = e >> 3, wd = e & 7;
          const bool on = r < rows && c0 + 4 * wd < d;
          cp_async4_s(base + 4 * e,
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
          cp_async16_s(base + WB + 16 * e,
                    on ? (const void*)(x + (size_t)r * n + k0 + 4 * p)
                       : (const void*)x,
                    on);
        }
      }
      // the stage's group scales, 16 bytes a copy
      for (int e = lane; e < 8 * nsl; e += 32) {
        const int j = e >> 3, p = e & 7, g = (k0 >> lg) + j;
        const bool on = (j << lg) < rows && g < ng && c0 + 4 * p < d;
        cp_async16_s(base + WB + XB + 16 * e,
                  on ? (const void*)(ws + (size_t)g * d + c0 + 4 * p)
                     : (const void*)ws,
                  on);
      }
    }
    cp_async_commit();
  };

  float acc[R], sg[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = sg[r] = 0.f;
  float sc = 0.f;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) load(s);
  for (int q = 0; q < total; ++q) {
    cp_async_wait<S - 2>();   // this lane's copies of stage q have landed
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
  cp_async_wait<0>();
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

// ------------------------------- the Q8_0 x Q8_0 GEMV, b <= 4 rows ----

// A stage: K = qg_k(R) k-rows of the warp's 32 columns (32 bytes a row,
// k-row 4 u + i of each 16 stored as row 4 u + (i ^ (u & 3))), the R rows'
// int8 activations over those k ([R][K]), their group scales ([R][K / 16]
// f32 at most) and the weights' ([K / 16][32] f32 at most); kQgRing = 4
// stages a warp at most.
constexpr int kQgRing = 4, kQgSmemBudget = 200 * 1024;

__host__ __device__ constexpr int qg_k(int R) { return R <= 2 ? 128 : 64; }
__host__ __device__ constexpr int qg_xoff(int R) { return qg_k(R) * 32; }
__host__ __device__ constexpr int qg_xsoff(int R) {
  return qg_xoff(R) + R * qg_k(R);
}
__host__ __device__ constexpr int qg_wsoff(int R) {
  return qg_xsoff(R) + 4 * R * (qg_k(R) / 16);
}
__host__ __device__ constexpr int qg_stage_bytes(int R) {
  return qg_wsoff(R) + 4 * 32 * (qg_k(R) / 16);
}

__device__ __forceinline__ int qg_row(int kr) {
  return (kr & ~3) | ((kr & 3) ^ ((kr >> 2) & 3));
}

// Lanes l, l ^ 8, l ^ 16, l ^ 24 (q = l >> 3) each hold partial sums v of
// four columns; returns the total of column q (exact integer adds).
__device__ __forceinline__ int reduce_scatter4(const int (&v)[4], int q) {
  const bool hi = q & 2, lo = q & 1;
  int k0 = hi ? v[2] : v[0], k1 = hi ? v[3] : v[1];
  k0 += __shfl_xor_sync(0xffffffffu, hi ? v[0] : v[2], 16);
  k1 += __shfl_xor_sync(0xffffffffu, hi ? v[1] : v[3], 16);
  return (lo ? k1 : k0) + __shfl_xor_sync(0xffffffffu, lo ? k0 : k1, 8);
}

// Block: nw warps over columns 32 blockIdx.x .. (kQgMaxWarps at most) and
// the whole of k, in units of U = max(K, G) k-rows (whole stages, whole
// groups): warp w takes units w, w + nw, ..., each a stage or (G > K) G / K
// stages in a row, through its ring of `slots` stages (min(kQgRing, its
// stages)). Each group's term goes to shared memory, [ng][R][32], and after
// one barrier thread (r, column) adds them up in the plain version's order.
// Requires b <= R, G a power of two in [16, 512], n % G == 0, d % 4 == 0,
// tk a multiple of G, R * n / G <= kQgMaxTerms.
constexpr int kQgMaxWarps = 16, kQgMaxTerms = 1024;

template <int R>
__global__ void __launch_bounds__(32 * kQgMaxWarps, 1)
q8q8_untiled_gemv_kernel(const int8_t* __restrict__ xq,
                         const float* __restrict__ xs,
                         const int8_t* __restrict__ wq,
                         const float* __restrict__ ws, float* __restrict__ out,
                         int b, int n, int d, int G, int tk, int slots) {
  constexpr int S = kQgRing, K = qg_k(R), SB = qg_stage_bytes(R);
  constexpr int XO = qg_xoff(R), XSO = qg_xsoff(R), WSO = qg_wsoff(R);
  constexpr int NSL = K / 16;   // group-scale slots a stage
  extern __shared__ int4 qg_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  char* ring = reinterpret_cast<char*>(qg_smem) + (size_t)warp * slots * SB;
  float* terms = reinterpret_cast<float*>(reinterpret_cast<char*>(qg_smem) +
                                          (size_t)nw * slots * SB);
  const unsigned ring_s = (unsigned)__cvta_generic_to_shared(ring);
  const int c0 = blockIdx.x * 32;
  const bool vec16 = (d & 15) == 0;   // a k-row's 32 bytes in 16-byte copies
  const int lg = 31 - __clz(G), ng = n / G;
  const int nsl = G < K ? K / G : 1;   // groups a stage
  const int U = max(K, G), spu = U / K, nu = n / U + (n % U != 0);
  const int total = warp < nu ? (nu - warp + nw - 1) / nw * spu : 0;
  // the lane's k-quad of each 16 k and its 4 columns; after a group's
  // reduce-scatter, its column
  const int q = lane >> 3, w = lane & 7, col = 4 * w + q;
  auto stage_k0 = [&](int qs) {   // this warp's stage qs: its first k
    return (warp + nw * (qs / spu)) * U + (qs % spu) * K;
  };

  auto load = [&](int qs) {   // called for qs = 0, 1, 2, ... in order
    if (qs < total) {
      const int k0 = stage_k0(qs), rows = min(K, n - k0);
      const int g0 = k0 >> lg;
      const unsigned base = ring_s + (qs % S) * SB;
      if (vec16) {
#pragma unroll
        for (int i = 0; i < K * 2 / 32; ++i) {
          const int e = lane + 32 * i, kr = e >> 1, h = e & 1;
          const bool on = kr < rows && c0 + 16 * h < d;
          cp_async16_s(base + 32 * qg_row(kr) + 16 * h,
                       on ? (const void*)(wq + (size_t)(k0 + kr) * d + c0 +
                                          16 * h)
                          : (const void*)wq,
                       on);
        }
      } else {
#pragma unroll
        for (int i = 0; i < K * 8 / 32; ++i) {
          const int e = lane + 32 * i, kr = e >> 3, wd = e & 7;
          const bool on = kr < rows && c0 + 4 * wd < d;
          cp_async4_s(base + 32 * qg_row(kr) + 4 * wd,
                      on ? (const void*)(wq + (size_t)(k0 + kr) * d + c0 +
                                         4 * wd)
                         : (const void*)wq,
                      on);
        }
      }
#pragma unroll
      for (int i = 0; i < (R * K / 16 + 31) / 32; ++i) {
        const int e = lane + 32 * i, r = e / (K / 16), p = e % (K / 16);
        if (e < R * K / 16) {
          const bool on = r < b && 16 * p < rows;
          cp_async16_s(base + XO + 16 * e,
                       on ? (const void*)(xq + (size_t)r * n + k0 + 16 * p)
                          : (const void*)xq,
                       on);
        }
      }
      for (int e = lane; e < R * NSL; e += 32) {
        const int r = e / NSL, j = e % NSL;
        const bool on = r < b && j < nsl && (j << lg) < rows && g0 + j < ng;
        cp_async4_s(base + XSO + 4 * e,
                    on ? (const void*)(xs + (size_t)r * ng + g0 + j)
                       : (const void*)xs,
                    on);
      }
      for (int e = lane; e < 8 * nsl; e += 32) {
        const int j = e >> 3, p = e & 7;
        const bool on = (j << lg) < rows && g0 + j < ng && c0 + 4 * p < d;
        cp_async16_s(base + WSO + 16 * e,
                     on ? (const void*)(ws + (size_t)(g0 + j) * d + c0 + 4 * p)
                        : (const void*)ws,
                     on);
      }
    }
    cp_async_commit();
  };

  int dot[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) dot[r][j] = 0;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) load(s);
  for (int qs = 0; qs < total; ++qs) {
    cp_async_wait<S - 2>();   // this lane's copies of stage qs have landed
    __syncwarp();   // every lane's copies visible; slot qs - 1 is free again
    load(qs + S - 1);
    const int k0 = stage_k0(qs), rows = min(K, n - k0);
    const char* st = ring + (qs % S) * SB;
    const float* sxs = reinterpret_cast<const float*>(st + XSO);
    const float* sws = reinterpret_cast<const float*>(st + WSO);
    // 16 k of the stage from kk: 4 k-rows x 4 columns a lane, transposed
    // into words of 4 k a column, then __dp4a against the activations; at a
    // group's end the reduce-scatter and the group's term
    auto step16 = [&](int kk) {
      int a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const int*>(st + 32 * (kk + 4 * q + (i ^ q)) +
                                             4 * w);
      transpose4x4(a, c);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int xw =
            *reinterpret_cast<const int*>(st + XO + r * K + kk + 4 * q);
#pragma unroll
        for (int j = 0; j < 4; ++j) dot[r][j] = __dp4a(c[j], xw, dot[r][j]);
      }
      if ((k0 + kk + 16) & (G - 1)) return;   // the group goes on
      const int g = (k0 + kk) >> lg, js = g - (k0 >> lg);
      const float sw = sws[32 * js + col];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int v = reduce_scatter4(dot[r], q);
        terms[((size_t)g * R + r) * 32 + col] =
            __fmul_rn(__int2float_rn(v), __fmul_rn(sxs[r * NSL + js], sw));
#pragma unroll
        for (int j = 0; j < 4; ++j) dot[r][j] = 0;
      }
    };
    if (rows == K) {
      // 4 steps at a time: 512 threads leave a lane 128 registers, and the
      // whole stage unrolled spilled at R = 1 and 2 and was no faster on
      // any layer matrix of qwen3-0.6b or qwen3-4b (an H100)
#pragma unroll 4
      for (int kk = 0; kk < K; kk += 16) step16(kk);
    } else {
      for (int kk = 0; kk < rows; kk += 16) step16(kk);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  // out = sum over k-tiles t, in order, of (sum over t's groups, in order,
  // of the terms), each from 0
  const int gpt = tk / G, nt = ng / gpt;
  for (int e = threadIdx.x; e < R * 32; e += blockDim.x) {
    const int r = e >> 5, l = e & 31;
    float o = 0.f;
    for (int t = 0; t < nt; ++t) {
      float acc = 0.f;
      for (int i = 0; i < gpt; ++i)
        acc = __fadd_rn(acc, terms[((size_t)(t * gpt + i) * R + r) * 32 + l]);
      o = __fadd_rn(o, acc);
    }
    if (r < b && c0 + l < d) out[(size_t)r * d + c0 + l] = o;
  }
}

// The GEMV's block: as many warps as its units, up to kQgMaxWarps, fewer
// while the rings and the terms would pass the shared memory budget
template <int R>
int launch_q8q8_untiled_gemv(const int8_t* xq, const float* xs,
                             const int8_t* wq, const float* ws, float* out,
                             int b, int n, int d, int G, int gpt,
                             cudaStream_t s) {
  static size_t set[16] = {};
  constexpr int K = qg_k(R);
  const int ng = n / G, U = max(K, G), spu = U / K;
  const int nu = n / U + (n % U != 0);
  if (R * ng > kQgMaxTerms) return (int)cudaErrorInvalidValue;
  const size_t terms = sizeof(float) * (size_t)ng * R * 32;
  int nw = min(nu, kQgMaxWarps), slots = 0;
  size_t smem = 0;
  for (;; --nw) {
    slots = min(kQgRing, (nu + nw - 1) / nw * spu);
    smem = (size_t)nw * slots * qg_stage_bytes(R) + terms;
    if (smem <= kQgSmemBudget || nw == 1) break;
  }
  auto kernel = q8q8_untiled_gemv_kernel<R>;
  const int err = allow_smem(kernel, smem, set);
  if (err) return err;
  kernel<<<(unsigned)((d + 31) / 32), 32 * nw, smem, s>>>(
      xq, xs, wq, ws, out, b, n, d, G, gpt * G, slots);
  return (int)cudaGetLastError();
}

// The tile path on [n, d] weights: q8_kernels.cuh's tile kernel with
// plan_q8q8's grid (`shape`, `splits`, `part`); kWCols4 where d's rows are
// not 16-byte aligned.
inline int q8q8_untiled_tiles(const int8_t* xq, const float* xs,
                              const int8_t* wq, const float* ws, float* out,
                              float* part, int b, int n, int d, int G,
                              int gpt, int shape, int splits,
                              cudaStream_t s) {
  const bool v16 = (d & 15) == 0;
  // an MMA never spans two groups; past G = 128 a dot may reach 2^22
  if (G == 16)
    return v16 ? launch_mma<16, false, kWCols>(xq, xs, wq, ws, out, part, b,
                                               n, d, G, gpt, shape, splits, s)
               : launch_mma<16, false, kWCols4>(xq, xs, wq, ws, out, part, b,
                                                n, d, G, gpt, shape, splits, s);
  if (G >= 256)
    return v16 ? launch_mma<32, true, kWCols>(xq, xs, wq, ws, out, part, b, n,
                                              d, G, gpt, shape, splits, s)
               : launch_mma<32, true, kWCols4>(xq, xs, wq, ws, out, part, b,
                                               n, d, G, gpt, shape, splits, s);
  return v16 ? launch_mma<32, false, kWCols>(xq, xs, wq, ws, out, part, b, n,
                                             d, G, gpt, shape, splits, s)
             : launch_mma<32, false, kWCols4>(xq, xs, wq, ws, out, part, b, n,
                                              d, G, gpt, shape, splits, s);
}

}  // namespace

extern "C" {

// out = q8_q8_matmul_pallas(xq, xs, wq, ws): xq int8 [b, n], xs f32 [b, n/G],
// wq int8 [n, d], ws f32 [n/G, d], out f32 [b, d]; gpt groups a k-tile.
// gemv != 0 (b <= 4) runs the GEMV, one launch; else the tile path with
// plan_q8q8's `shape` and `splits` (part: f32 [n / (gpt G), b, d] scratch
// when splits > 1, else unused). Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
int q8q8_untiled(const void* xq, const void* xs, const void* wq,
                 const void* ws, void* out, void* part, int b, int n, int d,
                 int group_size, int gpt, int gemv, int shape, int splits,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* x8 = static_cast<const int8_t*>(xq);
  const float* xsf = static_cast<const float*>(xs);
  const int8_t* w8 = static_cast<const int8_t*>(wq);
  const float* wsf = static_cast<const float*>(ws);
  float* o = static_cast<float*>(out);
  const int G = group_size;
  if (!gemv)
    return q8q8_untiled_tiles(x8, xsf, w8, wsf, o, static_cast<float*>(part),
                              b, n, d, G, gpt, shape, splits, s);
  if (b <= 1)
    return launch_q8q8_untiled_gemv<1>(x8, xsf, w8, wsf, o, b, n, d, G, gpt, s);
  if (b <= 2)
    return launch_q8q8_untiled_gemv<2>(x8, xsf, w8, wsf, o, b, n, d, G, gpt, s);
  if (b <= 4)
    return launch_q8q8_untiled_gemv<4>(x8, xsf, w8, wsf, o, b, n, d, G, gpt, s);
  return (int)cudaErrorInvalidValue;
}

// out = q8_matmul_pallas(x, wq, ws): x f32 [b, n], wq int8 [n, d], ws f32
// [n/G, d], out f32 [b, d]; bf16 != 0 computes in bf16, postscale != 0
// scales each group's dot after it. gemv != 0 (b <= 8) runs the GEMV, one
// launch, and ignores part; else the 64-row tile kernel, its k-tiles split
// over blocks into part (f32 [n / (gpt G), b, d]) when part is not null.
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
  q8_untiled_kernel<64, 4, 4><<<grid_of(b, d, 64, nt, split), kThreads, 0,
                                s>>>(xf, w8, wsf, dst, b, n, d, group_size,
                                     gpt, bf16, postscale, (int)split);
  if (!split) return (int)cudaGetLastError();
  return sum_tiles(dst, static_cast<float*>(out), nt, (size_t)b * d, s);
}

}  // extern "C"
