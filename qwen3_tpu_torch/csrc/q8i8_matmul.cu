// The pallas-int8 mode's matmul for Hopper (sm_90a), bound to Python through
// ctypes.
//
// Replaces the TPU kernels qwen3_tpu/ops/pallas/q8_matmul.py::
// q8i8_matmul_stacked (every layer matmul) and ::q8i8_matmul_tiled (the
// classifier), whose body is _kernel_q8i8, together with the activation
// quantization the JAX function runs before them. With tk = _pick_tile(n,
// 8 * G, 512) (512 at every qwen3 width; the whole axis when no multiple of
// 8 * G up to 512 divides n) and nt = n / tk k-tiles, both compute
//
//   xs[b, t]   = wmax / 127 (a true division; 1e-6 when wmax = 0), wmax =
//                max over the tile's k of |x[b, k]|
//   xq[b, k]   = clamp(sign(v) * floor(|v| + 0.5), -127, 127), v = x[b, k] / xs[b, t]
//   s8[t, c]   = max over the tile's groups g of ws[c, g]
//   w8[c, k]   = sign(wf) * floor(|wf| + 0.5),  wf = f32(wq[c, k]) * (ws[c, g] / s8[t, c])
//   out[b, c]  = sum over k-tiles t, in order from 0, of
//                f32(int32 sum_{k in t} xq[b, k] * w8[c, k]) * (xs[b, t] * s8[t, c])
//
// (xq/xs are ops/q8.py::quantize_act at group tk.) The weight tile is
// requantized to one int8 scale per (k-tile, column) inside the kernel, as
// the TPU kernel does in VMEM; no second int8 copy of the weights exists.
// Every division is a true IEEE division, every product and sum rounds as
// written (__fmul_rn, __fadd_rn), and the int32 dot is exact in any order
// (|dot| <= tk * 127^2 < 2^31) and converts to f32 once, exactly while tk
// <= 1040 (every qwen3 width): the kernels are bit-equal to their plain
// version, ops/cuda/q8_matmul.py::q8i8_matmul_plain, and a row's bits do
// not depend on the other rows of the call.
//
// Layout (the checkpoint's own, row-major per output column):
//   x  f32 [b, n]     xq int8 [b, n], xs f32 [b, nt] (the wrapper's scratch)
//   wq int8 [d, n]    ws f32 [d, n / G]   (stacked: [L, d, n], [L, d, n / G])
//   out f32 [b, d]
//
// Bound: at decode (b <= 8) the weight bytes (1 + 4 / G bytes a weight) over
// the memory rate (qwen3-0.6b's layer matrices: 0.7-2.0 us); at b = 512 the
// int8 operations over the int8 tensor-core peak.
//
// Design. __dp4a on CUDA cores in blocks of 8 rows x 64 columns (16 blocks
// for wo and w2), with the requantized weights staged in shared memory and
// the activations from seven small PyTorch kernels of quantize_act, took
// 8.714 ms a token at b = 1 against a 0.140 ms bound. Instead:
//  - q8i8_mma_kernel: the int8 dots on the tensor cores, mma.sync
//    m16n8k32 s8 x s8 -> s32, with the block's 16 output columns on M and 8
//    batch rows on N (C[16 columns x 8 rows] = W8[16 x 32 k] . xq^T[32 k x
//    8 rows]): W's rows are the checkpoint's [d, n] bytes, so each lane's A
//    fragment comes from 16 contiguous bytes of a column, and xq [b, n]
//    row-major is the col-major B operand. Lane (g, t) loads the 16 bytes
//    at k = 16 t of a 64-byte chunk for columns g and g + 8 and row g, and
//    two MMAs take words 0-1 and 2-3: one permutation of k for A and B,
//    which an exact integer dot does not see. A block owns 16 columns and
//    RB rows (8 when b <= 8, else 64, the rows split over blockIdx.y); its
//    warps split the n / 64 chunks into contiguous ranges (2 chunks a warp
//    while the grid has at most 264 blocks, else 4), so the k-tiles, and
//    the chunks of a k-tile, spread over the warps. Each warp issues its
//    first chunks' weight and scale loads before anything else, then
//    requantizes them once a block, in registers, straight into A fragments
//    (one division per 16 weights), and runs them against each 8-row chunk
//    of the block; its int32 partial dot of a k-tile goes into shared
//    memory by integer atomics (exact in any order). After one barrier each
//    (row, column) adds its k-tiles' terms in tile order.
//  - The activation quantization: at b <= 8 each block quantizes its rows
//    itself, one warp a (row, k-tile), into shared memory while its weight
//    loads are in flight, as long as all blocks together repeat at most
//    2^23 quantizations (qwen3-0.6b's layer matrices; not the classifier);
//    otherwise q8i8_quantize_kernel, one block per (k-tile, row), writes
//    xq and xs first. Both round as quantize_act does.
// Blocks: ceil(d / 16) x ceil(b / RB) (qwen3-0.6b at b <= 8: wqkv 256, wo
// and w2 64, w13 384), each of up to 16 warps.

#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_attr.cuh"

namespace {

constexpr int kCols = 16;       // a block's output columns: one MMA's M
constexpr int kMaxChunks = 4;   // 64-byte k chunks a warp holds as A fragments
constexpr int kMaxWarps = 16;
// up to this many blocks a warp takes 2 chunks, above it 4 (measured on
// qwen3-0.6b's matrices: more warps a block shorten a lone wave's chain of
// requantization, fewer pay off once the blocks queue)
constexpr int kFewBlocks = 264;
constexpr int kQuantThreads = 128;
// the block quantizes its own rows (b <= 8) while ceil(d / 16) * b * n, the
// quantizations all blocks repeat, stays within this
constexpr size_t kFoldWork = 1u << 23;

// sign(v) * floor(|v| + 0.5) for |v| < 2^31: the sum's truncation toward
// zero, with v's sign put on it first (an integer that fits in int8 here)
__device__ __forceinline__ int round_away(float v) {
  return __float2int_rz(copysignf(__fadd_rn(fabsf(v), 0.5f), v));
}

// The low bytes of four ints as one word, element 0 lowest.
__device__ __forceinline__ int pack4(int e0, int e1, int e2, int e3) {
  return (int)__byte_perm(__byte_perm(e0, e1, 0x0040),
                          __byte_perm(e2, e3, 0x0040), 0x5410);
}

// Four int8 weights of one 32-bit word, requantized with `ratio`: wf =
// f32(q) * ratio rounded half away from zero (|wf| <= 127: ratio <= 1).
__device__ __forceinline__ int requant4(int word, float ratio) {
  int m[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    m[i] = round_away(__fmul_rn((float)(int8_t)(word >> (8 * i)), ratio));
  return pack4(m[0], m[1], m[2], m[3]);
}

// A warp's int32 partial dots of one k-tile (the MMA's C fragment) into the
// block's [8 rows][16 columns] sums: integer adds, exact in any order.
__device__ __forceinline__ void flush(int* dt, int (&acc)[4], int gid,
                                      int tig) {
  atomicAdd(dt + (2 * tig) * kCols + gid, acc[0]);
  atomicAdd(dt + (2 * tig + 1) * kCols + gid, acc[1]);
  atomicAdd(dt + (2 * tig) * kCols + gid + 8, acc[2]);
  atomicAdd(dt + (2 * tig + 1) * kCols + gid + 8, acc[3]);
  acc[0] = acc[1] = acc[2] = acc[3] = 0;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], int b0,
                                       int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// quantize_act's scale of a (row, k-tile) from its absmax, and one value's
// int8: true divisions, round half away from zero, clamped to +-127.
__device__ __forceinline__ float act_scale(float wmax) {
  return wmax == 0.f ? 1e-6f : __fdiv_rn(wmax, 127.f);
}

__device__ __forceinline__ int act_q(float x, float s) {
  const float v = __fdiv_rn(x, s);
  return max(-127, min(127, round_away(v)));
}

__device__ __forceinline__ int act_q4(float4 v, float s) {
  return pack4(act_q(v.x, s), act_q(v.y, s), act_q(v.z, s), act_q(v.w, s));
}

__device__ __forceinline__ float absmax4(float m, float4 v) {
  return fmaxf(fmaxf(m, fabsf(v.x)),
               fmaxf(fabsf(v.y), fmaxf(fabsf(v.z), fabsf(v.w))));
}

// One block per (k-tile, row): quantize_act at group tk, for the calls
// whose matmul blocks do not quantize their rows themselves.
__global__ void __launch_bounds__(kQuantThreads)
q8i8_quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ xs, int n, int tk) {
  __shared__ float red[kQuantThreads / 32];
  const int t = blockIdx.x, row = blockIdx.y, nt = n / tk;
  const size_t base = (size_t)row * n + (size_t)t * tk;
  float m = 0.f;
  for (int k = 4 * threadIdx.x; k < tk; k += 4 * kQuantThreads)
    m = absmax4(m, *reinterpret_cast<const float4*>(x + base + k));
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  float wmax = red[0];
#pragma unroll
  for (int i = 1; i < kQuantThreads / 32; ++i) wmax = fmaxf(wmax, red[i]);
  const float s = act_scale(wmax);
  for (int k = 4 * threadIdx.x; k < tk; k += 4 * kQuantThreads)
    *reinterpret_cast<int*>(xq + base + k) =
        act_q4(*reinterpret_cast<const float4*>(x + base + k), s);
  if (threadIdx.x == 0) xs[(size_t)row * nt + t] = s;
}

// `fold`: b <= 8, and the block quantizes the activations itself into
// shared memory (rows padded by 64 bytes, so the B fragments' 16-byte
// reads of a quarter-warp hit distinct banks), while its weight loads are
// in flight; else it reads xq/xs written by q8i8_quantize_kernel.
__global__ void q8i8_mma_kernel(const float* __restrict__ x,
                                const int8_t* __restrict__ xq_g,
                                const float* __restrict__ xs_g,
                                const int8_t* __restrict__ wq,
                                const float* __restrict__ ws,
                                float* __restrict__ out, int b, int n, int d,
                                int G, int tk, int RB, int fold) {
  extern __shared__ int4 i8_smem[];
  const int nt = n / tk, ng = n / G, gpt = tk / G, nc = n / 64;
  const int RC = RB / 8;                          // 8-row chunks
  const int xstride = fold ? n + 64 : n;          // bytes a row of xq
  int* dots = reinterpret_cast<int*>(i8_smem);    // [RC][nt][8 rows][16 cols]
  float* s8_sm = reinterpret_cast<float*>(dots + RC * nt * 8 * kCols);
  float* xs_sm = s8_sm + nt * kCols;               // [8][nt] when fold
  int8_t* xq_sm = reinterpret_cast<int8_t*>(       // [8][n + 64] when fold
      i8_smem + (RC * nt * 8 * kCols + nt * kCols + 8 * nt + 3) / 4);
  const int8_t* xqp = fold ? xq_sm : xq_g;
  const float* xsp = fold ? xs_sm : xs_g;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int c0 = blockIdx.x * kCols, r0 = blockIdx.y * RB;
  const int rcn = min(RC, (b - r0 + 7) / 8);      // chunks holding rows
  const int ca = c0 + gid, cb = c0 + gid + 8;     // the lane's two columns
  const int ch0 = warp * nc / nw, ch1 = (warp + 1) * nc / nw;

  // the first chunks' weights and scales, loaded before anything waits
  int4 wa[kMaxChunks], wb[kMaxChunks];
  float sa[kMaxChunks], sb[kMaxChunks];
  auto load_w = [&](int p0) {
#pragma unroll
    for (int j = 0; j < kMaxChunks; ++j) {
      wa[j] = wb[j] = make_int4(0, 0, 0, 0);
      sa[j] = sb[j] = 0.f;
      if (p0 + j < ch1) {
        const int k = (p0 + j) * 64 + 16 * tig, g = k / G;
        if (ca < d) {
          wa[j] = __ldg(reinterpret_cast<const int4*>(wq + (size_t)ca * n + k));
          sa[j] = ws[(size_t)ca * ng + g];
        }
        if (cb < d) {
          wb[j] = __ldg(reinterpret_cast<const int4*>(wq + (size_t)cb * n + k));
          sb[j] = ws[(size_t)cb * ng + g];
        }
      }
    }
  };
  load_w(ch0);

  for (int i = tid; i < RC * nt * 8 * kCols; i += blockDim.x) dots[i] = 0;
  for (int i = tid; i < nt * kCols; i += blockDim.x) {
    const int t = i / kCols, c = c0 + i % kCols;
    float m = 0.f;
    if (c < d) {
      const float* srow = ws + (size_t)c * ng + (size_t)t * gpt;
      m = srow[0];
      for (int g = 1; g < gpt; ++g) m = fmaxf(m, srow[g]);
    }
    s8_sm[i] = m;
  }
  if (fold) {
    // one warp a (row, k-tile): absmax by shuffles, then the divisions
    for (int pr = warp; pr < b * nt; pr += nw) {
      const int r = pr / nt, t = pr % nt;
      const float* xr = x + (size_t)r * n + (size_t)t * tk;
      float m = 0.f;
      for (int k = 4 * lane; k < tk; k += 128)
        m = absmax4(m, *reinterpret_cast<const float4*>(xr + k));
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      const float s = act_scale(m);
      int8_t* qr = xq_sm + (size_t)r * xstride + (size_t)t * tk;
      for (int k = 4 * lane; k < tk; k += 128)
        *reinterpret_cast<int*>(qr + k) =
            act_q4(*reinterpret_cast<const float4*>(xr + k), s);
      if (lane == 0) xs_sm[r * nt + t] = s;
    }
  }
  __syncthreads();

  for (int p0 = ch0; p0 < ch1; p0 += kMaxChunks) {
    if (p0 != ch0) load_w(p0);
    int a[kMaxChunks][2][4];                      // [chunk][mma][register]
#pragma unroll
    for (int j = 0; j < kMaxChunks; ++j) {
      if (p0 + j < ch1) {
        const int t = (p0 + j) * 64 / tk;
        const float ra = ca < d ? __fdiv_rn(sa[j], s8_sm[t * kCols + gid])
                                : 0.f;
        const float rb = cb < d ? __fdiv_rn(sb[j], s8_sm[t * kCols + gid + 8])
                                : 0.f;
        // A: registers 0/2 hold column g, 1/3 column g + 8
        a[j][0][0] = requant4(wa[j].x, ra);
        a[j][0][1] = requant4(wb[j].x, rb);
        a[j][0][2] = requant4(wa[j].y, ra);
        a[j][0][3] = requant4(wb[j].y, rb);
        a[j][1][0] = requant4(wa[j].z, ra);
        a[j][1][1] = requant4(wb[j].z, rb);
        a[j][1][2] = requant4(wa[j].w, ra);
        a[j][1][3] = requant4(wb[j].w, rb);
      }
    }
    for (int rc = 0; rc < rcn; ++rc) {
      // the lane's B row; rows past b give columns of C that are not read
      const int row = 8 * rc + gid;
      int4 xv[kMaxChunks];
#pragma unroll
      for (int j = 0; j < kMaxChunks; ++j) {
        xv[j] = make_int4(0, 0, 0, 0);
        if (p0 + j < ch1 && (fold || r0 + row < b))
          xv[j] = *reinterpret_cast<const int4*>(
              xqp + (size_t)(fold ? row : r0 + row) * xstride +
              (size_t)(p0 + j) * 64 + 16 * tig);
      }
      int acc[4] = {0, 0, 0, 0};
      int t_cur = p0 * 64 / tk;
#pragma unroll
      for (int j = 0; j < kMaxChunks; ++j) {
        if (p0 + j < ch1) {
          const int t = (p0 + j) * 64 / tk;
          if (t != t_cur) {
            flush(dots + (size_t)(rc * nt + t_cur) * 8 * kCols, acc, gid,
                  tig);
            t_cur = t;
          }
          mma_s8(acc, a[j][0], xv[j].x, xv[j].y);
          mma_s8(acc, a[j][1], xv[j].z, xv[j].w);
        }
      }
      flush(dots + (size_t)(rc * nt + t_cur) * 8 * kCols, acc, gid, tig);
    }
  }
  __syncthreads();
  // the k-tiles' terms in tile order, one (row, column) a thread
  for (int p = tid; p < rcn * 8 * kCols; p += blockDim.x) {
    const int rc = p / (8 * kCols), rr = (p / kCols) % 8, cc = p % kCols;
    const int row = r0 + 8 * rc + rr, col = c0 + cc;
    if (row >= b || col >= d) continue;
    const float* xsr = xsp + (size_t)(fold ? 8 * rc + rr : row) * nt;
    float o = 0.f;
    for (int t = 0; t < nt; ++t) {
      const int dot = dots[((size_t)(rc * nt + t) * 8 + rr) * kCols + cc];
      o = __fadd_rn(o, __fmul_rn(__int2float_rn(dot),
                                 __fmul_rn(xsr[t], s8_sm[t * kCols + cc])));
    }
    out[(size_t)row * d + col] = o;
  }
}

int launch(const void* x, void* xq_out, void* xs_out, const void* wq,
           const void* ws, void* out, int b, int n, int d, int G, int tk,
           cudaStream_t s) {
  static size_t set[16] = {};
  const int nt = n / tk;
  int8_t* xq = static_cast<int8_t*>(xq_out);
  float* xs = static_cast<float*>(xs_out);
  const float* xf = static_cast<const float*>(x);
  const int RB = b <= 8 ? 8 : 64;
  const int col_blocks = (d + kCols - 1) / kCols;
  const int fold = b <= 8 && (size_t)col_blocks * b * n <= kFoldWork;
  int err = 0;
  if (!fold) {
    q8i8_quantize_kernel<<<dim3((unsigned)nt, (unsigned)b), kQuantThreads, 0,
                           s>>>(xf, xq, xs, n, tk);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  const int nc = n / 64;
  const int row_blocks = (b + RB - 1) / RB;
  const int cpw = (size_t)col_blocks * row_blocks <= kFewBlocks ? 2 : 4;
  const int nw = max(1, min(kMaxWarps, (nc + cpw - 1) / cpw));
  size_t smem = ((size_t)(RB / 8) * nt * 8 * kCols + nt * kCols + 8 * nt) *
                sizeof(int);
  if (fold) smem = (smem + 15) / 16 * 16 + (size_t)8 * (n + 64);
  err = allow_smem(q8i8_mma_kernel, smem, set);
  if (err) return err;
  const dim3 blocks((unsigned)col_blocks, (unsigned)row_blocks);
  q8i8_mma_kernel<<<blocks, 32 * nw, smem, s>>>(
      xf, xq, xs, static_cast<const int8_t*>(wq),
      static_cast<const float*>(ws), static_cast<float*>(out), b, n, d, G, tk,
      RB, fold);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out = q8i8(x, wq, ws): x f32 [b, n], wq int8 [d, n], ws f32 [d, n / G],
// out f32 [b, d]; xq int8 [b, n] and xs f32 [b, n / tk] receive the
// quantized activations. tk divides n and is a multiple of 64 and of G.
// Launches the quantization and the matmul on `stream` and returns
// cudaGetLastError() (0 = launched).
int q8i8_matmul(const void* x, void* xq, void* xs, const void* wq,
                const void* ws, void* out, int b, int n, int d,
                int group_size, int tk, void* stream) {
  return launch(x, xq, xs, wq, ws, out, b, n, d, group_size, tk,
                static_cast<cudaStream_t>(stream));
}

// The same against layer `layer` of stacked weights [L, d, n] / [L, d, n/G].
int q8i8_matmul_stacked(const void* x, void* xq, void* xs, const void* wq,
                        const void* ws, int layer, void* out, int b, int n,
                        int d, int group_size, int tk, void* stream) {
  const size_t off = (size_t)layer * (size_t)d * (size_t)n;
  const int8_t* wl = static_cast<const int8_t*>(wq) + off;
  const float* sl = static_cast<const float*>(ws) + off / group_size;
  return q8i8_matmul(x, xq, xs, wl, sl, out, b, n, d, group_size, tk,
                     stream);
}

}  // extern "C"
