// The Q8_0 matmul kernels of csrc/q8_matmul.cu (unfused) and csrc/q8_fused.cu
// (prologue-fused), written once.
//
// The b = 1 kernels (the Q8_0 x Q8_0 GEMV, the fast split kernel) take
// their activations through a template parameter `Act`:
//  - XqGlobal / BfGlobal (q8_matmul.cu) read what an earlier op made: the
//    quantized activations xq int8 [b, n] with their group scales xs f32
//    [b, n/G] (mode pallas), or bf16 activations x [b, n] (pallas-fast);
//  - XqPrologue / BfPrologue (below; q8_fused.cu) make the same values
//    inside the kernel from the raw f32 activations: h = prologue(x) (an
//    rmsnorm with its row factor given, a swiglu, or nothing), then
//    quantize_act's rounding, or the bf16 rounding.
// At b > 1 a fused call makes its activations once, with the same loader
// in a pass of its own, and runs the unfused kernels on them. Either way
// the weights, the dots, the epilogue and the sum order are one piece of
// code, so a fused call equals the unfused chain bit for bit by
// construction, and a redesign of an unfused kernel carries over to fuse.
//
// Every product and sum of this header is an explicit intrinsic (__fmul_rn,
// __fadd_rn, __fdiv_rn, fmaf), so its bits do not depend on nvcc's
// contraction setting: q8_matmul.cu builds with -fmad=false, q8_fused.cu with
// nvcc's default, which the swiglu prologue's expf needs to equal PyTorch's
// sigmoid (ops/cuda/build.py).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_attr.cuh"

namespace {

// ------------------------------------------------------------ prologue ----

enum Prologue { kNone = 0, kNorm = 1, kSwiglu = 2 };

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

// h[k .. k + 3] of row r: one 16-byte load of each operand, then
// prologue<PRO> on the loaded values (the same formula, value by value).
// k % 4 == 0; x, nw 16-byte aligned, n % 4 == 0.
__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

template <int PRO>
__device__ __forceinline__ float4 prologue4_of(const float* __restrict__ x,
                                               const float* __restrict__ inv,
                                               const float* __restrict__ nw,
                                               int r, int k, int n) {
  float v[8], w[4], iv = 0.f, h[4];
  const size_t row = (size_t)r * (PRO == kSwiglu ? 2 * n : n);
  *reinterpret_cast<float4*>(v) = ld4(x + row + k);
  if (PRO == kSwiglu)
    *reinterpret_cast<float4*>(v + 4) = ld4(x + row + n + k);
  if (PRO == kNorm) {
    *reinterpret_cast<float4*>(w) = ld4(nw + k);
    iv = __ldg(inv + r);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)   // v holds the row's values from k, n = 4
    h[e] = prologue<PRO>(v, &iv, w, 0, e, 4);
  return make_float4(h[0], h[1], h[2], h[3]);
}

// The prologue picked at run time (uniform over the grid)
__device__ __forceinline__ float4 prologue4(int pro, const float* x,
                                           const float* inv, const float* nw,
                                           int r, int k, int n) {
  if (pro == kNorm) return prologue4_of<kNorm>(x, inv, nw, r, k, n);
  if (pro == kSwiglu) return prologue4_of<kSwiglu>(x, inv, nw, r, k, n);
  return prologue4_of<kNone>(x, inv, nw, r, k, n);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bf16_bits_to_f32(unsigned short h) {
  return __uint_as_float(((unsigned)h) << 16);
}

__device__ __forceinline__ int pack4(int8_t a, int8_t b, int8_t c, int8_t d) {
  return (int)((unsigned)(uint8_t)a | ((unsigned)(uint8_t)b << 8) |
               ((unsigned)(uint8_t)c << 16) | ((unsigned)(uint8_t)d << 24));
}

// quantize_act of h = prologue(x) for rows r0 .. r0 + rows - 1 over k in
// [k0, k0 + len) (whole groups): q[row * qstride + k - k0] int8 and
// s[row * sstride + group - k0 / G] f32; rows >= b and k >= kend
// give zeros (scale 1e-6). A team of ts = min(G / 4, 32) lanes takes one
// (row, group) at a time, each lane vpg = max(1, G / 128) 16-byte pieces
// of it: the prologue runs once per value, the group's absmax is taken
// from the same values in registers (a shuffle over the team), then they
// are quantized. The T threads of the block call it together; it has no
// barrier.
__device__ __forceinline__ void build_q8(int pro, const float* x,
                                         const float* inv, const float* nw,
                                         int n, int b, int r0, int rows,
                                         int k0, int len, int kend, int G,
                                         int8_t* q, int qstride, float* s,
                                         int sstride, int tid, int T) {
  const int ts = min(G >> 2, 32), vpg = max(1, G >> 7);
  const int teams = T / ts, team = tid / ts, j = tid % ts;
  const int gpr = len / G, ngr = rows * gpr;
  for (int base = 0; base < ngr; base += teams) {
    const int gr = base + team;
    const bool on = gr < ngr;
    const int row = on ? gr / gpr : 0, gi = on ? gr % gpr : 0;
    const int r = r0 + row, kg = k0 + gi * G;
    float4 h[4];
    float m = 0.f;
    // a piece past b or kend is zeros, and is stored without a division
    // (a zero dividend takes __fdiv_rn's slow path)
    const bool live = on && r < b && kg < kend;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      h[v] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (v < vpg && live)
        h[v] = prologue4(pro, x, inv, nw, r, kg + 4 * (j + ts * v), n);
      m = fmaxf(m, fmaxf(fmaxf(fabsf(h[v].x), fabsf(h[v].y)),
                         fmaxf(fabsf(h[v].z), fabsf(h[v].w))));
    }
    for (int off = ts >> 1; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (!on) continue;
    const float sc = m == 0.f ? 1e-6f : __fdiv_rn(m, 127.f);
#pragma unroll
    for (int v = 0; v < 4; ++v)
      if (v < vpg)
        *reinterpret_cast<int*>(q + (size_t)row * qstride + gi * G +
                                4 * (j + ts * v)) =
            live ? pack4(quantize(h[v].x, sc), quantize(h[v].y, sc),
                         quantize(h[v].z, sc), quantize(h[v].w, sc))
                 : 0;
    if (j == 0) s[(size_t)row * sstride + gi] = sc;
  }
}

// ------------------------------------------------------ the loaders ----

// A quantized row where the GEMV reads it: x16(k) the 16 bytes from k,
// s(g) group g's scale
struct RowGlobal {
  const int8_t* xq;
  const float* xs;
  __device__ __forceinline__ int4 x16(int k) const {
    return __ldg(reinterpret_cast<const int4*>(xq + k));
  }
  __device__ __forceinline__ float s(int g) const { return __ldg(xs + g); }
};

struct RowShared {
  const int8_t* xq;
  const float* xs;
  __device__ __forceinline__ int4 x16(int k) const {
    return *reinterpret_cast<const int4*>(xq + k);
  }
  __device__ __forceinline__ float s(int g) const { return xs[g]; }
};

__host__ __device__ __forceinline__ size_t align16(size_t v) {
  return (v + 15) & ~(size_t)15;
}

// Q8_0 activations made by an earlier op
struct XqGlobal {
  const int8_t* xq;
  const float* xs;
  static constexpr bool kBuild = false;
  static size_t row_bytes(int, int) { return 0; }
  __device__ __forceinline__ void build_row(char*, int, int) const {}
  __device__ __forceinline__ RowGlobal row(char*, int, int) const {
    return RowGlobal{xq, xs};
  }
};

// Q8_0 activations made in the kernel from raw f32 x ([b, n], or [b, 2n]
// for swiglu), inv f32 [b] and nw f32 [n] (norm only)
struct XqPrologue {
  const float* x;
  const float* inv;
  const float* nw;
  int pro;
  static constexpr bool kBuild = true;
  // the GEMV's row in shared memory: n int8, then n / G f32
  static size_t row_bytes(int n, int G) {
    return align16((size_t)n) + sizeof(float) * (size_t)(n / G);
  }
  // b == 1: the whole row, quantized once into `sm` (row_bytes), then
  // read through row(). Not inlined: its divisions' slow-path calls then
  // save no register of the GEMV's (ptxas counted those saves as spills)
  __device__ __noinline__ void build_row(char* sm, int n, int G) const {
    build_q8(pro, x, inv, nw, n, 1, 0, 1, 0, n, n, G,
             reinterpret_cast<int8_t*>(sm), n,
             reinterpret_cast<float*>(sm + align16((size_t)n)), n / G,
             threadIdx.x, blockDim.x);
  }
  __device__ __forceinline__ RowShared row(char* sm, int n, int) const {
    return RowShared{reinterpret_cast<const int8_t*>(sm),
                     reinterpret_cast<const float*>(sm + align16((size_t)n))};
  }
  // b > 1: row r's groups over k in [k0, k0 + len), quantized by the
  // block into q (len int8 from k0) and s (len / G f32) in global memory;
  // not inlined, as build_row
  __device__ __noinline__ void build_global(int8_t* q, float* s, int r, int b,
                                            int n, int k0, int len,
                                            int G) const {
    build_q8(pro, x, inv, nw, n, b, r, 1, k0, len, n, G, q, len, s, len / G,
             threadIdx.x, blockDim.x);
  }
};

// bf16 activations made by an earlier op: raw8 gives the bf16 bits of row
// r's 8 values from k as stored (zeros where !live)
struct BfGlobal {
  const unsigned short* x;
  __device__ __forceinline__ int4 raw8(int r, int k, int n, bool live) const {
    int4 v = make_int4(0, 0, 0, 0);
    if (live) v = __ldg(reinterpret_cast<const int4*>(x + (size_t)r * n + k));
    return v;
  }
};

__device__ __forceinline__ int bf16_pair(float lo, float hi) {
  return (int)((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
               ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi))
                << 16));
}

// bf16(prologue(x)) made in the kernel from the raw f32 activations, as
// the same bits
struct BfPrologue {
  const float* x;
  const float* inv;
  const float* nw;
  int pro;
  __device__ __forceinline__ int4 raw8(int r, int k, int n, bool live) const {
    int4 v = make_int4(0, 0, 0, 0);
    if (live) {
      const float4 a = prologue4(pro, x, inv, nw, r, k, n);
      const float4 c = prologue4(pro, x, inv, nw, r, k + 4, n);
      v = make_int4(bf16_pair(a.x, a.y), bf16_pair(a.z, a.w),
                    bf16_pair(c.x, c.y), bf16_pair(c.z, c.w));
    }
    return v;
  }
};

// ------------------------------------------------ Q8_0 x Q8_0, b == 1 ----

__device__ __forceinline__ int dot16(const int4 w, const int4 x, int acc) {
  acc = __dp4a(w.x, x.x, acc);
  acc = __dp4a(w.y, x.y, acc);
  acc = __dp4a(w.z, x.z, acc);
  acc = __dp4a(w.w, x.w, acc);
  return acc;
}

// A block of kGemvThreads threads owns cols = kGemvWarps / wpc * CPW
// columns a column tile: warp w serves columns CPW * (w / wpc) + cc (cc <
// CPW) over piece w % wpc of their 512-byte chunks (contiguous pieces of
// whole chunks), NB chunks of each column in flight at a time. Block i
// walks column tiles i, i + gridDim.x, ... (one tile when the grid covers
// them). Requires G a power of two in [16, 512] and n % G == 0, so every
// chunk holds whole groups and the lanes of a group are aligned. Shared
// memory: the group terms, [cols][ng] floats, then the loader's row. A
// loader that builds its row first asks L2 for the block's first weight
// batch (a prefetch holds no register across the prologue), so that the
// prologue runs under those loads' latency.
constexpr int kGemvThreads = 256, kGemvWarps = kGemvThreads / 32;

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

template <int CPW, int NB, class Act>
__global__ void __launch_bounds__(kGemvThreads)
q8q8_gemv_kernel(Act act, const int8_t* __restrict__ wq,
                 const float* __restrict__ ws, float* __restrict__ out, int n,
                 int d, int G, int gpt, int wpc) {
  extern __shared__ int4 gemv_smem[];
  float* terms = reinterpret_cast<float*>(gemv_smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ng = n / G, lpg = G >> 4;
  const int cols = kGemvWarps / wpc * CPW;
  const int slot0 = warp / wpc * CPW;   // this warp's first column slot
  const int chunks = (n + 511) / 512;
  const int per = (chunks + wpc - 1) / wpc;
  const int j0 = warp % wpc * per, j1 = min(chunks, j0 + per);
  const int ntile = (d + cols - 1) / cols;
  const int4 zero = make_int4(0, 0, 0, 0);
  if constexpr (Act::kBuild) {
    const int c0 = blockIdx.x * cols + slot0;
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int k = (j0 + i) * 512 + lane * 16;
#pragma unroll
      for (int cc = 0; cc < CPW; ++cc)
        if (j0 + i < j1 && k < n && c0 + cc < d)
          prefetch_l2(wq + (size_t)(c0 + cc) * n + k);
    }
  }
  char* row_sm =
      reinterpret_cast<char*>(gemv_smem) + align16(sizeof(float) * cols * ng);
  if constexpr (Act::kBuild) {
    act.build_row(row_sm, n, G);
    __syncthreads();
  }
  const auto row = act.row(row_sm, n, G);
  auto column_tile = [&](int tile) {
    const int c0 = tile * cols + slot0;
    for (int jb = j0; jb < j1; jb += NB) {
      // every load of the batch first ...
      int4 x[NB], w[CPW][NB];
      float sx[NB], sw[CPW][NB];
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int k = (jb + i) * 512 + lane * 16;
        const bool in = jb + i < j1 && k < n;
        x[i] = in ? row.x16(k) : zero;
        sx[i] = in ? row.s(k / G) : 0.f;
#pragma unroll
        for (int cc = 0; cc < CPW; ++cc) {
          const bool on = in && c0 + cc < d;
          w[cc][i] = on ? __ldg(reinterpret_cast<const int4*>(
                              wq + (size_t)(c0 + cc) * n + k))
                        : zero;
          sw[cc][i] = on ? __ldg(ws + (size_t)(c0 + cc) * ng + k / G) : 0.f;
        }
      }
      // ... then the group dots and their terms
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int k = (jb + i) * 512 + lane * 16;
        const bool in = jb + i < j1 && k < n && (lane & (lpg - 1)) == 0;
#pragma unroll
        for (int cc = 0; cc < CPW; ++cc) {
          int dot = dot16(w[cc][i], x[i], 0);
          for (int off = lpg >> 1; off > 0; off >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          if (in)
            terms[(slot0 + cc) * ng + k / G] =
                __fmul_rn(__int2float_rn(dot), __fmul_rn(sx[i], sw[cc][i]));
        }
      }
    }
    __syncthreads();
    // the ordered sum, one warp per column slot: lane t adds k-tile t's
    // terms in order, then every lane adds the tile sums in order
    const int n_tiles = ng / gpt;
    for (int slot = warp; slot < cols; slot += kGemvWarps) {
      const float* trow = terms + slot * ng;
      float o = 0.f;
      for (int t0 = 0; t0 < n_tiles; t0 += 32) {
        const int t = t0 + lane;
        float acc = 0.f;
        if (t < n_tiles)
          for (int i = 0; i < gpt; ++i) acc = __fadd_rn(acc, trow[t * gpt + i]);
        const int m = min(32, n_tiles - t0);
        for (int i = 0; i < m; ++i)
          o = __fadd_rn(o, __shfl_sync(0xffffffffu, acc, i));
      }
      const int c = tile * cols + slot;
      if (lane == 0 && c < d) out[c] = o;
    }
  };
  if constexpr (Act::kBuild) {
    for (int tile = blockIdx.x; tile < ntile; tile += gridDim.x) {
      if (tile != (int)blockIdx.x) __syncthreads();   // the terms are read
      column_tile(tile);
    }
  } else {
    column_tile(blockIdx.x);   // the grid covers the column tiles
  }
}

// The GEMV's shape, from n and d: wpc warps share a column where d alone
// gives fewer than kGemvMinWarps warps (wo and w2 of qwen3-0.6b: 2) or a
// warp would walk more than kGemvMaxBatch chunks (long columns); NB, the
// chunks a warp has in flight, the least power of two that holds its
// piece; two columns a warp past kGemvPairCols columns (the classifier,
// whose 2-chunk columns would otherwise leave each lane 2 loads in
// flight). Registers, and with them the warps an SM holds, grow with NB
// and CPW. With `resident`, the grid is at most the blocks the card holds
// at once, each walking several column tiles (the fused kernel: a block
// makes its row once, so the classifier's 9496 tiles make it 4-8 times an
// SM, not 72). Returns a cudaError_t as an int.
constexpr int kGemvMinWarps = 2048, kGemvMaxBatch = 4,
              kGemvPairCols = 16384;

inline int sm_count() {
  static int sms[16] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 16 && sms[dev]) return sms[dev];
  int v = 0;
  cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
  if (dev < 16) sms[dev] = v;
  return v;
}

// The blocks of one kernel an SM holds at a given dynamic shared memory
// size, asked of the driver once per (device, size) and kept (a kernel's
// shared memory follows its matrix's n: a few sizes a kernel)
struct ResidentMemo {
  static constexpr int kSlots = 8;
  size_t smem[16][kSlots];
  int per_sm[16][kSlots];
};

template <typename K>
int resident_per_sm(K kernel, int threads, size_t smem, ResidentMemo& m,
                    int& per_sm) {
  int dev = 0;
  cudaGetDevice(&dev);
  const bool keep = dev < 16;
  int slot = -1;
  for (int i = 0; keep && i < ResidentMemo::kSlots; ++i) {
    if (m.per_sm[dev][i] && m.smem[dev][i] == smem) {
      per_sm = m.per_sm[dev][i];
      return 0;
    }
    if (slot < 0 && !m.per_sm[dev][i]) slot = i;
  }
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return (int)e;
  if (keep && slot >= 0 && per_sm > 0) {
    m.smem[dev][slot] = smem;
    m.per_sm[dev][slot] = per_sm;
  }
  return 0;
}

template <int CPW, int NB, class Act>
int launch_gemv_shape(Act act, const int8_t* wq, const float* ws, float* out,
                      int n, int d, int G, int gpt, int wpc, bool resident,
                      cudaStream_t s) {
  static size_t set[16] = {};
  const int cols = kGemvWarps / wpc * CPW;
  const size_t smem =
      align16(sizeof(float) * (size_t)cols * (n / G)) + Act::row_bytes(n, G);
  auto kernel = q8q8_gemv_kernel<CPW, NB, Act>;
  const int err = allow_smem(kernel, smem, set);
  if (err) return err;
  unsigned blocks = (unsigned)((d + cols - 1) / cols);
  if (resident) {
    static ResidentMemo held = {};
    int per_sm = 0;
    const int e = resident_per_sm(kernel, kGemvThreads, smem, held, per_sm);
    if (e) return e;
    const unsigned cap = (unsigned)(max(1, per_sm) * sm_count());
    if (blocks > cap) blocks = cap;
  }
  kernel<<<blocks, kGemvThreads, smem, s>>>(act, wq, ws, out, n, d, G, gpt,
                                            wpc);
  return (int)cudaGetLastError();
}

template <int CPW, class Act>
int launch_gemv_cpw(Act act, const int8_t* wq, const float* ws, float* out,
                    int n, int d, int G, int gpt, int wpc, int per,
                    bool resident, cudaStream_t s) {
  if (per <= 2)
    return launch_gemv_shape<CPW, 2>(act, wq, ws, out, n, d, G, gpt, wpc,
                                     resident, s);
  if (per <= 4)
    return launch_gemv_shape<CPW, 4>(act, wq, ws, out, n, d, G, gpt, wpc,
                                     resident, s);
  return launch_gemv_shape<CPW, 8>(act, wq, ws, out, n, d, G, gpt, wpc,
                                   resident, s);
}

template <class Act>
int launch_gemv(Act act, const int8_t* wq, const float* ws, float* out, int n,
                int d, int G, int gpt, bool resident, cudaStream_t s) {
  const int chunks = (n + 511) / 512;
  int wpc = 1;
  while (wpc < kGemvWarps && 2 * wpc <= chunks &&
         ((size_t)d * wpc < kGemvMinWarps ||
          (chunks + wpc - 1) / wpc > kGemvMaxBatch))
    wpc *= 2;
  const int per = (chunks + wpc - 1) / wpc;
  if (d >= kGemvPairCols)
    return launch_gemv_cpw<2>(act, wq, ws, out, n, d, G, gpt, wpc, per,
                              resident, s);
  return launch_gemv_cpw<1>(act, wq, ws, out, n, d, G, gpt, wpc, per,
                            resident, s);
}

// ------------------------------------------------- Q8_0 x Q8_0, b > 1 ----
//
// The int32 group dots on the int8 tensor cores (mma.sync
// m16n8k32 s8 x s8 -> s32; m16n8k16 at G = 16, so that one MMA never spans
// two groups), the ordered fp32 scale-and-sum in the MMA's fragment layout.
// Activation rows are the MMA's M, weight columns its N: both operands are
// row-major [rows][k] bytes as stored, so A and B fragments are 32-bit
// words of staged rows. A block owns BM = 16 MI WMW rows x BN = 8 NI WNW
// columns; warp (wm, wn) owns a (16 MI) x (8 NI) piece, and each lane
// holds 4 MI NI outputs with their int32 dot, the k-tile's running sum
// acc_t and the output's sum o. Stages of kStageK bytes of k (the block's
// activation and weight rows, padded to kRowWords words so that a
// fragment's 32 words come from 32 banks, and the stage's group scales)
// fly in a cp.async ring of kStages, so the next stages load while this
// one's MMAs and epilogue run; one barrier a stage. Once a group's dots are
// done, each lane adds f32(dot) * (xs * ws) to its acc_t and, at a k-tile's
// end, acc_t to o: the plain version's order, so any tile shape, split or
// batch gives the same bits. With `part` (a k-split: blockIdx.z walks
// k-tiles [z tps, (z + 1) tps)), each k-tile's acc_t goes to part[t]
// instead, and q8q8_split_sum_kernel adds them in tile order. Rows, columns
// and k past the matrix load as zeros (their outputs are never stored).
//
// The weights come in one of two layouts (template parameter WL), with the
// same dots, epilogue and sum order, so both give the plain version's bits:
//  - kWRows: wq int8 [d, n], ws f32 [d, n/G], the checkpoint's rows
//    (q8_matmul.cu, q8_fused.cu), staged as the activations are;
//  - kWCols / kWCols4: wq int8 [n, d], ws f32 [n/G, d], the
//    contraction leading (q8_untiled.cu). A stage holds [kStageK k-rows][BN
//    columns] bytes, copied along d in 16-byte pieces (kWCols4: 4-byte
//    ones, for d % 16 != 0), the 16-byte chunks of k-row k at chunk ^ ((k
//    >> 2) & 3) so that the fragment loads below hit 8 distinct bank
//    groups; the scales [kScaleSlots][BN] f32. An s8 B fragment is a word
//    of 4 consecutive k of one column (mma.sync has only .row.col for s8),
//    which no load of these bytes gives. kWCols makes it in registers:
//    ldmatrix .trans of an 8 x 8 b16 matrix whose rows are k-rows gives a
//    lane a 2 k x 2 column byte block, so two such matrices (k-rows 4t,
//    4t + 1 and 4t + 2, 4t + 3) and two __byte_perm give the words of two
//    columns, 2 g and 2 g + 1 of the 16-byte chunk: n-tile 2 p of a warp
//    takes the chunk's even columns and n-tile 2 p + 1 its odd ones, so a
//    lane's outputs of a row are 4 consecutive columns (one 16-byte
//    store). Transposing the landed stage into the rows layout in a second
//    shared pass instead (4 x 4 byte blocks, __byte_perm, one more barrier)
//    was 10-21% slower over qwen3-0.6b's layer matrices at b = 64 and 512
//    on an H100, and is not built.
constexpr int kStageK = 64, kRowWords = kStageK / 4 + 4, kStages = 4;
constexpr int kScaleSlots = kStageK / 16;   // group scales a staged row
constexpr int kSlotsLog = kScaleSlots == 8 ? 3 : 2;
enum WeightLayout { kWRows = 0, kWCols = 1, kWCols4 = 2 };

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

// The shared memory of one tile kernel instance: the kStages slots (data,
// then the scales)
template <int BM, int BN, int WL>
__host__ __device__ constexpr int mma_slot_words() {
  return WL == kWRows ? (BM + BN) * kRowWords
                      : BM * kRowWords + kStageK * BN / 4;
}

template <int BM, int BN, int WL>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  return (size_t)kStages * (mma_slot_words<BM, BN, WL>() * sizeof(int) +
                            (BM + BN) * kScaleSlots * sizeof(float));
}

__device__ __forceinline__ void cp_async16_s(unsigned dst, const void* src,
                                             bool on) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(on ? 16 : 0));
}

__device__ __forceinline__ void cp_async4_s(unsigned dst, const void* src,
                                            bool on) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(on ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 16-byte matrices of shared memory, one row address a lane
// (lanes 8 q .. 8 q + 7: matrix q): lane (g, t) gets word t of row g of
// each, which is the m16n8k32 s8 fragment layout of A (matrices: rows 0-7
// and 8-15 at bytes 0-15, then both at bytes 16-31) and of two n-tiles of B
// (each: columns 0-7 at bytes 0-15, then 16-31).
__device__ __forceinline__ void ldsm_x4(int (&r)[4], const int* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// The same, transposed: lane (g, t) gets elements [2 t][g] and [2 t + 1][g]
// of each matrix (16 bits each), i.e. bytes 2 g, 2 g + 1 of rows 2 t and
// 2 t + 1. x2: matrices 0 and 1, row addresses from lanes 0-15.
__device__ __forceinline__ void ldsm_x4_trans(int (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x2_trans(int (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(s));
}

// c = a . b + (fresh ? 0 : c): a group's first k-step starts its dots at 0
template <int KM>
__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4],
                                       const int (&b)[2], bool fresh) {
  const int z = 0;
  if (KM == 32) {
    if (fresh)
      asm volatile(
          "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, "
          "%10};\n"
          : "=r"(c[0]), "=r"(c[1]), "=r"(c[2]), "=r"(c[3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]), "r"(z));
    else
      asm volatile(
          "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  } else {
    if (fresh)
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
          "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %7, %7, %7};\n"
          : "=r"(c[0]), "=r"(c[1]), "=r"(c[2]), "=r"(c[3])
          : "r"(a[0]), "r"(a[1]), "r"(b[0]), "r"(z));
    else
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
          "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
          : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
          : "r"(a[0]), "r"(a[1]), "r"(b[0]));
  }
}

// f32(v), exactly: for |v| < 2^22 (G <= 128: |dot| <= 128 * 128 G) the
// float 1.5 * 2^23 + v, built by one integer add, less 1.5 * 2^23 (one
// exact fadd), where the int-to-float conversion issues at a quarter of
// the fp32 rate
template <bool BIG>
__device__ __forceinline__ float dot_to_f32(int v) {
  return BIG ? __int2float_rn(v)
             : __fadd_rn(__int_as_float(0x4B400000 + v), -12582912.f);
}

// A lane's fragment outputs into dst [b, d]: entries (2 h + e) of n-tile j
// of m-tile i at row r + 16 i + 8 h, column c + 8 j + e, the two columns of
// a row as one 8-byte store where d is even (a warp's store then fills
// whole 32-byte sectors), rows and columns past the matrix skipped.
template <int MI, int NI>
__device__ __forceinline__ void store_tile(const float (&v)[MI][NI][4],
                                           float* __restrict__ dst, int b,
                                           int d, int r, int c) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 16 * i + 8 * h;
      if (row >= b) continue;
      float* drow = dst + (size_t)row * d;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int col = c + 8 * j;
        if ((d & 1) == 0 && col + 1 < d) {
          *reinterpret_cast<float2*>(drow + col) =
              make_float2(v[i][j][2 * h], v[i][j][2 * h + 1]);
        } else {
          if (col < d) drow[col] = v[i][j][2 * h];
          if (col + 1 < d) drow[col + 1] = v[i][j][2 * h + 1];
        }
      }
    }
}

// The same for kWCols: n-tiles 2 p and 2 p + 1 hold the even and odd
// columns of 16, so a lane's entries of a row are columns c + 16 p .. + 3
// (c = the warp's first column + 4 tig), one 16-byte store (d % 4 == 0).
template <int MI, int NI>
__device__ __forceinline__ void store_tile4(const float (&v)[MI][NI][4],
                                            float* __restrict__ dst, int b,
                                            int d, int r, int c) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 16 * i + 8 * h;
      if (row >= b) continue;
#pragma unroll
      for (int p = 0; p < NI / 2; ++p) {
        const int col = c + 16 * p;
        if (col < d)
          *reinterpret_cast<float4*>(dst + (size_t)row * d + col) =
              make_float4(v[i][2 * p][2 * h], v[i][2 * p + 1][2 * h],
                          v[i][2 * p][2 * h + 1], v[i][2 * p + 1][2 * h + 1]);
      }
    }
}

template <int MI, int NI, int WMW, int WNW, int KM, bool BIG, int WL>
__global__ void __launch_bounds__(32 * WMW * WNW)
q8q8_mma_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                const int8_t* __restrict__ wq, const float* __restrict__ ws,
                float* __restrict__ out, float* __restrict__ part, int b,
                int n, int d, int G, int gpt, int tps) {
  constexpr int BM = 16 * MI * WMW, BN = 8 * NI * WNW;
  constexpr int T = 32 * WMW * WNW, ROWS = BM + BN;
  constexpr bool KN = WL != kWRows;           // wq [n, d]
  constexpr int PB = WL == kWCols4 ? 4 : 16;  // bytes a weight copy ([n, d])
  constexpr int SW = mma_slot_words<BM, BN, WL>();
  extern __shared__ int4 mma_smem[];
  int* data = reinterpret_cast<int*>(mma_smem);   // [kStages][SW]
  float* scl = reinterpret_cast<float*>(data + kStages * SW);
  const int ng = n / G, tk = gpt * G, nt = ng / gpt;
  const int lg = 31 - __clz(G);                  // G = 2^lg
  const int r0 = blockIdx.y * BM, c0 = blockIdx.x * BN;
  const int t0 = blockIdx.z * tps, t1 = min(nt, t0 + tps);
  const int kbeg = t0 * tk, kend = min(n, t1 * tk), gend = kend >> lg;
  const int nst = (kend - kbeg + kStageK - 1) / kStageK;
  const int lgs = max(0, kSlotsLog - lg + 4);    // log2 of the stage's groups
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp / WNW, wn = warp % WNW;
  const int wr = wm * 16 * MI, wc = BM + wn * 8 * NI;   // the warp's rows
  static_assert(NI % 2 == 0, "B fragments load two n-tiles at a time");
  static_assert(!KN || BN == kStageK, "an [n, d] stage is square");
  // the lane's ldmatrix row: A's row (lane & 15) at byte 16 (lane >> 4);
  // B's column 8 (lane >> 4) + (lane & 7) at byte 16 ((lane >> 3) & 1)
  const int a_off = (lane & 15) * kRowWords + 4 * (lane >> 4);
  const int b_off =
      (8 * (lane >> 4) + (lane & 7)) * kRowWords + 4 * ((lane >> 3) & 1);
  // kWCols: the lane's row of matrix q = lane >> 3 is k-row kb of the
  // k-step (q odd: 4 t + 2, 4 t + 3; q >= 2: the step's second 16 k), and
  // chunk wn NI / 2 + p of the warp's columns sits at that ^ (i >> 1)
  const int li = lane & 7, lq = lane >> 3;
  const int kb = 16 * (lq >> 1) + 4 * (li >> 1) + (li & 1) + 2 * (lq & 1);

  // each thread's copies, fixed but for k: 16-byte pieces of staged rows
  // (or PB-byte pieces of [n, d] k-rows) and group scales (rows past the
  // matrix load zeros; a copy past the staged rows is none, since a
  // zero-filling one would still write). Its shared addresses are taken
  // once, its sources advance a stage at a time: at these sizes the kernel
  // is bound by instruction issue
  static_assert((kStages & (kStages - 1)) == 0, "a power-of-two ring");
  constexpr int kPieces = kStageK / 16;
  constexpr int NA = (KN ? BM : ROWS) * kPieces;       // [rows][k] pieces
  constexpr int NB = KN ? kStageK * (BN / PB) : 0;     // [k][cols] pieces
  constexpr int CP = (NA + NB + T - 1) / T;
  constexpr int SA = (KN ? BM : ROWS) * kScaleSlots;   // 4-byte [rows][g]
  constexpr int SB = KN ? kScaleSlots * (BN / 4) : 0;  // 16-byte [g][cols]
  constexpr int CS = (SA + SB + T - 1) / T;
  constexpr unsigned kNoCopy = 0xffffffffu;
  constexpr unsigned kSlotBytes = SW * sizeof(int);
  constexpr unsigned kScaleSlotBytes = ROWS * kScaleSlots * sizeof(float);
  const unsigned data_s = (unsigned)__cvta_generic_to_shared(data);
  const unsigned scl_s = (unsigned)__cvta_generic_to_shared(scl);
  const size_t kstep = KN ? (size_t)kStageK * d : 0;   // an [n, d] stage
  const int8_t* psrc[CP];
  unsigned pdst[CP];
  int pk[CP];
  bool pon[CP], pkn[CP];
#pragma unroll
  for (int c = 0; c < CP; ++c) {
    const int e = tid + c * T;
    pkn[c] = KN && e >= NA;
    if (pkn[c]) {   // [n, d]: k-row kr, bytes PB w .. of the block's columns
      const int f = e - NA, kr = f / (BN / PB), w = f % (BN / PB);
      const int col = c0 + PB * w, ch = PB * w / 16;
      pon[c] = f < NB && col < d;
      pk[c] = kr;
      psrc[c] = pon[c] ? wq + (size_t)(kbeg + kr) * d + col : xq;
      pdst[c] = f < NB ? data_s + BM * kRowWords * sizeof(int) + kr * BN +
                             16 * (ch ^ ((kr >> 2) & 3)) + PB * w % 16
                       : kNoCopy;
      continue;
    }
    const int r = e / kPieces;
    const bool isx = r < BM;
    const int gr = isx ? r0 + r : c0 + r - BM;
    pon[c] = isx ? gr < b : gr < d;
    pk[c] = 16 * (e % kPieces);
    psrc[c] = pon[c] ? (isx ? xq : wq) + (size_t)gr * n + kbeg + pk[c] : xq;
    pdst[c] = e < NA ? data_s + (r * kRowWords + pk[c] / 4) * sizeof(int)
                     : kNoCopy;
  }
  const float* ssrc[CS];
  unsigned sdst[CS];
  int sj[CS];
  bool son[CS], skn[CS];
#pragma unroll
  for (int c = 0; c < CS; ++c) {
    const int e = tid + c * T;
    skn[c] = KN && e >= SA;
    if (skn[c]) {   // [n/G, d]: slot j's scales of columns c0 + 4 q ..
      const int f = e - SA, j = f / (BN / 4), q = f % (BN / 4);
      son[c] = f < SB && c0 + 4 * q < d;
      sj[c] = j;
      ssrc[c] = son[c] ? ws + (size_t)j * d + c0 + 4 * q : xs;
      sdst[c] = f < SB && j < (1 << lgs)
                    ? scl_s + (BM * kScaleSlots + j * BN + 4 * q) *
                                  sizeof(float)
                    : kNoCopy;
      continue;
    }
    const int r = e >> lgs, j = e & ((1 << lgs) - 1);
    const bool isx = r < BM;
    const int gr = isx ? r0 + r : c0 + r - BM;
    son[c] = isx ? gr < b : gr < d;
    sj[c] = j;
    ssrc[c] = son[c] ? (isx ? xs : ws) + (size_t)gr * ng + j : xs;
    sdst[c] = e < ((KN ? BM : ROWS) << lgs)
                  ? scl_s + (r * kScaleSlots + j) * sizeof(float)
                  : kNoCopy;
  }

  auto load = [&](int st) {   // called for st = 0, 1, 2, ... in order
    if (st < nst) {
      const int k0 = kbeg + st * kStageK;
      const unsigned so = (st & (kStages - 1)) * kSlotBytes;
      const bool full = k0 + kStageK <= kend;
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        const bool on = pon[c] && (full || k0 + pk[c] < kend);
        if (pdst[c] != kNoCopy) {
          if (PB == 4 && pkn[c])
            cp_async4_s(pdst[c] + so, on ? psrc[c] : xq, on);
          else
            cp_async16_s(pdst[c] + so, on ? psrc[c] : xq, on);
        }
        if (pon[c]) {
          if (pkn[c])
            psrc[c] += kstep;
          else
            psrc[c] += kStageK;
        }
      }
      const unsigned sso = (st & (kStages - 1)) * kScaleSlotBytes;
      const int g0 = k0 >> lg;
#pragma unroll
      for (int c = 0; c < CS; ++c) {
        const bool on = son[c] && g0 + sj[c] < gend;
        if (sdst[c] != kNoCopy) {
          if (skn[c])
            cp_async16_s(sdst[c] + sso, on ? ssrc[c] + (size_t)g0 * d : xs,
                         on);
          else
            cp_async4_s(sdst[c] + sso, on ? ssrc[c] + g0 : ssrc[c], on);
        }
      }
    }
    cp_async_commit();
  };

  int dot[MI][NI][4];
  float acc[MI][NI][4], o[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dot[i][j][e] = 0;   // set by each group's first MMA
        acc[i][j][e] = o[i][j][e] = 0.f;
      }

  int gt = 0, t_cur = t0;   // groups into the k-tile, and the k-tile
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load(s);
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // stage st has landed; slot st - 1 is free again
    load(st + kStages - 1);
    const int slot = st % kStages, k0 = kbeg + st * kStageK;
    const int* A = data + (KN ? slot * SW + wr * kRowWords
                              : (slot * ROWS + wr) * kRowWords);
    const int* B = data + (slot * ROWS + wc) * kRowWords;   // kWRows
    // [n, d]: the landed [k][BN] bytes, and the [cols] scales of a slot
    const char* Bk = reinterpret_cast<const char*>(data + slot * SW +
                                                   BM * kRowWords);
    const float* sx = scl + (slot * ROWS + wr) * kScaleSlots;
    const float* sw = scl + (slot * ROWS + wc) * kScaleSlots;
    const float* swc = scl + (slot * ROWS + BM) * kScaleSlots + (wc - BM);
#pragma unroll
    for (int ks = 0; ks < kStageK / KM; ++ks) {
      const int kw = ks * KM / 4 + tig;
      const bool fresh = ((k0 + ks * KM) & (G - 1)) == 0;
      int a[MI][4], bf[NI][2];
      if (KM == 32) {
#pragma unroll
        for (int i = 0; i < MI; ++i)
          ldsm_x4(a[i], A + 16 * i * kRowWords + ks * 8 + a_off);
      } else {   // m16n8k16: words 0 of A's two row halves
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const int* ar = A + (16 * i + gid) * kRowWords + kw;
          a[i][0] = ar[0];
          a[i][1] = ar[8 * kRowWords];
          a[i][2] = a[i][3] = 0;
        }
      }
      if constexpr (WL == kWCols || WL == kWCols4) {
        // chunk (wc - BM) / 16 + p of the k-step's rows; its even columns
        // are n-tile 2 p, its odd ones 2 p + 1
#pragma unroll
        for (int p = 0; p < NI / 2; ++p) {
          const int ch = (wc - BM) / 16 + p;
          int r[4];
          if (KM == 32) {
            ldsm_x4_trans(r, Bk + (ks * 32 + kb) * BN + 16 * (ch ^ (li >> 1)));
          } else {   // matrices 0, 1: k-rows 4 t .. 4 t + 3 of 16
            const int k = ks * 16 + 4 * (li >> 1) + (li & 1) + 2 * (lq & 1);
            ldsm_x2_trans(r, Bk + k * BN + 16 * (ch ^ ((k >> 2) & 3)));
            r[2] = r[3] = 0;
          }
          bf[2 * p][0] = __byte_perm(r[0], r[1], 0x6420);
          bf[2 * p + 1][0] = __byte_perm(r[0], r[1], 0x7531);
          bf[2 * p][1] = __byte_perm(r[2], r[3], 0x6420);
          bf[2 * p + 1][1] = __byte_perm(r[2], r[3], 0x7531);
        }
      } else if (KM == 32) {
#pragma unroll
        for (int j = 0; j < NI; j += 2) {
          int r[4];
          ldsm_x4(r, B + 8 * j * kRowWords + ks * 8 + b_off);
          bf[j][0] = r[0];
          bf[j][1] = r[1];
          bf[j + 1][0] = r[2];
          bf[j + 1][1] = r[3];
        }
      } else {   // m16n8k16: word 0 of B
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          bf[j][0] = B[(8 * j + gid) * kRowWords + kw];
          bf[j][1] = 0;
        }
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_s8<KM>(dot[i][j], a[i], bf[j], fresh);
      const int kn = k0 + (ks + 1) * KM;   // the k-step's end
      if (kn & (G - 1)) continue;          // the group goes on
      const int g = (kn >> lg) - 1;
      if (g >= gend) continue;             // past the matrix: zeros only
      {
        const int js = g - (k0 >> lg);     // 0 when a group spans stages
        float xv[MI][2], wv[NI][2];
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            xv[i][h] = sx[(16 * i + gid + 8 * h) * kScaleSlots + js];
        if constexpr (WL == kWCols || WL == kWCols4) {
#pragma unroll
          for (int p = 0; p < NI / 2; ++p) {
            const float4 s4 = *reinterpret_cast<const float4*>(
                swc + js * BN + 16 * p + 4 * tig);
            wv[2 * p][0] = s4.x;
            wv[2 * p + 1][0] = s4.y;
            wv[2 * p][1] = s4.z;
            wv[2 * p + 1][1] = s4.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < NI; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              wv[j][e] = KN ? swc[js * BN + 8 * j + 2 * tig + e]
                            : sw[(8 * j + 2 * tig + e) * kScaleSlots + js];
        }
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int j = 0; j < NI; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float& s = acc[i][j][2 * h + e];
                s = __fadd_rn(s, __fmul_rn(dot_to_f32<BIG>(dot[i][j][2 * h + e]),
                                           __fmul_rn(xv[i][h], wv[j][e])));
              }
          }
      }
      if (++gt < gpt) continue;            // the k-tile goes on
      gt = 0;
      const int t = t_cur++;
      if (part) {
        if constexpr (WL == kWCols || WL == kWCols4)
          store_tile4<MI, NI>(acc, part + (size_t)t * b * d, b, d,
                              r0 + wr + gid, c0 + wc - BM + 4 * tig);
        else
          store_tile<MI, NI>(acc, part + (size_t)t * b * d, b, d,
                             r0 + wr + gid, c0 + wc - BM + 2 * tig);
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NI; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      } else {
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NI; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              o[i][j][e] = __fadd_rn(o[i][j][e], acc[i][j][e]);
              acc[i][j][e] = 0.f;
            }
      }
    }
  }
  cp_async_wait<0>();
  if constexpr (WL == kWCols || WL == kWCols4) {
    if (!part)
      store_tile4<MI, NI>(o, out, b, d, r0 + wr + gid, c0 + wc - BM + 4 * tig);
  } else {
    if (!part)
      store_tile<MI, NI>(o, out, b, d, r0 + wr + gid, c0 + wc - BM + 2 * tig);
  }
}

// A k-split's second pass: out = the k-tiles' sums part[t] added in tile
// order from 0, one thread a (row, column).
__global__ void q8q8_split_sum_kernel(const float* __restrict__ part,
                                      float* __restrict__ out, int bd,
                                      int nt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= bd) return;
  float o = 0.f;
  for (int t = 0; t < nt; ++t) o = __fadd_rn(o, part[(size_t)t * bd + i]);
  out[i] = o;
}

template <int MI, int NI, int WMW, int WNW, int KM, bool BIG, int WL>
int launch_mma_shape(const int8_t* xq, const float* xs, const int8_t* wq,
                     const float* ws, float* out, float* part, int b, int n,
                     int d, int G, int gpt, int splits, cudaStream_t s) {
  static size_t set[16] = {};
  constexpr int BM = 16 * MI * WMW, BN = 8 * NI * WNW;
  const size_t smem = mma_smem_bytes<BM, BN, WL>();
  auto kernel = q8q8_mma_kernel<MI, NI, WMW, WNW, KM, BIG, WL>;
  const int err = allow_smem(kernel, smem, set);
  if (err) return err;
  const int nt = n / G / gpt;
  const int tps = (nt + splits - 1) / splits;
  const dim3 blocks((unsigned)((d + BN - 1) / BN), (unsigned)((b + BM - 1) / BM),
                    (unsigned)((nt + tps - 1) / tps));
  kernel<<<blocks, 32 * WMW * WNW, smem, s>>>(
      xq, xs, wq, ws, out, blocks.z > 1 ? part : nullptr, b, n, d, G, gpt, tps);
  int e = (int)cudaGetLastError();
  if (e || blocks.z == 1) return e;
  const int bd = b * d;
  q8q8_split_sum_kernel<<<(bd + 255) / 256, 256, 0, s>>>(part, out, bd, nt);
  return (int)cudaGetLastError();
}

// The tile shapes by `shape` (ops/cuda/q8_matmul.py::plan_q8q8 picks it
// from b): 0: 16 rows, 1: 32, 2: 64, all 64 columns.
template <int KM, bool BIG, int WL = kWRows>
int launch_mma(const int8_t* xq, const float* xs, const int8_t* wq,
               const float* ws, float* out, float* part, int b, int n, int d,
               int G, int gpt, int shape, int splits, cudaStream_t s) {
  switch (shape) {
    case 0:
      return launch_mma_shape<1, 2, 1, 4, KM, BIG, WL>(
          xq, xs, wq, ws, out, part, b, n, d, G, gpt, splits, s);
    case 1:
      return launch_mma_shape<2, 2, 1, 4, KM, BIG, WL>(
          xq, xs, wq, ws, out, part, b, n, d, G, gpt, splits, s);
    case 2:
      return launch_mma_shape<2, 4, 2, 2, KM, BIG, WL>(
          xq, xs, wq, ws, out, part, b, n, d, G, gpt, splits, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- fast ----
//
// bf16 activations times the Q8_0 weights dequantized to bf16, summed in
// fp32 (csrc/q8_matmul.cu's notes give the function and the design):
//  - q8_fast_split_kernel (b <= 8, and b > 8 where the host's planner,
//    ops/cuda/q8_matmul.py::plan_fast, picks it): the group split, a thread
//    a (column, group) chain for the block's rows, the activations staged
//    as padded f32 in shared memory, through Act::raw8, which reads bf16
//    values or (the fused call at b = 1) makes bf16(prologue(x)) once per
//    (block, k);
//  - q8_fast_tile_kernel (b > 8 on plan_fast's tile shapes): a
//    register-blocked, cp.async-pipelined tile on bf16 activations made by
//    an earlier op (below).
constexpr int kFastMinBlocks = 256;       // about two blocks an SM
// above this many columns the split kernel gives a thread two of them
constexpr int kFastWideCols = 4224;
constexpr int kFastSmemBudget = 112 * 1024;

template <int R, int TN, class Act>
__global__ void q8_fast_split_kernel(Act act, const int8_t* __restrict__ wq,
                                     const float* __restrict__ ws,
                                     float* __restrict__ out, int b, int n,
                                     int d, int G, int WG, int WC) {
  extern __shared__ float4 fast_smem[];
  constexpr int GW = 8 * TN;   // groups of a warp
  constexpr int SL = 32 / GW;  // column slots of a warp, TN columns each
  // lane l: group l / SL, slot l % SL, so a quarter-warp reads the float4s
  // of 8 / SL groups, each shared by SL lanes
  const int GP = GW * WG, CB = SL * TN * WC, T = 32 * WG * WC;
  const int GS = G + 4;  // a group's padded stride in x_sm, in words
  float* x_sm = reinterpret_cast<float*>(fast_smem);   // [R][GP][GS]
  float* part = x_sm + (size_t)R * GP * GS;            // [R][CB][GP + 1]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gl = (warp % WG) * GW + lane / SL;           // group in the pass
  const int cl = ((warp / WG) * SL + lane % SL) * TN;    // first column
  const int c = blockIdx.x * CB + cl;
  const int r0 = blockIdx.y * R;
  const int rows = min(R, b - r0);
  const int ng = n / G;
  const int segs = G / 16;  // 16-byte weight loads a group
  float o[4] = {0.f, 0.f, 0.f, 0.f};  // the ordered sums of pairs tid + i T

  for (int g0 = 0; g0 < ng; g0 += GP) {
    const int g = g0 + gl;
    int4 raw[TN][4];
    float sc[TN];
#pragma unroll
    for (int t = 0; t < TN; ++t) {
      sc[t] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) raw[t][j] = make_int4(0, 0, 0, 0);
      if (g < ng && c + t < d) {
        const int8_t* wp = wq + (size_t)(c + t) * n + (size_t)g * G;
        sc[t] = ws[(size_t)(c + t) * ng + g];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < segs)
            raw[t][j] = __ldg(reinterpret_cast<const int4*>(wp) + j);
      }
    }
    // the pass's activations, rows r0.. (zeros past b), k from g0 G
    const int vecs = (min(ng, g0 + GP) - g0) * G / 8;  // 8 values a row
    __syncthreads();  // the last pass's x_sm and part have been read
    for (int e = tid; e < R * vecs; e += T) {
      const int r = e / vecs, v = e % vecs;
      const int4 xv = act.raw8(r0 + r, g0 * G + 8 * v, n, r < rows);
      const int k = 8 * v;
      float* dst = x_sm + ((size_t)r * GP + k / G) * GS + k % G;
      const unsigned short* h = reinterpret_cast<const unsigned short*>(&xv);
      reinterpret_cast<float4*>(dst)[0] =
          make_float4(bf16_bits_to_f32(h[0]), bf16_bits_to_f32(h[1]),
                      bf16_bits_to_f32(h[2]), bf16_bits_to_f32(h[3]));
      reinterpret_cast<float4*>(dst)[1] =
          make_float4(bf16_bits_to_f32(h[4]), bf16_bits_to_f32(h[5]),
                      bf16_bits_to_f32(h[6]), bf16_bits_to_f32(h[7]));
    }
    __syncthreads();
    if (g < ng) {
      float s[TN][R];
#pragma unroll
      for (int t = 0; t < TN; ++t)
#pragma unroll
        for (int r = 0; r < R; ++r) s[t][r] = 0.f;
      const float* xg = x_sm + (size_t)gl * GS;
      for (int k0 = 0; k0 < G; k0 += 64) {
        if (k0 > 0) {
#pragma unroll
          for (int t = 0; t < TN; ++t)
            if (c + t < d) {
              const int8_t* wp = wq + (size_t)(c + t) * n + (size_t)g * G + k0;
#pragma unroll
              for (int j = 0; j < 4; ++j)
                raw[t][j] = __ldg(reinterpret_cast<const int4*>(wp) + j);
            }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < segs) {
            float w[TN][16];
#pragma unroll
            for (int t = 0; t < TN; ++t) {
              const int8_t* q = reinterpret_cast<const int8_t*>(&raw[t][j]);
#pragma unroll
              for (int i = 0; i < 16; ++i)
                w[t][i] = round_bf16(__fmul_rn((float)q[i], sc[t]));
            }
#pragma unroll
            for (int qd = 0; qd < 4; ++qd) {
              const int k = k0 + 16 * j + 4 * qd;
#pragma unroll
              for (int r = 0; r < R; ++r) {
                const float4 xv = *reinterpret_cast<const float4*>(
                    xg + (size_t)r * GP * GS + k);
#pragma unroll
                for (int t = 0; t < TN; ++t) {
                  s[t][r] = fmaf(xv.x, w[t][4 * qd], s[t][r]);
                  s[t][r] = fmaf(xv.y, w[t][4 * qd + 1], s[t][r]);
                  s[t][r] = fmaf(xv.z, w[t][4 * qd + 2], s[t][r]);
                  s[t][r] = fmaf(xv.w, w[t][4 * qd + 3], s[t][r]);
                }
              }
            }
          }
        }
      }
#pragma unroll
      for (int t = 0; t < TN; ++t)
#pragma unroll
        for (int r = 0; r < R; ++r)
          part[((size_t)r * CB + cl + t) * (GP + 1) + gl] = s[t][r];
    }
    __syncthreads();
    const int gn = min(GP, ng - g0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = tid + i * T;  // pair (row p / CB, column p % CB)
      if (p < R * CB) {
        const float* ps = part + (size_t)p * (GP + 1);
        for (int j = 0; j < gn; ++j) o[i] = __fadd_rn(o[i], ps[j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = tid + i * T;
    const int r = p / CB, col = blockIdx.x * CB + p % CB;
    if (p < R * CB && r < rows && col < d)
      out[(size_t)(r0 + r) * d + col] = o[i];
  }
}

template <int R, int TN, class Act>
int launch_fast_split(Act act, const int8_t* wq, const float* ws, float* out,
                      int b, int n, int d, int G, cudaStream_t s) {
  static size_t set[16] = {};
  constexpr int GW = 8 * TN;
  const int ng = n / G;
  const size_t wg_bytes = (size_t)R * GW * (G + 4) * sizeof(float);
  int WG = max(1, min((ng + GW - 1) / GW, (R <= 8 ? 64 : GW) / GW));
  while (WG > 1 && WG * wg_bytes > (size_t)kFastSmemBudget) --WG;
  const int row_tiles = (b + R - 1) / R;
  int WC = 1;
  for (int w = WG == 1 ? 8 : WG == 2 ? 4 : 2; w > 1; w /= 2)
    if ((size_t)((d + 4 * w - 1) / (4 * w)) * row_tiles >= kFastMinBlocks) {
      WC = w;
      break;
    }
  const int GP = GW * WG, CB = 4 * WC;
  const size_t smem = wg_bytes * WG +
                      (size_t)R * CB * (GP + 1) * sizeof(float);
  auto kernel = q8_fast_split_kernel<R, TN, Act>;
  const int err = allow_smem(kernel, smem, set);
  if (err) return err;
  const dim3 blocks((unsigned)((d + CB - 1) / CB), (unsigned)row_tiles);
  kernel<<<blocks, 32 * WG * WC, smem, s>>>(act, wq, ws, out, b, n, d, G, WG,
                                            WC);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------- the fast tile ----
//
// q8_fast_tile_kernel: a register-blocked tile of the fast function on CUDA
// cores (csrc/q8_matmul.cu's notes give the design and its times). A block
// owns BM rows x BN columns and runs W slices of kFastThreads threads; slice
// j computes groups j, j + W, ... of the block's outputs, so that a call of
// few rows and columns still has warps enough (a group's chain s_g starts
// at 0 and needs no other group). In a slice, thread (ty, tx) owns a TM x
// TN piece: rows q * BM / RQ + 4 ty + i and columns q * BN / CQ + 4 tx + j
// (i, j < 4), so that each k costs it RQ + CQ 16-byte shared loads for TM
// TN FMAs; a warp holds 8 ty x 4 tx, so that each of its loads is one
// shared-memory wavefront. A slice's k goes in stages of kFastK rows
// through two shared buffers of its own: the activations widened to f32 and
// transposed ([kFastK][BM]) and the weights dequantized once while staging
// ([kFastK][BN] f32, bf16_rn(f32(wq) * ws)), each staged weight serving BM
// rows. The raw copies of the next kFastRing - 1 stages (16-byte pieces of
// the bf16 rows, 8- or 16-byte pieces of the int8 columns, a scale a
// thread) fly by cp.async into a ring that only the copying thread reads
// back, so that no register holds them; halfway through a stage's FMAs each
// thread turns its landed copies of the next stage into the other buffer;
// one barrier a stage for the whole block. A thread keeps its chains s_g in
// registers. At the end of a round of W groups, slices 1 .. W - 1 park
// theirs in shared memory (two buffers by round), and after the barrier
// slice 0 adds the round's chains to its running sums, kept in shared
// memory (its own slots), in group order: o = ((o + s_g) + s_g+1) + ...
// from o = 0, the plain version's order, so every shape, W and b gives the
// same bits.
constexpr int kFastK = 16, kFastRing = 3, kFastThreads = 128;

// One raw stage of a slice: its bf16 activations, its int8 weights, one
// scale a thread
template <int BM, int BN>
__host__ __device__ constexpr int fast_raw_bytes() {
  return BM * kFastK * 2 + BN * kFastK + kFastThreads * 4;
}
// A slice's shared memory: x [2][kFastK][BM] f32, the weights
// [2][kFastK][BN] f32, its raw ring
template <int BM, int BN>
__host__ __device__ constexpr int fast_slice_bytes() {
  return 2 * kFastK * (BM + BN) * 4 + kFastRing * fast_raw_bytes<BM, BN>();
}
// The block's dynamic shared memory: W slices, the running sums (BM x BN
// f32), then the parked chains of slices 1 .. W - 1, two rounds' worth
template <int BM, int BN, int W>
__host__ __device__ constexpr int fast_tile_smem() {
  return W * fast_slice_bytes<BM, BN>() + BM * BN * 4 +
         2 * (W - 1) * BM * BN * 4;
}

__device__ __forceinline__ void cp_async8_s(unsigned dst, const void* src,
                                            bool on) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(on ? 8 : 0));
}

// byte j of w as f32, exactly: its sign-extended value added to 1.5 * 2^23
// in the float's bits, then 1.5 * 2^23 taken off
__device__ __forceinline__ float i8_to_f32(unsigned w, int j) {
  const int q = (int)(w << (24 - 8 * j)) >> 24;
  return __fadd_rn(__int_as_float(0x4B400000 + q), -12582912.f);
}

// The rows a tile reads and writes, by a policy class:
//  - x_row(r): the bf16 row behind the tile's row column r (the column of
//    the transposed x buffer), null where the column holds no row;
//  - w_row(cw): the weight row behind tile column cw, -1 past the matrix;
//  - store(rc, tx, o): the outputs of tile row column rc, tile columns
//    q * BN / CQ + 4 tx + j (q < CQ, j < 4), from o[q] (f32 sums).
// DenseRows is the matmul's: rows r0 .. r0 + BM - 1 of x and out in order.
struct DenseRows {
  const unsigned short* x;
  float* out;
  int b, n, d, r0, c0;
  __device__ __forceinline__ const unsigned short* x_row(int r) const {
    return r0 + r < b ? x + (size_t)(r0 + r) * n : nullptr;
  }
  __device__ __forceinline__ int w_row(int cw) const {
    return c0 + cw < d ? c0 + cw : -1;
  }
  template <int BN, int CQ>
  __device__ __forceinline__ void store(int rc, int tx,
                                        const float4 (&o)[CQ]) const {
    const int r = r0 + rc;
    if (r >= b) return;
#pragma unroll
    for (int q = 0; q < CQ; ++q) {
      const int c = c0 + q * (BN / CQ) + 4 * tx;
      float* dst = out + (size_t)r * d + c;
      if ((d & 3) == 0 && c + 3 < d) {
        *reinterpret_cast<float4*>(dst) = o[q];
      } else {
        const float v[4] = {o[q].x, o[q].y, o[q].z, o[q].w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < d) dst[j] = v[j];
      }
    }
  }
};

// requires n % G == 0, G a power of two in [16, 512], the rows' x, wq, ws
// and out 16-byte aligned. The FMAs run for the thread's rows i < NR only
// (NR = TM but for a tile whose rows past 8 NR hold no row, see ExpertRows)
template <int BM, int BN, int TM, int TN, int W, int NR, class Rows>
__device__ __forceinline__ void fast_tile(const Rows& rows,
                                          const int8_t* __restrict__ wq,
                                          const float* __restrict__ ws, int n,
                                          int G) {
  constexpr int NT = kFastThreads, TX = BN / TN, RQ = TM / 4, CQ = TN / 4;
  static_assert(TX * (BM / TM) == NT && TX % 4 == 0 && BM / TM == 8,
                "a slice's warps tile the block, 8 x 4 threads each");
  static_assert(NR >= 1 && NR <= TM, "live rows a thread");
  constexpr int RL = (NR + 3) / 4;           // x loads a k: the live quads
  constexpr int XC = BM * kFastK * 2 / 16;   // 16-byte x pieces a stage
  static_assert(XC == NT, "one x piece a thread");
  constexpr int WP = NT / BN;                // pieces of a weight column
  constexpr int WB = kFastK / WP;            // bytes a piece: 16 or 8
  static_assert(WP * BN == NT && (WB == 16 || WB == 8), "a piece a thread");
  constexpr int RB = fast_raw_bytes<BM, BN>();
  constexpr int SQ = TM * CQ;                // float4 slots a thread's piece
  extern __shared__ int4 fast_tile_smem_[];
  char* sm = reinterpret_cast<char*>(fast_tile_smem_);
  const int slice = threadIdx.x / NT, t = threadIdx.x % NT;
  char* own = sm + slice * fast_slice_bytes<BM, BN>();
  auto xs = reinterpret_cast<float (*)[kFastK][BM]>(own);
  auto wsm = reinterpret_cast<float (*)[kFastK][BN]>(own + 2 * kFastK * BM * 4);
  char* raw = own + 2 * kFastK * (BM + BN) * 4;
  float4* osm = reinterpret_cast<float4*>(sm + W * fast_slice_bytes<BM, BN>());
  float4* park = osm + SQ * NT;   // [2][W - 1][SQ][NT]
  // a warp takes 8 ty x 4 tx: its x loads read 8 float4s, its weight
  // loads 4, one wavefront each
  const int lane = t & 31, wp = t >> 5;
  const int tx = (wp % (TX / 4)) * 4 + (lane & 3);
  const int ty = (wp / (TX / 4)) * 8 + (lane >> 2);
  const int ng = n / G;
  const int spg = G / kFastK, lsg = 31 - __clz(spg);   // stages a group
  const int rounds = (ng + W - 1) / W, niter = rounds * spg;
  // this thread's weight piece: bytes pw * WB .. of column cw's stage
  const int cw = t % BN, pw = t / BN;
  const int wr = rows.w_row(cw);
  const bool won = wr >= 0;
  const int8_t* wsrc = wq + (size_t)(won ? wr : 0) * n + pw * WB;
  const float* ssrc = ws + (size_t)(won ? wr : 0) * ng;
  // this thread's x piece: row column t % BM, k-half t / BM, so that a
  // warp's pieces land in one row of the transposed buffer
  const unsigned short* xrow = rows.x_row(t % BM);
  const bool xon = xrow != nullptr;
  const unsigned raw_s = (unsigned)__cvta_generic_to_shared(raw);
  // the group of the slice's iteration it (>= ng: idle)
  auto group = [&](int it) { return (it >> lsg) * W + slice; };

  // iteration it's copies into raw stage it % kFastRing, one commit group
  // (empty when idle)
  auto fetch = [&](int it) {
    const int g = group(it);
    if (it < niter && g < ng) {
      const int k0 = g * G + (it & (spg - 1)) * kFastK;
      const unsigned st = raw_s + (it % kFastRing) * RB;
      const int h = t / BM;
      cp_async16_s(st + 16 * t,
                   xon ? (const void*)(xrow + k0 + 8 * h) : (const void*)wq,
                   xon);
      const unsigned sw = st + XC * 16;
      if constexpr (WB == 16)
        cp_async16_s(sw + 16 * t, wsrc + k0, won);
      else
        cp_async8_s(sw + 8 * t, wsrc + k0, won);
      cp_async4_s(sw + NT * WB + 4 * t, ssrc + g, won);
    }
    cp_async_commit();
  };

  // iteration it's copies, landed (this thread's own), into shared buffer
  // it & 1: x widened and transposed, the weights dequantized to bf16
  // values. Without a branch, so that it interleaves with the FMAs: an idle
  // iteration stashes stale bytes that no sum takes
  auto stash = [&](int it) {
    cp_async_wait<kFastRing - 2>();
    const int buf = it & 1;
    const char* st = raw + (it % kFastRing) * RB;
    {
      const int r = t % BM, h = t / BM;
      const int4 q = reinterpret_cast<const int4*>(st)[t];
      const unsigned u[4] = {(unsigned)q.x, (unsigned)q.y, (unsigned)q.z,
                             (unsigned)q.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        xs[buf][8 * h + 2 * j][r] = __uint_as_float(u[j] << 16);
        xs[buf][8 * h + 2 * j + 1][r] = __uint_as_float(u[j] & 0xffff0000u);
      }
    }
    const char* sw = st + XC * 16;
    const float sc = reinterpret_cast<const float*>(sw + NT * WB)[t];
    unsigned u[WB / 4];
    if constexpr (WB == 16) {
      const int4 q = reinterpret_cast<const int4*>(sw)[t];
      u[0] = q.x; u[1] = q.y; u[2] = q.z; u[3] = q.w;
    } else {
      const int2 q = reinterpret_cast<const int2*>(sw)[t];
      u[0] = q.x; u[1] = q.y;
    }
#pragma unroll
    for (int j = 0; j < WB / 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        wsm[buf][pw * WB + 4 * j + e][cw] =
            round_bf16(__fmul_rn(i8_to_f32(u[j], e), sc));
  };

  float acc[NR][TN];
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  if (slice == 0) {
#pragma unroll
    for (int q = 0; q < SQ; ++q)
      osm[q * NT + t] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

#pragma unroll
  for (int q = 0; q < kFastRing - 1; ++q) fetch(q);
  stash(0);
  __syncthreads();
  for (int it = 0; it < niter; ++it) {
    fetch(it + kFastRing - 1);
    const int buf = it & 1, round = it >> lsg;
#pragma unroll
    for (int kk = 0; kk < kFastK; ++kk) {
      // the next stage into the other buffer (last read before the previous
      // barrier), halfway, so that its latency hides behind the FMAs (past
      // the last stage it stashes stale bytes, never read)
      if (kk == kFastK / 2) stash(it + 1);
      float xv[4 * RL], wv[TN];
#pragma unroll
      for (int q = 0; q < RL; ++q) {
        const float4 a = *reinterpret_cast<const float4*>(
            &xs[buf][kk][q * (BM / RQ) + 4 * ty]);
        xv[4 * q] = a.x; xv[4 * q + 1] = a.y;
        xv[4 * q + 2] = a.z; xv[4 * q + 3] = a.w;
      }
#pragma unroll
      for (int q = 0; q < CQ; ++q) {
        const float4 c = *reinterpret_cast<const float4*>(
            &wsm[buf][kk][q * (BN / CQ) + 4 * tx]);
        wv[4 * q] = c.x; wv[4 * q + 1] = c.y;
        wv[4 * q + 2] = c.z; wv[4 * q + 3] = c.w;
      }
#pragma unroll
      for (int i = 0; i < NR; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
    }
    const bool ends = (it & (spg - 1)) == spg - 1;   // the round's groups end
    if (W > 1 && ends && slice > 0) {   // idle slices park what none adds
      float4* mine = park + ((size_t)((round & 1) * (W - 1) + slice - 1) * SQ) *
                                NT + t;
#pragma unroll
      for (int i = 0; i < NR; ++i)
#pragma unroll
        for (int q = 0; q < CQ; ++q) {
          mine[(i * CQ + q) * NT] =
              make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2],
                          acc[i][4 * q + 3]);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][4 * q + j] = 0.f;
        }
    }
    __syncthreads();
    if (!ends || slice > 0) continue;
    // slice 0: o = o + s_g for the round's groups, in order
    const int live = min(W, ng - round * W);
    const bool last = round == rounds - 1;
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      float4 o[CQ];
#pragma unroll
      for (int q = 0; q < CQ; ++q) {
        const int s = i * CQ + q;
        o[q] = osm[s * NT + t];
        o[q].x = __fadd_rn(o[q].x, acc[i][4 * q]);
        o[q].y = __fadd_rn(o[q].y, acc[i][4 * q + 1]);
        o[q].z = __fadd_rn(o[q].z, acc[i][4 * q + 2]);
        o[q].w = __fadd_rn(o[q].w, acc[i][4 * q + 3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][4 * q + j] = 0.f;
#pragma unroll
        for (int w = 1; w < W; ++w) {
          if (w >= live) break;
          const float4 p = park[((size_t)((round & 1) * (W - 1) + w - 1) * SQ +
                                 s) * NT + t];
          o[q].x = __fadd_rn(o[q].x, p.x);
          o[q].y = __fadd_rn(o[q].y, p.y);
          o[q].z = __fadd_rn(o[q].z, p.z);
          o[q].w = __fadd_rn(o[q].w, p.w);
        }
        if (!last) osm[s * NT + t] = o[q];
      }
      if (last)
        rows.template store<BN, CQ>((i / 4) * (BM / RQ) + 4 * ty + (i & 3),
                                    tx, o);
    }
  }
  cp_async_wait<0>();
}

template <int BM, int BN, int TM, int TN, int W, int MINB>
__global__ void __launch_bounds__(kFastThreads * W, MINB)
q8_fast_tile_kernel(const unsigned short* __restrict__ x,
                    const int8_t* __restrict__ wq,
                    const float* __restrict__ ws, float* __restrict__ out,
                    int b, int n, int d, int G) {
  const DenseRows rows{x, out, b, n, d, (int)blockIdx.y * BM,
                       (int)blockIdx.x * BN};
  fast_tile<BM, BN, TM, TN, W, TM>(rows, wq, ws, n, G);
}

// The tile kernel on one shape, one launch
template <int BM, int BN, int TM, int TN, int W, int MINB>
int launch_fast_tile_shape(const unsigned short* x, const int8_t* wq,
                           const float* ws, float* out, int b, int n, int d,
                           int G, cudaStream_t s) {
  static size_t set[16] = {};
  constexpr int smem = fast_tile_smem<BM, BN, W>();
  auto kernel = q8_fast_tile_kernel<BM, BN, TM, TN, W, MINB>;
  const int err = allow_smem(kernel, smem, set);
  if (err) return err;
  const dim3 grid((unsigned)((d + BN - 1) / BN), (unsigned)((b + BM - 1) / BM));
  kernel<<<grid, kFastThreads * W, smem, s>>>(x, wq, ws, out, b, n, d, G);
  return (int)cudaGetLastError();
}

// ------------------------------------------------ the grouped fast tile ----
//
// q8_fast_group_kernel: the fast tile above for the (row, expert) pairs of a
// sparse expert layer, one launch for all the layer's experts (ops/cuda/
// moe.py, csrc/moe_experts.cu), with the dense tile's body: the same
// staging, register blocking and sum order, so a pair's bits are the fast
// function's (the plain version's) at any count of pairs an expert. Expert
// e's pairs are the entries list[e * cap + i], i < count[e], both on the
// card (the routing's index kernel wrote them): an entry is row * K + slot,
// its activations bf16 row entry / xdiv of x (the layer's input rounded to
// bf16 by the router, xdiv = K, or an earlier grouped call's output, xdiv =
// 1), its output row entry. Expert e's weights are wq [e] ([dw, n] int8,
// dw = 2 d for GLU: w1 rows then w3 rows) with their scales. So no permuted
// copy of the activations is written and nothing is read back to the host:
// a block reads its expert's count itself.
//
// Grid: column tiles x row tiles x experts; a block takes its expert's row
// tiles y, y + gridDim.y, ... (none past the count: an idle block leaves at
// once). In a tile, pair slot s (of BM) sits in row column rc(s) so that
// thread ty holds slots ty, ty + 8, ...: its row i is slot 8 i + ty. A
// tile of `live` pairs then has live pairs in its threads' first
// NR = ceil(live / 8) rows, and the FMAs run for those only (NR picked a
// tile: a decode step's few pairs an expert cost NR = 1, an eighth of a
// full tile, while each staged weight still serves all of them).
// GLU: the tile's first BN / 2 columns are w1's, the rest w3's same
// columns, so that a thread holds each output's gate (q = 0) and up
// (q = 1) chains; its epilogue is the swiglu of the dense chain,
// (g * sigmoid(g)) * u with sigmoid(g) = 1 / (1 + expf(-g)), rounded to
// bf16 (what the next matmul's round_bf16 would give it); without GLU the
// f32 sums are stored.
constexpr int kGroupBM = 64, kGroupBN = 128;

template <bool GLU>
struct ExpertRows {
  const unsigned short* x;
  const int* ent;   // the tile's pairs: list + e * cap + r0
  void* out;
  int live, n, d, c0, xdiv;
  // tile row column rc's pair slot: row i of thread ty is slot 8 i + ty
  static __device__ __forceinline__ int slot(int rc) {
    return 8 * (((rc >> 5) << 2) + (rc & 3)) + ((rc & 31) >> 2);
  }
  __device__ __forceinline__ const unsigned short* x_row(int r) const {
    const int s = slot(r);
    return s < live ? x + (size_t)(__ldg(ent + s) / xdiv) * n : nullptr;
  }
  __device__ __forceinline__ int w_row(int cw) const {
    constexpr int H = GLU ? kGroupBN / 2 : kGroupBN;
    const int c = c0 + cw % H;
    return c < d ? (cw >= H ? d : 0) + c : -1;
  }
  template <int BN, int CQ>
  __device__ __forceinline__ void store(int rc, int tx,
                                        const float4 (&o)[CQ]) const {
    const int s = slot(rc);
    if (s >= live) return;
    const size_t row = (size_t)__ldg(ent + s);
    if constexpr (GLU) {
      static_assert(CQ == 2, "a thread holds a gate and an up quad");
      const float g4[4] = {o[0].x, o[0].y, o[0].z, o[0].w};
      const float u4[4] = {o[1].x, o[1].y, o[1].z, o[1].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + 4 * tx + j;
        if (c >= d) continue;
        const float g = g4[j];
        const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-g)));
        static_cast<__nv_bfloat16*>(out)[row * d + c] =
            __float2bfloat16_rn(__fmul_rn(__fmul_rn(g, sig), u4[j]));
      }
    } else {
#pragma unroll
      for (int q = 0; q < CQ; ++q) {
        const int c = c0 + q * (BN / CQ) + 4 * tx;
        float* dst = static_cast<float*>(out) + row * d + c;
        if ((d & 3) == 0 && c + 3 < d) {
          *reinterpret_cast<float4*>(dst) = o[q];
        } else {
          const float v[4] = {o[q].x, o[q].y, o[q].z, o[q].w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (c + j < d) dst[j] = v[j];
        }
      }
    }
  }
};

template <bool GLU>
__global__ void __launch_bounds__(kFastThreads, 3)
q8_fast_group_kernel(const unsigned short* __restrict__ x,
                     const int* __restrict__ list,
                     const int* __restrict__ count,
                     const int8_t* __restrict__ wq,
                     const float* __restrict__ ws, void* __restrict__ out,
                     int cap, int n, int d, int G, int xdiv) {
  constexpr int BM = kGroupBM, BN = kGroupBN, TM = 8, TN = 8;
  const int e = blockIdx.z, dw = GLU ? 2 * d : d;
  const int cnt = __ldg(count + e);
  const int8_t* we = wq + (size_t)e * dw * n;
  const float* se = ws + (size_t)e * dw * (n / G);
  const int c0 = blockIdx.x * (GLU ? BN / 2 : BN);
  for (int r0 = blockIdx.y * BM; r0 < cnt; r0 += gridDim.y * BM) {
    if (r0 != (int)blockIdx.y * BM) __syncthreads();   // the last tile's reads
    const ExpertRows<GLU> rows{x, list + (size_t)e * cap + r0, out,
                               min(BM, cnt - r0), n, d, c0, xdiv};
    switch ((rows.live + 7) / 8) {
      case 1: fast_tile<BM, BN, TM, TN, 1, 1>(rows, we, se, n, G); break;
      case 2: fast_tile<BM, BN, TM, TN, 1, 2>(rows, we, se, n, G); break;
      case 3: fast_tile<BM, BN, TM, TN, 1, 3>(rows, we, se, n, G); break;
      case 4: fast_tile<BM, BN, TM, TN, 1, 4>(rows, we, se, n, G); break;
      case 5: fast_tile<BM, BN, TM, TN, 1, 5>(rows, we, se, n, G); break;
      case 6: fast_tile<BM, BN, TM, TN, 1, 6>(rows, we, se, n, G); break;
      case 7: fast_tile<BM, BN, TM, TN, 1, 7>(rows, we, se, n, G); break;
      default: fast_tile<BM, BN, TM, TN, 1, 8>(rows, we, se, n, G); break;
    }
  }
}

// row_tiles: the grid's row tiles an expert (a block loops past them)
template <bool GLU>
int launch_fast_group(const unsigned short* x, const int* list,
                      const int* count, const int8_t* wq, const float* ws,
                      void* out, int E, int cap, int n, int d, int G,
                      int xdiv, int row_tiles, cudaStream_t s) {
  if (G < 16 || G > 512 || (G & (G - 1)) || n % G || row_tiles < 1 ||
      E < 1 || E > 65535)
    return (int)cudaErrorInvalidValue;
  static size_t set[16] = {};
  constexpr int smem = fast_tile_smem<kGroupBM, kGroupBN, 1>();
  auto kernel = q8_fast_group_kernel<GLU>;
  const int err = allow_smem(kernel, smem, set);
  if (err) return err;
  const int cols = GLU ? kGroupBN / 2 : kGroupBN;
  const dim3 grid((unsigned)((d + cols - 1) / cols), (unsigned)row_tiles,
                  (unsigned)E);
  kernel<<<grid, kFastThreads, smem, s>>>(x, list, count, wq, ws, out, cap, n,
                                          d, G, xdiv);
  return (int)cudaGetLastError();
}

}  // namespace
