// The sampler's two reductions in a fixed order for Hopper (sm_90a), bound
// to Python through ctypes.
//
// The port's own kernels: the JAX package leaves the sampler's sums to XLA
// (qwen3_tpu/runtime/sampler.py::sample_tokens, :90-170: jax.nn.softmax's
// denominator and jnp.cumsum over the sorted probabilities), and no Pallas
// kernel computes them. Per row of a [rows, n] fp32 tensor (contiguous):
//
//   softmax_sum:  s = sum(e)                  (e = exp(x / t - max), f32)
//   prefix_sum:   out[i] = e[0] + ... + e[i]  (the sorted probabilities)
//
// Why kernels. On the card torch.sum picks its reduction order by the
// number of rows, and the sampler's former prefix sum (two fp32 GEMMs)
// followed cuBLAS's choice of kernel by M = rows x blocks; so a row's token
// could follow the rows sampled with it (a serving slot's batch-mates, a dp
// rank's share of them). Here a row's order is a function of its width
// alone, and the prefix sum's first k entries do not depend on n either,
// so the k-candidate scan is a prefix of the full one, bit for bit.
//
// softmax_sum: 1024 threads a row (one block). The row is cut into 4-value
// chunks, chunk c to thread c % 1024; each thread sums its chunks' values
// in index order as one chain; a warp adds its lanes' sums by a __shfl_xor
// tree (offsets 16 .. 1); warp 0 adds the 32 warps' sums by the same tree.
//
// prefix_sum: tiles of 2048 values, 256 threads a tile, 8 consecutive
// values a thread:
//  - a thread's inclusive sums p[0..7] in index order (p[0] = v[0]);
//  - its lane's exclusive offset: a Kogge-Stone inclusive scan of the
//    threads' totals p[7] over the warp (__shfl_up, offsets 1 .. 16), read
//    one lane down (0 on lane 0);
//  - its warp's exclusive offset: the warps' totals added in order from 0;
//  - the tile's total: all 8 warps' totals added in order from 0;
//  - the tile's carry: the earlier tiles' totals added in order from 0
//    (pass 1, one block a tile, writes every tile's total; pass 2 reads
//    them; a row of one tile skips pass 1);
//  - out = ((carry + warp offset) + lane offset) + p[e].
// Every sum is rounded as written (__fadd_rn, -fmad=false), so the plain
// versions in ops/cuda/sampler.py (softmax_sum_ordered, cumsum_ordered),
// which add in these orders, give the same bits on the card.
//
// Bound: bytes (each value read once, the sums written once; at V = 151936
// a row is 608 KB). softmax_sum's one block a row streams it through one
// SM; prefix_sum's pass 1 reads the row a second time (the tiles' totals),
// which a single-pass scan with a look-back between blocks would save.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSumThreads = 1024;   // threads a row of softmax_sum
constexpr int kScanThreads = 256;   // threads a tile of prefix_sum
constexpr int kScanPer = 8;         // consecutive values a thread
constexpr int kTile = kScanThreads * kScanPer;
constexpr int kWarps = kScanThreads / 32;

__global__ void __launch_bounds__(kSumThreads)
softmax_sum_kernel(const float* __restrict__ e, float* __restrict__ out,
                   int n, int vec) {
  __shared__ float wsum[kSumThreads / 32];
  const float* row = e + (long long)blockIdx.x * n;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nc = (n + 3) / 4;
  float acc = 0.f;
  for (int c = t; c < nc; c += kSumThreads) {
    float v[4];
    if (vec) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(row) + c);
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = 4 * c + i < n ? __ldg(row + 4 * c + i) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) acc = __fadd_rn(acc, v[i]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, off));
  if (lane == 0) wsum[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    float s = wsum[lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s = __fadd_rn(s, __shfl_xor_sync(kFull, s, off));
    if (lane == 0) out[blockIdx.x] = s;
  }
}

// Tile `tile` of a row: this thread's inclusive sums p, its offset within
// the tile's warp (lex) and the warp's within the tile (wex), and the
// tile's total. wt: the block's shared warp totals. Ends after a barrier.
__device__ __forceinline__ void tile_scan(const float* row, int n, int tile,
                                          int vec, float* wt,
                                          float (&p)[kScanPer], float& lex,
                                          float& wex, float& total) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long i0 = (long long)tile * kTile + t * kScanPer;
  if (vec && i0 + kScanPer <= n) {
    const float4* q = reinterpret_cast<const float4*>(row + i0);
    const float4 a = __ldg(q), b = __ldg(q + 1);
    p[0] = a.x; p[1] = a.y; p[2] = a.z; p[3] = a.w;
    p[4] = b.x; p[5] = b.y; p[6] = b.z; p[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < kScanPer; ++i)
      p[i] = i0 + i < n ? __ldg(row + i0 + i) : 0.f;
  }
#pragma unroll
  for (int i = 1; i < kScanPer; ++i) p[i] = __fadd_rn(p[i - 1], p[i]);
  float s = p[kScanPer - 1];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(kFull, s, off);
    if (lane >= off) s = __fadd_rn(s, y);
  }
  const float below = __shfl_up_sync(kFull, s, 1);
  lex = lane ? below : 0.f;
  if (lane == 31) wt[warp] = s;
  __syncthreads();
  float a = 0.f;
  for (int w = 0; w < warp; ++w) a = __fadd_rn(a, wt[w]);
  wex = a;
  float tot = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) tot = __fadd_rn(tot, wt[w]);
  total = tot;
}

// Pass 1: block b is tile b % ntiles of row b / ntiles; writes its total.
__global__ void __launch_bounds__(kScanThreads)
scan_totals_kernel(const float* __restrict__ x, float* __restrict__ totals,
                   int n, int ntiles, int vec) {
  __shared__ float wt[kWarps];
  const int row = blockIdx.x / ntiles, tile = blockIdx.x % ntiles;
  float p[kScanPer], lex, wex, total;
  tile_scan(x + (long long)row * n, n, tile, vec, wt, p, lex, wex, total);
  if (threadIdx.x == 0) totals[blockIdx.x] = total;
}

// Pass 2: the tile's carry from pass 1's totals, then its prefix sums.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const float* __restrict__ x, const float* __restrict__ totals,
            float* __restrict__ out, int n, int ntiles, int vec) {
  __shared__ float wt[kWarps];
  __shared__ float tot[kScanThreads];
  __shared__ float carry_s;
  const int t = threadIdx.x;
  const int row = blockIdx.x / ntiles, tile = blockIdx.x % ntiles;
  float carry = 0.f;                 // thread 0's: the earlier tiles, in order
  for (int base = 0; base < tile; base += kScanThreads) {
    const int j = base + t;
    tot[t] = j < tile ? totals[(long long)row * ntiles + j] : 0.f;
    __syncthreads();
    if (t == 0) {
      const int m = min(kScanThreads, tile - base);
      for (int i = 0; i < m; ++i) carry = __fadd_rn(carry, tot[i]);
    }
    __syncthreads();
  }
  if (t == 0) carry_s = carry;
  float p[kScanPer], lex, wex, total;
  // tile_scan's barrier orders carry_s's write before the read below
  tile_scan(x + (long long)row * n, n, tile, vec, wt, p, lex, wex, total);
  const float off = __fadd_rn(__fadd_rn(carry_s, wex), lex);
  const long long i0 = (long long)tile * kTile + t * kScanPer;
  float* dst = out + (long long)row * n + i0;
#pragma unroll
  for (int i = 0; i < kScanPer; ++i) p[i] = __fadd_rn(off, p[i]);
  if (vec && i0 + kScanPer <= n) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(p[0], p[1], p[2], p[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(p[4], p[5], p[6], p[7]);
  } else {
#pragma unroll
    for (int i = 0; i < kScanPer; ++i)
      if (i0 + i < n) dst[i] = p[i];
  }
}

}  // namespace

extern "C" {

// rows rows of n f32 values of e, contiguous; writes out (f32 [rows]) =
// each row's sum in the fixed order above. vec != 0: e 16-byte aligned and
// n % 4 == 0. Launches on `stream`; returns cudaGetLastError() (0 =
// launched).
int softmax_sum(const void* e, void* out, int rows, int n, int vec,
                void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  softmax_sum_kernel<<<rows, kSumThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(e), static_cast<float*>(out), n, vec);
  return (int)cudaGetLastError();
}

// rows rows of n f32 values of x, contiguous; writes out (f32 [rows, n],
// not x) = each row's inclusive prefix sums in the fixed order above.
// totals: f32 scratch of rows * ceil(n / 2048) values (unused when a row is
// one tile). vec != 0: x and out 16-byte aligned and n % 4 == 0. Launches
// on `stream` (two kernels when a row has more than one tile); returns
// cudaGetLastError() (0 = launched).
int prefix_sum(const void* x, void* totals, void* out, int rows, int n,
               int vec, void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ntiles = (n + kTile - 1) / kTile;
  const long long blocks = (long long)rows * ntiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  float* tp = static_cast<float*>(totals);
  if (ntiles > 1) {
    scan_totals_kernel<<<(unsigned)blocks, kScanThreads, 0, s>>>(
        xp, tp, n, ntiles, vec);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  scan_kernel<<<(unsigned)blocks, kScanThreads, 0, s>>>(
      xp, tp, static_cast<float*>(out), n, ntiles, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
