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
// softmax_sum: 1024 "threads" a row, each of its 32 warps a one-warp block
// of its own, so that a row streams through 32 SMs. The row is cut into
// 4-value chunks, chunk c to thread c % 1024 (block w holds threads 32w ..
// 32w + 31); each thread sums its chunks' values in index order as one
// chain; a warp adds its lanes' sums by a __shfl_xor tree (offsets 16 ..
// 1) and writes its sum; the row's last block to finish (a completion
// counter a row, as the decode kernels' combining blocks find out that
// they are last, csrc/decode_partial.cuh) adds the 32 warps' sums by the
// same tree and resets the counter for the next call on the stream.
//
// prefix_sum: tiles of 2048 values, 256 threads a tile, 8 consecutive
// values a thread:
//  - a thread's inclusive sums p[0..7] in index order (p[0] = v[0]);
//  - its lane's exclusive offset: a Kogge-Stone inclusive scan of the
//    threads' totals p[7] over the warp (__shfl_up, offsets 1 .. 16), read
//    one lane down (0 on lane 0);
//  - its warp's exclusive offset: the warps' totals added in order from 0;
//  - the tile's total: all 8 warps' totals added in order from 0;
//  - the tile's carry: the earlier tiles' totals added in order from 0;
//  - out = ((carry + warp offset) + lane offset) + p[e].
// One pass, reading the row once: a block of row r takes its tile from the
// row's ticket (an atomic counter a row), so every tile of a lower ticket
// has started and runs to its end without waiting on a later one; it
// publishes its tile's total as one 64-bit word (a ready bit beside the
// value's bits), then reads the earlier tiles' words, waiting on each
// until it is ready, and its thread 0 adds them in order from 0. The row's
// last block to have read (a second counter a row) clears the row's words
// and both counters for the next call on the stream. A block stages its
// tile (8 KB) through shared memory, its threads on consecutive 16-byte
// pieces, and writes its sums back the same way: a thread's own 8
// consecutive values, read straight from the row, left each warp
// instruction half a 32-byte sector. One tile a block spreads a row over
// 75 blocks at V = 151936; on an H100 it was as fast as four tiles a block
// (32 KB in flight each) or faster at every B from 1 to 64 but 16.
//
// Every sum is rounded as written (__fadd_rn, -fmad=false), so the plain
// versions in ops/cuda/sampler.py (softmax_sum_ordered, cumsum_ordered),
// which add in these orders, give the same bits on the card.
//
// Bound: bytes (each value read once, the sums written once; at V = 151936
// a row is 608 KB).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSumThreads = 1024;   // threads a row of softmax_sum
constexpr int kSumWarps = kSumThreads / 32;   // its one-warp blocks a row
constexpr int kScanThreads = 256;   // threads a tile of prefix_sum
constexpr int kScanPer = 8;         // consecutive values a thread
constexpr int kTile = kScanThreads * kScanPer;
constexpr int kWarps = kScanThreads / 32;
constexpr unsigned long long kReady = 1ull << 32;   // a published word's bit

// Block b is warp b % kSumWarps of row b / kSumWarps; partial holds a
// warp's sum at b, counters one int a row (zero between calls).
__global__ void __launch_bounds__(32)
softmax_sum_kernel(const float* __restrict__ e, float* __restrict__ partial,
                   int* __restrict__ counters, float* __restrict__ out, int n,
                   int vec) {
  const int row = blockIdx.x / kSumWarps, warp = blockIdx.x % kSumWarps;
  const float* rp = e + (long long)row * n;
  const int lane = threadIdx.x;
  const int nc = (n + 3) / 4;
  float acc = 0.f;
#pragma unroll 4
  for (int c = warp * 32 + lane; c < nc; c += kSumThreads) {
    float v[4];
    if (vec) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(rp) + c);
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = 4 * c + i < n ? __ldg(rp + 4 * c + i) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) acc = __fadd_rn(acc, v[i]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, off));
  if (lane == 0) partial[blockIdx.x] = acc;
  // the row's last warp to finish combines
  __threadfence();
  int last = 0;
  if (lane == 0) {
    last = atomicAdd(counters + row, 1) == kSumWarps - 1;
    if (last) counters[row] = 0;
  }
  if (!__shfl_sync(kFull, last, 0)) return;
  __threadfence();
  float s = __ldcg(partial + (long long)row * kSumWarps + lane);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(kFull, s, off));
  if (lane == 0) out[row] = s;
}

__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// Tile `tile` of a row into the block's staging buffer sv (kTile floats,
// zeros past n), the block's threads on consecutive 16-byte (or 4-byte)
// pieces, so that a warp reads 512 contiguous bytes an instruction; a
// thread's own 8 consecutive values are then read from sv (tile_mine).
__device__ __forceinline__ void tile_stage(const float* row, int n, int tile,
                                           int vec, float* sv) {
  const long long base = (long long)tile * kTile;
  const int t = threadIdx.x;
  if (vec && base + kTile <= n) {
    const float4* q = reinterpret_cast<const float4*>(row + base);
#pragma unroll
    for (int k = 0; k < kScanPer / 4; ++k)
      reinterpret_cast<float4*>(sv)[k * kScanThreads + t] =
          __ldg(q + k * kScanThreads + t);
  } else {
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {
      const long long i = base + k * kScanThreads + t;
      sv[k * kScanThreads + t] = i < n ? __ldg(row + i) : 0.f;
    }
  }
}

__device__ __forceinline__ void tile_mine(const float* sv,
                                          float (&p)[kScanPer]) {
  const float4* q = reinterpret_cast<const float4*>(sv + threadIdx.x * kScanPer);
  const float4 a = q[0], b = q[1];
  p[0] = a.x; p[1] = a.y; p[2] = a.z; p[3] = a.w;
  p[4] = b.x; p[5] = b.y; p[6] = b.z; p[7] = b.w;
}

// The block's outputs of tile `tile` from the staging buffer sv to out,
// the same consecutive pieces as tile_stage.
__device__ __forceinline__ void tile_store(const float* sv, int n, int tile,
                                           int vec, float* row) {
  const long long base = (long long)tile * kTile;
  const int t = threadIdx.x;
  if (vec && base + kTile <= n) {
    float4* q = reinterpret_cast<float4*>(row + base);
#pragma unroll
    for (int k = 0; k < kScanPer / 4; ++k)
      q[k * kScanThreads + t] =
          reinterpret_cast<const float4*>(sv)[k * kScanThreads + t];
  } else {
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {
      const long long i = base + k * kScanThreads + t;
      if (i < n) row[i] = sv[k * kScanThreads + t];
    }
  }
}

// A tile's scan within the block, before the barrier: this thread's
// inclusive sums p (in place), its offset within its warp (lex), and its
// warp's total written to wt[warp].
__device__ __forceinline__ void tile_warp_scan(float (&p)[kScanPer],
                                               float& lex, float* wt) {
  const int lane = threadIdx.x & 31;
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
  if (lane == 31) wt[threadIdx.x >> 5] = s;
}

// Block b works on row b / ntiles, on the tile of its ticket. state: 2 +
// ntiles words a row: [0] the ticket, [1] the blocks that have read, [2 +
// j] tile j's word (zero until published); all zero between calls.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const float* __restrict__ x, float* __restrict__ out,
            unsigned long long* __restrict__ state, int n, int ntiles,
            int vec) {
  __shared__ __align__(16) float sv[kTile];   // 8 KB
  __shared__ float wt[kWarps];
  __shared__ float tot[kScanThreads];
  __shared__ float carry_s;
  __shared__ int ticket_s, clear_s;
  const int t = threadIdx.x, warp = t >> 5;
  const int row = blockIdx.x / ntiles;
  unsigned long long* st = state + (long long)row * (2 + ntiles);
  unsigned long long* words = st + 2;
  if (t == 0) ticket_s = (int)atomicAdd(st, 1ull);
  __syncthreads();
  const int tile = ticket_s;
  const float* rp = x + (long long)row * n;
  float p[kScanPer], lex;
  tile_stage(rp, n, tile, vec, sv);
  __syncthreads();
  tile_mine(sv, p);
  tile_warp_scan(p, lex, wt);
  __syncthreads();
  float wex = 0.f, total = 0.f;
  for (int w = 0; w < warp; ++w) wex = __fadd_rn(wex, wt[w]);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total = __fadd_rn(total, wt[w]);
  if (t == 0) atomicExch(words + tile, kReady | __float_as_uint(total));
  float carry = 0.f;                 // thread 0's: the earlier tiles, in order
  for (int base = 0; base < tile; base += kScanThreads) {
    const int j = base + t;
    if (j < tile) {
      unsigned long long w;
      while (!((w = load_word(words + j)) & kReady)) __nanosleep(32);
      tot[t] = __uint_as_float((unsigned)w);
    }
    __syncthreads();
    if (t == 0) {
      const int m = min(kScanThreads, tile - base);
      for (int i = 0; i < m; ++i) carry = __fadd_rn(carry, tot[i]);
    }
    __syncthreads();
  }
  if (t == 0) {
    carry_s = carry;
    __threadfence();
    clear_s = atomicAdd(st + 1, 1ull) == (unsigned long long)ntiles - 1;
  }
  __syncthreads();
  if (clear_s) {       // the row's every block has read: reset for the next call
    for (int i = t; i < ntiles; i += kScanThreads) words[i] = 0ull;
    if (t == 0) {
      st[0] = 0ull;
      st[1] = 0ull;
    }
  }
  // the tile's sums into the staging buffer (this thread's own 8 values),
  // then out from there
  const float off = __fadd_rn(__fadd_rn(carry_s, wex), lex);
  float r[kScanPer];
#pragma unroll
  for (int e = 0; e < kScanPer; ++e) r[e] = __fadd_rn(off, p[e]);
  float4* q = reinterpret_cast<float4*>(sv + t * kScanPer);
  q[0] = make_float4(r[0], r[1], r[2], r[3]);
  q[1] = make_float4(r[4], r[5], r[6], r[7]);
  __syncthreads();
  tile_store(sv, n, tile, vec, out + (long long)row * n);
}

}  // namespace

extern "C" {

// rows rows of n f32 values of e, contiguous; writes out (f32 [rows]) =
// each row's sum in the fixed order above. partial: f32 scratch of rows *
// 32 values; counters: rows ints, zero (the kernel leaves them zero).
// vec != 0: e 16-byte aligned and n % 4 == 0. One launch on `stream`;
// returns cudaGetLastError() (0 = launched).
int softmax_sum(const void* e, void* partial, void* counters, void* out,
                int rows, int n, int vec, void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)rows * kSumWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  softmax_sum_kernel<<<(unsigned)blocks, 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(e), static_cast<float*>(partial),
      static_cast<int*>(counters), static_cast<float*>(out), n, vec);
  return (int)cudaGetLastError();
}

// rows rows of n f32 values of x, contiguous; writes out (f32 [rows, n],
// not x) = each row's inclusive prefix sums in the fixed order above.
// state: rows * (2 + ceil(n / 2048)) 64-bit words, zero (the kernel
// leaves them zero). vec != 0: x and out 16-byte aligned and n % 4 == 0. One
// launch on `stream`; returns cudaGetLastError() (0 = launched).
int prefix_sum(const void* x, void* state, void* out, int rows, int n,
               int vec, void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const int ntiles = (n + kTile - 1) / kTile;
  const long long blocks = (long long)rows * ntiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  scan_kernel<<<(unsigned)blocks, kScanThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out),
      static_cast<unsigned long long*>(state), n, ntiles, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
