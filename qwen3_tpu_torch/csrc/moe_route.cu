// The routing of a sparse expert layer for Hopper (sm_90a), bound to Python
// through ctypes (ops/cuda/moe.py): the router with its selection, the
// per-expert index of the routed pairs, and the weighted combine of the
// experts' outputs. The grouped expert matmuls between the index and the
// combine are csrc/moe_experts.cu's.
//
// Replaces no TPU kernel: the JAX package has no expert layer. They exist
// so that Qwen3-30B-A3B's layer runs on the card in a fixed number of
// launches with nothing read back to the host: the routing stays on the
// card and the grouped kernels read it there.
//
//  - moe_route_kernel, one block a row: the router's logits l_e = h . w_e
//    in f32 (w_e the router's Q8_0 row dequantized, f32(q) * s; a chain of
//    rounded products and sums over a group's k in order from 0, then the
//    groups added in order from 0), the softmax p_e = expf(l_e - max) / Z
//    with Z summed over the experts in id order, the top K by p (ties to
//    the lower id), and their weights p / (their sum in that order); and
//    the row rounded to bf16 (nearest even), the grouped w13's input, so
//    that the expert kernels read bf16 rows as the dense tile does. Bound:
//    the router's f32 work (2 dim E operations a row) and, at decode, a
//    block's latency; its 256 KB of weights stay in L2.
//  - moe_index_kernel, one block an expert: the entries row * K + slot
//    routed to it, in entry order (ballots and a block scan: no atomics, so
//    the order is fixed), its count, and the count added to the layer's
//    row of the per-(layer, expert) statistics. Bound: reading the routed
//    ids once a block (32 KB at 1024 rows).
//  - moe_combine_kernel: out[r] = sum over the slots in order (descending
//    weight, the selection's order) of w[r, j] * y[r * K + j], each
//    product and sum rounded. Bound: reading y (K dim f32 a row).
//
// Every product, quotient and sum is an explicit intrinsic, and expf is the
// math library's: this file builds with nvcc's default contraction setting,
// as PyTorch's kernels do (ops/cuda/build.py), so that the plain versions
// (ops/cuda/moe.py's *_plain, torch.exp and true divisions) give the same
// bits on the card.
//
// Layout: h f32 [N, dim], wq int8 [E, dim], ws f32 [E, dim / G]; ids int32
// [N, K], w f32 [N, K], hb bf16 [N, dim]; list int32 [E, cap], count int32 [E], stats int64
// [E] (or null); y f32 [N K, dim], out f32 [N, dim].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kIndexThreads = 256, kCombineThreads = 256;

// a block of ceil32(E) threads a row; shared: x [n] f32, then p [E]
__global__ void moe_route_kernel(const float* __restrict__ h,
                                 const int8_t* __restrict__ wq,
                                 const float* __restrict__ ws,
                                 int* __restrict__ ids, float* __restrict__ w,
                                 __nv_bfloat16* __restrict__ hb, int n, int E,
                                 int K, int G) {
  extern __shared__ float4 route_smem[];
  float* x = reinterpret_cast<float*>(route_smem);
  float* p = x + n;
  __shared__ float red[32];
  __shared__ float zsum;
  const int t = threadIdx.x, r = blockIdx.x, lane = t & 31, warp = t >> 5;
  const int nw = blockDim.x >> 5;
  for (int k = 4 * t; k < n; k += 4 * blockDim.x) {
    const float4 v =
        __ldg(reinterpret_cast<const float4*>(h + (size_t)r * n + k));
    *reinterpret_cast<float4*>(x + k) = v;
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(hb + (size_t)r * n + k);
    o[0] = __floats2bfloat162_rn(v.x, v.y);
    o[1] = __floats2bfloat162_rn(v.z, v.w);
  }
  __syncthreads();
  float l = -__int_as_float(0x7f800000);   // -inf: no expert
  if (t < E) {
    const int8_t* wr = wq + (size_t)t * n;
    const float* sr = ws + (size_t)t * (n / G);
    float o = 0.f;
    for (int g0 = 0; g0 < n; g0 += G) {
      const float sc = __ldg(sr + g0 / G);
      float s = 0.f;
      for (int k = g0; k < g0 + G; k += 16) {
        const int4 q4 = __ldg(reinterpret_cast<const int4*>(wr + k));
        const int8_t* q = reinterpret_cast<const int8_t*>(&q4);
#pragma unroll
        for (int i = 0; i < 16; ++i)
          s = __fadd_rn(s, __fmul_rn(x[k + i], __fmul_rn((float)q[i], sc)));
      }
      o = __fadd_rn(o, s);
    }
    l = o;
  }
  // the largest logit (exact in any order)
  float m = l;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) red[warp] = m;
  __syncthreads();
  if (t == 0) {
    float mm = red[0];
    for (int i = 1; i < nw; ++i) mm = fmaxf(mm, red[i]);
    red[0] = mm;
  }
  __syncthreads();
  m = red[0];
  if (t < E) p[t] = expf(__fsub_rn(l, m));
  __syncthreads();
  if (t == 0) {
    float z = 0.f;
    for (int e = 0; e < E; ++e) z = __fadd_rn(z, p[e]);
    zsum = z;
  }
  __syncthreads();
  if (t < E) p[t] = __fdiv_rn(p[t], zsum);
  __syncthreads();
  if (warp != 0) return;
  // the top K, one warp: K rounds of an arg-max (ties to the lower id),
  // each taking its winner out (p >= 0, so -1 marks it)
  float den = 0.f;
  float pick_p[32];
  int pick_e[32];
  for (int j = 0; j < K; ++j) {
    float bp = -1.f;
    int be = E;
    for (int e = lane; e < E; e += 32) {
      const float v = p[e];
      if (v > bp) {   // e rises, so a tie keeps the lower id
        bp = v;
        be = e;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float op = __shfl_xor_sync(0xffffffffu, bp, off);
      const int oe = __shfl_xor_sync(0xffffffffu, be, off);
      if (op > bp || (op == bp && oe < be)) {
        bp = op;
        be = oe;
      }
    }
    if (lane == 0) p[be] = -1.f;
    __syncwarp();
    pick_p[j] = bp;
    pick_e[j] = be;
    den = __fadd_rn(den, bp);
  }
  if (lane == 0) {
    for (int j = 0; j < K; ++j) {
      ids[(size_t)r * K + j] = pick_e[j];
      w[(size_t)r * K + j] = __fdiv_rn(pick_p[j], den);
    }
  }
}

__global__ void __launch_bounds__(kIndexThreads)
moe_index_kernel(const int* __restrict__ ids, int* __restrict__ list,
                 int* __restrict__ count, long long* __restrict__ stats,
                 int M, int cap) {
  __shared__ int warp_tot[kIndexThreads / 32];
  const int e = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int* el = list + (size_t)e * cap;
  int base = 0;
  for (int i0 = 0; i0 < M; i0 += kIndexThreads) {
    const int i = i0 + t;
    const bool f = i < M && __ldg(ids + i) == e;
    const unsigned ball = __ballot_sync(0xffffffffu, f);
    if (lane == 0) warp_tot[warp] = __popc(ball);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kIndexThreads / 32; ++w) {
      before += w < warp ? warp_tot[w] : 0;
      total += warp_tot[w];
    }
    if (f) el[base + before + __popc(ball & ((1u << lane) - 1u))] = i;
    base += total;
    __syncthreads();   // warp_tot is read before the next round writes it
  }
  if (t == 0) {
    count[e] = base;
    if (stats != nullptr) stats[e] += base;
  }
}

// four columns a thread; grid (rows, column blocks)
__global__ void __launch_bounds__(kCombineThreads)
moe_combine_kernel(const float* __restrict__ y, const float* __restrict__ w,
                   float* __restrict__ out, int K, int d) {
  const int r = blockIdx.x, c = 4 * (blockIdx.y * kCombineThreads +
                                     threadIdx.x);
  if (c >= d) return;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < K; ++j) {
    const float wj = __ldg(w + (size_t)r * K + j);
    const float4 v = __ldg(reinterpret_cast<const float4*>(
        y + ((size_t)r * K + j) * d + c));
    acc.x = __fadd_rn(acc.x, __fmul_rn(wj, v.x));
    acc.y = __fadd_rn(acc.y, __fmul_rn(wj, v.y));
    acc.z = __fadd_rn(acc.z, __fmul_rn(wj, v.z));
    acc.w = __fadd_rn(acc.w, __fmul_rn(wj, v.w));
  }
  *reinterpret_cast<float4*>(out + (size_t)r * d + c) = acc;
}

}  // namespace

extern "C" {

// ids, w = the top K of softmax(h . dequant(wq, ws)) for N rows: h f32
// [N, n], wq int8 [E, n], ws f32 [E, n / G]; hb bf16 [N, n] = h rounded. Requires E <= 1024, K <= 32,
// n % 16 == 0, G a multiple of 16 dividing n, 16-byte aligned rows.
int moe_route(const void* h, const void* wq, const void* ws, void* ids,
              void* w, void* hb, int N, int n, int E, int K, int G,
              void* stream) {
  if (E < 1 || E > 1024 || K < 1 || K > 32 || K > E || n % 16 || G % 16 ||
      n % G)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const int threads = (E + 31) / 32 * 32;
  const size_t smem = sizeof(float) * ((size_t)n + E);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  moe_route_kernel<<<N, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<const int8_t*>(wq),
      static_cast<const float*>(ws), static_cast<int*>(ids),
      static_cast<float*>(w), static_cast<__nv_bfloat16*>(hb), n, E, K, G);
  return (int)cudaGetLastError();
}

// list[e, :count[e]] = the entries i < M with ids[i] == e, in order;
// stats[e] += count[e] (stats may be null).
int moe_index(const void* ids, void* list, void* count, void* stats, int M,
              int cap, int E, void* stream) {
  if (E < 1) return (int)cudaErrorInvalidValue;
  moe_index_kernel<<<E, kIndexThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<int*>(list),
      static_cast<int*>(count), static_cast<long long*>(stats), M, cap);
  return (int)cudaGetLastError();
}

// out[r] = sum_j w[r, j] y[r K + j] in slot order: y f32 [N K, d], w f32
// [N, K], out f32 [N, d]; d % 4 == 0.
int moe_combine(const void* y, const void* w, void* out, int N, int K, int d,
                void* stream) {
  if (d % 4) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const dim3 grid((unsigned)N,
                  (unsigned)((d / 4 + kCombineThreads - 1) / kCombineThreads));
  moe_combine_kernel<<<grid, kCombineThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(w),
      static_cast<float*>(out), K, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
