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
// sequential fp32 sums, the groups in order, as the q8_fast kernels). Every
// step is the port's unfused chain (rmsnorm / swiglu -> quantize_act or
// round_bf16 -> the q8q8 or fast kernel) in the same fp32 order, with explicit
// round-to-nearest intrinsics: fused and unfused give the same bits, and a
// row's bits do not depend on the other rows of the call. The sigmoid is
// PyTorch's CUDA formula, 1 / (1 + exp(-g)) with expf and a true division;
// this file builds with nvcc's default contraction setting, as PyTorch's own
// kernels do, and every product and sum of the kernels is an intrinsic.
//
// Layout: x f32 [b, n] ([b, 2n] for swiglu), inv f32 [b], nw f32 [n],
// wq int8 [d, n], ws f32 [d, n / G], out f32 [b, d].
//
// Bound: at decode (b <= 8) the weight bytes over the memory rate; at b = 512
// the operations (int8 or bf16) over their peak, and for the exact path the
// ordered epilogue (csrc/q8_matmul.cu's notes) plus the prologue's fp32 work.
//
// Design. The kernels are the unfused ones (q8_kernels.cuh): the same
// grids, planners, dots, epilogues and sum orders, so fused equals unfused
// bit for bit by construction. The first design (a 64-column tile per
// block, 8 rows at b <= 8, __dp4a or fp32 FMAs from shared memory, the
// prologue run twice a group by every column block) took 7.45 ms a token's
// 113 launches where the unfused chain takes 4.70 (an NVIDIA H100 80GB HBM3
// at 700 W, chip_smoke.py).
//  - b == 1, one launch a call (decode: the launches fuse exists to cut).
//    Exact: the unfused GEMV with the XqPrologue loader. A block asks L2
//    for its first batch of weights, then quantizes the row once into
//    shared memory (n int8 and n / G f32, 3.3 KB at n = 3072: the
//    prologue once per value, the group's absmax from the same values in
//    registers), and its warps read their 16-byte chunks from there. The
//    grid is at most the blocks the card holds at once, each walking
//    several column tiles, so the whole grid evaluates the prologue
//    blocks x n times: at qwen3-0.6b 256 x 2048 (wo), 512 x 1024 (wqkv),
//    768 or fewer x 1024 (w13), 256 x 3072 (w2) and, for the classifier's
//    9496 16-column tiles, a few blocks an SM x 1024, far below the 155 MB
//    its weights take to stream. Fast: the unfused split kernel with the
//    BfPrologue loader, which stages bf16(prologue(x)) in shared memory
//    while its weight loads are in flight.
//  - b > 1 (prefill blocks, the perplexity eval's logits): a pass of its
//    own makes the call's activations once, q8q8_prologue_kernel (a team
//    a group: quantize_act's rounding of the prologue's values into xq / xs)
//    or q8_fast_prologue_kernel (8 values a thread: bf16(prologue(x))),
//    into scratch the caller gives; then q8_matmul.cu's own entry runs the
//    unfused tile path (with its k-split's ordered sum pass where plan_q8q8
//    splits) or fast kernel on them: the same binary. A second design made
//    the rows inside the tile kernel, into panels beside its cp.async
//    ring: every column block quantized its rows again, so a 512-row
//    block's 112 layer launches took 14.3 ms against the unfused kernel's
//    4.5, and the classifier 4.5 ms against 1.1 (PERF.md). The pass costs
//    one small launch and a write and a read of the b x n activations.

#include <cuda_runtime.h>
#include <stdint.h>

#include "q8_kernels.cuh"

namespace {

constexpr int kPrologueThreads = 256;

// the groups a block of q8q8_prologue_kernel quantizes: one a team of
// min(G / 4, 32) lanes
__host__ __device__ constexpr int prologue_groups(int G) {
  return kPrologueThreads / (G / 4 < 32 ? G / 4 : 32);
}

// xq / xs [b, n] / [b, n / G] = quantize_act(prologue(x)): block (i, r)
// takes row r's groups from i prologue_groups(G), so that a few rows
// still spread over many SMs
__global__ void __launch_bounds__(kPrologueThreads)
q8q8_prologue_kernel(XqPrologue act, int8_t* __restrict__ xq,
                     float* __restrict__ xs, int b, int n, int G) {
  const int r = blockIdx.y, ng = n / G, per = prologue_groups(G);
  const int g0 = blockIdx.x * per, k0 = g0 * G;
  const int len = (ng - g0 < per ? ng - g0 : per) * G;
  act.build_global(xq + (size_t)r * n + k0, xs + (size_t)r * ng + g0, r, b, n,
                   k0, len, G);
}

// xb bf16 [b, n] = bf16(prologue(x)), 8 values a thread
__global__ void __launch_bounds__(kPrologueThreads)
q8_fast_prologue_kernel(BfPrologue act, unsigned short* __restrict__ xb,
                        int b, int n) {
  const int per = n / 8;
  const size_t e = (size_t)blockIdx.x * kPrologueThreads + threadIdx.x;
  if (e >= (size_t)b * per) return;
  const int r = (int)(e / per), k = (int)(e % per) * 8;
  *reinterpret_cast<int4*>(xb + (size_t)r * n + k) = act.raw8(r, k, n, true);
}

}  // namespace

extern "C" {

// the unfused entries (q8_matmul.cu), which the b > 1 path runs as they are
int q8q8_matmul(const void* xq, const void* xs, const void* wq,
                const void* ws, void* out, void* part, int b, int n, int d,
                int group_size, int gpt, int shape, int splits, void* stream);
int q8_fast_matmul(const void* x, const void* wq, const void* ws, void* out,
                   int b, int n, int d, int group_size, void* stream);

// out = fused(x, inv, nw, wq, ws): prologue 0 none, 1 norm, 2 swiglu; exact
// 1 (Q8_0 x Q8_0, gpt groups per k-tile) or 0 (bf16). x f32 [b, n] (swiglu:
// [b, 2n]), inv f32 [b] and nw f32 [n] (norm only; otherwise ignored), wq int8
// [d, n], ws f32 [d, n / G], out f32 [b, d], all 16-byte aligned. At b > 1
// the call's activations go to act_q / act_s first: exact int8 [b, n] and
// f32 [b, n / G], fast bf16 [b, n] (act_s unused); then in the exact path
// `shape` (0-2) and `splits` set the tile path's grid as for q8q8_matmul,
// with `part` f32 [n / (G gpt), b, d] the k-split's scratch (null at splits
// 1); the fast path ignores them. Launches on `stream` and returns
// cudaGetLastError() (0 = launched; cudaErrorInvalidValue for an unknown
// prologue or shape).
int q8_fused_matmul(const void* x, const void* inv, const void* nw,
                    const void* wq, const void* ws, void* out, void* part,
                    void* act_q, void* act_s, int b, int n, int d,
                    int group_size, int gpt, int shape, int splits,
                    int prologue, int exact, void* stream) {
  if (prologue < kNone || prologue > kSwiglu)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* invf = static_cast<const float*>(inv);
  const float* nwf = static_cast<const float*>(nw);
  const int8_t* wq8 = static_cast<const int8_t*>(wq);
  const float* wsf = static_cast<const float*>(ws);
  float* o = static_cast<float*>(out);
  const int G = group_size;
  if (exact) {
    const XqPrologue act{xf, invf, nwf, prologue};
    if (b == 1) return launch_gemv(act, wq8, wsf, o, n, d, G, gpt, true, s);
    int8_t* xq = static_cast<int8_t*>(act_q);
    float* xs = static_cast<float*>(act_s);
    const int per = prologue_groups(G);
    const dim3 grid((unsigned)((n / G + per - 1) / per), (unsigned)b);
    q8q8_prologue_kernel<<<grid, kPrologueThreads, 0, s>>>(act, xq, xs, b, n,
                                                           G);
    const int e = (int)cudaGetLastError();
    if (e) return e;
    return q8q8_matmul(xq, xs, wq, ws, out, part, b, n, d, G, gpt, shape,
                       splits, stream);
  }
  const BfPrologue act{xf, invf, nwf, prologue};
  if (b == 1) return launch_fast_split<1, 1>(act, wq8, wsf, o, b, n, d, G, s);
  unsigned short* xb = static_cast<unsigned short*>(act_q);
  const size_t vecs = (size_t)b * (n / 8);
  q8_fast_prologue_kernel<<<(unsigned)((vecs + kPrologueThreads - 1) /
                                       kPrologueThreads),
                            kPrologueThreads, 0, s>>>(act, xb, b, n);
  const int e = (int)cudaGetLastError();
  if (e) return e;
  return q8_fast_matmul(xb, wq, ws, out, b, n, d, G, stream);
}

}  // extern "C"
