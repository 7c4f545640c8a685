// The grouped Q8_0 expert matmuls of a sparse expert layer for Hopper
// (sm_90a), bound to Python through ctypes (ops/cuda/moe.py): one launch
// for the layer's w13 with the swiglu folded into its epilogue, one for its
// w2, over the (row, expert) pairs that csrc/moe_route.cu's index kernel
// listed on the card.
//
// Replaces no TPU kernel: the JAX package has no expert layer. The kernel
// is q8_kernels.cuh's q8_fast_group_kernel: the fast tile kernel's body
// (fast_tile) on rows gathered by the index, whose function it computes
// (the pallas-fast rule: bf16 activations times bf16-dequantized weights,
// f32 chains a group in k order, the groups in order), so that a pair's
// bits equal the plain version's (ops/cuda/moe.py::experts_plain, which
// runs q8_fast_matmul_plain an expert) at any count of pairs an expert.
//
// Bound: at decode (a few pairs an expert, every expert reached) the
// experts' weight bytes over the memory rate, 604 MB a layer of
// Qwen3-30B-A3B (0.18 ms at 3.35 TB/s), each weight read once for all its
// pairs; in prefill (tens of pairs an expert) the f32 FMAs, 3 dim width
// FMAs a pair, as the dense tile kernel's. The design (the notes in
// q8_kernels.cuh): a block a (64 x 128 tile, expert), the dense tile's
// register blocking and cp.async ring, its pairs laid out so that a tile
// of few pairs runs the FMAs of its live rows only, while each staged
// weight, dequantized once, serves all of them.
//
// This file builds with nvcc's default contraction setting (ops/cuda/
// build.py) for the swiglu's expf, PyTorch's; every product and sum is an
// intrinsic.

#include "q8_kernels.cuh"

extern "C" {

// glu = 1: out bf16 [M, d] = swiglu of x bf16 rows (entry / xdiv) times
// wq [E, 2 d, n] (w1 rows, then w3 rows); glu = 0: out f32 [M, d] = x bf16
// rows (entry / xdiv) times wq [E, d, n]. ws f32 [E, rows, n / G]; list
// int32 [E, cap], count int32 [E] on the card; row_tiles: the grid's
// 64-pair tiles an expert (a block takes more where an expert has more).
int moe_experts(const void* x, const void* list, const void* count,
                const void* wq, const void* ws, void* out, int E, int cap,
                int n, int d, int G, int xdiv, int glu, int row_tiles,
                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned short* xb = static_cast<const unsigned short*>(x);
  const int* l = static_cast<const int*>(list);
  const int* c = static_cast<const int*>(count);
  const int8_t* q = static_cast<const int8_t*>(wq);
  const float* sc = static_cast<const float*>(ws);
  if (glu)
    return launch_fast_group<true>(xb, l, c, q, sc, out, E, cap, n, d, G,
                                   xdiv, row_tiles, s);
  return launch_fast_group<false>(xb, l, c, q, sc, out, E, cap, n, d, G,
                                  xdiv, row_tiles, s);
}

}  // extern "C"
