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
//    GEMV that streams each weight byte once per call. Its first design (a
//    warp a column, one 16-byte load a lane in flight, then a shuffle
//    reduction and eight serial shuffle-broadcast adds before the next
//    load) read 1.09 TB/s where a pure read of the same bytes reaches
//    2.26-2.34. Now a warp issues the 16-byte weight, activation and scale
//    loads of NB (2, 4 or 8) 512-byte chunks of its column (or of two
//    columns, CPW = 2, sharing the activation loads) before it reduces any;
//    each group's term is formed in its own lanes and parked in shared
//    memory; and the ordered fp32 sum runs once per column after the loads:
//    lane t adds k-tile t's terms in order, then every lane adds the tile
//    sums in order. Where d is small (wo, w2 at 1024 columns) or a column
//    long, wpc warps share a column's chunks, so that enough loads are in
//    flight to fill the card. No bit changes: the group dots are exact, and
//    the sum's order is the plain version's. On an NVIDIA H100 80GB HBM3 at
//    700 W (chip_smoke.py, cold L2): a token's 112 layer launches 1.00 ms
//    (the first design 1.35, F.linear on bf16 1.18, the byte bound 0.14),
//    the classifier 0.090 ms, 1.84 TB/s (0.138, 0.115, 0.050).
//  - b > 1 (prefill blocks; serving steps in mode pallas): bound by the
//    ordered epilogue more than by bytes or int8 operations. Each (row,
//    column, group) costs 4 fp32-pipe operations (the dot's conversion,
//    xs * ws, the product, the sum) that no MMA can take, against 2 G int8
//    operations on the tensor cores: for wqkv at b = 512 4.0 us of epilogue
//    over the card's fp32 pipe, 4.5 us of bytes, 1.1 us of int8 MMAs. The
//    first design (a 64 x 64 tile, __dp4a on CUDA cores from shared memory,
//    two barriers a group and no load in flight, 16 blocks for wo and w2)
//    took 45-126 us a layer matrix at b = 64 and 80-119 at b = 512, where
//    F.linear on bf16 takes 10-13. q8q8_mma_kernel runs the group dots on
//    mma.sync s8 tensor cores and keeps the epilogue in the MMA's fragment
//    layout, one lane's outputs in registers; a cp.async ring keeps the next
//    stages' activations, weights and scales in flight; the tile holds 16,
//    32 or 64 rows by b (plan_q8q8 in ops/cuda/q8_matmul.py), so small
//    batches multiply few zero rows, and where its blocks are fewer than the
//    card's SMs the k-tiles split over several blocks, added in tile order
//    by a second pass. The group dots are exact, each row is computed alone
//    in the plain version's order, so no shape, split or batch changes a
//    bit. The kernel is bound by instruction issue more than by any pipe:
//    so the loop does no division (G is a power of two, the k-tile a
//    counter), each thread's copy addresses are fixed once, the fragments
//    come by ldmatrix, a group's first MMA starts its dots at zero, and a
//    row's two columns leave as one 8-byte store.
//
// The kernels themselves are in q8_kernels.cuh, shared with q8_fused.cu:
// this file runs them on activations an earlier op made (the b = 1
// kernels' loaders XqGlobal, BfGlobal).

// ---------------------------------------------------------------- fast ----
//
// The pallas-fast mode's matmul, replacing qwen3_tpu/ops/pallas/q8_matmul.py::
// q8_matmul_stacked_fast (every layer matmul) and ::q8_matmul_tiled_fast
// (the classifier): bf16 activations times the Q8_0 weights dequantized to
// bf16, summed in fp32:
//
//   w[c, k]  = bf16_rn(f32(wq[c, k]) * ws[c, k / G])        (one IEEE multiply)
//   out[b, c] = sum over groups g, in order, of
//               s_g = sum over k in g, in order, of x[b, k] * w[c, k]
//
// with x [b, n] already bf16, s_g starting at 0 and out at 0. A product of
// two bf16 values is exact in fp32, so fmaf(x, w, s) rounds once, as the
// plain version's s + x * w does: the kernel is bit-equal to
// ops/cuda/q8_matmul.py::q8_fast_matmul_plain. Every row is computed the same
// way whatever b is, so a row's bits never depend on its batch-mates (the
// serving engine's contract that a stream's tokens do not).
//
// Why CUDA cores: an MMA sums its products in an order of its own, not the
// k order of each s_g, so tensor cores would break the bits.
//
// Bound: at decode (b <= 8) the weight bytes, 1 + 4/G a weight, over the
// memory rate (qwen3-0.6b's layer matrices: 0.7-2.0 us); at b = 512 the
// fp32 FMAs over the card's 67 TFLOP/s outside the tensor cores (wqkv: 64
// us), which the bit rule makes the floor.
//
// Design. The parallelism the function allows is over (row, column,
// group): every s_g starts at 0 and depends on no other group. A block of
// 8 rows x 64 columns that walks all groups alone runs 16 blocks for wo and
// w2 on 132 SMs, multiplies 7 zero rows at b = 1, and dequantizes every
// weight into shared memory (75.9 us for wo at b = 1 against a 0.67 us
// bound). Two kernels, picked by the call's shape:
//  - q8_fast_split_kernel (b <= 8, and b > 8 while the tile kernel would
//    have fewer than 128 blocks): the group split. A thread owns one group
//    of TN columns (1, or 2 for d > 4224) and keeps that group's fmaf chains
//    for the block's R rows in registers (R = b rounded up to a power of
//    two when b <= 8, else 16 or 32 rows a block, the rows split over
//    blockIdx.y). It issues its 64-byte weight loads (16 bytes a load)
//    before the block stages the activations, and dequantizes each weight
//    once, in registers. Lane l of a warp takes group l / SL and column slot
//    l % SL (SL = 4 / TN), so a warp spans 8 TN groups of 4 columns; WG
//    warps side by side span a pass of GP groups, WC warps CB = 4 WC
//    columns. The block stages the pass's activations as f32 in shared
//    memory, each group's values padded to G + 4 words, so a quarter-warp
//    reads its float4s from distinct banks and SL lanes share each one.
//    The chains land in shared memory, and the thread that owns a (row,
//    column) adds them to its running sum in group order, pass after pass:
//    the plain version's order. WC is the widest that still gives >= 256
//    blocks (qwen3-0.6b at b <= 8: wqkv and wo 256, w13 384, w2 256).
//  - q8_fast_tile_kernel (b > 8 with >= 128 of its blocks): a 64 x 64
//    tile, 4 x 4 outputs a thread from shared memory, each group's chain
//    and then the ordered sum in registers. It is the faster of the two at
//    b = 512 on every qwen3-0.6b matrix and for the classifier from b = 64.
// Both compute each row alone in the same order, so the choice by shape
// changes no bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "q8_kernels.cuh"

namespace {

// The Q8_0 x Q8_0 matmul at b > 1: the tile path, its grid (`shape`,
// `splits`, `part`) from the host's planner (plan_q8q8).
inline int q8q8_tiles(const int8_t* xq, const float* xs, const int8_t* wq,
                      const float* ws, float* out, float* part, int b, int n,
                      int d, int G, int gpt, int shape, int splits,
                      cudaStream_t s) {
  // an MMA never spans two groups; past G = 128 a dot may reach 2^22
  if (G == 16)
    return launch_mma<16, false>(xq, xs, wq, ws, out, part, b, n, d, G, gpt,
                                 shape, splits, s);
  if (G >= 256)
    return launch_mma<32, true>(xq, xs, wq, ws, out, part, b, n, d, G, gpt,
                                shape, splits, s);
  return launch_mma<32, false>(xq, xs, wq, ws, out, part, b, n, d, G, gpt,
                               shape, splits, s);
}

// The fast matmul at any b: the kernel and its rows a block by the call's
// shape.
inline int fast_dispatch(BfGlobal act, const int8_t* wq, const float* ws,
                         float* out, int b, int n, int d, int G,
                         cudaStream_t s) {
  const int ng = n / G;
  // two columns a thread where more than about two waves of column blocks
  // share each activation load (measured on qwen3-0.6b's matrices)
  const bool wide = d > kFastWideCols;
  if (b <= 1) return launch_fast_split<1, 1>(act, wq, ws, out, b, n, d, G, s);
  if (b <= 8) {
    if (b <= 2)
      return wide ? launch_fast_split<2, 2>(act, wq, ws, out, b, n, d, G, s)
                  : launch_fast_split<2, 1>(act, wq, ws, out, b, n, d, G, s);
    if (b <= 4)
      return wide ? launch_fast_split<4, 2>(act, wq, ws, out, b, n, d, G, s)
                  : launch_fast_split<4, 1>(act, wq, ws, out, b, n, d, G, s);
    return wide ? launch_fast_split<8, 2>(act, wq, ws, out, b, n, d, G, s)
                : launch_fast_split<8, 1>(act, wq, ws, out, b, n, d, G, s);
  }
  if ((size_t)((d + kFastCols - 1) / kFastCols) * ((b + 63) / 64) >=
      kFastTileBlocks)
    return launch_fast_tile(act, wq, ws, out, b, n, d, G, s);
  if (G > 64) return launch_fast_split<8, 2>(act, wq, ws, out, b, n, d, G, s);
  if (ng <= 16 && b > 16)
    return launch_fast_split<32, 2>(act, wq, ws, out, b, n, d, G, s);
  return launch_fast_split<16, 2>(act, wq, ws, out, b, n, d, G, s);
}

}  // namespace

extern "C" {

// out = q8_fast(x, wq, ws): x bf16 [b, n], wq int8 [d, n], ws f32 [d, n/G],
// out f32 [b, d]. Launches on `stream` and returns cudaGetLastError().
int q8_fast_matmul(const void* x, const void* wq, const void* ws, void* out,
                   int b, int n, int d, int group_size, void* stream) {
  return fast_dispatch(BfGlobal{static_cast<const unsigned short*>(x)},
                       static_cast<const int8_t*>(wq),
                       static_cast<const float*>(ws), static_cast<float*>(out),
                       b, n, d, group_size, static_cast<cudaStream_t>(stream));
}

// The same against layer `layer` of stacked weights [L, d, n] / [L, d, n/G].
int q8_fast_matmul_stacked(const void* x, const void* wq, const void* ws,
                           int layer, void* out, int b, int n, int d,
                           int group_size, void* stream) {
  const size_t off = (size_t)layer * (size_t)d * (size_t)n;
  const int8_t* wl = static_cast<const int8_t*>(wq) + off;
  const float* sl = static_cast<const float*>(ws) + off / group_size;
  return q8_fast_matmul(x, wl, sl, out, b, n, d, group_size, stream);
}

// out = q8q8(xq, xs, wq, ws); gpt = groups per k-tile. At b > 1 `shape`
// (0-2: 16, 32 or 64 rows a block) and `splits` (k-tiles split over
// that many blocks a tile; part f32 [n / (G gpt), b, d] is their scratch,
// unused and may be null at 1) set the tile path's grid. Launches on
// `stream` and returns cudaGetLastError() as an int (0 = launched).
int q8q8_matmul(const void* xq, const void* xs, const void* wq,
                const void* ws, void* out, void* part, int b, int n, int d,
                int group_size, int gpt, int shape, int splits,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xq8 = static_cast<const int8_t*>(xq);
  const float* xsf = static_cast<const float*>(xs);
  const int8_t* wq8 = static_cast<const int8_t*>(wq);
  const float* wsf = static_cast<const float*>(ws);
  float* o = static_cast<float*>(out);
  if (b == 1)
    return launch_gemv(XqGlobal{xq8, xsf}, wq8, wsf, o, n, d, group_size, gpt,
                       false, s);
  return q8q8_tiles(xq8, xsf, wq8, wsf, o, static_cast<float*>(part), b, n, d,
                    group_size, gpt, shape, splits, s);
}

// The same against layer `layer` of stacked weights [L, d, n] / [L, d, n/G].
int q8q8_matmul_stacked(const void* xq, const void* xs, const void* wq,
                        const void* ws, int layer, void* out, void* part,
                        int b, int n, int d, int group_size, int gpt,
                        int shape, int splits, void* stream) {
  const size_t off = (size_t)layer * (size_t)d * (size_t)n;
  const int8_t* wl = static_cast<const int8_t*>(wq) + off;
  const float* sl = static_cast<const float*>(ws) + off / group_size;
  return q8q8_matmul(xq, xs, wl, sl, out, part, b, n, d, group_size, gpt,
                     shape, splits, stream);
}

}  // extern "C"
