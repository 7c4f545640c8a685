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
//  - b > 8: q8_untiled_tile_kernel, a register-blocked SGEMM tile on CUDA
//    cores. Its first design (64 x 64 outputs a block of 256 threads, 4 x 4
//    a thread, so 8 shared loads for every 16 FMAs; k staged in min(G,
//    64)-row chunks through padded scalar stores, two barriers a chunk and
//    no load in flight) took 22.72 ms a 512-row block's 112 layer matrices
//    of qwen3-0.6b in f32 prescale, slower than its plain version (20.58)
//    and 3.4x its fp32-FMA bound (6.73; an NVIDIA H100 80GB HBM3 at 700 W,
//    chip_smoke.py). The bound is the FMAs: the function fixes each (row,
//    column, k-tile) sum as one fmaf chain in k order (the GEMV's rows, b
//    <= 8, must stay equal to these rows), so no tensor-core MMA can run it,
//    and what the kernel does about it is to issue little but FFMAs:
//    a block owns BM (64 or 128, plan_untiled's shape) rows x 128 columns
//    with 2 BM threads, 8 x 8 outputs a thread (4 shared 16-byte loads for
//    every 64 FMAs). k goes in stages of 16 rows through two shared buffers:
//    x transposed ([16][BM] f32, cd-rounded) and the weights dequantized
//    once while staging ([16][128] f32: int8 -> f32, times the scale and
//    cd-rounded in prescale), each staged weight serving BM rows. The
//    copies of the next two stages (two 16-byte x copies, 2-4 weight words
//    and one scale quad a thread, cp.async into a ring of raw stages that
//    only the copying thread reads back, so that no register holds them)
//    are in flight while a stage's 1024 FMAs a thread run, and halfway
//    through them each thread converts its landed copies of the next stage
//    into the other shared buffer; one barrier a stage. (Held in registers
//    instead, the copies made the prescale instances spill at the 128
//    registers of two blocks an SM.) The tile sums go straight to out (out
//    = 0 + acc_0, then out + acc_t, the block owning its outputs), so no
//    running sum is held in registers: prescale keeps 64 chains a thread,
//    postscale 64 more for the group's dot. Where the row and column
//    blocks alone fill the card too thinly, plan_untiled splits the k-tiles
//    evenly across blocks: block z writes each of its tiles' acc_t into
//    part[t], and the last of a (row, column) block's splits to finish (a
//    completion counter) adds them in order (out = ((0 + acc_0) + acc_1) +
//    ...), the same sums, in the same launch. Each row's arithmetic is the
//    same at any b, shape and split, so a row's bits do not depend on its
//    batch-mates or the route, and equal the GEMV's. It takes 13.9 ms a
//    512-row block's 112 layer matrices in f32 prescale, 2.06x the bound,
//    where cuBLAS SGEMM on the dequantized f32 weights takes 12.1 (the same
//    card, chip_smoke.py): the layer matrices are one thin wave each.
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

// ------------------------------------------------ the tile, b > 8 ----

// k-rows a stage, a block's columns, and the raw stages of the copy ring
// (kTileRing - 1 in flight while a stage computes)
constexpr int kTileK = 16, kTileCols = 128, kTileRing = 3;

// The block's dynamic shared memory: x transposed [2][kTileK][BM] f32, the
// dequantized weights [2][kTileK][kTileCols] f32, then kTileRing raw
// stages, each the 2 BM threads' own copies: x float4s (two a thread),
// weight words (kTileK * 32 in all, 2 or 4 a thread) and scale quads (one
// a thread); then a split's last-block flag
template <int BM>
__host__ __device__ constexpr int tile_raw_bytes() {
  return 2 * (2 * BM) * 16 + kTileK * 32 * 4 + (2 * BM) * 16;
}
template <int BM>
__host__ __device__ constexpr int tile_smem_bytes() {   // + the split's flag
  return 2 * kTileK * (BM + kTileCols) * 4 + kTileRing * tile_raw_bytes<BM>() +
         16;
}

// Thread (ty, tx) = (tid / 16, tid % 16) owns rows 4 ty + i and BM / 2 +
// 4 ty + i, columns 4 tx + j and 64 + 4 tx + j (i, j < 4) of the block's
// tile. Block z of the grid takes k-tiles z tps .. + tps - 1; with `part`
// it writes each tile's sum there, else it adds them into out in order.
// Requires G a power of two in [16, 512], n % tk == 0, tk % G == 0, d % 4
// == 0, x 16-byte aligned.
template <int BM, bool BF16, bool POST>
__global__ void __launch_bounds__(2 * BM, POST ? 1 : 256 / BM)
q8_untiled_tile_kernel(const float* __restrict__ x,
                       const int8_t* __restrict__ wq,
                       const float* __restrict__ ws, float* out, float* part,
                       int* counters, int b, int n, int d, int G, int tk,
                       int tps) {
  constexpr int NT = 2 * BM;                  // threads
  constexpr int XL = BM * kTileK / 4 / NT;    // 16-byte x loads a thread: 2
  constexpr int WR = kTileK * 32 / NT;        // weight words a thread: 2 or 4
  constexpr int RB = tile_raw_bytes<BM>();
  extern __shared__ int4 tile_smem[];
  auto xs = reinterpret_cast<float (*)[kTileK][BM]>(tile_smem);
  auto wsm = reinterpret_cast<float (*)[kTileK][kTileCols]>(
      reinterpret_cast<char*>(tile_smem) + 2 * kTileK * BM * 4);
  char* raw = reinterpret_cast<char*>(tile_smem) +
              2 * kTileK * (BM + kTileCols) * 4;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int r0 = blockIdx.y * BM, c0 = blockIdx.x * kTileCols;
  const int t0 = blockIdx.z * tps;
  const int kbeg = t0 * tk, nstage = tps * (tk / kTileK);
  const int spt = tk / kTileK, lg = 31 - __clz(G);
  // staging: x copy i of a thread is row e % BM, k-quad e / BM (e = tid +
  // NT i), so a warp stores 32 rows of one k into a [16][BM] row; weight
  // word i is k-row tid / 32 + (NT / 32) i, columns 4 (tid % 32) .. + 3
  const int cq = tid & 31, wc = c0 + 4 * cq;
  const bool won = wc < d;    // d % 4 == 0: a quad is all in or all out
  const unsigned raw_s = (unsigned)__cvta_generic_to_shared(raw);

  // stage s's copies into raw stage s % kTileRing, one commit group (empty
  // past the last stage)
  auto fetch = [&](int s) {
    if (s >= nstage) {
      cp_async_commit();
      return;
    }
    const int k0 = kbeg + s * kTileK;
    const unsigned sx = raw_s + (s % kTileRing) * RB;
    const unsigned sw = sx + XL * NT * 16, ss = sw + WR * NT * 4;
#pragma unroll
    for (int i = 0; i < XL; ++i) {
      const int e = tid + NT * i, r = e % BM, kq = e / BM;
      const bool on = r0 + r < b;
      cp_async16_s(sx + 16 * e,
                   on ? (const void*)(x + (size_t)(r0 + r) * n + k0 + 4 * kq)
                      : (const void*)x,
                   on);
    }
#pragma unroll
    for (int i = 0; i < WR; ++i) {
      const int kr = (tid >> 5) + (NT / 32) * i;
      cp_async4_s(sw + 4 * (tid + NT * i),
                  won ? (const void*)(wq + (size_t)(k0 + kr) * d + wc)
                      : (const void*)wq,
                  won);
    }
    if (!POST)   // a stage lies in one group (kTileK <= G)
      cp_async16_s(ss + 16 * tid,
                   won ? (const void*)(ws + (size_t)(k0 >> lg) * d + wc)
                       : (const void*)ws,
                   won);
    cp_async_commit();
  };

  // stage s's copies, landed (this thread's own), into shared buffer s & 1:
  // x transposed and cd-rounded, the weights dequantized
  auto stash = [&](int s) {
    cp_async_wait<kTileRing - 2>();
    const int buf = s & 1;
    const char* st = raw + (s % kTileRing) * RB;
    const float4* raw_x = reinterpret_cast<const float4*>(st);
    const int* raw_w = reinterpret_cast<const int*>(st + XL * NT * 16);
    const float4* raw_sc =
        reinterpret_cast<const float4*>(st + XL * NT * 16 + WR * NT * 4);
#pragma unroll
    for (int i = 0; i < XL; ++i) {
      const int e = tid + NT * i, r = e % BM, kq = e / BM;
      const float4 q = raw_x[e];
      const float v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        xs[buf][4 * kq + j][r] = BF16 ? round_bf16(v[j]) : v[j];
    }
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
    if (!POST) {
      const float4 q = raw_sc[tid];
      sc[0] = q.x; sc[1] = q.y; sc[2] = q.z; sc[3] = q.w;
    }
#pragma unroll
    for (int i = 0; i < WR; ++i) {
      const int kr = (tid >> 5) + (NT / 32) * i, word = raw_w[tid + NT * i];
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float f =   // byte j, sign-extended: exact
            (float)((int)((unsigned)word << (24 - 8 * j)) >> 24);
        v[j] = POST ? f : BF16 ? round_bf16(__fmul_rn(f, sc[j]))
                               : __fmul_rn(f, sc[j]);
      }
      *reinterpret_cast<float4*>(&wsm[buf][kr][4 * cq]) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  };

  // prescale: acc the tile's chains; postscale: sg the group's, acc the
  // tile's sum of the scaled group dots
  float acc[8][8], sg[POST ? 8 : 1][POST ? 8 : 1];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[i][j] = 0.f;
      if constexpr (POST) sg[i][j] = 0.f;
    }

#pragma unroll
  for (int q = 0; q < kTileRing - 1; ++q) fetch(q);
  stash(0);
  __syncthreads();
  int ks = 0;   // stages done in the current k-tile
  for (int s = 0; s < nstage; ++s) {
    fetch(s + kTileRing - 1);
    const int buf = s & 1;
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      // the next stage into the other buffer (last read before the previous
      // barrier), halfway, so that its latency hides behind the FMAs
      if (kk == kTileK / 2 && s + 1 < nstage) stash(s + 1);
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[buf][kk][4 * ty]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&xs[buf][kk][BM / 2 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&wsm[buf][kk][4 * tx]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&wsm[buf][kk][64 + 4 * tx]);
      const float xv[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float wv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if constexpr (POST)
            sg[i][j] = fmaf(xv[i], wv[j], sg[i][j]);
          else
            acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
        }
    }
    const int kend = kbeg + (s + 1) * kTileK;
    if constexpr (POST) {
      if ((kend & (G - 1)) == 0) {   // a group ends: acc += dot * scale
        const size_t g = (size_t)((kend >> lg) - 1) * d;
        float sc[8];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c0 + 64 * h + 4 * tx;
          const float4 q = c < d ? __ldg(reinterpret_cast<const float4*>(
                                       ws + g + c))
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
          sc[4 * h] = q.x; sc[4 * h + 1] = q.y;
          sc[4 * h + 2] = q.z; sc[4 * h + 3] = q.w;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(sg[i][j], sc[j]));
            sg[i][j] = 0.f;
          }
      }
    }
    if (++ks == spt) {   // a k-tile ends: its sum to part, or into out
      ks = 0;
      const int t = kend / tk - 1;
      float* dst = part != nullptr ? part + (size_t)t * b * d : out;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = r0 + (i < 4 ? 4 * ty + i : BM / 2 + 4 * ty + i - 4);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c0 + 64 * h + 4 * tx;
          if (r < b && c < d) {
            float4* p = reinterpret_cast<float4*>(dst + (size_t)r * d + c);
            float4 o = make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                   acc[i][4 * h + 2], acc[i][4 * h + 3]);
            if (part == nullptr) {   // out = out + acc_t, out from 0
              const float4 q = t == t0 ? make_float4(0.f, 0.f, 0.f, 0.f) : *p;
              o = make_float4(__fadd_rn(q.x, o.x), __fadd_rn(q.y, o.y),
                              __fadd_rn(q.z, o.z), __fadd_rn(q.w, o.w));
            }
            *p = o;
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      }
    }
    __syncthreads();
  }
  if (part == nullptr) return;
  // split: the last of the (row, column) block's gridDim.z blocks to finish
  // adds every tile's sum in order, out = ((0 + acc_0) + acc_1) + ..., and
  // leaves its counter at 0 for the next call on the stream
  int& last = *reinterpret_cast<int*>(raw + kTileRing * RB);
  __threadfence();
  int* counter = counters + (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0) {
    last = atomicAdd(counter, 1) == (int)gridDim.z - 1;
    if (last) *counter = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int nt = (int)gridDim.z * tps;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + (i < 4 ? 4 * ty + i : BM / 2 + 4 * ty + i - 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + 64 * h + 4 * tx;
      if (r >= b || c >= d) continue;
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int t = 0; t < nt; ++t) {   // other blocks' writes: through L2
        const float4 q = __ldcg(reinterpret_cast<const float4*>(
            part + ((size_t)t * b + r) * d + c));
        o = make_float4(__fadd_rn(o.x, q.x), __fadd_rn(o.y, q.y),
                        __fadd_rn(o.z, q.z), __fadd_rn(o.w, q.w));
      }
      *reinterpret_cast<float4*>(out + (size_t)r * d + c) = o;
    }
  }
}

// The tile kernel at BM rows a block, its k-tiles split over `splits`
// blocks (a divisor of the tile count; part: f32 [nt, b, d] and counters:
// int32 zeros, one a (row, column) block, when splits > 1), one launch
template <int BM, bool BF16, bool POST>
int launch_tile(const float* x, const int8_t* wq, const float* ws, float* out,
                float* part, int* counters, int b, int n, int d, int G,
                int tk, int splits, cudaStream_t s) {
  const int nt = n / tk;
  if (splits < 1 || nt % splits != 0 ||
      (splits > 1 && (part == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  static size_t set[16] = {};
  auto kernel = q8_untiled_tile_kernel<BM, BF16, POST>;
  const int err = allow_smem(kernel, tile_smem_bytes<BM>(), set);
  if (err) return err;
  const dim3 grid((unsigned)((d + kTileCols - 1) / kTileCols),
                  (unsigned)((b + BM - 1) / BM), (unsigned)splits);
  kernel<<<grid, 2 * BM, tile_smem_bytes<BM>(), s>>>(
      x, wq, ws, out, splits > 1 ? part : nullptr, counters, b, n, d, G, tk,
      nt / splits);
  return (int)cudaGetLastError();
}

template <bool BF16, bool POST>
int untiled_tiles(const float* x, const int8_t* wq, const float* ws,
                  float* out, float* part, int* counters, int b, int n, int d,
                  int G, int tk, int shape, int splits, cudaStream_t s) {
  if (shape == 0)
    return launch_tile<64, BF16, POST>(x, wq, ws, out, part, counters, b, n, d,
                                       G, tk, splits, s);
  if (shape == 1)
    return launch_tile<128, BF16, POST>(x, wq, ws, out, part, counters, b, n,
                                        d, G, tk, splits, s);
  return (int)cudaErrorInvalidValue;
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
// launch; else the tile kernel at plan_untiled's `shape` (0: 64 rows a
// block, 1: 128) with its k-tiles split over `splits` blocks (a divisor of
// the n / (gpt G) tiles; when splits > 1, part: f32 [n / (gpt G), b, d]
// scratch and counters: int32 zeros, one a (row, column) block, left at
// 0), one launch. Launches on `stream` and returns cudaGetLastError() (0 =
// launched).
int q8_untiled(const void* x, const void* wq, const void* ws, void* out,
               void* part, void* counters, int b, int n, int d,
               int group_size, int gpt, int bf16, int postscale, int gemv,
               int shape, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int8_t* w8 = static_cast<const int8_t*>(wq);
  const float* wsf = static_cast<const float*>(ws);
  float* o = static_cast<float*>(out);
  const int G = group_size;
  if (gemv) {
    if (bf16)
      return postscale ? untiled_gemv_rows<true, true>(xf, w8, wsf, o, b, n, d,
                                                       G, gpt, s)
                       : untiled_gemv_rows<true, false>(xf, w8, wsf, o, b, n,
                                                        d, G, gpt, s);
    return postscale ? untiled_gemv_rows<false, true>(xf, w8, wsf, o, b, n, d,
                                                      G, gpt, s)
                     : untiled_gemv_rows<false, false>(xf, w8, wsf, o, b, n,
                                                       d, G, gpt, s);
  }
  float* pt = static_cast<float*>(part);
  int* cn = static_cast<int*>(counters);
  const int tk = gpt * G;
  if (bf16)
    return postscale ? untiled_tiles<true, true>(xf, w8, wsf, o, pt, cn, b, n,
                                                 d, G, tk, shape, splits, s)
                     : untiled_tiles<true, false>(xf, w8, wsf, o, pt, cn, b, n,
                                                  d, G, tk, shape, splits, s);
  return postscale ? untiled_tiles<false, true>(xf, w8, wsf, o, pt, cn, b, n,
                                                d, G, tk, shape, splits, s)
                   : untiled_tiles<false, false>(xf, w8, wsf, o, pt, cn, b, n,
                                                 d, G, tk, shape, splits, s);
}

}  // extern "C"
