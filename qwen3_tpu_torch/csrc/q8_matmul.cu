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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_attr.cuh"

namespace {

__device__ __forceinline__ int dot16(const int4 w, const int4 x, int acc) {
  acc = __dp4a(w.x, x.x, acc);
  acc = __dp4a(w.y, x.y, acc);
  acc = __dp4a(w.z, x.z, acc);
  acc = __dp4a(w.w, x.w, acc);
  return acc;
}

// b == 1 path. A block of kGemvThreads threads owns cols = kGemvWarps / wpc
// * CPW columns: warp w serves columns CPW * (w / wpc) + cc (cc < CPW) over
// piece w % wpc of their 512-byte chunks (contiguous pieces of whole
// chunks), NB chunks of each column in flight at a time. Requires G a power
// of two in [16, 512] and n % G == 0, so every chunk holds whole groups and
// the lanes of a group are aligned. Shared memory: the group terms,
// [cols][ng] floats.
constexpr int kGemvThreads = 256, kGemvWarps = kGemvThreads / 32;

template <int CPW, int NB>
__global__ void __launch_bounds__(kGemvThreads)
q8q8_gemv_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                 const int8_t* __restrict__ wq, const float* __restrict__ ws,
                 float* __restrict__ out, int n, int d, int G, int gpt,
                 int wpc) {
  extern __shared__ float terms[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ng = n / G, lpg = G >> 4;
  const int cols = kGemvWarps / wpc * CPW;
  const int slot0 = warp / wpc * CPW;   // this warp's first column slot
  const int c0 = blockIdx.x * cols + slot0;
  const int chunks = (n + 511) / 512;
  const int per = (chunks + wpc - 1) / wpc;
  const int j0 = warp % wpc * per, j1 = min(chunks, j0 + per);
  const int4 zero = make_int4(0, 0, 0, 0);
  for (int jb = j0; jb < j1; jb += NB) {
    // every load of the batch first ...
    int4 x[NB], w[CPW][NB];
    float sx[NB], sw[CPW][NB];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int k = (jb + i) * 512 + lane * 16;
      const bool in = jb + i < j1 && k < n;
      x[i] = in ? __ldg(reinterpret_cast<const int4*>(xq + k)) : zero;
      sx[i] = in ? __ldg(xs + k / G) : 0.f;
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
    const float* row = terms + slot * ng;
    float o = 0.f;
    for (int t0 = 0; t0 < n_tiles; t0 += 32) {
      const int t = t0 + lane;
      float acc = 0.f;
      if (t < n_tiles)
        for (int i = 0; i < gpt; ++i) acc = __fadd_rn(acc, row[t * gpt + i]);
      const int m = min(32, n_tiles - t0);
      for (int i = 0; i < m; ++i)
        o = __fadd_rn(o, __shfl_sync(0xffffffffu, acc, i));
    }
    const int c = blockIdx.x * cols + slot;
    if (lane == 0 && c < d) out[c] = o;
  }
}

// The GEMV's shape, from n and d: wpc warps share a column where d alone
// gives fewer than kGemvMinWarps warps (wo and w2 of qwen3-0.6b: 2) or a
// warp would walk more than kGemvMaxBatch chunks (long columns); NB, the
// chunks a warp has in flight, the least power of two that holds its
// piece; two columns a warp past kGemvPairCols columns (the classifier,
// whose 2-chunk columns would otherwise leave each lane 2 loads in
// flight). Registers, and with them the warps an SM holds, grow with NB
// and CPW. Returns a cudaError_t as an int.
constexpr int kGemvMinWarps = 2048, kGemvMaxBatch = 4,
              kGemvPairCols = 16384;

template <int CPW, int NB>
int launch_gemv_shape(const int8_t* xq, const float* xs, const int8_t* wq,
                      const float* ws, float* out, int n, int d, int G,
                      int gpt, int wpc, cudaStream_t s) {
  static size_t set[16] = {};
  const int cols = kGemvWarps / wpc * CPW;
  const size_t smem = sizeof(float) * (size_t)cols * (n / G);
  const int err = allow_smem(q8q8_gemv_kernel<CPW, NB>, smem, set);
  if (err) return err;
  const unsigned blocks = (unsigned)((d + cols - 1) / cols);
  q8q8_gemv_kernel<CPW, NB><<<blocks, kGemvThreads, smem, s>>>(
      xq, xs, wq, ws, out, n, d, G, gpt, wpc);
  return (int)cudaGetLastError();
}

template <int CPW>
int launch_gemv_cpw(const int8_t* xq, const float* xs, const int8_t* wq,
                    const float* ws, float* out, int n, int d, int G, int gpt,
                    int wpc, int per, cudaStream_t s) {
  if (per <= 2)
    return launch_gemv_shape<CPW, 2>(xq, xs, wq, ws, out, n, d, G, gpt, wpc,
                                     s);
  if (per <= 4)
    return launch_gemv_shape<CPW, 4>(xq, xs, wq, ws, out, n, d, G, gpt, wpc,
                                     s);
  return launch_gemv_shape<CPW, 8>(xq, xs, wq, ws, out, n, d, G, gpt, wpc, s);
}

int launch_gemv(const int8_t* xq, const float* xs, const int8_t* wq,
                const float* ws, float* out, int n, int d, int G, int gpt,
                cudaStream_t s) {
  const int chunks = (n + 511) / 512;
  int wpc = 1;
  while (wpc < kGemvWarps && 2 * wpc <= chunks &&
         ((size_t)d * wpc < kGemvMinWarps ||
          (chunks + wpc - 1) / wpc > kGemvMaxBatch))
    wpc *= 2;
  const int per = (chunks + wpc - 1) / wpc;
  if (d >= kGemvPairCols)
    return launch_gemv_cpw<2>(xq, xs, wq, ws, out, n, d, G, gpt, wpc, per, s);
  return launch_gemv_cpw<1>(xq, xs, wq, ws, out, n, d, G, gpt, wpc, per, s);
}

// b > 1 path: the int32 group dots on the int8 tensor cores (mma.sync
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
constexpr int kStageK = 64, kRowWords = kStageK / 4 + 4, kStages = 4;
constexpr int kScaleSlots = kStageK / 16;   // group scales a staged row
constexpr int kSlotsLog = kScaleSlots == 8 ? 3 : 2;

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

template <int MI, int NI, int WMW, int WNW, int KM, bool BIG>
__global__ void __launch_bounds__(32 * WMW * WNW)
q8q8_mma_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                const int8_t* __restrict__ wq, const float* __restrict__ ws,
                float* __restrict__ out, float* __restrict__ part, int b,
                int n, int d, int G, int gpt, int tps) {
  constexpr int BM = 16 * MI * WMW, BN = 8 * NI * WNW;
  constexpr int T = 32 * WMW * WNW, ROWS = BM + BN;
  extern __shared__ int4 mma_smem[];
  int* data = reinterpret_cast<int*>(mma_smem);   // [kStages][ROWS][kRowWords]
  float* scl = reinterpret_cast<float*>(data + kStages * ROWS * kRowWords);
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
  // the lane's ldmatrix row: A's row (lane & 15) at byte 16 (lane >> 4);
  // B's column 8 (lane >> 4) + (lane & 7) at byte 16 ((lane >> 3) & 1)
  const int a_off = (lane & 15) * kRowWords + 4 * (lane >> 4);
  const int b_off =
      (8 * (lane >> 4) + (lane & 7)) * kRowWords + 4 * ((lane >> 3) & 1);

  // each thread's copies, fixed but for k: 16-byte pieces of staged rows
  // and group scales (rows past the matrix load zeros; a copy past the
  // staged rows is none, since a zero-filling one would still write). Its
  // shared addresses are taken once, its row pointers advance a stage at a
  // time: at these sizes the kernel is bound by instruction issue
  static_assert((kStages & (kStages - 1)) == 0, "a power-of-two ring");
  constexpr int kPieces = kStageK / 16;
  constexpr int CP = (ROWS * kPieces + T - 1) / T;
  constexpr int CS = (ROWS * kScaleSlots + T - 1) / T;
  constexpr unsigned kNone = 0xffffffffu;
  constexpr unsigned kSlotBytes = ROWS * kRowWords * sizeof(int);
  constexpr unsigned kScaleSlotBytes = ROWS * kScaleSlots * sizeof(float);
  const unsigned data_s = (unsigned)__cvta_generic_to_shared(data);
  const unsigned scl_s = (unsigned)__cvta_generic_to_shared(scl);
  const int8_t* psrc[CP];
  unsigned pdst[CP];
  int pk[CP];
  bool pon[CP];
#pragma unroll
  for (int c = 0; c < CP; ++c) {
    const int e = tid + c * T, r = e / kPieces;
    const bool isx = r < BM;
    const int gr = isx ? r0 + r : c0 + r - BM;
    pon[c] = isx ? gr < b : gr < d;
    pk[c] = 16 * (e % kPieces);
    psrc[c] = pon[c] ? (isx ? xq : wq) + (size_t)gr * n + kbeg + pk[c] : xq;
    pdst[c] = e < ROWS * kPieces
                  ? data_s + (r * kRowWords + pk[c] / 4) * sizeof(int)
                  : kNone;
  }
  const float* ssrc[CS];
  unsigned sdst[CS];
  int sj[CS];
  bool son[CS];
#pragma unroll
  for (int c = 0; c < CS; ++c) {
    const int e = tid + c * T, r = e >> lgs, j = e & ((1 << lgs) - 1);
    const bool isx = r < BM;
    const int gr = isx ? r0 + r : c0 + r - BM;
    son[c] = isx ? gr < b : gr < d;
    sj[c] = j;
    ssrc[c] = son[c] ? (isx ? xs : ws) + (size_t)gr * ng + j : xs;
    sdst[c] = e < (ROWS << lgs)
                  ? scl_s + (r * kScaleSlots + j) * sizeof(float)
                  : kNone;
  }

  auto load = [&](int st) {   // called for st = 0, 1, 2, ... in order
    if (st < nst) {
      const int k0 = kbeg + st * kStageK;
      const unsigned so = (st & (kStages - 1)) * kSlotBytes;
      const bool full = k0 + kStageK <= kend;
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        const bool on = pon[c] && (full || k0 + pk[c] < kend);
        if (pdst[c] != kNone)
          cp_async16_s(pdst[c] + so, on ? psrc[c] : xq, on);
        if (pon[c]) psrc[c] += kStageK;
      }
      const unsigned sso = (st & (kStages - 1)) * kScaleSlotBytes;
      const int g0 = k0 >> lg;
#pragma unroll
      for (int c = 0; c < CS; ++c) {
        const bool on = son[c] && g0 + sj[c] < gend;
        if (sdst[c] != kNone)
          cp_async4_s(sdst[c] + sso, on ? ssrc[c] + g0 : ssrc[c], on);
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
    const int* A = data + (slot * ROWS + wr) * kRowWords;
    const int* B = data + (slot * ROWS + wc) * kRowWords;
    const float* sx = scl + (slot * ROWS + wr) * kScaleSlots;
    const float* sw = scl + (slot * ROWS + wc) * kScaleSlots;
#pragma unroll
    for (int ks = 0; ks < kStageK / KM; ++ks) {
      const int kw = ks * KM / 4 + tig;
      const bool fresh = ((k0 + ks * KM) & (G - 1)) == 0;
      int a[MI][4], bf[NI][2];
      if (KM == 32) {
#pragma unroll
        for (int i = 0; i < MI; ++i)
          ldsm_x4(a[i], A + 16 * i * kRowWords + ks * 8 + a_off);
#pragma unroll
        for (int j = 0; j < NI; j += 2) {
          int r[4];
          ldsm_x4(r, B + 8 * j * kRowWords + ks * 8 + b_off);
          bf[j][0] = r[0];
          bf[j][1] = r[1];
          bf[j + 1][0] = r[2];
          bf[j + 1][1] = r[3];
        }
      } else {   // m16n8k16: words 0 of A's two row halves and of B
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const int* ar = A + (16 * i + gid) * kRowWords + kw;
          a[i][0] = ar[0];
          a[i][1] = ar[8 * kRowWords];
          a[i][2] = a[i][3] = 0;
        }
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
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            wv[j][e] = sw[(8 * j + 2 * tig + e) * kScaleSlots + js];
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
  if (!part)
    store_tile<MI, NI>(o, out, b, d, r0 + wr + gid, c0 + wc - BM + 2 * tig);
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

template <int MI, int NI, int WMW, int WNW, int KM, bool BIG>
int launch_mma_shape(const int8_t* xq, const float* xs, const int8_t* wq,
                     const float* ws, float* out, float* part, int b, int n,
                     int d, int G, int gpt, int splits, cudaStream_t s) {
  static size_t set[16] = {};
  constexpr int BM = 16 * MI * WMW, BN = 8 * NI * WNW;
  const size_t smem = (size_t)kStages * (BM + BN) *
                      (kRowWords * sizeof(int) + kScaleSlots * sizeof(float));
  auto kernel = q8q8_mma_kernel<MI, NI, WMW, WNW, KM, BIG>;
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
template <int KM, bool BIG>
int launch_mma(const int8_t* xq, const float* xs, const int8_t* wq,
               const float* ws, float* out, float* part, int b, int n, int d,
               int G, int gpt, int shape, int splits, cudaStream_t s) {
  switch (shape) {
    case 0:
      return launch_mma_shape<1, 2, 1, 4, KM, BIG>(
          xq, xs, wq, ws, out, part, b, n, d, G, gpt, splits, s);
    case 1:
      return launch_mma_shape<2, 2, 1, 4, KM, BIG>(
          xq, xs, wq, ws, out, part, b, n, d, G, gpt, splits, s);
    case 2:
      return launch_mma_shape<2, 4, 2, 2, KM, BIG>(
          xq, xs, wq, ws, out, part, b, n, d, G, gpt, splits, s);
  }
  return (int)cudaErrorInvalidValue;
}

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
constexpr int kFastMinBlocks = 256;       // about two blocks an SM
constexpr int kFastSmemBudget = 112 * 1024;

__device__ __forceinline__ float bf16_bits_to_f32(unsigned short h) {
  return __uint_as_float(((unsigned)h) << 16);
}

template <int R, int TN>
__global__ void q8_fast_split_kernel(const unsigned short* __restrict__ x,
                                     const int8_t* __restrict__ wq,
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
    const int vecs = (min(ng, g0 + GP) - g0) * G / 8;  // int4s a row
    __syncthreads();  // the last pass's x_sm and part have been read
    for (int e = tid; e < R * vecs; e += T) {
      const int r = e / vecs, v = e % vecs;
      int4 xv = make_int4(0, 0, 0, 0);
      if (r < rows)
        xv = __ldg(reinterpret_cast<const int4*>(
                       x + (size_t)(r0 + r) * n + (size_t)g0 * G) + v);
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
                w[t][i] = __bfloat162float(
                    __float2bfloat16_rn(__fmul_rn((float)q[i], sc[t])));
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

template <int R, int TN>
int launch_fast_split(const void* x, const void* wq, const void* ws,
                      void* out, int b, int n, int d, int G, cudaStream_t s) {
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
  const int err = allow_smem(q8_fast_split_kernel<R, TN>, smem, set);
  if (err) return err;
  const dim3 blocks((unsigned)((d + CB - 1) / CB), (unsigned)row_tiles);
  q8_fast_split_kernel<R, TN><<<blocks, 32 * WG * WC, smem, s>>>(
      static_cast<const unsigned short*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(ws), static_cast<float*>(out), b, n, d, G,
      WG, WC);
  return (int)cudaGetLastError();
}

// The tile kernel: a block owns 64 rows x 64 columns with 256 threads; per
// chunk of kc = min(G, 64) k it stages the activations [64][kc] and the
// dequantized weights [64][kc] as f32 in shared memory (rows padded to 65
// words), and each thread runs 4 x 4 outputs as sequential fmaf chains,
// rows ty + 16 i and columns tx + 16 j.
constexpr int kFastCols = 64, kFastThreads = 256, kMaxChunk = 64;
// the tile kernel takes b > 8 once it has this many blocks
constexpr int kFastTileBlocks = 128;
// above this many columns the split kernel gives a thread two of them
constexpr int kFastWideCols = 4224;

__global__ void __launch_bounds__(kFastThreads)
q8_fast_tile_kernel(const unsigned short* __restrict__ x,
                    const int8_t* __restrict__ wq,
                    const float* __restrict__ ws, float* __restrict__ out,
                    int b, int n, int d, int G) {
  constexpr int BM = 64, TM = 4, TN = 4;
  constexpr int TY = BM / TM, TX = kFastThreads / TY;
  static_assert(TX * TN == kFastCols, "a block owns 64 columns");
  __shared__ float x_sm[BM][kMaxChunk + 1];
  __shared__ float w_sm[kFastCols][kMaxChunk + 1];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int r0 = blockIdx.y * BM, c0 = blockIdx.x * kFastCols;
  const int kc = min(G, kMaxChunk);
  const int chunks = G / kc;   // chunks per group
  const int xv = kc / 8;       // int4 loads per activation row per chunk
  const int wv = kc / 16;      // int4 loads per weight row per chunk
  const int ng = n / G;
  float o[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) o[i][j] = 0.f;

  for (int g = 0; g < ng; ++g) {
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
    for (int ch = 0; ch < chunks; ++ch) {
      const int k0 = g * G + ch * kc;
      for (int e = tid; e < BM * xv; e += kFastThreads) {
        const int r = e / xv, v = e % xv;
        int4 raw = make_int4(0, 0, 0, 0);
        if (r0 + r < b)
          raw = __ldg(reinterpret_cast<const int4*>(x + (size_t)(r0 + r) * n +
                                                    k0) + v);
        const unsigned short* h = reinterpret_cast<const unsigned short*>(&raw);
#pragma unroll
        for (int i = 0; i < 8; ++i) x_sm[r][8 * v + i] = bf16_bits_to_f32(h[i]);
      }
      for (int e = tid; e < kFastCols * wv; e += kFastThreads) {
        const int c = e / wv, v = e % wv;
        int4 raw = make_int4(0, 0, 0, 0);
        float sc = 0.f;
        if (c0 + c < d) {
          raw = __ldg(reinterpret_cast<const int4*>(wq + (size_t)(c0 + c) * n +
                                                    k0) + v);
          sc = ws[(size_t)(c0 + c) * ng + g];
        }
        const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int i = 0; i < 16; ++i)
          w_sm[c][16 * v + i] = __bfloat162float(
              __float2bfloat16_rn(__fmul_rn((float)q[i], sc)));
      }
      __syncthreads();
      for (int kk = 0; kk < kc; ++kk) {
        float xr[TM], wr[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) xr[i] = x_sm[ty + TY * i][kk];
#pragma unroll
        for (int j = 0; j < TN; ++j) wr[j] = w_sm[tx + TX * j][kk];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) s[i][j] = fmaf(xr[i], wr[j], s[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) o[i][j] = __fadd_rn(o[i][j], s[i][j]);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + ty + TY * i;
    if (r >= b) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = c0 + tx + TX * j;
      if (c < d) out[(size_t)r * d + c] = o[i][j];
    }
  }
}

int launch_fast_tile(const void* x, const void* wq, const void* ws, void* out,
                     int b, int n, int d, int G, cudaStream_t s) {
  const dim3 blocks((unsigned)((d + kFastCols - 1) / kFastCols),
                    (unsigned)((b + 63) / 64));
  q8_fast_tile_kernel<<<blocks, kFastThreads, 0, s>>>(
      static_cast<const unsigned short*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(ws), static_cast<float*>(out), b, n, d, G);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out = q8_fast(x, wq, ws): x bf16 [b, n], wq int8 [d, n], ws f32 [d, n/G],
// out f32 [b, d]. Launches on `stream` and returns cudaGetLastError().
int q8_fast_matmul(const void* x, const void* wq, const void* ws, void* out,
                   int b, int n, int d, int group_size, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = group_size, ng = n / G;
  // two columns a thread where more than about two waves of column blocks
  // share each activation load (measured on qwen3-0.6b's matrices)
  const bool wide = d > kFastWideCols;
  if (b <= 1) return launch_fast_split<1, 1>(x, wq, ws, out, b, n, d, G, s);
  if (b <= 8) {
    if (b <= 2)
      return wide ? launch_fast_split<2, 2>(x, wq, ws, out, b, n, d, G, s)
                  : launch_fast_split<2, 1>(x, wq, ws, out, b, n, d, G, s);
    if (b <= 4)
      return wide ? launch_fast_split<4, 2>(x, wq, ws, out, b, n, d, G, s)
                  : launch_fast_split<4, 1>(x, wq, ws, out, b, n, d, G, s);
    return wide ? launch_fast_split<8, 2>(x, wq, ws, out, b, n, d, G, s)
                : launch_fast_split<8, 1>(x, wq, ws, out, b, n, d, G, s);
  }
  if ((size_t)((d + kFastCols - 1) / kFastCols) * ((b + 63) / 64) >=
      kFastTileBlocks)
    return launch_fast_tile(x, wq, ws, out, b, n, d, G, s);
  if (G > 64) return launch_fast_split<8, 2>(x, wq, ws, out, b, n, d, G, s);
  if (ng <= 16 && b > 16)
    return launch_fast_split<32, 2>(x, wq, ws, out, b, n, d, G, s);
  return launch_fast_split<16, 2>(x, wq, ws, out, b, n, d, G, s);
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
    return launch_gemv(xq8, xsf, wq8, wsf, o, n, d, group_size, gpt, s);
  float* pf = static_cast<float*>(part);
  // an MMA never spans two groups; past G = 128 a dot may reach 2^22
  if (group_size == 16)
    return launch_mma<16, false>(xq8, xsf, wq8, wsf, o, pf, b, n, d,
                                 group_size, gpt, shape, splits, s);
  if (group_size >= 256)
    return launch_mma<32, true>(xq8, xsf, wq8, wsf, o, pf, b, n, d,
                                group_size, gpt, shape, splits, s);
  return launch_mma<32, false>(xq8, xsf, wq8, wsf, o, pf, b, n, d, group_size,
                               gpt, shape, splits, s);
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
