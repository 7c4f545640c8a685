// Flash GQA attention over the KV cache for Hopper (sm_90a), bound to Python
// through ctypes.
//
// Replaces the TPU kernels qwen3_tpu/ops/pallas/flash_decode.py::
// flash_decode_gqa (a decode step: one query token per slot),
// ::flash_decode_gqa_two_segment (a serving decode step: main cache rows
// below the chunk's base position plus the chunk's side buffer) and
// ::flash_prefill_gqa (a prefill block: T query rows, block-causal). All
// compute, per query row and query head h (kv head h / M, M = H / KV):
//
//   out = sum_s p_s * vs_s * v_s / sum_s p_s,   p_s = exp(x_s - max_s x_s),
//   x_s = (q . k_s) * (1/sqrt(D)) * ks_s        over the row's visible rows
//
// with ks/vs the int8 cache's per-(row, kv head) scales (1 without them), as
// an online softmax over tiles of the cache in true fp32: rows past the
// position are masked to -FLT_MAX, their p is an exact 0, and a tile wholly
// past the position is never read. expf (not __expf); the build's
// -fmad=false keeps a*b+c uncontracted, the dot products use explicit fmaf.
//
// Layout (the JAX package's own):
//   q     f32 [B, H, D] (decode) or [B, T, H, D] (prefill)
//   k, v  f32 / bf16 / int8 [B, S, KV, D]      ks, vs  f32 [B, S, KV] or null
//   pos   int32 [B] (decode) or [T] (prefill, increasing)
//   out   f32, q's shape
// D is a power of two from 16 to 128.
//
// Decode is bound by bytes: at depth p it must read 2 p KV D cache bytes
// (int8) and 2 p KV scales per layer, and does 4 H D flops per row, far
// below the card's ratio. The TPU walks the tiles of one slot in order on
// one core; here that sequential axis becomes parallel blocks, a block per
// (S-tile of ts rows, kv head, slot), whose unnormalised partials (acc, m,
// l) for the M query heads of the kv head are combined in tile order. The
// first design (a block of 128 threads walking 64-row chunks behind three
// barriers each, and a second kernel for the combine) took 33 us a layer at
// depth 8192 against a 5.2 us byte bound on an NVIDIA H100 80GB HBM3 at
// 700 W. decode_partial.cuh's kernel now:
//  - launches once: the last block of a (slot, kv head) to finish, told so
//    by a counter and a __threadfence, combines the slot's partials in tile
//    order (side tile last), never in the order of arrival, and resets the
//    counter for the next call;
//  - walks without barriers: each lane group (the lanes of one cache row,
//    16 bytes a lane) keeps its own online softmax over the rows it reads,
//    and the groups merge by shuffles, the warps in warp order, once per
//    block;
//  - keeps loads in flight: each warp has its own 4-stage cp.async ring of
//    K and V pieces and scales, filled while it computes.
// The two-segment form reads the side buffer as one more tile per slot,
// combined after the main tiles (the TPU kernel's last grid step); a slot
// at base position 0 reads no main tile at all. batched_decode.cu shares
// the kernel.
//
// Prefill is bound by operations: 4 T H S D flops per layer against K/V
// bytes that are read once per query tile. The first design (a block per
// query tile of 128 score rows, fp32 FMAs on CUDA cores, each chunk loaded,
// then converted, then used, behind three barriers) took 87.16 ms a 28-layer
// block at T = 512 from depth 8192 on an NVIDIA H100 80GB HBM3 at 700 W,
// its bound 14.81 ms: it had 64 blocks for 132 SMs, no load in flight while
// it computed, and 17% of the fp32 peak. This design:
//  - fills the card: a block owns (query tile of tq rows, segment of the
//    tile's 64-row chunks, kv head, slot), tq * M <= 64 score rows (16 a
//    warp, 4 warps). The host (ops/cuda/flash_decode.py::plan_prefill)
//    picks the segment length so that the grid holds about two waves of
//    two blocks an SM; a tile's chunks are cut into near-equal segments
//    (prefill_segment below), as many as the grid holds at most, so `live`
//    sizes the grid and never the result, and a tile with few chunks stays
//    whole. Each block of a split tile writes its unnormalised partial
//    (acc, m, l) per score row, and prefill_combine_kernel adds a row's
//    segments in segment order: no atomics, so the output repeats bit for
//    bit;
//  - overlaps loads and math: the next chunk's K/V (int8 and bf16: 16-byte
//    loads into registers) is in flight while the block computes this one,
//    and is converted to fp32 in shared memory once per block and chunk;
//  - uses the tensor cores under the fp32 contract: Q K^T and P V run on
//    mma.sync m16n8k8 TF32 with every fp32 operand split into hi + lo TF32
//    parts (x = hi + lo to 2^-22): int8 and bf16 cache values are exact in
//    TF32, so hi(q) k + lo(q) k is the whole product to 2^-22 (two MMAs);
//    an fp32 cache adds hi(q) lo(k) (three MMAs, the 3xTF32 split; lo*lo,
//    below 2^-22, is dropped). Plain TF32 (one MMA, 2^-11) is not used.
// The accumulators stay in registers in the MMA's fragment layout; P goes
// from the score fragment to the P V operand without a shuffle, by taking
// score column 2t (2t + 1) as the operand's k index t (t + 4) and reading
// V's rows in the same order. Bound by operations: at two TF32 MMAs a
// product over 495 TFLOP/s, 4.01 ms a 28-layer block at T = 512 from 8192
// (14.81 ms in fp32 over 67). On the same card (chip_smoke.py): 17.16 ms,
// 58 fp32-equivalent TFLOP/s, scaled_dot_product_attention on K/V
// dequantized to fp32 61.30 ms; a 64-row block at 8192 0.112 ms a launch
// (the first design about 3).

#include "decode_partial.cuh"
#include "smem_attr.cuh"

namespace {

// --------------------------------------------------------------- prefill --

constexpr int kPreThreads = 128, kPreWarps = kPreThreads / 32;
constexpr int kRows = 16 * kPreWarps;      // score rows (query rows x heads)
constexpr int kCols = 64;                  // cache rows per chunk

// the fp32 value x as a TF32 operand, rounded to nearest (ties away)
__device__ __forceinline__ uint32_t tf32_of(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32; x - hi is exact in fp32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_of(x);
  lo = tf32_of(x - __uint_as_float(hi));
}

// c += a b over a 16 x 8 x 8 tile: a 16 x 8 row-major, b 8 x 8 col-major,
// lane (g, t) = (lane / 4, lane % 4) holds a (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4); b (t, g), (t + 4, g); c (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Chunks [first, end) of segment j of a tile with `chunks` chunks cut into
// near-equal segments of at most max(seg, ceil(chunks / n_seg)) chunks
// (ops/cuda/flash_decode.py::prefill_segments): at most n_seg segments, so
// the grid holds every chunk whatever `live` the plan was made for; first
// >= end when the tile has no segment j.
__device__ __forceinline__ void prefill_segment(int chunks, int seg,
                                                int n_seg, int j, int& first,
                                                int& end) {
  seg = max(seg, (chunks + n_seg - 1) / n_seg);
  const int n_t = (chunks + seg - 1) / seg;
  first = j < n_t ? (int)((long long)j * chunks / n_t) : chunks;
  end = j < n_t ? (int)((long long)(j + 1) * chunks / n_t) : chunks;
}

// the chunks query tile qt sees: rows 0 .. its last position, within S
__device__ __forceinline__ int prefill_chunks(const int* qpos, int qt, int tq,
                                              int T_, int S) {
  const int last = qpos[min(qt * tq + tq - 1, T_ - 1)];
  return min(max(last, 0) / kCols + 1, (S + kCols - 1) / kCols);
}

template <typename T, int D>
constexpr size_t prefill_smem() {
  constexpr int dp = D + 4;
  constexpr int kv_parts = sizeof(T) == 4 ? 2 : 1;   // fp32: hi and lo
  return sizeof(float) * ((size_t)kRows * dp + 2 * kv_parts * kCols * dp +
                          2 * kCols) +
         sizeof(int) * kRows;
}

// One block per (query tile, segment, kv head + KV * slot). Score row
// r = tl * M + mm is query t0 + tl at head kv * M + mm; warp w owns score
// rows 16 w .. 16 w + 15. Shared memory: q [kRows][D + 4] fp32, K and V
// [kCols][D + 4] fp32 each (an fp32 cache: their TF32 hi parts, then the lo
// parts), the chunk's K and V scales and each score row's position. Rows
// are padded by 4 floats, so the fragments' reads hit 32 distinct banks.
template <typename T, int D>
__global__ void __launch_bounds__(kPreThreads)
flash_prefill_kernel(const float* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ ks,
                     const float* __restrict__ vs,
                     const int* __restrict__ qpos, float* __restrict__ out,
                     float* __restrict__ part_acc,
                     float* __restrict__ part_ml, int T_, int S, int KV,
                     int M, int tq, int seg, float scale) {
  constexpr bool kSplitKV = sizeof(T) == 4;
  // int8 and bf16 chunks are loaded ahead into registers; fp32 ones (2-4x
  // the registers) when their turn comes
  constexpr bool kAhead = !kSplitKV;
  constexpr int dp = D + 4;
  constexpr int E = Row16<T>::E;
  constexpr int vpr = D / E;                  // 16-byte pieces a row
  constexpr int kPass = (kCols * vpr + kPreThreads - 1) / kPreThreads;
  constexpr int KS = D / 8;                   // 8-wide steps over D
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                                   // [kRows][dp]
  float* k_s = q_s + kRows * dp;                       // [kCols][dp] (x2)
  float* v_s = k_s + (kSplitKV ? 2 : 1) * kCols * dp;  // [kCols][dp] (x2)
  float* kss = v_s + (kSplitKV ? 2 : 1) * kCols * dp;  // [kCols]
  float* vss = kss + kCols;                            // [kCols]
  int* rpos = reinterpret_cast<int*>(vss + kCols);     // [kRows]

  const int qt = blockIdx.x, j = blockIdx.y;
  const int kv = blockIdx.z % KV, b = blockIdx.z / KV;
  const int chunks = prefill_chunks(qpos, qt, tq, T_, S);
  int c_first, c_end;
  prefill_segment(chunks, seg, gridDim.y, j, c_first, c_end);
  if (c_first >= c_end) return;   // the tile has no segment j
  const int t0 = qt * tq, H = KV * M, rows = tq * M;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  for (int i = tid; i < kRows * (D / 4); i += kPreThreads) {
    const int r = i / (D / 4), c = i % (D / 4);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) {
      const int tl = r / M, mm = r % M;
      x = __ldg(reinterpret_cast<const float4*>(
                    q + (((size_t)b * T_ + t0 + tl) * H + kv * M + mm) * D) +
                c);
    }
    *reinterpret_cast<float4*>(q_s + r * dp + 4 * c) = x;
  }
  for (int r = tid; r < kRows; r += kPreThreads)
    rpos[r] = r < rows ? qpos[t0 + r / M] : -1;

  const size_t row_stride = (size_t)KV * D;
  const T* kb = k + ((size_t)b * S * KV + kv) * D;
  const T* vb = v + ((size_t)b * S * KV + kv) * D;
  // a chunk's values as fp32 (an fp32 cache: TF32 hi at [r][c], lo at
  // [kCols + r][c]) into shared memory
  auto put = [&](int r, int pc, const int4 kr, const int4 vr) {
    float kx[E], vx[E];
    Row16<T>::cvt(kr, kx);
    Row16<T>::cvt(vr, vx);
    float* kd = k_s + r * dp + pc * E;
    float* vd = v_s + r * dp + pc * E;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if constexpr (kSplitKV) {
        uint32_t hi, lo;
        split_tf32(kx[e], hi, lo);
        kd[e] = __uint_as_float(hi);
        kd[kCols * dp + e] = __uint_as_float(lo);
        split_tf32(vx[e], hi, lo);
        vd[e] = __uint_as_float(hi);
        vd[kCols * dp + e] = __uint_as_float(lo);
      } else {
        kd[e] = kx[e];
        vd[e] = vx[e];
      }
    }
  };
  // a scale of the chunk at c0: threads < kCols a K one, kCols .. 2 kCols a
  // V one (kss and vss are adjacent)
  auto scale_of = [&](int c0, int n) {
    const float* sp = tid < kCols ? ks : vs;
    const int sr = tid % kCols;
    return (sp && tid < 2 * kCols && sr < n)
               ? sp[((size_t)b * S + c0 + sr) * KV + kv]
               : 1.f;
  };
  // int8 and bf16: the next chunk's 16-byte pieces in registers
  int4 kraw[kAhead ? kPass : 1], vraw[kAhead ? kPass : 1];
  float sraw = 1.f;
  auto issue = [&](int c0) {
    const int n = min(kCols, S - c0);
#pragma unroll
    for (int ps = 0; ps < (kAhead ? kPass : 0); ++ps) {
      const int i = tid + ps * kPreThreads, r = i / vpr, pc = i % vpr;
      kraw[ps] = vraw[ps] = make_int4(0, 0, 0, 0);
      if (i < kCols * vpr && r < n) {
        kraw[ps] = load16(kb + (size_t)(c0 + r) * row_stride + pc * E);
        vraw[ps] = load16(vb + (size_t)(c0 + r) * row_stride + pc * E);
      }
    }
    sraw = scale_of(c0, n);
  };
  // the chunk at c0 into shared memory: from the registers, or (fp32)
  // loaded now
  auto stage = [&](int c0) {
    if constexpr (kAhead) {
#pragma unroll
      for (int ps = 0; ps < kPass; ++ps) {
        const int i = tid + ps * kPreThreads;
        if (i < kCols * vpr) put(i / vpr, i % vpr, kraw[ps], vraw[ps]);
      }
    } else {
      const int n = min(kCols, S - c0);
      for (int i = tid; i < kCols * vpr; i += kPreThreads) {
        const int r = i / vpr, pc = i % vpr;
        int4 kr = make_int4(0, 0, 0, 0), vr = kr;
        if (r < n) {
          kr = load16(kb + (size_t)(c0 + r) * row_stride + pc * E);
          vr = load16(vb + (size_t)(c0 + r) * row_stride + pc * E);
        }
        put(r, pc, kr, vr);
      }
      sraw = scale_of(c0, n);
    }
    if (tid < 2 * kCols) kss[tid] = sraw;
  };

  // this lane's accumulators: score rows 16 w + g and 16 w + g + 8
  float o[KS][4];
#pragma unroll
  for (int nt = 0; nt < KS; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  float m_run[2] = {kNeg, kNeg}, l_run[2] = {0.f, 0.f};
  const int r0 = 16 * w + g;
  const float* qa = q_s + r0 * dp + t;

  if (kAhead) issue(c_first * kCols);
  for (int c = c_first; c < c_end; ++c) {
    const int c0 = c * kCols;
    const int n = min(kCols, S - c0);
    __syncthreads();   // the last chunk's readers are done (and q, rpos set)
    stage(c0);
    if (kAhead && c + 1 < c_end) issue(c0 + kCols);
    __syncthreads();   // this chunk is in shared memory

    // scores: s = q k^T over this warp's 16 rows and the chunk's 64 columns
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ah[4], al[4];
      split_tf32(qa[kk * 8], ah[0], al[0]);
      split_tf32(qa[kk * 8 + 8 * dp], ah[1], al[1]);
      split_tf32(qa[kk * 8 + 4], ah[2], al[2]);
      split_tf32(qa[kk * 8 + 8 * dp + 4], ah[3], al[3]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float* kr = k_s + (nt * 8 + g) * dp + kk * 8 + t;
        const uint32_t b0 = __float_as_uint(kr[0]);
        const uint32_t b1 = __float_as_uint(kr[4]);
        mma_tf32(s[nt], al, b0, b1);
        if (kSplitKV)
          mma_tf32(s[nt], ah, __float_as_uint(kr[kCols * dp]),
                   __float_as_uint(kr[kCols * dp + 4]));
        mma_tf32(s[nt], ah, b0, b1);
      }
    }

    // online softmax per score row (h = 0: row r0, h = 1: row r0 + 8); the
    // lane holds columns 8 nt + 2t + e, the quad (lanes 4g .. 4g + 3) a row
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rp = rpos[r0 + 8 * h];
      float mx = kNeg;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = nt * 8 + 2 * t + e;
          float x = kNeg;
          if (col < n && c0 + col <= rp) {
            x = s[nt][2 * h + e] * scale;
            if (ks) x = x * kss[col];
          }
          s[nt][2 * h + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m_run[h], mx);
      const float alpha = expf(m_run[h] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = nt * 8 + 2 * t + e;
          const float pr =
              (col < n && c0 + col <= rp) ? expf(s[nt][2 * h + e] - m_new)
                                          : 0.f;
          sum += pr;
          s[nt][2 * h + e] = vs ? pr * vss[col] : pr;
        }
      // the lane's share of l; the quad's shares are added at the end
      l_run[h] = l_run[h] * alpha + sum;
      m_run[h] = m_new;
#pragma unroll
      for (int nt = 0; nt < KS; ++nt) {
        o[nt][2 * h] = o[nt][2 * h] * alpha;
        o[nt][2 * h + 1] = o[nt][2 * h + 1] * alpha;
      }
    }

    // o += (p * vs) V: the k index t (t + 4) of step kk is score column
    // 8 kk + 2t (2t + 1), so V's rows are read in that order
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t ah[4], al[4];
      split_tf32(s[kk][0], ah[0], al[0]);
      split_tf32(s[kk][2], ah[1], al[1]);
      split_tf32(s[kk][1], ah[2], al[2]);
      split_tf32(s[kk][3], ah[3], al[3]);
#pragma unroll
      for (int nt = 0; nt < KS; ++nt) {
        const float* vr = v_s + (kk * 8 + 2 * t) * dp + nt * 8 + g;
        const uint32_t b0 = __float_as_uint(vr[0]);
        const uint32_t b1 = __float_as_uint(vr[dp]);
        mma_tf32(o[nt], al, b0, b1);
        if (kSplitKV)
          mma_tf32(o[nt], ah, __float_as_uint(vr[kCols * dp]),
                   __float_as_uint(vr[kCols * dp + dp]));
        mma_tf32(o[nt], ah, b0, b1);
      }
    }
  }

  const bool split = gridDim.y > 1;
  const size_t part =
      (((size_t)b * KV + kv) * gridDim.x + qt) * gridDim.y + j;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(kFull, l, 1);
    l += __shfl_xor_sync(kFull, l, 2);
    const int r = r0 + 8 * h;
    if (r >= rows) continue;
    float* dst;
    if (split) {
      dst = part_acc + (part * kRows + r) * D;
      if (t == 0) {
        part_ml[(part * kRows + r) * 2] = m_run[h];
        part_ml[(part * kRows + r) * 2 + 1] = l;
      }
    } else {
      const int tl = r / M, mm = r % M;
      dst = out + (((size_t)b * T_ + t0 + tl) * H + kv * M + mm) * D;
    }
#pragma unroll
    for (int nt = 0; nt < KS; ++nt) {
      float2 x = make_float2(o[nt][2 * h], o[nt][2 * h + 1]);
      if (!split) x = make_float2(x.x / l, x.y / l);
      *reinterpret_cast<float2*>(dst + nt * 8 + 2 * t) = x;
    }
  }
}

// One warp per score row of a split tile: the row's segments' partials
// combined in segment order, out = sum_j acc_j e^(m_j - m) / sum_j l_j
// e^(m_j - m) with m the largest m_j (a fixed order: the output repeats bit
// for bit). Grid (query tiles, kRows / 4, KV * B), 128 threads.
constexpr int kCombRows = 4;

template <int D>
__global__ void __launch_bounds__(32 * kCombRows)
prefill_combine_kernel(const float* __restrict__ part_acc,
                       const float* __restrict__ part_ml,
                       const int* __restrict__ qpos, float* __restrict__ out,
                       int T_, int S, int KV, int M, int tq, int seg,
                       int n_seg) {
  constexpr int kPer = (D + 31) / 32;   // columns a lane
  const int qt = blockIdx.x, lane = threadIdx.x & 31;
  const int r = blockIdx.y * kCombRows + (threadIdx.x >> 5);
  const int kv = blockIdx.z % KV, b = blockIdx.z / KV;
  if (r >= tq * M) return;
  const int chunks = prefill_chunks(qpos, qt, tq, T_, S);
  const int seg_t = max(seg, (chunks + n_seg - 1) / n_seg);
  const int n_t = (chunks + seg_t - 1) / seg_t;
  const size_t base = (((size_t)b * KV + kv) * gridDim.x + qt) * n_seg;
  float mg = kNeg;
  for (int j = lane; j < n_t; j += 32)
    mg = fmaxf(mg, part_ml[((base + j) * kRows + r) * 2]);
  for (int off = 16; off > 0; off >>= 1)
    mg = fmaxf(mg, __shfl_xor_sync(kFull, mg, off));
  float acc[kPer], l = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
#pragma unroll 4
  for (int j = 0; j < n_t; ++j) {
    const size_t at = (base + j) * kRows + r;
    const float wgt = expf(part_ml[at * 2] - mg);
    l = l + part_ml[at * 2 + 1] * wgt;
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      if (lane + 32 * i < D)
        acc[i] = acc[i] + part_acc[at * D + lane + 32 * i] * wgt;
  }
  const int tl = r / M, mm = r % M;
  float* dst =
      out + (((size_t)b * T_ + qt * tq + tl) * (KV * M) + kv * M + mm) * D;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    if (lane + 32 * i < D) dst[lane + 32 * i] = acc[i] / l;
}

template <typename T, int D>
int launch_prefill(const float* q, const void* k, const void* v,
                   const float* ks, const float* vs, const int* qpos,
                   float* out, float* part_acc, float* part_ml, int B,
                   int T_, int S, int H, int KV, int tq, int seg, int n_seg,
                   float scale, cudaStream_t stream) {
  static size_t set[16] = {};
  const int M = H / KV;
  if (tq * M > kRows || T_ % tq || seg < 1 || n_seg < 1 ||
      (n_seg > 1 && (!part_acc || !part_ml)))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = prefill_smem<T, D>();
  const int err = allow_smem(flash_prefill_kernel<T, D>, smem, set);
  if (err) return err;
  const dim3 grid((unsigned)(T_ / tq), (unsigned)n_seg, (unsigned)(KV * B));
  flash_prefill_kernel<T, D><<<grid, kPreThreads, smem, stream>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), ks, vs, qpos,
      out, part_acc, part_ml, T_, S, KV, M, tq, seg, scale);
  if (n_seg > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const dim3 cgrid((unsigned)(T_ / tq),
                     (unsigned)((tq * M + kCombRows - 1) / kCombRows),
                     (unsigned)(KV * B));
    prefill_combine_kernel<D><<<cgrid, 32 * kCombRows, 0, stream>>>(
        part_acc, part_ml, qpos, out, T_, S, KV, M, tq, seg, n_seg);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_prefill_any_d(const float* q, const void* k, const void* v,
                         const float* ks, const float* vs, const int* qpos,
                         float* out, float* part_acc, float* part_ml, int B,
                         int T_, int S, int H, int KV, int D, int tq, int seg,
                         int n_seg, float scale, cudaStream_t stream) {
  switch (D) {
#define PREFILL_D(DD)                                                       \
  case DD:                                                                  \
    return launch_prefill<T, DD>(q, k, v, ks, vs, qpos, out, part_acc,      \
                                 part_ml, B, T_, S, H, KV, tq, seg, n_seg,  \
                                 scale, stream);
    PREFILL_D(16)
    PREFILL_D(32)
    PREFILL_D(64)
    PREFILL_D(128)
#undef PREFILL_D
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 int8. ks/vs may be null. part_acc
// [B, KV, n_split, M, D] and part_ml [B, KV, n_split, M, 2] are scratch;
// n_split tiles of ts rows cover every position; counters int32 [B, KV, M]
// hold zeros and are left so (decode_partial.cuh). Launches on `stream` and
// returns cudaGetLastError() as an int (0 = launched).
int flash_decode(const void* q, const void* k, const void* v, const void* ks,
                 const void* vs, const void* pos, void* part_acc,
                 void* part_ml, void* out, void* counters, int dtype, int B,
                 int S, int H, int KV, int D, int ts, int n_split,
                 float scale, void* stream) {
  // rows 0 .. pos[b]: the row limit is pos + 1
  return dispatch_decode<false>(dtype, q, k, v, ks, vs, S, nullptr, nullptr,
                                nullptr, nullptr, 0, pos, 1, nullptr,
                                part_acc, part_ml, out, nullptr, nullptr,
                                counters, B, H, KV, D, ts, n_split, scale,
                                stream);
}

// Two segments under one softmax: main rows < base[b] of k/v [B, S, KV, D]
// in n_main tiles of ts rows, then side rows j <= off[b] of sk/sv
// [B, C, KV, D] as one more tile, combined last. Scales
// ks/vs [B, S, KV] and sks/svs [B, C, KV], all four or none. part_acc
// [B, KV, n_main + 1, M, D] and part_ml [B, KV, n_main + 1, M, 2] are
// scratch, counters as for flash_decode. Same dtype codes and return value
// as flash_decode.
int flash_decode_two_segment(const void* q, const void* k, const void* v,
                             const void* ks, const void* vs, const void* sk,
                             const void* sv, const void* sks,
                             const void* svs, const void* base,
                             const void* off, void* part_acc, void* part_ml,
                             void* out, void* counters, int dtype, int B,
                             int S, int C, int H, int KV, int D, int ts,
                             int n_main, float scale, void* stream) {
  return dispatch_decode<false>(dtype, q, k, v, ks, vs, S, sk, sv, sks, svs,
                                C, base, 0, off, part_acc, part_ml, out,
                                nullptr, nullptr, counters, B, H, KV, D, ts,
                                n_main, scale, stream);
}

// Block-causal prefill over query tiles of tq rows (tq divides T,
// tq * H / KV <= 64), each tile's 64-row chunks cut into ceil(chunks / seg)
// segments, n_seg at most (the grid's second axis; 1: no tile is split and
// part_acc, part_ml may be null). part_acc [B, KV, T / tq, n_seg, 64, D]
// and part_ml [B, KV, T / tq, n_seg, 64, 2] are scratch. Same dtype codes
// and return value as flash_decode.
int flash_prefill(const void* q, const void* k, const void* v, const void* ks,
                  const void* vs, const void* qpos, void* out, void* part_acc,
                  void* part_ml, int dtype, int B, int T, int S, int H,
                  int KV, int D, int tq, int seg, int n_seg, float scale,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* ksf = static_cast<const float*>(ks);
  const float* vsf = static_cast<const float*>(vs);
  const int* p = static_cast<const int*>(qpos);
  float* o = static_cast<float*>(out);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  switch (dtype) {
    case 0:
      return launch_prefill_any_d<float>(qf, k, v, ksf, vsf, p, o, pa, pm, B,
                                         T, S, H, KV, D, tq, seg, n_seg,
                                         scale, st);
    case 1:
      return launch_prefill_any_d<__nv_bfloat16>(qf, k, v, ksf, vsf, p, o,
                                                 pa, pm, B, T, S, H, KV, D,
                                                 tq, seg, n_seg, scale, st);
    case 2:
      return launch_prefill_any_d<int8_t>(qf, k, v, ksf, vsf, p, o, pa, pm, B,
                                          T, S, H, KV, D, tq, seg, n_seg,
                                          scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
