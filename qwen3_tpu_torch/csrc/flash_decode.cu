// Flash GQA attention over the KV cache for Hopper (sm_90a), bound to Python
// through ctypes.
//
// Replaces the TPU kernels qwen3_tpu/ops/pallas/flash_decode.py::
// flash_decode_gqa (a decode step: one query token per slot) and
// ::flash_prefill_gqa (a prefill block: T query rows, block-causal). Both
// compute, per query row and query head h (kv head h / M, M = H / KV):
//
//   out = sum_s p_s * vs_s * v_s / sum_s p_s,   p_s = exp(x_s - max_s x_s),
//   x_s = (q . k_s) * (1/sqrt(D)) * ks_s        over rows s <= the row's position
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
// one core; here that sequential axis becomes parallel blocks. A block per
// (S-tile of ts rows, kv head, slot) computes the tile's unnormalised
// partial (acc, m, l) for the M query heads of its kv head, so the M heads
// share every K/V row it loads; K and V stream from device memory in
// 16-byte loads, neighbouring lanes on neighbouring bytes of a row, a whole
// 64-row chunk in flight per block, and V is staged in shared memory as
// stored (int8 stays 1 byte), every access free of bank conflicts. A
// second kernel combines the partials of
// tiles 0..pos/ts in tile order, one block per (head, slot): no atomics, so
// the output repeats bit for bit. At depth 8192 with ts = 256 and 8 kv heads
// that is 264 blocks for 132 SMs, where one block per (slot, kv head) would
// leave 124 SMs idle.
//
// Prefill is bound by operations: 4 T H S D fp32 flops per layer against
// K/V bytes that are read once per query tile. A block per (query tile of
// tq rows, kv head, slot) holds its tq * M <= 128 score rows' queries in
// shared memory and walks the cache in 64-row chunks, up to the tile's last
// position; per chunk it stages K and V as f32 in shared memory, computes
// the 128 x 64 scores (256 threads, 8 x 4 each, float4 reads of padded
// rows), runs the online softmax per score row with each row's own mask,
// and accumulates P V in registers (8 rows x D/16 columns a thread). No
// tensor cores: true fp32 is the contract (Precision.HIGHEST on the TPU);
// a 3xTF32 split on wgmma is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -FLT_MAX;   // jnp.finfo(f32).min, the mask value
constexpr unsigned kFull = 0xffffffffu;

// 16 bytes of a cache row as E floats (exact conversions)
union Raw16 {
  int4 v;
  float f[4];
  unsigned short h[8];
  int8_t c[16];
};

template <typename T> struct Row16;
template <> struct Row16<float> {
  static constexpr int E = 4;
  __device__ __forceinline__ static void cvt(const int4 raw, float* o) {
    Raw16 r;
    r.v = raw;
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = r.f[e];
  }
};
template <> struct Row16<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ __forceinline__ static void cvt(const int4 raw, float* o) {
    Raw16 r;
    r.v = raw;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      o[e] = __bfloat162float(__ushort_as_bfloat16(r.h[e]));
  }
};
template <> struct Row16<int8_t> {
  static constexpr int E = 16;
  __device__ __forceinline__ static void cvt(const int4 raw, float* o) {
    Raw16 r;
    r.v = raw;
#pragma unroll
    for (int e = 0; e < 16; ++e) o[e] = (float)r.c[e];
  }
};

template <typename T>
__device__ __forceinline__ int4 load16(const T* p) {
  return __ldg(reinterpret_cast<const int4*>(p));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

// ---------------------------------------------------------------- decode --

constexpr int kDecThreads = 128, kDecWarps = kDecThreads / 32;
constexpr int kChunk = 64;                 // cache rows per inner step
constexpr int kMaxOut = 16;                // M * D <= kDecThreads * kMaxOut

size_t decode_smem(int M, int D, int elem) {
  const int E = 16 / elem;
  return (size_t)kChunk * D * elem +
         sizeof(float) * ((size_t)M * (D + D / E) + (size_t)M * kChunk +
                          3 * (size_t)M + 2 * kChunk);
}

// One block per (tile, kv head, slot): the partial over rows
// [tile * ts, min((tile + 1) * ts, pos + 1)). Per 64-row chunk, every thread
// holds its 16-byte loads of K and V in registers (kPass of each: the whole
// chunk per block) and one K or V scale; K pieces go straight into the score
// dots (vpr lanes per row, shuffled together), V pieces into shared memory
// as they are (16-byte stores, conflict-free) to be converted when read, and
// then the next chunk's loads are issued, so that they fly during this
// chunk's softmax and P V. Shared memory: the V chunk [kChunk][D] of T,
// q [M][vpr][E + 1] f32 (a piece padded by one float, so the lanes of a row
// read distinct banks), scores [M][kChunk], per head m, l and alpha, and
// the chunk's K and V scales. D is a power of two from 16 to 128, so
// thread tid owns column tid % D of heads tid / D + j (128 / D), and each V
// value it reads serves all of them.
template <typename T>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_partial_kernel(const float* __restrict__ q,
                            const T* __restrict__ k, const T* __restrict__ v,
                            const float* __restrict__ ks,
                            const float* __restrict__ vs,
                            const int* __restrict__ pos,
                            float* __restrict__ part_acc,
                            float* __restrict__ part_ml, int S, int KV, int M,
                            int D, int ts, float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int E = Row16<T>::E;
  constexpr int kPass = kChunk * 128 / (kDecThreads * E);
  const int tile = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int p = pos[b];
  const int r0 = tile * ts;
  if (r0 > p) return;  // a tile past the slot's position is skipped
  const int r_end = min(min(r0 + ts, p + 1), S);
  const int H = KV * M;
  const int vpr = D / E;                    // 16-byte pieces per row
  const int qstride = vpr * (E + 1);
  T* v_s = reinterpret_cast<T*>(smem);      // [kChunk][D]
  float* q_s = smem + kChunk * D * sizeof(T) / sizeof(float);
  float* sc = q_s + M * qstride;            // [M][kChunk]
  float* m_s = sc + M * kChunk;             // [M]
  float* l_s = m_s + M;                     // [M]
  float* a_s = l_s + M;                     // [M]
  float* s_s = a_s + M;                     // [2][kChunk]: K, V scales
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < M * D; i += kDecThreads) {
    const int mm = i / D, dd = i % D;
    q_s[mm * qstride + (dd / E) * (E + 1) + dd % E] =
        q[((size_t)b * H + (size_t)kv * M) * D + i];
  }
  if (tid < M) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }
  float acc[kMaxOut];
#pragma unroll
  for (int j = 0; j < kMaxOut; ++j) acc[j] = 0.f;

  const int rpw = 32 / vpr;                 // K rows per warp pass
  const int sub = lane / vpr, piece = lane % vpr;
  // this thread's outputs: column d_own of heads mm0 + j * mstep, j < nj
  const int d_own = tid % D, mm0 = tid / D, mstep = kDecThreads / D;
  const int nj = mm0 < M ? (M - mm0 + mstep - 1) / mstep : 0;
  const size_t row_stride = (size_t)KV * D;
  const T* kb = k + ((size_t)b * S * KV + kv) * D;
  const T* vb = v + ((size_t)b * S * KV + kv) * D;
  __syncthreads();

  // the loads of a chunk: kPass 16-byte pieces of K and of V per thread,
  // and one scale (threads below kChunk: K's of row tid, the others: V's)
  int4 kraw[kPass], vraw[kPass];
  float sraw = 1.f;
  const float* sp = tid < kChunk ? ks : vs;
  const int srow = tid % kChunk;
  auto issue = [&](int c0) {
    const int n = min(kChunk, r_end - c0);
#pragma unroll
    for (int ps = 0; ps < kPass; ++ps) {
      const int row = (ps * kDecWarps + warp) * rpw + sub;
      kraw[ps] = make_int4(0, 0, 0, 0);
      if (row < n)
        kraw[ps] = load16(kb + (size_t)(c0 + row) * row_stride + piece * E);
      const int i = tid + ps * kDecThreads;
      if (i < n * vpr)
        vraw[ps] = load16(vb + (size_t)(c0 + i / vpr) * row_stride +
                          (i % vpr) * E);
    }
    sraw = 1.f;
    if (sp && srow < n) sraw = sp[((size_t)b * S + c0 + srow) * KV + kv];
  };
  issue(r0);

  for (int c0 = r0; c0 < r_end; c0 += kChunk) {
    const int n = min(kChunk, r_end - c0);
    // scores: vpr lanes per row, each a 16-byte piece against all M heads
#pragma unroll
    for (int ps = 0; ps < kPass; ++ps) {
      const int row = (ps * kDecWarps + warp) * rpw + sub;
      float kx[E];
      Row16<T>::cvt(kraw[ps], kx);
      for (int mm = 0; mm < M; ++mm) {
        const float* qq = q_s + mm * qstride + piece * (E + 1);
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qq[e], kx[e], d);
        for (int off = vpr >> 1; off > 0; off >>= 1)
          d += __shfl_xor_sync(kFull, d, off);
        if (row < n && piece == 0) sc[mm * kChunk + row] = d;
      }
    }
    // the V chunk as it is: piece i is bytes [16 i, 16 i + 16) of the chunk
#pragma unroll
    for (int ps = 0; ps < kPass; ++ps) {
      const int i = tid + ps * kDecThreads;
      if (i < n * vpr) reinterpret_cast<int4*>(v_s)[i] = vraw[ps];
    }
    s_s[tid] = sraw;
    // the next chunk's loads fly while this one's softmax and P V run
    if (c0 + kChunk < r_end) issue(c0 + kChunk);
    __syncthreads();
    // online softmax, one warp per head, two columns a lane
    for (int mm = warp; mm < M; mm += kDecWarps) {
      float x[2];
      float mx = kNeg;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        x[h] = kNeg;
        if (c < n) {
          float s = sc[mm * kChunk + c] * scale;
          if (ks) s = s * s_s[c];
          x[h] = s;
        }
        mx = fmaxf(mx, x[h]);
      }
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_prev = m_s[mm];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        const float pr = c < n ? expf(x[h] - m_new) : 0.f;
        sum += pr;
        if (c < n)
          sc[mm * kChunk + c] = vs ? pr * s_s[kChunk + c] : pr;
      }
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      __syncwarp();
      if (lane == 0) {
        l_s[mm] = l_s[mm] * alpha + sum;
        m_s[mm] = m_new;
        a_s[mm] = alpha;
      }
    }
    __syncthreads();
    // acc = acc * alpha + (p * vs) @ v over column d_own for heads
    // mm0 + j * mstep, j < nj
    // (two sums, even and odd rows, for two independent FMA chains)
    const T* v_col = v_s + d_own;
#pragma unroll
    for (int j = 0; j < kMaxOut; ++j) {
      if (j < nj) {
        const float* pr = sc + (mm0 + j * mstep) * kChunk;
        float a0 = 0.f, a1 = 0.f;
        int c = 0;
#pragma unroll 4
        for (; c + 1 < n; c += 2) {
          a0 = fmaf(pr[c], to_f32(v_col[c * D]), a0);
          a1 = fmaf(pr[c + 1], to_f32(v_col[(c + 1) * D]), a1);
        }
        if (c < n) a0 = fmaf(pr[c], to_f32(v_col[c * D]), a0);
        acc[j] = acc[j] * a_s[mm0 + j * mstep] + (a0 + a1);
      }
    }
    __syncthreads();
  }
  const size_t part = ((size_t)b * KV + kv) * n_split + tile;
#pragma unroll
  for (int j = 0; j < kMaxOut; ++j)
    if (j < nj)
      part_acc[(part * M + mm0 + j * mstep) * D + d_own] = acc[j];
  if (tid < M) {
    part_ml[(part * M + tid) * 2] = m_s[tid];
    part_ml[(part * M + tid) * 2 + 1] = l_s[tid];
  }
}

// One block per (head, slot): combines the partials of tiles 0..pos/ts.
// The tiles' m and l are read in parallel into shared memory (dynamic,
// 2 n_split floats) and their weights exp(m_t - max m) computed in
// parallel; warp w then sums l and every output column over its own
// contiguous range of tiles (lanes over columns), and the warps' sums are
// added in warp order: a fixed order, so the output repeats bit for bit.
constexpr int kCombineThreads = 128, kCombineWarps = kCombineThreads / 32;

__global__ void __launch_bounds__(kCombineThreads)
flash_decode_combine_kernel(const float* __restrict__ part_acc,
                            const float* __restrict__ part_ml,
                            const int* __restrict__ pos,
                            float* __restrict__ out, int KV, int M, int D,
                            int ts, int n_split) {
  extern __shared__ __align__(16) float cs[];
  float* w_s = cs;                          // [n_split]: m_t, then weights
  float* l_s = cs + n_split;                // [n_split]
  __shared__ float red[kCombineWarps];
  __shared__ float wsum[kCombineWarps][128];
  __shared__ float lsum[kCombineWarps];
  const int h = blockIdx.x, b = blockIdx.y;
  const int kv = h / M, mm = h % M;
  const int n = min(pos[b] / ts, n_split - 1) + 1;
  const size_t base = ((size_t)b * KV + kv) * n_split;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float mx = kNeg;
  for (int t = tid; t < n; t += kCombineThreads) {
    const float* ml = part_ml + ((base + t) * M + mm) * 2;
    w_s[t] = ml[0];
    l_s[t] = ml[1];
    mx = fmaxf(mx, ml[0]);
  }
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  float mg = red[0];
  for (int w = 1; w < kCombineWarps; ++w) mg = fmaxf(mg, red[w]);
  for (int t = tid; t < n; t += kCombineThreads) w_s[t] = expf(w_s[t] - mg);
  __syncthreads();
  const int per = (n + kCombineWarps - 1) / kCombineWarps;
  const int t0 = min(n, warp * per), t1 = min(n, t0 + per);
  float l = 0.f;
  for (int t = t0 + lane; t < t1; t += 32) l = l + l_s[t] * w_s[t];
  for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(kFull, l, off);
  float a[4] = {0.f, 0.f, 0.f, 0.f};      // columns lane + 32 i (D <= 128)
  const float* acc = part_acc + (base * M + mm) * D;
  const size_t step = (size_t)M * D;
#pragma unroll 4
  for (int t = t0; t < t1; ++t) {
    const float w = w_s[t];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (lane + 32 * i < D) a[i] = a[i] + acc[t * step + lane + 32 * i] * w;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (lane + 32 * i < D) wsum[warp][lane + 32 * i] = a[i];
  if (lane == 0) lsum[warp] = l;
  __syncthreads();
  for (int d = tid; d < D; d += kCombineThreads) {
    float o = wsum[0][d], lt = lsum[0];
    for (int w = 1; w < kCombineWarps; ++w) {
      o = o + wsum[w][d];
      lt = lt + lsum[w];
    }
    out[((size_t)b * KV * M + h) * D + d] = o / lt;
  }
}

template <typename T>
int launch_decode(const float* q, const void* k, const void* v,
                  const float* ks, const float* vs, const int* pos,
                  float* part_acc, float* part_ml, float* out, int B, int S,
                  int H, int KV, int D, int ts, int n_split, float scale,
                  cudaStream_t stream) {
  const int M = H / KV;
  if (M * D > kDecThreads * kMaxOut || D < 16 || D > 128 || (D & (D - 1)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = decode_smem(M, D, (int)sizeof(T));
  const dim3 grid((unsigned)n_split, (unsigned)KV, (unsigned)B);
  flash_decode_partial_kernel<T><<<grid, kDecThreads, smem, stream>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), ks, vs, pos,
      part_acc, part_ml, S, KV, M, D, ts, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_decode_combine_kernel<<<dim3((unsigned)H, (unsigned)B),
                                kCombineThreads,
                                2 * sizeof(float) * (size_t)n_split, stream>>>(
      part_acc, part_ml, pos, out, KV, M, D, ts, n_split);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------- prefill --

constexpr int kPreThreads = 256;
constexpr int kRows = 128;                 // score rows (query rows x heads)
constexpr int kCols = 64;                  // cache rows per chunk
constexpr int kRowsPerThread = kRows / (kPreThreads / 16);   // 8
constexpr int kColsPerThread = kCols / 16;                   // 4
constexpr int kMaxDCols = 128 / 16;        // output columns per thread

size_t prefill_smem(int D) {
  const size_t dp = (size_t)D + 4;
  return sizeof(float) * (kRows * dp + kCols * dp + (size_t)kCols * D +
                          (size_t)kRows * (kCols + 1) + 2 * kCols) +
         sizeof(int) * kRows;
}

// One block per (query tile, kv head, slot). Score row r = tl * M + mm is
// query t0 + tl at head kv * M + mm; thread (ty, tx) owns score rows
// ty * 8 + i and chunk columns tx + 16 j, and output columns tx + 16 j.
template <typename T>
__global__ void __launch_bounds__(kPreThreads)
flash_prefill_kernel(const float* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ ks,
                     const float* __restrict__ vs,
                     const int* __restrict__ qpos, float* __restrict__ out,
                     int T_, int S, int KV, int M, int D, int tq,
                     float scale) {
  extern __shared__ __align__(16) float smem[];
  const int dp = D + 4;   // padded rows: 16-byte aligned, float4 reads of 8
                          // neighbouring rows fall in distinct banks
  float* q_s = smem;                        // [kRows][dp]
  float* k_s = q_s + kRows * dp;            // [kCols][dp]
  float* v_s = k_s + kCols * dp;            // [kCols][D]
  float* p_s = v_s + kCols * D;             // [kRows][kCols + 1]
  float* kss = p_s + kRows * (kCols + 1);   // [kCols]
  float* vss = kss + kCols;                 // [kCols]
  int* rpos = reinterpret_cast<int*>(vss + kCols);   // [kRows]

  const int qt = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int t0 = qt * tq, H = KV * M, rows = tq * M;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nd = D / 16;
  const int d4 = D / 4;

  for (int i = tid; i < kRows * d4; i += kPreThreads) {
    const int r = i / d4, c = i % d4;
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
  const int tile_last = qpos[min(t0 + tq - 1, T_ - 1)];

  float m_run[kRowsPerThread], l_run[kRowsPerThread];
  float acc[kRowsPerThread][kMaxDCols];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m_run[i] = kNeg;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxDCols; ++j) acc[i][j] = 0.f;
  }

  constexpr int E = Row16<T>::E;
  const int vpr = D / E;
  const size_t row_stride = (size_t)KV * D;
  const T* kb = k + ((size_t)b * S * KV + kv) * D;
  const T* vb = v + ((size_t)b * S * KV + kv) * D;
  __syncthreads();

  for (int c0 = 0; c0 <= tile_last && c0 < S; c0 += kCols) {
    const int n = min(kCols, S - c0);
    for (int i = tid; i < kCols * vpr; i += kPreThreads) {
      const int r = i / vpr, pc = i % vpr;
      float kx[E], vx[E];
      if (r < n) {
        Row16<T>::cvt(load16(kb + (size_t)(c0 + r) * row_stride + pc * E),
                      kx);
        Row16<T>::cvt(load16(vb + (size_t)(c0 + r) * row_stride + pc * E),
                      vx);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kx[e] = vx[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < E; ++e) {
        k_s[r * dp + pc * E + e] = kx[e];
        v_s[r * D + pc * E + e] = vx[e];
      }
    }
    for (int r = tid; r < kCols; r += kPreThreads) {
      const bool in = r < n;
      const size_t at = ((size_t)b * S + c0 + r) * KV + kv;
      kss[r] = (ks && in) ? ks[at] : 1.f;
      vss[r] = (vs && in) ? vs[at] : 1.f;
    }
    __syncthreads();

    float s[kRowsPerThread][kColsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; d += 4) {
      float4 kb4[kColsPerThread];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        kb4[j] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * j) * dp + d);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float4 qa = *reinterpret_cast<const float4*>(
            q_s + (ty * kRowsPerThread + i) * dp + d);
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) {
          float a = s[i][j];
          a = fmaf(qa.x, kb4[j].x, a);
          a = fmaf(qa.y, kb4[j].y, a);
          a = fmaf(qa.z, kb4[j].z, a);
          a = fmaf(qa.w, kb4[j].w, a);
          s[i][j] = a;
        }
      }
    }

#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = ty * kRowsPerThread + i;
      const int rp = rpos[r];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int c = tx + 16 * j;
        float x = kNeg;
        if (c < n && c0 + c <= rp) {
          x = s[i][j] * scale;
          if (ks) x = x * kss[c];
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = expf(m_run[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int c = tx + 16 * j;
        const float pr = (c < n && c0 + c <= rp) ? expf(s[i][j] - m_new) : 0.f;
        sum += pr;
        p_s[r * (kCols + 1) + c] = vs ? pr * vss[c] : pr;
      }
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      l_run[i] = l_run[i] * alpha + sum;
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < kMaxDCols; ++j) acc[i][j] = acc[i][j] * alpha;
    }
    __syncthreads();

    for (int c = 0; c < n; ++c) {
      float pr[kRowsPerThread], vv[kMaxDCols];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        pr[i] = p_s[(ty * kRowsPerThread + i) * (kCols + 1) + c];
#pragma unroll
      for (int j = 0; j < kMaxDCols; ++j)
        vv[j] = j < nd ? v_s[c * D + tx + 16 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kMaxDCols; ++j)
          if (j < nd) acc[i][j] = fmaf(pr[i], vv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = ty * kRowsPerThread + i;
    if (r >= rows) continue;
    const int tl = r / M, mm = r % M;
    float* o = out + (((size_t)b * T_ + t0 + tl) * H + kv * M + mm) * D;
#pragma unroll
    for (int j = 0; j < kMaxDCols; ++j)
      if (j < nd) o[tx + 16 * j] = acc[i][j] / l_run[i];
  }
}

template <typename T>
int launch_prefill(const float* q, const void* k, const void* v,
                   const float* ks, const float* vs, const int* qpos,
                   float* out, int B, int T_, int S, int H, int KV, int D,
                   int tq, float scale, cudaStream_t stream) {
  const int M = H / KV;
  if (tq * M > kRows || D > 16 * kMaxDCols || T_ % tq)
    return (int)cudaErrorInvalidValue;
  const size_t smem = prefill_smem(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(T_ / tq), (unsigned)KV, (unsigned)B);
  flash_prefill_kernel<T><<<grid, kPreThreads, smem, stream>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), ks, vs, qpos,
      out, T_, S, KV, M, D, tq, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 int8. ks/vs may be null. part_acc
// [B, KV, n_split, M, D] and part_ml [B, KV, n_split, M, 2] are scratch;
// n_split tiles of ts rows cover every position. Launches on `stream` and
// returns cudaGetLastError() as an int (0 = launched).
int flash_decode(const void* q, const void* k, const void* v, const void* ks,
                 const void* vs, const void* pos, void* part_acc,
                 void* part_ml, void* out, int dtype, int B, int S, int H,
                 int KV, int D, int ts, int n_split, float scale,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* ksf = static_cast<const float*>(ks);
  const float* vsf = static_cast<const float*>(vs);
  const int* p = static_cast<const int*>(pos);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  float* o = static_cast<float*>(out);
  switch (dtype) {
    case 0:
      return launch_decode<float>(qf, k, v, ksf, vsf, p, pa, pm, o, B, S, H,
                                  KV, D, ts, n_split, scale, s);
    case 1:
      return launch_decode<__nv_bfloat16>(qf, k, v, ksf, vsf, p, pa, pm, o,
                                          B, S, H, KV, D, ts, n_split, scale,
                                          s);
    case 2:
      return launch_decode<int8_t>(qf, k, v, ksf, vsf, p, pa, pm, o, B, S, H,
                                   KV, D, ts, n_split, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Block-causal prefill over query tiles of tq rows (tq divides T,
// tq * H / KV <= 128). Same dtype codes and return value as flash_decode.
int flash_prefill(const void* q, const void* k, const void* v, const void* ks,
                  const void* vs, const void* qpos, void* out, int dtype,
                  int B, int T, int S, int H, int KV, int D, int tq,
                  float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* ksf = static_cast<const float*>(ks);
  const float* vsf = static_cast<const float*>(vs);
  const int* p = static_cast<const int*>(qpos);
  float* o = static_cast<float*>(out);
  switch (dtype) {
    case 0:
      return launch_prefill<float>(qf, k, v, ksf, vsf, p, o, B, T, S, H, KV,
                                   D, tq, scale, s);
    case 1:
      return launch_prefill<__nv_bfloat16>(qf, k, v, ksf, vsf, p, o, B, T, S,
                                           H, KV, D, tq, scale, s);
    case 2:
      return launch_prefill<int8_t>(qf, k, v, ksf, vsf, p, o, B, T, S, H, KV,
                                    D, tq, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
