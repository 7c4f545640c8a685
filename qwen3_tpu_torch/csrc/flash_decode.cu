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
// leave 124 SMs idle. The two-segment form reads the side buffer as one more
// tile per slot, combined after the main tiles (the TPU kernel's last grid
// step); a slot at base position 0 reads no main tile at all. Both decode
// forms are decode_partial.cuh's kernels, which batched_decode.cu shares.
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

#include "decode_partial.cuh"

namespace {

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
  // rows 0 .. pos[b]: the row limit is pos + 1
  return dispatch_decode<false>(dtype, q, k, v, ks, vs, S, nullptr, nullptr,
                                nullptr, nullptr, 0, pos, 1, nullptr,
                                part_acc, part_ml, out, nullptr, nullptr, B,
                                H, KV, D, ts, n_split, scale, stream);
}

// Two segments under one softmax: main rows < base[b] of k/v [B, S, KV, D]
// in n_main tiles of ts rows, then side rows j <= off[b] of sk/sv
// [B, C, KV, D] as one more tile, combined last. Scales
// ks/vs [B, S, KV] and sks/svs [B, C, KV], all four or none. part_acc
// [B, KV, n_main + 1, M, D] and part_ml [B, KV, n_main + 1, M, 2] are
// scratch. Same dtype codes and return value as flash_decode.
int flash_decode_two_segment(const void* q, const void* k, const void* v,
                             const void* ks, const void* vs, const void* sk,
                             const void* sv, const void* sks,
                             const void* svs, const void* base,
                             const void* off, void* part_acc, void* part_ml,
                             void* out, int dtype, int B, int S, int C,
                             int H, int KV, int D, int ts, int n_main,
                             float scale, void* stream) {
  return dispatch_decode<false>(dtype, q, k, v, ks, vs, S, sk, sv, sks, svs,
                                C, base, 0, off, part_acc, part_ml, out,
                                nullptr, nullptr, B, H, KV, D, ts, n_main,
                                scale, stream);
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
