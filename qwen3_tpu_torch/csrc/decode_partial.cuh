// One-token GQA attention partials over a KV cache, and their fixed-order
// combine: the decode kernels shared by flash_decode.cu (flash_decode_gqa,
// flash_decode_gqa_two_segment) and batched_decode.cu
// (batched_decode_partial). See flash_decode.cu's header for the design and
// the bound.
//
// A partial block owns (tile, kv head, slot). Tiles 0 .. n_main-1 cover the
// main cache [B, S, KV, D] in `ts`-row tiles, rows < lim[b] + lim_add; with a
// side buffer [B, C, KV, D], tile n_main covers its rows j <= off[b]. Each
// block writes the unnormalised online-softmax partial (acc, m, l) of its
// rows for the M query heads of its kv head. The combine walks a slot's main
// tiles in order, then its side tile, and writes either acc / l or the
// unnormalised (acc, m, l) relative to the largest m.
//
// Arithmetic per row s (all fp32, the Pallas kernels' order of operations):
//   x_s = (q . k_s) * scale, then * ks_s        p_s = exp(x_s - m)
//   l  += p_s                                   acc += (p_s * vs_s) * v_s
// FAST (the pallas-fast serving mode): the caller rounds q to bf16, K and V
// are rounded to bf16 as they are read (exact for int8 and bf16 caches), and
// p_s * vs_s is rounded to bf16 before the value dot; every product of two
// bf16 values is exact in fp32, so only the sums round.

#pragma once

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

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// a cache value as the dot takes it: fp32 as stored, or rounded to bf16
// under FAST (a no-op for bf16 and int8 values, which bf16 holds exactly)
template <bool FAST, typename T>
__device__ __forceinline__ float dot_operand(T x) {
  const float f = to_f32(x);
  return (FAST && sizeof(T) == 4) ? bf16_round(f) : f;
}

constexpr int kDecThreads = 128, kDecWarps = kDecThreads / 32;
constexpr int kChunk = 64;                 // cache rows per inner step
constexpr int kMaxOut = 16;                // M * D <= kDecThreads * kMaxOut

size_t decode_smem(int M, int D, int elem) {
  const int E = 16 / elem;
  return (size_t)kChunk * D * elem +
         sizeof(float) * ((size_t)M * (D + D / E) + (size_t)M * kChunk +
                          3 * (size_t)M + 2 * kChunk);
}

// One segment of the cache a partial block reads: rows [r0, r_end) of
// k/v [B, rows, KV, D] (scales [B, rows, KV] or null).
template <typename T>
struct Segment {
  const T* k;
  const T* v;
  const float* ks;
  const float* vs;
  int rows;
};

// One block per (tile, kv head, slot). Per 64-row chunk, every thread holds
// its 16-byte loads of K and V in registers (kPass of each: the whole chunk
// per block) and one K or V scale; K pieces go straight into the score dots
// (vpr lanes per row, shuffled together), V pieces into shared memory as
// they are (16-byte stores, conflict-free) to be converted when read, and
// then the next chunk's loads are issued, so that they fly during this
// chunk's softmax and P V. Shared memory: the V chunk [kChunk][D] of T,
// q [M][vpr][E + 1] f32 (a piece padded by one float, so the lanes of a row
// read distinct banks), scores [M][kChunk], per head m, l and alpha, and
// the chunk's K and V scales. D is a power of two from 16 to 128, so
// thread tid owns column tid % D of heads tid / D + j (128 / D), and each V
// value it reads serves all of them.
template <typename T, bool FAST>
__global__ void __launch_bounds__(kDecThreads)
decode_partial_kernel(const float* __restrict__ q, Segment<T> main_seg,
                      Segment<T> side_seg, const int* __restrict__ lim,
                      int lim_add, const int* __restrict__ off,
                      float* __restrict__ part_acc,
                      float* __restrict__ part_ml, int n_main, int KV, int M,
                      int D, int ts, float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int E = Row16<T>::E;
  constexpr int kPass = kChunk * 128 / (kDecThreads * E);
  const int tile = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int n_tiles = gridDim.x;
  const bool is_side = tile >= n_main;
  const Segment<T> seg = is_side ? side_seg : main_seg;
  const int S = seg.rows;
  int r0, r_end;
  if (is_side) {
    r0 = 0;
    r_end = min(off[b] + 1, S);
  } else {
    r0 = tile * ts;
    r_end = min(min(r0 + ts, lim[b] + lim_add), S);
  }
  if (r0 >= r_end) return;  // a tile past the slot's rows is skipped
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
  const T* kb = seg.k + ((size_t)b * S * KV + kv) * D;
  const T* vb = seg.v + ((size_t)b * S * KV + kv) * D;
  __syncthreads();

  // the loads of a chunk: kPass 16-byte pieces of K and of V per thread,
  // and one scale (threads below kChunk: K's of row tid, the others: V's)
  int4 kraw[kPass], vraw[kPass];
  float sraw = 1.f;
  const float* sp = tid < kChunk ? seg.ks : seg.vs;
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
      if (FAST && sizeof(T) == 4) {
#pragma unroll
        for (int e = 0; e < E; ++e) kx[e] = bf16_round(kx[e]);
      }
      for (int mm = 0; mm < M; ++mm) {
        const float* qq = q_s + mm * qstride + piece * (E + 1);
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qq[e], kx[e], d);
        for (int o = vpr >> 1; o > 0; o >>= 1)
          d += __shfl_xor_sync(kFull, d, o);
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
          if (seg.ks) s = s * s_s[c];
          x[h] = s;
        }
        mx = fmaxf(mx, x[h]);
      }
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_prev = m_s[mm];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        const float pr = c < n ? expf(x[h] - m_new) : 0.f;
        sum += pr;
        if (c < n) {
          const float pv = seg.vs ? pr * s_s[kChunk + c] : pr;
          sc[mm * kChunk + c] = FAST ? bf16_round(pv) : pv;
        }
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(kFull, sum, o);
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
          a0 = fmaf(pr[c], dot_operand<FAST>(v_col[c * D]), a0);
          a1 = fmaf(pr[c + 1], dot_operand<FAST>(v_col[(c + 1) * D]), a1);
        }
        if (c < n) a0 = fmaf(pr[c], dot_operand<FAST>(v_col[c * D]), a0);
        acc[j] = acc[j] * a_s[mm0 + j * mstep] + (a0 + a1);
      }
    }
    __syncthreads();
  }
  const size_t part = ((size_t)b * KV + kv) * n_tiles + tile;
#pragma unroll
  for (int j = 0; j < kMaxOut; ++j)
    if (j < nj)
      part_acc[(part * M + mm0 + j * mstep) * D + d_own] = acc[j];
  if (tid < M) {
    part_ml[(part * M + tid) * 2] = m_s[tid];
    part_ml[(part * M + tid) * 2 + 1] = l_s[tid];
  }
}

// One block per (head, slot): combines the slot's partials, its main tiles
// 0 .. ceil((lim[b] + lim_add) / ts) - 1 in order and then, with `off`, its
// side tile n_main. The tiles' m and l are read in parallel into shared
// memory (dynamic, 2 n_tiles floats) and their weights exp(m_t - max m)
// computed in parallel; warp w then sums l and every output column over its
// own contiguous range of tiles (lanes over columns), and the warps' sums
// are added in warp order: a fixed order, so the output repeats bit for
// bit. Writes out = acc / l when m_out is null, else the unnormalised
// (acc, m, l) into (out, m_out, l_out); a slot with no row at all then gets
// (0, -FLT_MAX, 0).
constexpr int kCombineThreads = 128, kCombineWarps = kCombineThreads / 32;

__global__ void __launch_bounds__(kCombineThreads)
decode_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_ml,
                      const int* __restrict__ lim, int lim_add,
                      const int* __restrict__ off, float* __restrict__ out,
                      float* __restrict__ m_out, float* __restrict__ l_out,
                      int KV, int M, int D, int ts, int n_main) {
  extern __shared__ __align__(16) float cs[];
  const int n_tiles = n_main + (off ? 1 : 0);
  float* w_s = cs;                          // [n_tiles]: m_t, then weights
  float* l_s = cs + n_tiles;                // [n_tiles]
  __shared__ float red[kCombineWarps];
  __shared__ float wsum[kCombineWarps][128];
  __shared__ float lsum[kCombineWarps];
  const int h = blockIdx.x, b = blockIdx.y;
  const int kv = h / M, mm = h % M;
  const int rows = max(lim[b] + lim_add, 0);
  const int nm = min((rows + ts - 1) / ts, n_main);
  const int n = nm + ((off && off[b] >= 0) ? 1 : 0);
  const size_t base = ((size_t)b * KV + kv) * n_tiles;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float mx = kNeg;
  for (int t = tid; t < n; t += kCombineThreads) {
    const int tile = t < nm ? t : n_main;
    const float* ml = part_ml + ((base + tile) * M + mm) * 2;
    w_s[t] = ml[0];
    l_s[t] = ml[1];
    mx = fmaxf(mx, ml[0]);
  }
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
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
  for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(kFull, l, o);
  float a[4] = {0.f, 0.f, 0.f, 0.f};      // columns lane + 32 i (D <= 128)
  const float* acc = part_acc + (base * M + mm) * D;
  const size_t step = (size_t)M * D;
#pragma unroll 4
  for (int t = t0; t < t1; ++t) {
    const float w = w_s[t];
    const size_t tile = t < nm ? t : n_main;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (lane + 32 * i < D) a[i] = a[i] + acc[tile * step + lane + 32 * i] * w;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (lane + 32 * i < D) wsum[warp][lane + 32 * i] = a[i];
  if (lane == 0) lsum[warp] = l;
  __syncthreads();
  const size_t row = (size_t)b * KV * M + h;
  for (int d = tid; d < D; d += kCombineThreads) {
    float o = wsum[0][d], lt = lsum[0];
    for (int w = 1; w < kCombineWarps; ++w) {
      o = o + wsum[w][d];
      lt = lt + lsum[w];
    }
    out[row * D + d] = m_out ? o : o / lt;
    if (m_out && d == 0) {
      m_out[row] = mg;
      l_out[row] = lt;
    }
  }
}

// Partials then combine on `stream`; part_acc [B, KV, n_tiles, M, D] and
// part_ml [B, KV, n_tiles, M, 2] are scratch, n_tiles = n_main (+ 1 with a
// side segment, i.e. when `off` is not null). Returns cudaGetLastError().
template <typename T, bool FAST>
int launch_decode_partials(const float* q, Segment<T> main_seg,
                           Segment<T> side_seg, const int* lim, int lim_add,
                           const int* off, float* part_acc, float* part_ml,
                           float* out, float* m_out, float* l_out, int B,
                           int H, int KV, int D, int ts, int n_main,
                           float scale, cudaStream_t stream) {
  const int M = H / KV;
  if (M * D > kDecThreads * kMaxOut || D < 16 || D > 128 || (D & (D - 1)))
    return (int)cudaErrorInvalidValue;
  const int n_tiles = n_main + (off ? 1 : 0);
  const size_t smem = decode_smem(M, D, (int)sizeof(T));
  const dim3 grid((unsigned)n_tiles, (unsigned)KV, (unsigned)B);
  decode_partial_kernel<T, FAST><<<grid, kDecThreads, smem, stream>>>(
      q, main_seg, side_seg, lim, lim_add, off, part_acc, part_ml, n_main,
      KV, M, D, ts, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<<<dim3((unsigned)H, (unsigned)B), kCombineThreads,
                          2 * sizeof(float) * (size_t)n_tiles, stream>>>(
      part_acc, part_ml, lim, lim_add, off, out, m_out, l_out, KV, M, D, ts,
      n_main);
  return (int)cudaGetLastError();
}

template <typename T>
Segment<T> segment(const void* k, const void* v, const void* ks,
                   const void* vs, int rows) {
  return Segment<T>{static_cast<const T*>(k), static_cast<const T*>(v),
                    static_cast<const float*>(ks),
                    static_cast<const float*>(vs), rows};
}

// launch_decode_partials for a cache of dtype code 0 (float32), 1 (bfloat16)
// or 2 (int8); the side segment's pointers may be null (then `off` is null).
template <bool FAST>
int dispatch_decode(int dtype, const void* q, const void* k, const void* v,
                    const void* ks, const void* vs, int S, const void* sk,
                    const void* sv, const void* sks, const void* svs, int C,
                    const void* lim, int lim_add, const void* off,
                    void* part_acc, void* part_ml, void* out, void* m_out,
                    void* l_out, int B, int H, int KV, int D, int ts,
                    int n_main, float scale, void* stream) {
  const float* qf = static_cast<const float*>(q);
  const int* li = static_cast<const int*>(lim);
  const int* of = static_cast<const int*>(off);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  float* o = static_cast<float*>(out);
  float* mo = static_cast<float*>(m_out);
  float* lo = static_cast<float*>(l_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_decode_partials<float, FAST>(
          qf, segment<float>(k, v, ks, vs, S),
          segment<float>(sk, sv, sks, svs, C), li, lim_add, of, pa, pm, o,
          mo, lo, B, H, KV, D, ts, n_main, scale, s);
    case 1:
      return launch_decode_partials<__nv_bfloat16, FAST>(
          qf, segment<__nv_bfloat16>(k, v, ks, vs, S),
          segment<__nv_bfloat16>(sk, sv, sks, svs, C), li, lim_add, of, pa,
          pm, o, mo, lo, B, H, KV, D, ts, n_main, scale, s);
    case 2:
      return launch_decode_partials<int8_t, FAST>(
          qf, segment<int8_t>(k, v, ks, vs, S),
          segment<int8_t>(sk, sv, sks, svs, C), li, lim_add, of, pa, pm, o,
          mo, lo, B, H, KV, D, ts, n_main, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
