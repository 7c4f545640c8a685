// One-token GQA attention over a KV cache in one launch: per-tile partials
// and their fixed-order combine. The decode kernel shared by flash_decode.cu
// (flash_decode_gqa, flash_decode_gqa_two_segment) and batched_decode.cu
// (batched_decode_partial). See flash_decode.cu's header for the bound and
// the design's history.
//
// Blocks own (tile, kv head x head group, slot). Tiles 0 .. n_main-1 cover
// the main cache [B, S, KV, D] in `ts`-row tiles, rows < lim[b] + lim_add;
// with a side buffer [B, C, KV, D], tile n_main covers its rows j <= off[b].
// Each block writes the unnormalised online-softmax partial (acc, m, l) of
// its rows for its query heads; the last block of a slot to finish combines
// the slot's main tiles in order, then its side tile, and writes either
// acc / l or the unnormalised (acc, m, l) relative to the largest m.
//
// Arithmetic per row s (all fp32, the Pallas kernels' order within a row):
//   x_s = (q . k_s) * scale, then * ks_s        p_s = exp(x_s - m)
//   l  += p_s                                   acc += (p_s * vs_s) * v_s
// with m the running max of the lane group's rows so far (expf, explicit
// fmaf, no contraction: -fmad=false). FAST (the pallas-fast serving mode):
// the caller rounds q to bf16, K and V are rounded to bf16 as they are read
// (exact for int8 and bf16 caches), and p_s * vs_s is rounded to bf16
// before the value dot; every product of two bf16 values is exact in fp32,
// so only the sums round.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "smem_attr.cuh"

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
// int8: each byte b, biased to b + 128 (an xor), becomes the low byte of the
// float 2^23 + b + 128 (one byte permute), less 2^23 + 128 (one exact fadd):
// the value exactly, where an int-to-float conversion issues at a quarter
// of the fp32 rate
template <> struct Row16<int8_t> {
  static constexpr int E = 16;
  __device__ __forceinline__ static void cvt(const int4 raw, float* o) {
    const unsigned w[4] = {(unsigned)raw.x ^ 0x80808080u,
                           (unsigned)raw.y ^ 0x80808080u,
                           (unsigned)raw.z ^ 0x80808080u,
                           (unsigned)raw.w ^ 0x80808080u};
#pragma unroll
    for (int e = 0; e < 16; ++e)
      o[e] = __fadd_rn(
          __uint_as_float(__byte_perm(w[e >> 2], 0x4B000000u, 0x7440u | (e & 3))),
          -8388736.f);
  }
};

template <typename T>
__device__ __forceinline__ int4 load16(const T* p) {
  return __ldg(reinterpret_cast<const int4*>(p));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

constexpr int kDecWarps = 8, kDecThreads = 32 * kDecWarps;
// a warp's cp.async ring: a stage holds one 16-byte K and V piece a lane
constexpr int kDecStages = 4;
constexpr int kRing = kDecWarps * kDecStages * 32;  // pieces

__device__ __forceinline__ void dec_cp16(void* dst, const void* src, bool on) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(on ? 16 : 0));
}

__device__ __forceinline__ void dec_cp4(void* dst, const void* src, bool on) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(on ? 4 : 0));
}

// Dynamic shared memory: the rings (K and V pieces, K and V scales; the
// warps' merge area reuses them after the walk), then the combine's
// per-(head, tile) m and l.
size_t decode_smem(int NH, int n_tiles) {
  return (size_t)kRing * (2 * sizeof(int4) + 2 * sizeof(float)) +
         sizeof(float) * (2 * (size_t)NH * n_tiles + NH);
}

// One segment of the cache a block reads: rows [r0, r_end) of k/v
// [B, rows, KV, D] (scales [B, rows, KV] or null).
template <typename T>
struct Segment {
  const T* k;
  const T* v;
  const float* ks;
  const float* vs;
  int rows;
};

// One block per (tile, kv head x head group, slot), kDecWarps warps, NH
// query heads of the kv head (heads NH hg ..). Every lane owns a 16-byte
// piece of a cache row (vpr lanes a row, rpw = 32 / vpr rows a warp load)
// and keeps, for its lane group (the lanes of one row), its own online
// softmax: m and l per head, and acc over its piece's E columns per head.
// A warp walks granules of rpw rows (a row a lane group), granule g of the
// tile going to warp g % kDecWarps, through a private ring of kDecStages
// stages filled by cp.async (each lane copies, and later reads, only its
// own piece and its row's scales, so the walk has no barrier at all). At the
// walk's end the lane groups of a warp merge by shuffles, the warps in warp
// order through shared memory, and the block writes its partial (acc, m,
// l). Then it counts itself done on counters[blockIdx.z][blockIdx.y]; the
// last block of that (slot, kv head, head group) resets the counter to 0
// and combines the slot's partials in tile order (main tiles 0 .. ceil(
// (lim[b] + lim_add) / ts) - 1, then the side tile n_main with `off`):
// out = acc / l, or the unnormalised (acc, m, l) into (out, m_out, l_out),
// (0, -FLT_MAX, 0) for a slot with no row. Every order is fixed, never the
// order of arrival, so the output repeats bit for bit.
template <typename T, bool FAST, int NH>
__global__ void __launch_bounds__(kDecThreads, NH == 2 ? 2 : 1)
decode_kernel(const float* __restrict__ q, Segment<T> main_seg,
              Segment<T> side_seg, const int* __restrict__ lim, int lim_add,
              const int* __restrict__ off, float* __restrict__ part_acc,
              float* __restrict__ part_ml, float* __restrict__ out,
              float* __restrict__ m_out, float* __restrict__ l_out,
              int* __restrict__ counters, int n_main, int KV, int M, int D,
              int ts, float scale) {
  extern __shared__ __align__(16) int4 dsm[];
  __shared__ int last;
  constexpr int E = Row16<T>::E;
  constexpr bool RoundKV = FAST && sizeof(T) == 4;
  const int tile = blockIdx.x, n_tiles = gridDim.x;
  const int HG = gridDim.y / KV;
  const int kv = blockIdx.y / HG, h0 = blockIdx.y % HG * NH, b = blockIdx.z;
  const int nh = min(NH, M - h0);
  const int H = KV * M;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int vpr = D / E, rpw = 32 / vpr, sub = lane / vpr, piece = lane % vpr;
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
  const size_t base = ((size_t)b * KV + kv) * n_tiles;

  if (r0 < r_end) {   // a tile past the slot's rows is never read
    float qv[NH][E], m[NH], l[NH], acc[NH][E];
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      m[h] = kNeg;
      l[h] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        acc[h][e] = 0.f;
        qv[h][e] = h < nh ? q[((size_t)b * H + (size_t)kv * M + h0 + h) * D +
                              piece * E + e]
                          : 0.f;
      }
    }
    const size_t row_stride = (size_t)KV * D;
    const size_t cache0 = (size_t)b * S * KV + kv;   // (b, row 0, kv)
    const T* kb = seg.k + cache0 * D + piece * E;
    const T* vb = seg.v + cache0 * D + piece * E;
    const float* ksb = seg.ks ? seg.ks + cache0 : nullptr;
    const float* vsb = seg.vs ? seg.vs + cache0 : nullptr;
    int4* rk = dsm + warp * kDecStages * 32;
    int4* rv = rk + kRing;
    float* rks = reinterpret_cast<float*>(dsm + 2 * kRing) +
                 warp * kDecStages * 32;
    float* rvs = rks + kRing;
    const int n_gran = (r_end - r0 + rpw - 1) / rpw;
    const int steps =
        warp < n_gran ? (n_gran - warp + kDecWarps - 1) / kDecWarps : 0;
    auto issue = [&](int st) {
      if (st < steps) {
        const int row = r0 + (st * kDecWarps + warp) * rpw + sub;
        const bool on = row < r_end;
        const int i = (st % kDecStages) * 32 + lane;
        dec_cp16(rk + i, on ? kb + row * row_stride : kb, on);
        dec_cp16(rv + i, on ? vb + row * row_stride : vb, on);
        if (ksb) {
          dec_cp4(rks + i, on ? ksb + (size_t)row * KV : ksb, on);
          dec_cp4(rvs + i, on ? vsb + (size_t)row * KV : vsb, on);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::);
    };
#pragma unroll
    for (int st = 0; st < kDecStages - 1; ++st) issue(st);
    for (int st = 0; st < steps; ++st) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kDecStages - 2));
      issue(st + kDecStages - 1);
      const int i = (st % kDecStages) * 32 + lane;
      const bool ok = r0 + (st * kDecWarps + warp) * rpw + sub < r_end;
      float kx[E];
      Row16<T>::cvt(rk[i], kx);
      if (RoundKV) {
#pragma unroll
        for (int e = 0; e < E; ++e) kx[e] = bf16_round(kx[e]);
      }
      const float ksc = ksb ? rks[i] : 1.f;
      // the piece's dot in two chains (even and odd columns), then the
      // row's pieces: every lane runs every butterfly level, which keeps
      // the warp converged and the heads interleaved, and adds the levels
      // below vpr, the row's own lanes
      float x[NH];
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        float d0 = 0.f, d1 = 0.f;
#pragma unroll
        for (int e = 0; e < E; e += 2) {
          d0 = fmaf(qv[h][e], kx[e], d0);
          d1 = fmaf(qv[h][e + 1], kx[e + 1], d1);
        }
        x[h] = d0 + d1;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const float t = __shfl_xor_sync(kFull, x[h], o);
          if (o < vpr) x[h] += t;
        }
      }
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        float sc = x[h] * scale;
        if (ksb) sc = sc * ksc;
        x[h] = ok ? sc : kNeg;
      }
      float vx[E];
      Row16<T>::cvt(rv[i], vx);
      if (RoundKV) {
#pragma unroll
        for (int e = 0; e < E; ++e) vx[e] = bf16_round(vx[e]);
      }
      const float vsc = vsb ? rvs[i] : 1.f;
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        // a new running max rescales l and acc; else alpha would be exactly
        // 1 and the products changeless, so they are skipped
        const float mx = fmaxf(m[h], x[h]);
        if (mx > m[h]) {
          const float alpha = expf(m[h] - mx);
          l[h] = l[h] * alpha;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[h][e] = acc[h][e] * alpha;
          m[h] = mx;
        }
        const float p = ok ? expf(x[h] - mx) : 0.f;
        l[h] = l[h] + p;
        const float w = vsb ? p * vsc : p;
        const float pv = FAST ? bf16_round(w) : w;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[h][e] = fmaf(pv, vx[e], acc[h][e]);
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
    // the warp's lane groups, merged by shuffles (a lane and its partner
    // add the same two terms, so they hold the same bits)
    for (int o = vpr; o < 32; o <<= 1) {
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const float mo = __shfl_xor_sync(kFull, m[h], o);
        const float lo = __shfl_xor_sync(kFull, l[h], o);
        const float mn = fmaxf(m[h], mo);
        const float a = expf(m[h] - mn), c = expf(mo - mn);
        l[h] = l[h] * a + lo * c;
        m[h] = mn;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float ao = __shfl_xor_sync(kFull, acc[h][e], o);
          acc[h][e] = acc[h][e] * a + ao * c;
        }
      }
    }
    // the warps, merged in warp order; the rings are free once every warp
    // has left its walk
    float* wacc = reinterpret_cast<float*>(dsm);          // [warps][NH][D]
    float* wml = wacc + kDecWarps * NH * D;               // [warps][NH][2]
    __syncthreads();
    if (sub == 0) {
#pragma unroll
      for (int h = 0; h < NH; ++h) {
#pragma unroll
        for (int e = 0; e < E; ++e)
          wacc[(warp * NH + h) * D + piece * E + e] = acc[h][e];
        if (piece == 0) {
          wml[(warp * NH + h) * 2] = m[h];
          wml[(warp * NH + h) * 2 + 1] = l[h];
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < nh * D; i += kDecThreads) {
      const int h = i / D, dd = i % D;
      float mg = kNeg;
      for (int w = 0; w < kDecWarps; ++w)
        mg = fmaxf(mg, wml[(w * NH + h) * 2]);
      float o = 0.f, lt = 0.f;
      for (int w = 0; w < kDecWarps; ++w) {
        const float c = expf(wml[(w * NH + h) * 2] - mg);
        o = o + wacc[(w * NH + h) * D + dd] * c;
        lt = lt + wml[(w * NH + h) * 2 + 1] * c;
      }
      const size_t pr = (base + tile) * M + h0 + h;
      part_acc[pr * D + dd] = o;
      if (dd == 0) {
        part_ml[pr * 2] = mg;
        part_ml[pr * 2 + 1] = lt;
      }
    }
  }

  // the last block of (slot, kv head, head group) to finish combines
  __threadfence();
  __syncthreads();
  int* counter = counters + (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  if (tid == 0) {
    last = atomicAdd(counter, 1) == n_tiles - 1;
    if (last) *counter = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int rows = max(lim[b] + lim_add, 0);
  const int nm = min((rows + ts - 1) / ts, n_main);
  const int n = nm + ((off && off[b] >= 0) ? 1 : 0);
  float* cm = reinterpret_cast<float*>(dsm + 2 * kRing) + 2 * kRing;
  float* cl = cm + NH * n_tiles;
  float* mgs = cl + NH * n_tiles;
  for (int i = tid; i < nh * n; i += kDecThreads) {
    const int h = i / n, t = i % n;
    const int tl = t < nm ? t : n_main;
    const float* ml = part_ml + ((base + tl) * M + h0 + h) * 2;
    cm[h * n_tiles + t] = __ldcg(ml);
    cl[h * n_tiles + t] = __ldcg(ml + 1);
  }
  __syncthreads();
  if (tid < nh) {
    float mg = kNeg;
    for (int t = 0; t < n; ++t) mg = fmaxf(mg, cm[tid * n_tiles + t]);
    mgs[tid] = mg;
  }
  __syncthreads();
  for (int i = tid; i < nh * n; i += kDecThreads) {
    const int h = i / n, t = i % n;
    cm[h * n_tiles + t] = expf(cm[h * n_tiles + t] - mgs[h]);
  }
  __syncthreads();
  // warp w adds its contiguous range of tiles in order, a lane 4 columns;
  // then the warps' sums are added in warp order
  const int per = (n + kDecWarps - 1) / kDecWarps;
  const int t0 = min(n, warp * per), t1 = min(n, t0 + per);
  float* wsum = reinterpret_cast<float*>(dsm);          // [warps][NH][D]
  float* lsum = wsum + kDecWarps * NH * D;              // [warps][NH]
  const bool col = 4 * lane < D;
  const float* pa = part_acc + (base * M + h0) * D + 4 * lane;
  float4 a[NH];
  float lt[NH];
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    a[h] = make_float4(0.f, 0.f, 0.f, 0.f);
    lt[h] = 0.f;
  }
#pragma unroll 4
  for (int t = t0; t < t1; ++t) {
    const size_t tl = t < nm ? t : n_main;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      if (h >= nh) continue;
      const float wt = cm[h * n_tiles + t];
      if (col) {
        const float4 v = __ldcg(
            reinterpret_cast<const float4*>(pa + (tl * M + h) * D));
        a[h].x = a[h].x + v.x * wt;
        a[h].y = a[h].y + v.y * wt;
        a[h].z = a[h].z + v.z * wt;
        a[h].w = a[h].w + v.w * wt;
      }
      lt[h] = lt[h] + cl[h * n_tiles + t] * wt;
    }
  }
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    if (h >= nh) continue;
    if (col)
      *reinterpret_cast<float4*>(wsum + (warp * NH + h) * D + 4 * lane) =
          a[h];
    if (lane == 0) lsum[warp * NH + h] = lt[h];
  }
  __syncthreads();
  for (int i = tid; i < nh * D; i += kDecThreads) {
    const int h = i / D, dd = i % D;
    float o = 0.f, lt = 0.f;
    for (int w = 0; w < kDecWarps; ++w) {
      o = o + wsum[(w * NH + h) * D + dd];
      lt = lt + lsum[w * NH + h];
    }
    const size_t row = (size_t)b * H + (size_t)kv * M + h0 + h;
    out[row * D + dd] = m_out ? o : o / lt;
    if (m_out && dd == 0) {
      m_out[row] = mgs[h];
      l_out[row] = lt;
    }
  }
}

// The decode kernel on `stream`: part_acc [B, KV, n_tiles, M, D] and
// part_ml [B, KV, n_tiles, M, 2] are scratch, n_tiles = n_main (+ 1 with a
// side segment, i.e. when `off` is not null); counters int32 [B, KV, M]
// hold zeros and are left so (the combining blocks reset them), which
// makes the calls on one stream safe one after another; two streams need
// two buffers (ops/cuda/flash_decode.py::decode_counters keeps one each).
// NH = 2 query heads a block for M <= 2, else 4 (ceil(M / 4) head groups,
// each reading the kv head's rows). Returns cudaGetLastError().
template <typename T, bool FAST, int NH>
int launch_decode_nh(const float* q, Segment<T> main_seg, Segment<T> side_seg,
                     const int* lim, int lim_add, const int* off,
                     float* part_acc, float* part_ml, float* out,
                     float* m_out, float* l_out, int* counters, int B, int H,
                     int KV, int D, int ts, int n_main, float scale,
                     cudaStream_t stream) {
  static size_t set[16] = {};
  const int M = H / KV, HG = (M + NH - 1) / NH;
  const int n_tiles = n_main + (off ? 1 : 0);
  const size_t smem = decode_smem(NH, n_tiles);
  auto kernel = decode_kernel<T, FAST, NH>;
  const int err = allow_smem(kernel, smem, set);
  if (err) return err;
  const dim3 grid((unsigned)n_tiles, (unsigned)(KV * HG), (unsigned)B);
  kernel<<<grid, kDecThreads, smem, stream>>>(
      q, main_seg, side_seg, lim, lim_add, off, part_acc, part_ml, out, m_out,
      l_out, counters, n_main, KV, M, D, ts, scale);
  return (int)cudaGetLastError();
}

template <typename T, bool FAST>
int launch_decode_partials(const float* q, Segment<T> main_seg,
                           Segment<T> side_seg, const int* lim, int lim_add,
                           const int* off, float* part_acc, float* part_ml,
                           float* out, float* m_out, float* l_out,
                           int* counters, int B, int H, int KV, int D, int ts,
                           int n_main, float scale, cudaStream_t stream) {
  if (D < 16 || D > 128 || (D & (D - 1)) || H % KV)
    return (int)cudaErrorInvalidValue;
  if (H / KV <= 2)
    return launch_decode_nh<T, FAST, 2>(q, main_seg, side_seg, lim, lim_add,
                                        off, part_acc, part_ml, out, m_out,
                                        l_out, counters, B, H, KV, D, ts,
                                        n_main, scale, stream);
  return launch_decode_nh<T, FAST, 4>(q, main_seg, side_seg, lim, lim_add,
                                      off, part_acc, part_ml, out, m_out,
                                      l_out, counters, B, H, KV, D, ts, n_main,
                                      scale, stream);
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
                    void* l_out, void* counters, int B, int H, int KV, int D,
                    int ts, int n_main, float scale, void* stream) {
  const float* qf = static_cast<const float*>(q);
  const int* li = static_cast<const int*>(lim);
  const int* of = static_cast<const int*>(off);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  float* o = static_cast<float*>(out);
  float* mo = static_cast<float*>(m_out);
  float* lo = static_cast<float*>(l_out);
  int* cn = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_decode_partials<float, FAST>(
          qf, segment<float>(k, v, ks, vs, S),
          segment<float>(sk, sv, sks, svs, C), li, lim_add, of, pa, pm, o,
          mo, lo, cn, B, H, KV, D, ts, n_main, scale, s);
    case 1:
      return launch_decode_partials<__nv_bfloat16, FAST>(
          qf, segment<__nv_bfloat16>(k, v, ks, vs, S),
          segment<__nv_bfloat16>(sk, sv, sks, svs, C), li, lim_add, of, pa,
          pm, o, mo, lo, cn, B, H, KV, D, ts, n_main, scale, s);
    case 2:
      return launch_decode_partials<int8_t, FAST>(
          qf, segment<int8_t>(k, v, ks, vs, S),
          segment<int8_t>(sk, sv, sks, svs, C), li, lim_add, of, pa, pm, o,
          mo, lo, cn, B, H, KV, D, ts, n_main, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
