// RMSNorm with a fixed reduction order for Hopper (sm_90a), bound to Python
// through ctypes.
//
// The port's own kernel: the JAX package leaves the norms to XLA
// (qwen3_tpu/ops/norms.py::rmsnorm and ::rms_inv), and no Pallas kernel
// computes them. Per row of n values (x f32 or bf16):
//
//   inv = rsqrt(mean(x^2) + eps)           (rms_inv: inv, f32 [rows])
//   out = (w * (x * inv)).to(x.dtype)      (rmsnorm: w f32 [n])
//
// Why a kernel. The plain chain (x*x, torch.mean, + eps, rsqrt, two
// products, the cast) is 5-7 PyTorch kernels a call, and torch.mean on the
// card picks its reduction order by the number of rows, so a row's bits
// could follow the batch it sits in. Here a row's order is a function of n
// alone, and so is the launch's shape a row:
//  - TR = 32 threads a row (one warp) up to n = 1024, TR = 128 above;
//  - the row is cut into 4-value chunks, chunk c to thread c % TR; each
//    thread sums the squares of its chunks' values in index order as one
//    chain (every product and sum rounded, -fmad=false and intrinsics);
//  - a warp adds its lanes' sums by a __shfl_xor tree (offsets 16 .. 1,
//    lane l adding lane l ^ off to its own), and with TR = 128 the four
//    warps' sums add as (s0 + s2) + (s1 + s3);
//  - mean = sum * (1 / n), the reciprocal rounded once, as torch.mean's
//    CUDA reduction scales its sum; then + eps and rsqrtf, the rsqrt that
//    torch.rsqrt runs on the card.
// So only the sum's order differs from the plain chain on the card, and
// ops/cuda/norms.py::rms_inv_ordered, a plain version in this order, gives
// the same bits. rmsnorm computes inv exactly as rms_inv does and then
// __fmul_rn(w, __fmul_rn(x, inv)), so w * (x * rms_inv(x)) equals
// rmsnorm(x, w) bit for bit (the fused matmul's "norm" prologue).
//
// Bound: bytes (x read once, w read once, out written once; at qwen3-0.6b's
// decode one row of 1024 values, so the time is the launch). One launch
// replaces the chain's kernels.
//
// Rows: x's leading dimensions as at most two strided levels, [R0, R1] with
// element strides (s0, s1) and the last dimension contiguous, so that the
// q and k heads of a fused qkv output normalize in place as views. out and
// inv are contiguous. A row whose values are not 16-byte (f32) or 8-byte
// (bf16) aligned takes scalar loads: the same chunks, the same order.
//
// The folds: the same row walk, and so the same bits, with the work around
// a norm in its launch. A decoded token's norms are each one launch of a 4
// KB row, so their time is the launch's fixed cost (about 6.5 us on an
// H100), and without the folds a layer launches 16 more tiny kernels on the
// same rows: the residual adds and two rope chains of 7 kernels each. Two
// more entries:
//  - add_rmsnorm / add_rms_inv: s = x + y rounded into x's dtype as
//    torch.add rounds it, written out, then the norm (or its row factor) of
//    s from registers. A thread holds its first kHeld chunks (32 values at
//    n = 1024 with one warp, at n = 4096 with 128 threads), so x and y are
//    read once; wider rows add their later chunks again from x and y.
//  - qk_norm_rope: the q heads and the k heads of a token, one warp a head
//    (head_dim <= 1024; 128 threads above, up to 4096), each normalized in
//    the walk above, rounded to its dtype, staged in shared memory, and
//    rotated there: out[i] = x1*cos - x2*sin, out[i + half] = x1*sin +
//    x2*cos, every product and sum rounded as ops/rope.py's chain rounds
//    it, f32 out (torch's promotion of a head times the f32 tables). cos
//    and sin are read at the row's (b, t) through their strides, so both
//    the prefill's [T, 1, half] and the decode step's [B, 1, 1, half]
//    tables take it.
// Each is bit-equal to its chain on the card: x + y, then rmsnorm or
// rms_inv; rmsnorm, then apply_rope. Bound: bytes, still the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;     // a block: 4 rows of 32 threads, or 1 of 128
constexpr int kNarrowRow = 1024;  // rows up to this width take one warp
constexpr int kHeld = 8;          // chunks a thread of a fold keeps in registers
constexpr int kMaxHead = kHeld * 4 * kThreads;   // qk_norm_rope's widest head

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// v rounded into T and back, as a store of v into a T tensor rounds it.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (sizeof(T) == 4) {
    return v;
  } else {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
}

// The 4 values of chunk c of a row (zeros past n, which leave a sum of
// squares unchanged: it is never -0).
template <typename T>
__device__ __forceinline__ void chunk4(const T* row, int c, int n, bool vec,
                                       float (&v)[4]) {
  if (vec) {
    if constexpr (sizeof(T) == 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(row) + c);
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(row) + c);
      v[0] = __uint_as_float(q.x << 16);
      v[1] = __uint_as_float(q.x & 0xffff0000u);
      v[2] = __uint_as_float(q.y << 16);
      v[3] = __uint_as_float(q.y & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = 4 * c + e < n ? to_f32(row[4 * c + e]) : 0.f;
  }
}

__device__ __forceinline__ void store4(float* p, int c, int n, bool vec,
                                       const float (&v)[4]) {
  if (vec) {
    reinterpret_cast<float4*>(p)[c] = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (4 * c + e < n) p[4 * c + e] = v[e];
  }
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, int c, int n,
                                       bool vec, const float (&v)[4]) {
  if (vec) {
    unsigned h[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      h[e] = __bfloat16_as_ushort(__float2bfloat16_rn(v[e]));
    reinterpret_cast<uint2*>(p)[c] =
        make_uint2(h[0] | (h[1] << 16), h[2] | (h[3] << 16));
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (4 * c + e < n) p[4 * c + e] = __float2bfloat16_rn(v[e]);
  }
}

// A row's factor from its threads' chains: the __shfl_xor tree over a
// warp's lanes, with TR = 128 the four warps' sums as (s0 + s2) + (s1 +
// s3), then rsqrt(sum * (1 / n) + eps). Every thread of the row gets it.
// TR = 128 is one row a block and synchronizes the block.
template <int TR>
__device__ __forceinline__ float row_inv(float acc, int n, float eps) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if constexpr (TR > 32) {
    static_assert(TR == 128, "a wide row takes four warps");
    __shared__ float wsum[4];
    if ((threadIdx.x & 31) == 0) wsum[threadIdx.x >> 5] = acc;
    __syncthreads();
    acc = __fadd_rn(__fadd_rn(wsum[0], wsum[2]), __fadd_rn(wsum[1], wsum[3]));
  }
  const float ms = __fmul_rn(acc, __frcp_rn((float)n));
  return rsqrtf(__fadd_rn(ms, eps));
}

// Row r of the grid: block r / (kThreads / TR), threads TR a row. w non-null
// (NORM) writes out; inv non-null writes the row's factor.
template <int TR, typename T, bool NORM>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ out, float* __restrict__ inv_out, int rows,
               int n, int r1, long long s0, long long s1, int vec, float eps) {
  const int t = threadIdx.x % TR;
  const int r = blockIdx.x * (kThreads / TR) + threadIdx.x / TR;
  if (r >= rows) return;       // a whole row's threads leave together
  const T* row = x + (long long)(r / r1) * s0 + (long long)(r % r1) * s1;
  const int nc = (n + 3) / 4;
  float acc = 0.f;
#pragma unroll 4
  for (int c = t; c < nc; c += TR) {
    float v[4];
    chunk4(row, c, n, vec, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc = __fadd_rn(acc, __fmul_rn(v[e], v[e]));
  }
  const float inv = row_inv<TR>(acc, n, eps);
  if (inv_out != nullptr && t == 0) inv_out[r] = inv;
  if constexpr (NORM) {
    T* dst = out + (long long)r * n;
    for (int c = t; c < nc; c += TR) {
      float v[4], g[4], o[4];
      chunk4(row, c, n, vec, v);
      chunk4(w, c, n, vec, g);
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = __fmul_rn(g[e], __fmul_rn(v[e], inv));
      store4(dst, c, n, vec, o);
    }
  }
}

template <int TR, typename T>
int launch_rmsnorm(const void* x, const void* w, void* out, void* inv,
                   int rows, int n, int r1, long long s0, long long s1,
                   int vec, float eps, cudaStream_t s) {
  constexpr int per_block = kThreads / TR;   // rows a block
  const unsigned grid = (unsigned)((rows + per_block - 1) / per_block);
  const T* xp = static_cast<const T*>(x);
  const float* wp = static_cast<const float*>(w);
  float* ip = static_cast<float*>(inv);
  if (w != nullptr)
    rmsnorm_kernel<TR, T, true><<<grid, kThreads, 0, s>>>(
        xp, wp, static_cast<T*>(out), ip, rows, n, r1, s0, s1, vec, eps);
  else
    rmsnorm_kernel<TR, T, false><<<grid, kThreads, 0, s>>>(
        xp, nullptr, nullptr, ip, rows, n, r1, s0, s1, vec, eps);
  return (int)cudaGetLastError();
}

// add_rmsnorm (NORM) or add_rms_inv: rows of n values of x and y, both
// contiguous; writes s = x + y (T) and out = rmsnorm(s, w) (T) or inv
// (f32 a row). Chunk c to thread c % TR as in rmsnorm_kernel; a thread's
// first kHeld chunks stay in registers between the sum and the norm.
template <int TR, typename T, bool NORM>
__global__ void __launch_bounds__(kThreads)
add_rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ y,
                   const float* __restrict__ w, T* __restrict__ s_out,
                   T* __restrict__ out, float* __restrict__ inv_out, int rows,
                   int n, int vec, float eps) {
  const int t = threadIdx.x % TR;
  const int r = blockIdx.x * (kThreads / TR) + threadIdx.x / TR;
  if (r >= rows) return;       // a whole row's threads leave together
  const long long base = (long long)r * n;
  const T* xr = x + base;
  const T* yr = y + base;
  T* sr = s_out + base;
  const int nc = (n + 3) / 4;
  float held[kHeld][4];
  float acc = 0.f;
  // the row's chunk c of s, rounded into T, stored, squared into the chain
  auto sum_chunk = [&](int c, float (&v)[4]) {
    float a[4], b[4];
    chunk4(xr, c, n, vec, a);
    chunk4(yr, c, n, vec, b);
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = round_to<T>(__fadd_rn(a[e], b[e]));
    store4(sr, c, n, vec, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc = __fadd_rn(acc, __fmul_rn(v[e], v[e]));
  };
#pragma unroll
  for (int j = 0; j < kHeld; ++j)
    if (j * TR + t < nc) sum_chunk(j * TR + t, held[j]);
  for (int c = kHeld * TR + t; c < nc; c += TR) {
    float v[4];
    sum_chunk(c, v);
  }
  const float inv = row_inv<TR>(acc, n, eps);
  if (inv_out != nullptr && t == 0) inv_out[r] = inv;
  if constexpr (NORM) {
    T* dst = out + base;
    auto norm_chunk = [&](int c, const float (&v)[4]) {
      float g[4], o[4];
      chunk4(w, c, n, vec, g);
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = __fmul_rn(g[e], __fmul_rn(v[e], inv));
      store4(dst, c, n, vec, o);
    };
#pragma unroll
    for (int j = 0; j < kHeld; ++j)
      if (j * TR + t < nc) norm_chunk(j * TR + t, held[j]);
    for (int c = kHeld * TR + t; c < nc; c += TR) {
      float a[4], b[4], v[4];
      chunk4(xr, c, n, vec, a);
      chunk4(yr, c, n, vec, b);
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = round_to<T>(__fadd_rn(a[e], b[e]));
      norm_chunk(c, v);
    }
  }
}

template <int TR, typename T>
int launch_add(const void* x, const void* y, const void* w, void* s, void* out,
               void* inv, int rows, int n, int vec, float eps,
               cudaStream_t st) {
  constexpr int per_block = kThreads / TR;
  const unsigned grid = (unsigned)((rows + per_block - 1) / per_block);
  const T* xp = static_cast<const T*>(x);
  const T* yp = static_cast<const T*>(y);
  T* sp = static_cast<T*>(s);
  float* ip = static_cast<float*>(inv);
  if (w != nullptr)
    add_rmsnorm_kernel<TR, T, true><<<grid, kThreads, 0, st>>>(
        xp, yp, static_cast<const float*>(w), sp, static_cast<T*>(out), ip,
        rows, n, vec, eps);
  else
    add_rmsnorm_kernel<TR, T, false><<<grid, kThreads, 0, st>>>(
        xp, yp, nullptr, sp, nullptr, ip, rows, n, vec, eps);
  return (int)cudaGetLastError();
}

// One head's row of a q or k tensor: rows in at most two strided levels
// (row r at (r / r1) * s0 + (r % r1) * s1), `heads` rows a token.
struct HeadRows {
  const void* x;
  const float* w;
  float* out;
  long long s0, s1;
  int rows, r1, heads;
};

// qk_norm_rope: rows 0 .. q.rows - 1 of the grid are q's heads, the rest
// k's; TR threads a head of d values (d even). The token of row r is r /
// heads, at (b, t) = (token / tlen, token % tlen); cos and sin at b * c_sb
// + t * c_st + i. out: f32 [rows, d] contiguous.
template <int TR, typename T>
__global__ void __launch_bounds__(kThreads)
qk_norm_rope_kernel(HeadRows q, HeadRows k, const float* __restrict__ cosv,
                    const float* __restrict__ sinv, int tlen, long long c_sb,
                    long long c_st, int d, int vec, float eps) {
  __shared__ float buf[kMaxHead];   // kThreads / TR heads of d <= kMaxHead
  const int t = threadIdx.x % TR;
  const int slot = threadIdx.x / TR;
  int r = blockIdx.x * (kThreads / TR) + slot;
  if (r >= q.rows + k.rows) return;   // a whole head's threads leave together
  const bool is_q = r < q.rows;
  const HeadRows h = is_q ? q : k;
  if (!is_q) r -= q.rows;
  const T* row = static_cast<const T*>(h.x) + (long long)(r / h.r1) * h.s0 +
                 (long long)(r % h.r1) * h.s1;
  const int nc = (d + 3) / 4;
  float held[kHeld][4];
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < kHeld; ++j) {
    const int c = j * TR + t;
    if (c < nc) {
      chunk4(row, c, d, vec, held[j]);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc = __fadd_rn(acc, __fmul_rn(held[j][e], held[j][e]));
    }
  }
  const float inv = row_inv<TR>(acc, d, eps);
  float* hb = buf + slot * (kMaxHead / (kThreads / TR));
#pragma unroll
  for (int j = 0; j < kHeld; ++j) {
    const int c = j * TR + t;
    if (c < nc) {
      float g[4];
      chunk4(h.w, c, d, vec, g);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * c + e < d)
          hb[4 * c + e] = round_to<T>(__fmul_rn(g[e], __fmul_rn(held[j][e], inv)));
    }
  }
  if constexpr (TR > 32) __syncthreads(); else __syncwarp();
  const int half = d / 2;
  const int token = r / h.heads;
  const long long cs = (long long)(token / tlen) * c_sb +
                       (long long)(token % tlen) * c_st;
  float* dst = h.out + (long long)r * d;
  for (int i = t; i < half; i += TR) {
    const float a = hb[i], b = hb[i + half];
    const float c = __ldg(cosv + cs + i), sn = __ldg(sinv + cs + i);
    dst[i] = __fsub_rn(__fmul_rn(a, c), __fmul_rn(b, sn));
    dst[i + half] = __fadd_rn(__fmul_rn(a, sn), __fmul_rn(b, c));
  }
}

template <int TR, typename T>
int launch_qk(const HeadRows& q, const HeadRows& k, const void* cosv,
              const void* sinv, int tlen, long long c_sb, long long c_st,
              int d, int vec, float eps, cudaStream_t st) {
  constexpr int per_block = kThreads / TR;
  const long long rows = (long long)q.rows + k.rows;
  const unsigned grid = (unsigned)((rows + per_block - 1) / per_block);
  qk_norm_rope_kernel<TR, T><<<grid, kThreads, 0, st>>>(
      q, k, static_cast<const float*>(cosv), static_cast<const float*>(sinv),
      tlen, c_sb, c_st, d, vec, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// rows rows of n values of x (f32, or bf16 when bf16 != 0), row r at element
// (r / r1) * s0 + (r % r1) * s1. w (f32 [n]) non-null writes out (x's dtype,
// [rows, n] contiguous) = rmsnorm(x, w); inv non-null writes f32 [rows] =
// rms_inv(x). vec != 0: every row and w 16-byte (f32) or 8-byte (bf16)
// aligned and n % 4 == 0. Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
int rmsnorm(const void* x, const void* w, void* out, void* inv, int rows,
            int n, int r1, long long s0, long long s1, int bf16, int vec,
            float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || n <= 0 || r1 <= 0) return (int)cudaErrorInvalidValue;
  if (n <= kNarrowRow)
    return bf16 ? launch_rmsnorm<32, __nv_bfloat16>(x, w, out, inv, rows, n,
                                                    r1, s0, s1, vec, eps, s)
                : launch_rmsnorm<32, float>(x, w, out, inv, rows, n, r1, s0,
                                            s1, vec, eps, s);
  return bf16 ? launch_rmsnorm<128, __nv_bfloat16>(x, w, out, inv, rows, n, r1,
                                                   s0, s1, vec, eps, s)
              : launch_rmsnorm<128, float>(x, w, out, inv, rows, n, r1, s0, s1,
                                           vec, eps, s);
}

// rows rows of n values of x and y (f32, or bf16 when bf16 != 0), both
// contiguous [rows, n]; writes s ([rows, n], x's dtype) = x + y and, with w
// (f32 [n]) non-null, out ([rows, n], x's dtype) = rmsnorm(s, w), else inv
// (f32 [rows]) = rms_inv(s). vec != 0: x, y, s, out and w 16-byte (f32) or
// 8-byte (bf16) aligned and n % 4 == 0. Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
int add_rmsnorm(const void* x, const void* y, const void* w, void* s,
                void* out, void* inv, int rows, int n, int bf16, int vec,
                float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  if (n <= kNarrowRow)
    return bf16 ? launch_add<32, __nv_bfloat16>(x, y, w, s, out, inv, rows, n,
                                                vec, eps, st)
                : launch_add<32, float>(x, y, w, s, out, inv, rows, n, vec,
                                        eps, st);
  return bf16 ? launch_add<128, __nv_bfloat16>(x, y, w, s, out, inv, rows, n,
                                               vec, eps, st)
              : launch_add<128, float>(x, y, w, s, out, inv, rows, n, vec,
                                       eps, st);
}

// The q heads (nq rows, hq a token, rows at (r / q_r1) * q_s0 + (r % q_r1)
// * q_s1) and the k heads (the same for k) of d values (d even, at most
// 4096; f32, or bf16 when bf16 != 0), normalized by wq / wk (f32 [d]) and
// rotated: qo ([nq, d] f32) and ko ([nk, d] f32). A head of token `tok` is
// at (b, t) = (tok / tlen, tok % tlen) and reads cos and sin (f32) from
// b * c_sb + t * c_st + i. vec != 0: every row and both weights 16-byte
// (f32) or 8-byte (bf16) aligned and d % 4 == 0. One launch on `stream`;
// returns cudaGetLastError() (0 = launched).
int qk_norm_rope(const void* q, const void* k, const void* wq, const void* wk,
                 const void* cosv, const void* sinv, void* qo, void* ko,
                 int nq, int q_r1, long long q_s0, long long q_s1, int hq,
                 int nk, int k_r1, long long k_s0, long long k_s1, int hk,
                 int tlen, long long c_sb, long long c_st, int d, int bf16,
                 int vec, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nq < 0 || nk < 0 || nq + nk <= 0 || d <= 0 || d % 2 != 0 ||
      d > kMaxHead || q_r1 <= 0 || k_r1 <= 0 || hq <= 0 || hk <= 0 ||
      tlen <= 0)
    return (int)cudaErrorInvalidValue;
  const HeadRows qr{q, static_cast<const float*>(wq), static_cast<float*>(qo),
                    q_s0, q_s1, nq, q_r1, hq};
  const HeadRows kr{k, static_cast<const float*>(wk), static_cast<float*>(ko),
                    k_s0, k_s1, nk, k_r1, hk};
  if (d <= kNarrowRow)
    return bf16 ? launch_qk<32, __nv_bfloat16>(qr, kr, cosv, sinv, tlen, c_sb,
                                               c_st, d, vec, eps, st)
                : launch_qk<32, float>(qr, kr, cosv, sinv, tlen, c_sb, c_st,
                                       d, vec, eps, st);
  return bf16 ? launch_qk<128, __nv_bfloat16>(qr, kr, cosv, sinv, tlen, c_sb,
                                              c_st, d, vec, eps, st)
              : launch_qk<128, float>(qr, kr, cosv, sinv, tlen, c_sb, c_st, d,
                                      vec, eps, st);
}

}  // extern "C"
