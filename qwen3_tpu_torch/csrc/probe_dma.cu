// Pure-read probes of the weight stream for Hopper (sm_90a), bound to Python
// through ctypes.
//
// Replace the TPU kernels tools/probe_dma.py::pure_read_stacked and
// ::pure_read_manual. Both read every byte of layer `layer` of stacked int8
// weights w [L, d, n] (the port's row-major layout) and return the JAX
// probes' checksum, int32 out [8, td], every row equal to
//
//   out[r, t] = sum over jj < d / td, kk < n / tk, i < 8 of
//               w[layer, jj * td + t, kk * tk + i]
//
// the TPU kernels' 8-row sum of each [tk, td] tile, here the first 8 bytes of
// each tk-byte run of a weight row. Integer sums are exact, so the atomics'
// order does not show; the wrapper zeroes out before the launch.
//
// Bound: bytes, one layer's d * n weight bytes read once (49.8 MB for
// qwen3-4b's w13), so a probe's time is the layer over the rate the card
// streams it at.
//
//  - pure_read_stacked keeps the grid, block shape and load pattern of the
//    Q8_0 GEMV the CLI decodes with (q8_matmul.cu::q8q8_gemv_kernel): one warp
//    a weight row, 8 rows a 256-thread block, each lane 16 bytes an iteration,
//    so a warp-iteration reads a 512-byte run of the row. The checksum uses
//    8 bytes of each tk-byte run, and ptxas drops a load whose value is
//    unused (a first version read 3.9 TB/s, above the card's 3.35), where
//    the TPU's DMA read the whole tile: so every loaded word also goes into
//    a witness, xor & mask with mask = 0 from the caller, that the kernel
//    adds to the checksum; the compiler cannot know that it adds 0.
//  - pure_read_manual streams the same tiles through a ring of n_buf slots in
//    shared memory, filled by bulk async copies (cp.async.bulk, the TMA's 1-D
//    form) that complete on one mbarrier a slot: the counterpart of the TPU
//    kernel's make_async_copy ring with DMA semaphores. The TPU ran one
//    program; one block would measure one SM here, so a persistent grid of
//    one block an SM walks the tiles, each block its own ring. A TPU tile
//    [tk, td] (512 KB at tk = 512, td = 1024) does not fit in shared memory,
//    so a slot holds 64 weight rows of one tile (64 x tk bytes, 32 KB),
//    copied row by row (tk bytes each, 16-byte aligned) by 64 threads. Sub-
//    tiles go in the TPU's tile order, tile idx = jj * (n / tk) + kk, sub-
//    tile s within it; block i takes sub-tiles i, i + grid, i + 2 grid, ...
//    A block sums its rows' checksums per column in shared memory and adds
//    the columns it touched to out once, at its end.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlotRows = 64;
constexpr int kManualThreads = 256;
constexpr int kMaxBuf = 4;
constexpr int kMaxTd = 1024;

// sum of the 8 signed bytes in words a, b
__device__ __forceinline__ int sum8(int a, int b) {
  return __dp4a(b, 0x01010101, __dp4a(a, 0x01010101, 0));
}

// Requires n % 16 == 0 and tk a multiple of 512 or n itself, so every tk-byte
// run starts at a warp-iteration's first lane; mask = 0.
__global__ void pure_read_stacked_kernel(const int8_t* __restrict__ w,
                                         int* __restrict__ out, int n, int d,
                                         int td, int tk, int mask) {
  const int c = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= d) return;  // uniform over the warp
  const int8_t* row = w + (size_t)c * n;
  int s = 0;
  for (int k0 = 0; k0 < n; k0 += 512) {
    const int k = k0 + lane * 16;
    if (k < n) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(row + k));
      s += (v.x ^ v.y ^ v.z ^ v.w) & mask;   // the witness: adds 0
      if (lane == 0 && k0 % tk == 0) s += sum8(v.x, v.y);
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane < 8) atomicAdd(out + (size_t)lane * td + c % td, s);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Requires d % td == 0, td % 64 == 0, td <= 1024, n % tk == 0, tk % 16 == 0,
// 64 * tk <= 32768, 2 <= n_buf <= 4; dynamic shared memory n_buf * 64 * tk.
__global__ void __launch_bounds__(kManualThreads)
pure_read_manual_kernel(const int8_t* __restrict__ w, int* __restrict__ out,
                        int n, int d, int td, int tk, int n_buf) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t bar[kMaxBuf];
  __shared__ int col_sum[kMaxTd];
  const int nk = n / tk;
  const int per_tile = td / kSlotRows;
  const int total = (d / td) * nk * per_tile;
  const int count = ((int)blockIdx.x < total)
                        ? (total - (int)blockIdx.x + (int)gridDim.x - 1) /
                              (int)gridDim.x
                        : 0;
  const int slot_bytes = kSlotRows * tk;
  const int tid = threadIdx.x;
  for (int c = tid; c < td; c += kManualThreads) col_sum[c] = 0;
  if (tid == 0) {
    for (int s = 0; s < n_buf; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(&bar[s]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread r < 64 copies row r of this block's i-th sub-tile into `slot`;
  // thread 0 also arms the slot's barrier for the 64 rows' bytes (the
  // transaction count may run below 0 until it does: the phase completes
  // only at its arrival)
  auto issue = [&](int slot, int i) {
    const int q = (int)blockIdx.x + i * (int)gridDim.x;
    const int tile = q / per_tile, sub = q % per_tile;
    const int jj = tile / nk, kk = tile % nk;
    const int8_t* src = w + (size_t)(jj * td + sub * kSlotRows + tid) * n +
                        (size_t)kk * tk;
    const uint32_t b = smem_addr(&bar[slot]);
    const uint32_t dst =
        smem_addr(ring + (size_t)slot * slot_bytes + (size_t)tid * tk);
    if (tid == 0)
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
          "r"(slot_bytes)
          : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(dst),
        "l"(src), "r"(tk), "r"(b)
        : "memory");
  };

  if (tid < kSlotRows)
    for (int i = 0; i < n_buf && i < count; ++i) issue(i, i);
  for (int i = 0; i < count; ++i) {
    const int slot = i % n_buf;
    bar_wait(smem_addr(&bar[slot]), (uint32_t)((i / n_buf) & 1));
    if (tid < kSlotRows) {
      const int q = (int)blockIdx.x + i * (int)gridDim.x;
      const int* p = reinterpret_cast<const int*>(
          ring + (size_t)slot * slot_bytes + (size_t)tid * tk);
      atomicAdd(&col_sum[(q % per_tile) * kSlotRows + tid], sum8(p[0], p[1]));
    }
    __syncthreads();   // every thread is done with the slot
    if (tid < kSlotRows && i + n_buf < count) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(slot, i + n_buf);
    }
  }
  // a column's sum goes to all 8 rows of out; a column this block never
  // touched holds 0 and is skipped (so is one whose bytes summed to 0)
  for (int e = tid; e < 8 * td; e += kManualThreads) {
    const int s = col_sum[e % td];
    if (s != 0) atomicAdd(out + e, s);
  }
}

}  // namespace

extern "C" {

// out [8, td] += the checksum of layer `layer` of w [L, d, n], walked as the
// Q8_0 GEMV walks it; mask = 0 (the witness's). Launches on `stream`;
// returns cudaGetLastError().
int pure_read_stacked(const void* w, int layer, void* out, int d, int n,
                      int td, int tk, int mask, void* stream) {
  const int8_t* wl = static_cast<const int8_t*>(w) + (size_t)layer * d * n;
  const int threads = 256;  // 8 weight rows a block
  const unsigned blocks = (unsigned)(((size_t)d * 32 + threads - 1) / threads);
  pure_read_stacked_kernel<<<blocks, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      wl, static_cast<int*>(out), n, d, td, tk, mask);
  return (int)cudaGetLastError();
}

// The same checksum, streamed by `blocks` persistent blocks through n_buf-slot
// rings of bulk async copies. Launches on `stream`; returns
// cudaGetLastError().
int pure_read_manual(const void* w, int layer, void* out, int d, int n,
                     int td, int tk, int n_buf, int blocks, void* stream) {
  const int8_t* wl = static_cast<const int8_t*>(w) + (size_t)layer * d * n;
  const int smem = n_buf * kSlotRows * tk;
  cudaError_t err = cudaFuncSetAttribute(
      pure_read_manual_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  pure_read_manual_kernel<<<(unsigned)blocks, kManualThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      wl, static_cast<int*>(out), n, d, td, tk, n_buf);
  return (int)cudaGetLastError();
}

}  // extern "C"
