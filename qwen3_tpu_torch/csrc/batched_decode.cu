// Batched decode-attention partials for Hopper (sm_90a), bound to Python
// through ctypes.
//
// Replaces the TPU kernel qwen3_tpu/ops/pallas/batched_decode.py::
// batched_decode_partial: for B slots, one query token each, the
// unnormalised flash partials of attention over layer `layer` of the stacked
// [L, B, S, KV, D] cache, rows < row_limit[b]:
//
//   m = max_s x_s,  l = sum_s p_s,  acc = sum_s (p_s * vs_s) * v_s,
//   x_s = (q . k_s) * (1/sqrt(D)) * ks_s,  p_s = exp(x_s - m)
//
// per query head, in the shapes acc [B, KV, M, D], m and l [B, KV, M]; the
// serving step folds the chunk's side buffer in afterwards
// (ops/attention.py::fused_batched_attention). With `fast` (the pallas-fast
// mode) the dots take bf16 operands: q rounded by the caller, K and V
// rounded as read (int8 and bf16 exactly), p * vs rounded before the value
// dot; products of bf16 values are exact in fp32 and the sums stay fp32.
//
// The TPU kernel serves `bb` slots per grid step with one "expanded-column"
// MXU product over every (row, kv head) pair, a layout for its matrix unit.
// Here the work is decode_partial.cuh's, as for flash decode: a block per
// (256-row tile, kv head, slot) writes its partial, and the last block of a
// slot's kv head combines the slot's tiles in tile order, in the same
// launch. The tiles start at row 0 whatever the host's bucket, a tile at
// or past a slot's limit is never read, and every sum runs in an order
// fixed by the slot's own rows, so a slot's result depends only on them:
// the same bits at any batch size and bucket, and on every run. Bound by
// bytes: the int8 K/V and scales of the rows below each slot's limit, once.
//
// Layout: q f32 [B, H, D]; k, v one layer [B, S, KV, D] of f32 / bf16 / int8
// (the wrapper passes the layer's offset); ks, vs [B, S, KV] f32 or null;
// row_limit int32 [B].

#include "decode_partial.cuh"

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 int8; fast: 0 or 1. part_acc
// [B, KV, n_tiles, M, D] and part_ml [B, KV, n_tiles, M, 2] are scratch;
// n_tiles tiles of ts rows cover the bucket; counters int32 [B, KV, M]
// hold zeros and are left so. Writes acc [B, H, D], m and l [B, H]. Launches on `stream` and returns cudaGetLastError() as an int.
int batched_decode_partial(const void* q, const void* k, const void* v,
                           const void* ks, const void* vs,
                           const void* row_limit, void* part_acc,
                           void* part_ml, void* acc, void* m, void* l,
                           void* counters, int dtype, int fast, int B, int S,
                           int H, int KV, int D, int ts, int n_tiles,
                           float scale, void* stream) {
  if (fast)
    return dispatch_decode<true>(dtype, q, k, v, ks, vs, S, nullptr, nullptr,
                                 nullptr, nullptr, 0, row_limit, 0, nullptr,
                                 part_acc, part_ml, acc, m, l, counters, B, H,
                                 KV, D, ts, n_tiles, scale, stream);
  return dispatch_decode<false>(dtype, q, k, v, ks, vs, S, nullptr, nullptr,
                                nullptr, nullptr, 0, row_limit, 0, nullptr,
                                part_acc, part_ml, acc, m, l, counters, B, H,
                                KV, D, ts, n_tiles, scale, stream);
}

}  // extern "C"
