"""Quantized matmuls of modes "exact" and "bf16" over Q8_0 weights
(qwen3_tpu/ops/quant_matmul.py's contract).

The JAX package runs these through XLA, not Pallas: they are plain large
products outside any kernel, and stay plain PyTorch here on every device.

- `q8_matmul_exact`: the reference kernel's integer math (src/forward.c:
  79-101): int8 x int8 dots per quantization group, each scaled by
  w_scale * x_scale, then summed over the groups in fp32. The group dots are
  fp32 batched products of int8 values cast to fp32, exact since every
  partial sum is an integer below 64 * 127^2 < 2^24 (torch.matmul on int8
  returns int8 and wraps).
- `q8_matmul_bf16`: weight-only quantization: the weights dequantized once
  to bf16 [n, d], the activations rounded to bf16, fp32 sums and an fp32
  output.
"""

from __future__ import annotations

import torch

# the exact product's [rows, columns, groups] temporaries, and its weight
# chunk cast to fp32, hold at most this many floats (the classifier over a
# 256-row block would need 2.5 GB in one piece)
_CHUNK_ELEMS = 1 << 24


def q8_matmul_exact(x_q: torch.Tensor, x_s: torch.Tensor, w_q: torch.Tensor,
                    w_s: torch.Tensor, group_size: int) -> torch.Tensor:
    """out[..., d] = sum_g f32(int32 dot(x_q[..., g], w_q[d, g])) * w_s[d, g]
    * x_s[..., g], scaled in that order, (dots * w_s) * x_s, as the JAX
    function does, then summed over the groups.

    x_q: int8 [..., n]; x_s: f32 [..., n/G]; w_q: int8 [d, n]; w_s: f32
    [d, n/G]. Columns go in chunks that keep the temporaries small."""
    *lead, n = x_q.shape
    d = w_q.shape[0]
    k = n // group_size
    xg = x_q.reshape(-1, k, group_size).float().transpose(0, 1)  # [k, b, G]
    xs = x_s.reshape(-1, k).float()
    b = xg.shape[1]
    out = torch.empty(b, d, dtype=torch.float32, device=x_q.device)
    step = max(1, _CHUNK_ELEMS // max(b * k, n))
    for c0 in range(0, d, step):
        c1 = min(d, c0 + step)
        wg = w_q[c0:c1].reshape(c1 - c0, k, group_size).float().permute(
            1, 2, 0)                                               # [k, G, c]
        dots = torch.bmm(xg, wg).permute(1, 2, 0)                  # [b, c, k]
        out[:, c0:c1] = (dots * w_s[c0:c1].float() * xs[:, None, :]).sum(-1)
    return out.reshape(*lead, d)


def dequant_weights_bf16(w_q: torch.Tensor, w_s: torch.Tensor,
                         group_size: int) -> torch.Tensor:
    """Q8_0 weights [..., d, n] to bf16 [..., n, d]: bf16(f32(q) * s),
    rounded to nearest even (transposed so the product contracts the
    leading axis)."""
    d, n = w_q.shape[-2], w_q.shape[-1]
    g = w_q.reshape(*w_q.shape[:-1], n // group_size, group_size).float()
    w = (g * w_s[..., None].float()).reshape(*w_q.shape[:-2], d, n)
    return w.transpose(-1, -2).contiguous().to(torch.bfloat16)


def q8_matmul_bf16(x: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
    """x [..., n] @ w_t [n, d] -> fp32 [..., d]: x rounded to bf16, the
    products of bf16 values summed in fp32, the output kept in fp32 (a bf16
    product in PyTorch would round the output to bf16). On the card one
    cuBLAS product with an fp32 output; on the CPU the bf16 values upcast to
    fp32 (TF32 stays off)."""
    *lead, n = x.shape
    xb = x.reshape(-1, n).to(torch.bfloat16)
    if x.device.type == "cuda":
        out = torch.mm(xb, w_t, out_dtype=torch.float32)
    else:
        out = xb.float() @ w_t.float()
    return out.reshape(*lead, w_t.shape[-1])
