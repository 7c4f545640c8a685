"""The peaks of the card and the work of each kernel family, counted from
the model's shapes and the tokens a window served.

Peaks: NVIDIA H100 Tensor Core GPU data sheet, SXM5 part, dense rates
(no sparsity) at its 700 W limit: 989 TFLOP/s in bf16 (pallas-fast
multiplies bf16 activations by bf16-dequantized weights), 3.35 TB/s of
HBM3. A share is the least time the card could take (the larger of the
operations over the FLOP peak and the bytes over the byte peak) over the
time measured, so it reads the same work whatever kernel does it. Work is
what these inputs need: a decode step's rows are the tokens it generated
(not the frozen or empty slots it also ran), a prefill's rows the prompt
tokens (not a block's padding), each input byte read once and each output
byte written once.
"""

from __future__ import annotations

PEAK_FLOPS = 989e12      # bf16 dense, H100 SXM
PEAK_BYTES = 3.35e12     # HBM3, H100 SXM


def layer_mats(s: dict) -> list[tuple[int, int]]:
    """(in, out) of one layer's matmuls as the port runs them: qkv, wo,
    w1 and w3 together, w2."""
    P = s["n_heads"] * s["head_dim"]
    KV = s["n_kv_heads"] * s["head_dim"]
    return [(s["dim"], P + 2 * KV), (P, s["dim"]),
            (s["dim"], 2 * s["hidden_dim"]), (s["hidden_dim"], s["dim"])]


def weight_bytes(n_in: int, n_out: int, group: int) -> int:
    """Q8_0: one int8 a weight, one float32 scale a group."""
    return n_in * n_out + 4 * n_out * (n_in // group)


def matmul_params(s: dict) -> tuple[int, int]:
    """(parameters of every layer's matmuls, of the classifier)."""
    layers = s["n_layers"] * sum(i * o for i, o in layer_mats(s))
    return layers, s["dim"] * s["vocab_size"]


def matmul_work(s: dict, decode_tokens: int, steps: int,
                prompt_tokens: int, admitted: int,
                forwards: int) -> tuple[float, float]:
    """(operations, bytes) of the matmul kernels for `decode_tokens`
    generated over `steps` decode steps and `prompt_tokens` prefilled
    for `admitted` requests over `forwards` block forwards. Every step
    and every block forward reads all weights once; the classifier of a
    prefill runs on each request's last prompt row only. Activations:
    bf16 in, float32 out."""
    G = s["group_size"]
    mats = layer_mats(s)
    w_layers = s["n_layers"] * sum(weight_bytes(i, o, G) for i, o in mats)
    w_cls = weight_bytes(s["dim"], s["vocab_size"], G)
    a_layers = s["n_layers"] * sum(2 * i + 4 * o for i, o in mats)
    a_cls = 2 * s["dim"] + 4 * s["vocab_size"]
    p_layers, p_cls = matmul_params(s)
    flops = (2 * p_layers * (decode_tokens + prompt_tokens)
             + 2 * p_cls * (decode_tokens + admitted))
    nbytes = ((steps + forwards) * (w_layers + w_cls)
              + (decode_tokens + prompt_tokens) * a_layers
              + (decode_tokens + admitted) * a_cls)
    return float(flops), float(nbytes)


def decode_attention_work(s: dict,
                          positions: list[int]) -> tuple[float, float]:
    """(operations, bytes) of decode attention for one token fed at each
    of `positions`: every layer reads the int8 K and V rows and their
    float32 scales of positions 0..p once, its query (bf16) and writes its
    partial output (float32 values, max and sum); two products a row a
    head element (scores, then values)."""
    H, KV, D, L = (s["n_heads"], s["n_kv_heads"], s["head_dim"],
                   s["n_layers"])
    rows = sum(p + 1 for p in positions)
    flops = 4 * H * D * L * rows
    nbytes = L * (rows * 2 * KV * (D + 4)
                  + len(positions) * (2 * H * D + 4 * H * (D + 2)))
    return float(flops), float(nbytes)


def prefill_attention_flops(s: dict, lengths: list[int]) -> float:
    """Causal attention's products over whole prompts of `lengths`."""
    H, D, L = s["n_heads"], s["head_dim"], s["n_layers"]
    return float(sum(4 * H * D * L * n * (n + 1) // 2 for n in lengths))


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def sub_window(run):
    """(generated positions, admitted prompt lengths) of the traced
    sub-window."""
    lo, hi = run.trace.bursts
    return run.positions(lo, hi), run.admitted(lo, hi)
