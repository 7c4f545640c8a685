"""Perplexity evaluation (qwen3_tpu/eval/perplexity.py's contract).

The quality criterion is perplexity parity with the reference engine
(delta ppl <= 0.05 at Q8_0): bit-exact sampled streams are out of reach
across floating-point stacks. The reference has no evaluator; the oracle is
the exact-mode forward, whose logits follow the C integer pipeline.

NLL convention: mean over positions of -log softmax(logits[t])[token[t+1]],
teacher-forced, fp32.
"""

from __future__ import annotations

import numpy as np
import torch

from qwen3_tpu_torch.models.qwen3 import forward, init_kv_cache


def sequence_nll(params, cfg, tokens: list[int], *, mode: str = "bf16",
                 kv_dtype: str = "float32", chunk: int = 256,
                 fuse: bool = False) -> np.ndarray:
    """Per-position negative log-likelihoods of a token sequence, in
    `chunk`-token blocks through one KV cache on the parameters' device.
    `fuse`: the prologue-fused matmuls (models.qwen3.forward).

    Returns an fp32 array of length len(tokens) - 1 (next-token NLLs)."""
    dev = params["emb_q"].device
    toks = torch.tensor([tokens], dtype=torch.int64, device=dev)
    n = len(tokens)
    k, v = init_kv_cache(cfg, 1, max(n, 1), kv_dtype, dev)
    nlls = []
    for off in range(0, n - 1, chunk):
        t = min(chunk, n - off)          # includes the next-token targets
        logits, k, v = forward(params, cfg, toks[:, off:off + t], k, v, off,
                               mode=mode, all_logits=True, fuse=fuse)
        logp = torch.log_softmax(logits[0].float(), dim=-1)
        # the target of position off + i is tokens[off + i + 1]
        upto = min(t, n - 1 - off)
        targets = toks[0, off + 1:off + upto + 1]
        picked = torch.gather(logp[:upto], 1, targets[:, None])[:, 0]
        nlls.append((-picked).cpu().numpy())
        del logits, logp
    return np.concatenate(nlls) if nlls else np.zeros((0,), np.float32)


def perplexity(params, cfg, tokens: list[int], **kw) -> float:
    nll = sequence_nll(params, cfg, tokens, **kw)
    return float(np.exp(nll.mean())) if nll.size else float("nan")
