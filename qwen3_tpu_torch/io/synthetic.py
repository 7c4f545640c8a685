"""Synthetic checkpoint + tokenizer generation.

Real Qwen3 checkpoints cannot be downloaded in an air-gapped environment, and
tokens/s does not depend on weight values — so benchmarking and golden-token
oracle tests (our engine vs. the reference C engine run on the *same* synthetic
artifact) use random Q8_0 checkpoints with real architecture shapes.
"""

from __future__ import annotations

import numpy as np

from qwen3_tpu_torch.config import ModelConfig
from qwen3_tpu_torch.io.checkpoint import Q8Weights
from qwen3_tpu_torch.io.tokenizer_bin import SpecialTokens, TokenizerData


def synthetic_weights(cfg: ModelConfig, seed: int = 0,
                      scale: float = 0.02) -> Q8Weights:
    """Random Q8_0 weights with sane magnitudes (norm weights ~1, projections
    small) so the forward pass stays numerically tame over many steps."""
    rng = np.random.default_rng(seed)
    L, D, H = cfg.n_layers, cfg.dim, cfg.hidden_dim
    V, HD, G = cfg.vocab_size, cfg.head_dim, cfg.group_size
    P, KV = cfg.proj_dim, cfg.kv_dim

    def norm(shape):
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)

    def q8(shape, row_scale=scale):
        # raw-byte generation (the bounded int64 path is ~10x slower for
        # multi-GB checkpoints); clamp -128 to the Q8_0 range [-127, 127]
        q = rng.integers(0, 256, size=shape, dtype=np.uint8).view(np.int8)
        np.maximum(q, -127, out=q)
        s_shape = shape[:-1] + (shape[-1] // G,)
        s = (row_scale / 127.0) * (0.5 + rng.random(s_shape, dtype=np.float32))
        return q, s.astype(np.float32)

    emb_q, emb_s = q8((V, D))
    wq_q, wq_s = q8((L, P, D))
    wk_q, wk_s = q8((L, KV, D))
    wv_q, wv_s = q8((L, KV, D))
    wo_q, wo_s = q8((L, D, P))
    w1_q, w1_s = q8((L, H, D))
    w2_q, w2_s = q8((L, D, H))
    w3_q, w3_s = q8((L, H, D))
    if cfg.shared_classifier:
        cls_q, cls_s = emb_q, emb_s
    else:
        cls_q, cls_s = q8((V, D))

    return Q8Weights(
        config=cfg,
        att_norm=norm((L, D)), ffn_norm=norm((L, D)), out_norm=norm((D,)),
        q_norm=norm((L, HD)), k_norm=norm((L, HD)),
        emb_q=emb_q, emb_s=emb_s,
        wq_q=wq_q, wq_s=wq_s, wk_q=wk_q, wk_s=wk_s, wv_q=wv_q, wv_s=wv_s,
        wo_q=wo_q, wo_s=wo_s,
        w1_q=w1_q, w1_s=w1_s, w2_q=w2_q, w2_s=w2_s, w3_q=w3_q, w3_s=w3_s,
        cls_q=cls_q, cls_s=cls_s,
    )


def synthetic_tokenizer(vocab_size: int = 512) -> TokenizerData:
    """Byte-level BPE tokenizer: 256 raw byte tokens, a few ASCII merge tokens,
    and the full 10-special-token set at the top of the id space."""
    tokens: list[bytes] = [bytes([b]) for b in range(256)]
    scores: list[float] = [-1e6] * 256

    merges = [b"th", b"the", b"in", b"an", b"and", b"er", b"on", b"re",
              b"he", b"at", b" t", b" a", b" the", b"ing", b"en", b"ed"]
    for rank, m in enumerate(merges):
        tokens.append(m)
        scores.append(-float(np.log(rank + 1)))

    specials = [b"<|endoftext|>", b"<|im_end|>", b"<|im_start|>",
                b"<think>", b"</think>", b"<tool_call>", b"</tool_call>",
                b"<tool_response>", b"</tool_response>"]
    special_ids = {}
    for sp in specials:
        special_ids[sp] = len(tokens)
        tokens.append(sp)
        scores.append(-1e6)

    # pad to vocab_size like the exporter (qwen3/tokenizer.py:194-199)
    i = len(tokens)
    while len(tokens) < vocab_size:
        tokens.append(f"<|pad_{i}|>".encode())
        scores.append(-1e6)
        i += 1

    special = SpecialTokens(
        bos=special_ids[b"<|endoftext|>"], eos=special_ids[b"<|im_end|>"],
        eot=special_ids[b"<|im_start|>"], pad=special_ids[b"<|endoftext|>"],
        bor=special_ids[b"<think>"], eor=special_ids[b"</think>"],
        btc=special_ids[b"<tool_call>"], etc=special_ids[b"</tool_call>"],
        btr=special_ids[b"<tool_response>"], etr=special_ids[b"</tool_response>"],
    )
    max_len = max(len(t) for t in tokens)
    return TokenizerData(tokens=tokens, scores=scores, special=special, max_len=max_len)
