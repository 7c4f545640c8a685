"""A plain float32 reference of Qwen3-30B-A3B's forward (HF `qwen3_moe`) in
PyTorch, for the CPU tests of the port's expert model (not a test module).

It follows the published architecture
(https://huggingface.co/Qwen/Qwen3-30B-A3B/blob/main/config.json, HF
transformers' Qwen3MoeForCausalLM): per layer an RMSNorm, the q/k/v
projections, an RMSNorm over each q and k head, rotary embeddings on the
two halves of a head at theta 1e6, causal grouped-query attention over
every earlier position (softmax in float32), the output projection and
the residual add; an RMSNorm, then the sparse MLP: the router's logits
h . W_r over all experts, a softmax, the top `n_experts_per_tok`
experts, their weights divided by their sum (norm_topk_prob), each
expert's SwiGLU w2(silu(w1 h) * w3 h), the outputs summed with their
weights, and the residual add; a last RMSNorm and the untied classifier.
No shared expert, every layer sparse (decoder_sparse_step 1,
mlp_only_layers []).

Departures from the published model, each also the port's: every weight
is the test's Q8_0 tensor dequantized to float32 (published bf16); the
router runs in float32. It runs whole sequences, without a cache, kernels
or batching, with TF32 off, and imports neither JAX, the JAX package nor
any kernel of the port. `fault` plants one of the known wrong expert
layers that the tests must tell apart: "top7" (one expert fewer),
"no_renorm" (the top weights not divided by their sum), "bf16_router"
(the router's logits from bf16 operands), "fp8_experts" (the experts'
activations rounded to float8 e4m3 with a scale a row).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

FAULTS = ("top7", "no_renorm", "bf16_router", "fp8_experts")


def dequant(q: torch.Tensor, s: torch.Tensor, group: int) -> torch.Tensor:
    """Q8_0 values [..., n] and group scales [..., n / group] to float32."""
    q, s = torch.as_tensor(q), torch.as_tensor(s)
    return (q.float().reshape(*q.shape[:-1], -1, group)
            * s.float()[..., None]).reshape(q.shape)


def rmsnorm(x: torch.Tensor, w, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
        * torch.as_tensor(w).float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotary embedding of x [T, heads, D] at positions pos."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64) / half)
    ang = pos.double()[:, None] * freqs[None, :]
    cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    s = x.abs().amax(-1, keepdim=True).clamp(min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def route(h: torch.Tensor, wr: torch.Tensor, k: int,
          fault: str | None = None):
    """The router on h [T, dim]: (weights [T, k], expert ids [T, k]) of
    the top k of softmax(h . wr), the weights divided by their sum."""
    if fault == "bf16_router":
        logits = (h.bfloat16() @ wr.bfloat16().T).float()
    else:
        logits = h @ wr.T
    p = torch.softmax(logits, dim=-1)
    w, ids = torch.topk(p, k - 1 if fault == "top7" else k, dim=-1)
    if fault != "no_renorm":
        w = w / w.sum(-1, keepdim=True)
    return w, ids


def expert_layer(h: torch.Tensor, wr, we1, we2, we3, k: int,
                 fault: str | None = None) -> torch.Tensor:
    """The sparse MLP on h [T, dim]: wr [E, dim], we1/we3 [E, width, dim],
    we2 [E, dim, width], all float32."""
    w, ids = route(h, wr, k, fault)
    out = torch.zeros_like(h)
    for e in range(wr.shape[0]):
        rows, slot = (ids == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        x = h[rows]
        if fault == "fp8_experts":
            x = fp8_rows(x)
        a = F.silu(x @ we1[e].T) * (x @ we3[e].T)
        if fault == "fp8_experts":
            a = fp8_rows(a)
        out.index_add_(0, rows, w[rows, slot, None] * (a @ we2[e].T))
    return out


def attention(q, k, v, n_heads: int, n_kv: int) -> torch.Tensor:
    T, _, D = q.shape
    k = k.repeat_interleave(n_heads // n_kv, dim=1)
    v = v.repeat_interleave(n_heads // n_kv, dim=1)
    s = torch.einsum("thd,shd->hts", q, k) / D ** 0.5
    mask = torch.ones(T, T, dtype=torch.bool).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("hts,shd->thd", p, v)


def logits(w, cfg, ids: list[int], fault: str | None = None,
           theta: float = 1e6, eps: float = 1e-6) -> torch.Tensor:
    """Logits [T, vocab] of the token ids through the whole model; `w` is
    the port's Q8Weights (numpy or torch, stacked), `cfg` its
    ModelConfig."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits(w, cfg, ids, fault, theta, eps)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _logits(w, cfg, ids, fault, theta, eps):
    G, H, KV, D = cfg.group_size, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    t = torch.as_tensor(ids, dtype=torch.long)
    T = t.shape[0]
    pos = torch.arange(T)
    x = dequant(torch.as_tensor(w.emb_q)[t], torch.as_tensor(w.emb_s)[t], G)
    for l in range(cfg.n_layers):
        def mat(name):
            return dequant(getattr(w, name + "_q")[l],
                           getattr(w, name + "_s")[l], G)
        h = rmsnorm(x, w.att_norm[l], eps)
        q = rmsnorm((h @ mat("wq").T).reshape(T, H, D), w.q_norm[l], eps)
        k = rmsnorm((h @ mat("wk").T).reshape(T, KV, D), w.k_norm[l], eps)
        v = (h @ mat("wv").T).reshape(T, KV, D)
        q, k = rope(q, pos, theta), rope(k, pos, theta)
        x = x + attention(q, k, v, H, KV).reshape(T, H * D) @ mat("wo").T
        h = rmsnorm(x, w.ffn_norm[l], eps)
        x = x + expert_layer(h, mat("wr"), mat("we1"), mat("we2"),
                             mat("we3"), cfg.n_experts_per_tok, fault)
    cls = dequant(w.cls_q, w.cls_s, G)
    return rmsnorm(x, w.out_norm, eps) @ cls.T
