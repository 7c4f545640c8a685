"""The plain reference of Qwen3-30B-A3B (HF `qwen3_moe`), in float32
PyTorch: the benchmark's own copy of the published model, beside
reference/qwen3.py (whose sampler and gaps it repeats, as a reference file
imports nothing but torch).

It follows the published architecture
(https://huggingface.co/Qwen/Qwen3-30B-A3B/blob/main/config.json, HF
transformers' Qwen3MoeForCausalLM): the Q8_0 embedding row dequantized;
per layer an RMSNorm, the q/k/v projections, an RMSNorm over each q and k
head, rotary embeddings on the two halves of a head at theta
`rope_theta`, causal grouped-query attention over every earlier position
(scores over sqrt(head_dim), softmax in float32), the output projection
and the residual add, an RMSNorm, then the sparse MLP: the router's
logits h . W_r over all experts, a softmax, the top `experts_per_tok`,
their weights divided by their sum (norm_topk_prob), each expert's SwiGLU
w2(silu(w1 h) * w3 h), the outputs summed with their weights, and the
residual add; a last RMSNorm and the classifier. No shared expert; every
layer is sparse.

Departures, each the program's too: every weight is the benchmark's own
Q8_0 tensor dequantized to float32 (published bf16), and the router runs
in float32 (every product in float32 with TF32 off). It has no cache and
no batching: each sequence's attention runs whole, the layers one at a
time over all sequences, a layer's dense weights and each expert's
dequantized once a layer (one expert at a time: 30.5 billion float32
weights would not fit). A control's lower precision (`act`) rounds the
activations of every matmul but the router's, which stays the float32 the
configuration states. Its sampler is qwen3.c's (src/sampler.c): softmax at
the request's temperature, nucleus at its top_p, the token whose span of
prefix sums holds coin * mass, the coins xorshift64* from the request's
seed.

It imports nothing of the program under test.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# rows of a matmul or of the logits at a time: bounds the temporaries
_ROWS = 1024


def dequant(q: torch.Tensor, s: torch.Tensor, group: int) -> torch.Tensor:
    """Q8_0 values [..., n] and group scales [..., n / group] to float32."""
    return (q.float().reshape(*q.shape[:-1], -1, group)
            * s.float()[..., None]).reshape(q.shape)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope_tables(n: int, head_dim: int, theta: float, device):
    half = head_dim // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64) / half)
    ang = torch.arange(n, dtype=torch.float64)[:, None] * freqs[None, :]
    return (ang.cos().float().to(device)[:, None, :],
            ang.sin().float().to(device)[:, None, :])


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def linear(x: torch.Tensor, w: torch.Tensor, act=None) -> torch.Tensor:
    """x [T, in] times w [out, in] transposed, in blocks of rows; `act`
    rounds the activations first (a control's lower precision)."""
    if act is not None:
        x = act(x)
    return torch.cat([x[i:i + _ROWS] @ w.T
                      for i in range(0, x.shape[0], _ROWS)])


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one float32 scale a row (its largest
    magnitude to 448): a control's activations, a step below bfloat16."""
    s = x.abs().amax(-1, keepdim=True).clamp(min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def attention(q, k, v, n_heads: int, n_kv: int) -> torch.Tensor:
    """Causal GQA over one sequence: q [T, H, D], k/v [T, KV, D]."""
    T, _, D = q.shape
    k = k.repeat_interleave(n_heads // n_kv, dim=1)
    v = v.repeat_interleave(n_heads // n_kv, dim=1)
    out = []
    for i in range(0, T, _ROWS):
        qi = q[i:i + _ROWS]
        s = torch.einsum("thd,shd->hts", qi, k[:i + qi.shape[0]])
        s = s / torch.sqrt(torch.tensor(float(D), device=q.device))
        pos = torch.arange(i, i + qi.shape[0], device=q.device)
        mask = torch.arange(s.shape[-1], device=q.device)[None, :] \
            <= pos[:, None]
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        out.append(torch.einsum("hts,shd->thd", p, v[:i + qi.shape[0]]))
    return torch.cat(out)


def experts(h: torch.Tensor, wr: torch.Tensor, w: dict, l: int, s: dict,
            act=None) -> torch.Tensor:
    """Layer l's sparse MLP on h [T, dim] (every sequence's rows): the
    float32 router over all experts, the softmax's top k renormalised,
    each expert's SwiGLU over its rows, weighted and summed."""
    G, k = s["group_size"], s["experts_per_tok"]
    p = torch.softmax(linear(h, wr), dim=-1)
    top, ids = torch.topk(p, k, dim=-1)
    top = top / top.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(s["n_experts"]):
        rows, slot = (ids == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        W = {n: dequant(w[n + "_q"][l][e], w[n + "_s"][l][e], G)
             for n in ("we1", "we2", "we3")}
        x = h[rows]
        a = F.silu(linear(x, W["we1"], act)) * linear(x, W["we3"], act)
        out.index_add_(0, rows, top[rows, slot, None]
                       * linear(a, W["we2"], act))
        del W
    return out


def hidden(w: dict, s: dict, seqs: list[list[int]], device,
           act=None) -> list:
    """The final hidden states [T, dim] (before the last norm) of each
    sequence of token ids; `act` as in `linear`."""
    G, H, KV, D = s["group_size"], s["n_heads"], s["n_kv_heads"], \
        s["head_dim"]
    eps = s["rms_eps"]
    ids = [torch.tensor(x, dtype=torch.long, device=device) for x in seqs]
    xs = [dequant(w["emb_q"][i], w["emb_s"][i], G) for i in ids]
    cos, sin = rope_tables(max(len(x) for x in seqs), D, s["rope_theta"],
                           device)
    for l in range(s["n_layers"]):
        W = {n: dequant(w[n + "_q"][l], w[n + "_s"][l], G)
             for n in ("wq", "wk", "wv", "wo", "wr")}
        hs = []
        for j, x in enumerate(xs):
            T = x.shape[0]
            h = rmsnorm(x, w["att_norm"][l], eps)
            q = rmsnorm(linear(h, W["wq"], act).reshape(T, H, D),
                        w["q_norm"][l], eps)
            k = rmsnorm(linear(h, W["wk"], act).reshape(T, KV, D),
                        w["k_norm"][l], eps)
            v = linear(h, W["wv"], act).reshape(T, KV, D)
            q, k = rope(q, cos[:T], sin[:T]), rope(k, cos[:T], sin[:T])
            xs[j] = x + linear(attention(q, k, v, H, KV).reshape(T, H * D),
                               W["wo"], act)
            hs.append(rmsnorm(xs[j], w["ffn_norm"][l], eps))
        y = experts(torch.cat(hs), W["wr"], w, l, s, act)
        xs = [x + d for x, d in zip(xs, y.split([x.shape[0] for x in xs]))]
        del W, hs, y
    return xs


def _no_tf32(fn):
    """Run fn with TF32 off, as the reference's float32 products are."""
    def run(*a, **kw):
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return fn(*a, **kw)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old[0]
            torch.backends.cudnn.allow_tf32 = old[1]
    run.__doc__ = fn.__doc__
    return run


def _logits(w: dict, s: dict, seqs: list[list[int]], first: list[int],
            lengths: list[int], device, act=None):
    """Yield (j, i, logits [rows, vocab]) over positions first[j] + i ..
    of each sequence j, up to lengths[j] of them, a block of rows at a
    time; `act` as in `linear`."""
    xs = hidden(w, s, seqs, device, act)
    cls = dequant(w["cls_q"], w["cls_s"], s["group_size"])
    for j, (x, f, n) in enumerate(zip(xs, first, lengths)):
        h = rmsnorm(x[f:f + n], w["out_norm"], s["rms_eps"])
        for i in range(0, n, _SAMPLE_ROWS):
            yield j, i, linear(h[i:i + _SAMPLE_ROWS], cls, act)


# -- the sampler (qwen3.c's src/sampler.c) ---------------------------------

# rows sampled at a time: a row's sort, sums and order take ~25 bytes an
# entry of the vocabulary
_SAMPLE_ROWS = 256
_M64 = (1 << 64) - 1
_HEAL = 1e-3


def coins(seed: int, n: int) -> list[float]:
    """The first n coins of a request seeded `seed`: xorshift64* (the
    state shifted by >> 12, << 25, >> 27; the high 32 bits of its product
    with 0x2545F4914F6CDD1D, their top 24 bits over 2^24), one a token,
    the first for the token sampled from the prompt's last position."""
    state, out = seed & _M64, []
    for _ in range(n):
        state ^= state >> 12
        state ^= (state << 25) & _M64
        state ^= state >> 27
        out.append((((state * 0x2545F4914F6CDD1D) & _M64) >> 40)
                   / 16777216.0)
    return out


def nucleus(logits: torch.Tensor, temperature: float, top_p: float):
    """The sampler's distribution at each row of logits [B, V]: the
    softmax of logits / temperature (float64 sums), sorted descending with
    ties by lower id, and its prefix sums; the nucleus is the prefix up to
    the first sum over top_p, its mass that sum (doubled under 1e-3).
    Returns (order, sorted probabilities, prefix sums, last index in the
    nucleus, mass) ."""
    p = torch.softmax(logits.double() / temperature, dim=-1)
    sp, order = torch.sort(p, dim=-1, descending=True, stable=True)
    cum = sp.cumsum(-1)
    over = cum > top_p
    idx = torch.where(over.any(-1), over.to(torch.uint8).argmax(-1),
                      cum.shape[-1] - 1)
    mass = cum.gather(-1, idx[:, None])[:, 0]
    return order, sp, cum, idx, torch.where(mass < _HEAL, mass + mass, mass)


def sample(logits: torch.Tensor, coin: torch.Tensor, temperature: float,
           top_p: float) -> torch.Tensor:
    """The token each row's coin picks: the first prefix sum of the
    nucleus over coin * mass (the nucleus's next to last entry where none
    is, as qwen3.c falls back)."""
    order, _, cum, idx, mass = nucleus(logits, temperature, top_p)
    r = coin.double() * mass
    inside = torch.arange(cum.shape[-1], device=cum.device) <= idx[:, None]
    hit = (r[:, None] < cum) & inside
    pick = torch.where(hit.any(-1), hit.to(torch.uint8).argmax(-1), idx - 1)
    return order.gather(-1, (pick % cum.shape[-1])[:, None])[:, 0]


def coin_gaps(logits: torch.Tensor, tokens: torch.Tensor, coin: torch.Tensor,
              temperature: float, top_p: float) -> torch.Tensor:
    """How far, in probability mass, each row's coin * mass lies outside
    the span of the prefix sums that the reference gives `tokens` (0 where
    the reference's own sampler picks it with that coin, and > 0 for a
    token outside its nucleus)."""
    order, sp, cum, _, mass = nucleus(logits, temperature, top_p)
    at = (order == tokens[:, None]).to(torch.uint8).argmax(-1)[:, None]
    hi = cum.gather(-1, at)[:, 0]
    lo = hi - sp.gather(-1, at)[:, 0]
    r = coin.double() * mass
    return torch.clamp(torch.maximum(lo - r, r - hi), min=0.0)


@_no_tf32
def gaps(w: dict, s: dict, seqs: list[list[int]], first: list[int],
         draws: list, picks: dict[str, list[list[int]]],
         device) -> dict[str, list]:
    """For each named list of picked tokens, at each position i >= first[j]
    of sequence j, the gap of picks[name][j][i - first[j]]: for a greedy
    sequence (draws[j] None) how far its logit lies below the largest
    logit there (0 for the reference's argmax); for a sampled one
    (draws[j] = (temperature, top_p, seed)) its `coin_gaps` with the
    request's own coins. Returns {name: [float64 tensor per sequence]}."""
    lengths = [max(len(p[j]) for p in picks.values())
               for j in range(len(seqs))]
    coin = [None if d is None else torch.tensor(coins(d[2], n),
                                                device=device)
            for d, n in zip(draws, lengths)]
    out: dict[str, list] = {name: [[] for _ in seqs] for name in picks}
    for j, i, logits in _logits(w, s, seqs, first, lengths, device):
        for name, p in picks.items():
            tok = torch.tensor(p[j][i:i + logits.shape[0]], dtype=torch.long,
                               device=device)
            rows = logits[:tok.shape[0]]
            if draws[j] is None:
                g = (rows.max(-1).values
                     - rows.gather(-1, tok[:, None])[:, 0]).double()
            else:
                g = coin_gaps(rows, tok, coin[j][i:i + tok.shape[0]],
                              draws[j][0], draws[j][1])
            out[name][j].append(g.cpu())
    return {name: [torch.cat(g) if g else torch.zeros(0, dtype=torch.float64)
                   for g in v] for name, v in out.items()}


@_no_tf32
def picks(w: dict, s: dict, seqs: list[list[int]], first: list[int],
          lengths: list[int], draws: list, device,
          act=None) -> list[list[int]]:
    """The tokens this reference, its activations rounded by `act`, picks
    at positions first[j] .. first[j] + lengths[j] - 1 of each sequence:
    its argmax for a greedy one, its sampler with the request's coins for
    a sampled one (a control's picks)."""
    out = [[] for _ in seqs]
    coin = [None if d is None else torch.tensor(coins(d[2], n),
                                                device=device)
            for d, n in zip(draws, lengths)]
    for j, i, logits in _logits(w, s, seqs, first, lengths, device, act):
        out[j].extend(pick_rows(logits, draws[j],
                                None if coin[j] is None
                                else coin[j][i:i + logits.shape[0]]))
    return out


def pick_rows(logits: torch.Tensor, draw, coin) -> list[int]:
    """Rows' picks: argmax where `draw` is None, else the sampler at
    draw's temperature and top_p with these coins."""
    if draw is None:
        return logits.argmax(-1).tolist()
    return sample(logits, coin, draw[0], draw[1]).tolist()
