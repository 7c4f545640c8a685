"""The sparse expert layer's kernels (Qwen3-30B-A3B's MLP): wrappers and
their plain versions.

Replaces no TPU kernel: the JAX package has no expert layer. A layer with
experts runs, on the ffn_norm output h [N, dim] f32 (models/qwen3.py::
_moe), five launches and no read back to the host:

1. `route` (csrc/moe_route.cu): the router's logits h . W_r in float32
   (W_r the router's Q8_0 weight dequantized), a softmax over the experts,
   the top k by probability (ties to the lower id) and their weights
   divided by their sum, in that order: ids int32 [N, k], w f32 [N, k];
   and h rounded to bf16, hb [N, dim], the experts' input;
2. `index` (csrc/moe_route.cu): each expert's entries (row * k + slot) in
   entry order, list int32 [E, N], and their count, int32 [E], on the card;
   the count is added to the per-(layer, expert) statistics `stats`;
3. `experts(..., glu=True)` (csrc/moe_experts.cu): each entry's w13
   product with its expert's weights, the swiglu folded in, bf16 [N k,
   width], gathering the rows of hb by the index: no permuted copy;
4. `experts(..., glu=False)`: each entry's w2 product, f32 [N k, dim];
5. `combine` (csrc/moe_route.cu): each row's k outputs summed with their
   weights in slot order (descending weight).

The products follow mode pallas-fast's rule (activations rounded to bf16,
weights dequantized to bf16, f32 chains a group in k order, the groups in
order: ops/cuda/q8_matmul.py::q8_fast_matmul_plain); the router stays in
float32, because the choice of experts is discontinuous. Every kernel is
bit-equal on the card to its plain version (`*_plain`, plain PyTorch in the
kernel's order), at any count of rows an expert, so a row's bits do not
depend on its batch-mates. A wrapper takes the plain version only for CPU
tensors; for CUDA tensors it launches the kernel or raises. `LAUNCHES`
counts the launches by kernel.
"""

from __future__ import annotations

import torch

from qwen3_tpu_torch.ops.activations import swiglu

LAUNCHES = {"route": 0, "index": 0, "w13": 0, "w2": 0, "combine": 0}
GROUP_ROWS = 64   # the grouped kernel's pairs a tile (q8_kernels.cuh kGroupBM)


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


# -- plain versions ---------------------------------------------------------


def route_plain(h: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor, k: int,
                group_size: int):
    """The route kernel's function: (ids int32 [N, k], w f32 [N, k], hb
    bf16 [N, n], h rounded to nearest even). The
    logits h [N, n] f32 times wq [E, n] int8 dequantized as f32(wq) * ws,
    per group the rounded products summed in k order from 0, then the
    groups in order from 0; the softmax p = exp(l - max) / Z, Z summed
    over the experts in id order; the k largest p, ties to the lower id,
    in descending order; each divided by their sum in that order."""
    N, n = h.shape
    E, g = wq.shape[0], group_size
    ng = n // g
    x = h.float().reshape(N, 1, ng, g)
    w = wq.float().reshape(E, ng, g) * ws.float()[..., None]
    s = torch.zeros(N, E, ng, dtype=torch.float32, device=h.device)
    for i in range(g):
        s = s + x[..., i] * w[None, :, :, i]
    logits = torch.zeros(N, E, dtype=torch.float32, device=h.device)
    for i in range(ng):
        logits = logits + s[..., i]
    ex = torch.exp(logits - logits.max(-1, keepdim=True).values)
    z = torch.zeros(N, dtype=torch.float32, device=h.device)
    for e in range(E):
        z = z + ex[:, e]
    p = ex / z[:, None]
    ids = torch.sort(p, dim=-1, descending=True, stable=True).indices[:, :k]
    sel = p.gather(-1, ids)
    den = torch.zeros(N, dtype=torch.float32, device=h.device)
    for j in range(k):
        den = den + sel[:, j]
    return ids.to(torch.int32), sel / den[:, None], h.to(torch.bfloat16)


def index_plain(ids: torch.Tensor, n_experts: int, stats=None):
    """(list int32 [E, N], count int32 [E]): expert e's entries i (of ids
    flattened, i = row * k + slot) in order in list[e, :count[e]], the rest
    of the row -1; `stats` (int64 [E]) gets the counts added."""
    flat = ids.reshape(-1)
    N = ids.shape[0]
    lst = torch.full((n_experts, N), -1, dtype=torch.int32, device=ids.device)
    cnt = torch.zeros(n_experts, dtype=torch.int32, device=ids.device)
    for e in range(n_experts):
        ent = (flat == e).nonzero().reshape(-1).to(torch.int32)
        lst[e, :ent.numel()] = ent
        cnt[e] = ent.numel()
    if stats is not None:
        stats += cnt.to(stats.dtype)
    return lst, cnt


def experts_plain(x: torch.Tensor, lst: torch.Tensor, cnt: torch.Tensor,
                  wq: torch.Tensor, ws: torch.Tensor, group_size: int,
                  xdiv: int, glu: bool) -> torch.Tensor:
    """The grouped kernel's function: entry i = lst[e, j] (j < cnt[e]) of
    expert e takes row i // xdiv of x (bf16) through wq[e] ([2 d, n] w1 then w3
    rows with glu, else [d, n]) by the fast function
    (q8_fast_matmul_plain); glu: swiglu(gate, up) rounded to bf16, [M, d]
    bf16, else the f32 product [M, d]; M = the entries listed."""
    from qwen3_tpu_torch.ops.cuda.q8_matmul import q8_fast_matmul_plain

    counts = cnt.tolist()
    M = int(sum(counts))
    d = wq.shape[1] // 2 if glu else wq.shape[1]
    out = torch.zeros(M, d, device=x.device,
                      dtype=torch.bfloat16 if glu else torch.float32)
    for e, c in enumerate(counts):
        if c == 0:
            continue
        ent = lst[e, :c].long()
        y = q8_fast_matmul_plain(x[ent // xdiv], wq[e], ws[e], group_size)
        out[ent] = (swiglu(y[:, :d], y[:, d:]).to(torch.bfloat16) if glu
                    else y)
    return out


def combine_plain(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """out [N, d] = sum over slots j in order of w[:, j] * y[row k + j],
    each product and sum rounded, from 0."""
    N, k = w.shape
    y = y.reshape(N, k, -1)
    out = torch.zeros(N, y.shape[-1], dtype=torch.float32, device=y.device)
    for j in range(k):
        out = out + w[:, j, None] * y[:, j]
    return out


# -- the kernels ------------------------------------------------------------


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _need(t: torch.Tensor, name: str, dtype, device, dims: int) -> None:
    if t.dtype != dtype or t.dim() != dims:
        raise ValueError(f"{name} must be {dims}-d {dtype}, got "
                         f"{t.dim()}-d {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_group(n: int, group_size: int) -> None:
    g = group_size
    if g < 16 or g > 512 or g & (g - 1) or n % g or n % 64:
        raise ValueError(f"group_size {g} must be a power of two in [16, "
                         f"512] dividing n = {n}, a multiple of 64")


def route(h: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor, k: int,
          group_size: int):
    """(ids int32 [N, k], w f32 [N, k], hb bf16 [N, n]) of h f32 [N, n]
    against the router wq int8 [E, n], ws f32 [E, n / G]."""
    if h.device.type == "cpu":
        return route_plain(h, wq, ws, k, group_size)
    from qwen3_tpu_torch.ops.cuda.build import load_library

    N, n = h.shape
    E = wq.shape[0]
    _need(h, "h", torch.float32, h.device, 2)
    _need(wq, "wq", torch.int8, h.device, 2)
    _need(ws, "ws", torch.float32, h.device, 2)
    _check_group(n, group_size)
    if wq.shape[1] != n or ws.shape != (E, n // group_size):
        raise ValueError(f"router shapes {tuple(wq.shape)}, "
                         f"{tuple(ws.shape)} do not fit n = {n}")
    ids = torch.empty(N, k, dtype=torch.int32, device=h.device)
    w = torch.empty(N, k, dtype=torch.float32, device=h.device)
    hb = torch.empty(N, n, dtype=torch.bfloat16, device=h.device)
    err = load_library().moe_route(h.data_ptr(), wq.data_ptr(), ws.data_ptr(),
                                   ids.data_ptr(), w.data_ptr(), hb.data_ptr(),
                                   N, n, E, k, group_size, _stream(h))
    if err != 0:
        raise RuntimeError(f"moe route kernel launch failed: CUDA error {err}")
    LAUNCHES["route"] += 1
    return ids, w, hb


def index(ids: torch.Tensor, n_experts: int, stats=None):
    """(list int32 [E, N], count int32 [E]) of the routed ids [N, k]: the
    entries of each expert in order (past count, list holds no value);
    `stats` int64 [E] gets the counts added."""
    if ids.device.type == "cpu":
        return index_plain(ids, n_experts, stats)
    from qwen3_tpu_torch.ops.cuda.build import load_library

    _need(ids, "ids", torch.int32, ids.device, 2)
    if stats is not None:
        _need(stats, "stats", torch.int64, ids.device, 1)
        if stats.shape[0] != n_experts:
            raise ValueError(f"stats holds {stats.shape[0]} experts, not "
                             f"{n_experts}")
    N = ids.shape[0]
    lst = torch.empty(n_experts, max(N, 1), dtype=torch.int32,
                      device=ids.device)
    cnt = torch.empty(n_experts, dtype=torch.int32, device=ids.device)
    err = load_library().moe_index(
        ids.data_ptr(), lst.data_ptr(), cnt.data_ptr(),
        None if stats is None else stats.data_ptr(), ids.numel(),
        lst.shape[1], n_experts, _stream(ids))
    if err != 0:
        raise RuntimeError(f"moe index kernel launch failed: CUDA error {err}")
    LAUNCHES["index"] += 1
    return lst, cnt


def experts(x: torch.Tensor, lst: torch.Tensor, cnt: torch.Tensor,
            wq: torch.Tensor, ws: torch.Tensor, group_size: int, xdiv: int,
            glu: bool, entries: int) -> torch.Tensor:
    """The grouped fast matmul over `entries` listed entries (see
    experts_plain), x bf16: glu, the layer's input (route's hb) against
    w13 [E, 2 d, n], out bf16 [entries, d]; else against w2 [E, d, n], out
    f32. The grid holds the row tiles of an even load, one more (a block
    takes an expert's tiles past them)."""
    if x.device.type == "cpu":
        return experts_plain(x, lst, cnt, wq, ws, group_size, xdiv, glu)
    from qwen3_tpu_torch.ops.cuda.build import load_library

    n = x.shape[1]
    E, rows = wq.shape[0], wq.shape[1]
    _need(x, "x", torch.bfloat16, x.device, 2)
    _need(lst, "list", torch.int32, x.device, 2)
    _need(cnt, "count", torch.int32, x.device, 1)
    _need(wq, "wq", torch.int8, x.device, 3)
    _need(ws, "ws", torch.float32, x.device, 3)
    _check_group(n, group_size)
    if wq.shape[2] != n or ws.shape != (E, rows, n // group_size) \
            or lst.shape[0] != E or cnt.shape[0] != E:
        raise ValueError(f"expert shapes {tuple(wq.shape)}, "
                         f"{tuple(ws.shape)} do not fit n = {n}, E = "
                         f"{lst.shape[0]}")
    d = rows // 2 if glu else rows
    out = torch.empty(entries, d, device=x.device,
                      dtype=torch.bfloat16 if glu else torch.float32)
    cap = lst.shape[1]
    row_tiles = max(1, min(-(-cap // GROUP_ROWS),
                           -(-entries // (E * GROUP_ROWS)) + 1))
    err = load_library().moe_experts(
        x.data_ptr(), lst.data_ptr(), cnt.data_ptr(), wq.data_ptr(),
        ws.data_ptr(), out.data_ptr(), E, cap, n, d, group_size, xdiv,
        int(glu), row_tiles, _stream(x))
    if err != 0:
        raise RuntimeError(f"moe experts kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["w13" if glu else "w2"] += 1
    return out


def combine(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """out f32 [N, d] = sum_j w[:, j] * y[row k + j] in slot order; y f32
    [N k, d], w f32 [N, k]."""
    if y.device.type == "cpu":
        return combine_plain(y, w)
    from qwen3_tpu_torch.ops.cuda.build import load_library

    _need(y, "y", torch.float32, y.device, 2)
    _need(w, "w", torch.float32, y.device, 2)
    N, k = w.shape
    d = y.shape[1]
    if y.shape[0] != N * k or d % 4:
        raise ValueError(f"y {tuple(y.shape)} does not fit w {tuple(w.shape)}")
    out = torch.empty(N, d, dtype=torch.float32, device=y.device)
    err = load_library().moe_combine(y.data_ptr(), w.data_ptr(),
                                     out.data_ptr(), N, k, d, _stream(y))
    if err != 0:
        raise RuntimeError(f"moe combine kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["combine"] += 1
    return out


def expert_layer(h: torch.Tensor, wr_q, wr_s, w13_q, w13_s, w2_q, w2_s,
                 k: int, group_size: int, stats=None) -> torch.Tensor:
    """One expert layer of mode pallas-fast on h f32 [N, dim] (one layer's
    tensors: the router [E, dim], w13 [E, 2 width, dim], w2 [E, dim,
    width]): route, index, the grouped w13 with its swiglu, the grouped
    w2, combine; five launches on the card. Returns f32 [N, dim]."""
    ids, w, hb = route(h, wr_q, wr_s, k, group_size)
    lst, cnt = index(ids, wr_q.shape[0], stats)
    act = experts(hb, lst, cnt, w13_q, w13_s, group_size, k, True,
                  ids.numel())
    y = experts(act, lst, cnt, w2_q, w2_s, group_size, 1, False, ids.numel())
    return combine(y, w)
