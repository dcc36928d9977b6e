"""Plain PyTorch versions of every kernel (the allclose references).

Each function computes what its twin in `repro.kernels.ref` computes,
with the same layouts, in float32, and returns the query's dtype. Masked
scores are the finite NEG_INF, so a row that sees no position gets the
mean of V over all S positions, as in the JAX package. The
wrappers in `kernels/ops.py` use them for tensors on the CPU, and
`chip_smoke.py` holds each hand kernel against them on the card.
The `*_twin` functions are no plain versions: each repeats the blocked
algorithm of one hand kernel (A / B's body, over float32 / bfloat16 or
int8 K/V; C; both bodies of D; E's per-element loops), for the tests and
`chip_smoke.py`, and no wrapper calls them.

The Beta bounds' plain versions (betainc, betaincinv and the terms of its
gradient, behind kernel E) are the float32 recipe of the JAX package's
`jax.scipy.special.betainc` and `repro.core.bounds`; `core/bounds.py`
builds the differentiable bounds on them.
"""
from __future__ import annotations

import math

import torch

GLOBAL = 1 << 30
NEG_INF = -1e30


def decode_attention_ref(q, k_cache, v_cache, lengths, *,
                         window: int = GLOBAL):
    """q: (B, KV, G, dk); k: (B, S, KV, dk); v: (B, S, KV, dv);
    lengths: (B,). Returns (B, KV, G, dv): `decode_query_attention_ref`
    at Lq 1."""
    return decode_query_attention_ref(q[:, None], k_cache, v_cache, lengths,
                                      window=window)[:, 0]


def decode_query_attention_ref(q, k_cache, v_cache, lengths, *,
                               window: int = GLOBAL):
    """Fused multi-token query decode.

    q: (B, Lq, KV, G, dk); k: (B, S, KV, dk); v: (B, S, KV, dv);
    lengths: (B,) counts all valid tokens INCLUDING the Lq query tokens.
    Query i sits at position lengths - Lq + i and attends causally within
    `window`. Returns (B, Lq, KV, G, dv).

    Batch-invariant, as the kernels are: both products take contiguous
    (B, KV, ., .) operands, so an item's rows go through the same batched
    GEMM whatever B is (at B 1 a permuted view would reach the library
    strided, through another kernel that rounds differently)."""
    B, Lq, KV, G, dk = q.shape
    S = k_cache.shape[1]
    dev = q.device
    qf = (q.float() * dk ** -0.5).permute(0, 2, 1, 3, 4).reshape(
        B, KV, Lq * G, dk).contiguous()
    kf = k_cache.float().permute(0, 2, 3, 1).contiguous()    # (B, KV, dk, S)
    s = torch.matmul(qf, kf).reshape(B, KV, Lq, G, S)
    lengths = lengths.to(dev).long()
    k_pos = torch.arange(S, device=dev)[None, None, :]
    q_pos = (lengths[:, None] - Lq
             + torch.arange(Lq, device=dev)[None, :])[:, :, None]
    mask = (k_pos <= q_pos) & ((q_pos - k_pos) < window)      # (B, Lq, S)
    s = torch.where(mask[:, None, :, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).reshape(B, KV, Lq * G, S)
    vf = v_cache.float().permute(0, 2, 1, 3).contiguous()    # (B, KV, S, dv)
    out = torch.matmul(p.contiguous(), vf)
    return out.reshape(B, KV, Lq, G, -1).permute(0, 2, 1, 3, 4).to(q.dtype)


DECODE_SPLIT, DECODE_SUB = 128, 16  # kernel A's split, and its warps' share


def _decode_span(n: int, Lq: int, S: int, window: int):
    """The positions some query row of an item of length n can see:
    [lo, hi], empty when lo > hi."""
    hi = min(n - 1, S - 1)
    lo = hi + 1 if window < 1 else max(0, n - Lq - window + 1)
    return lo, hi


def decode_uses_mma(dtype, dk: int, dv: int, quant: bool = False) -> bool:
    """Whether kernel A / B's body runs these inputs on the tensor cores
    (the rule of `csrc/decode_attention.cu`, for contiguous inputs):
    bfloat16 q with, over bfloat16 K/V, dk and dv multiples of 16 up to
    128; over int8 K/V (`quant`), dk 64 or 128 and dv a multiple of 32 up
    to 128."""
    if dtype != torch.bfloat16:
        return False
    if quant:
        return dk in (64, 128) and dv % 32 == 0 and dv <= 128
    return dk % 16 == 0 and dv % 16 == 0 and dk <= 128 and dv <= 128


def _merge(m, l, acc):
    """Partials (m, l, acc) along dim 0 merged in order, as the kernel
    does: M = max m; l, acc = sums of l * exp(m - M), acc * exp(m - M);
    rows whose every m is -inf get (-inf, 0, 0)."""
    M = m.amax(0)
    dead = M == -torch.inf
    f = torch.exp(m - torch.where(dead, 0.0, M))
    f = torch.where(dead.expand_as(f), 0.0, f)
    lo, ac = torch.zeros_like(M), torch.zeros_like(acc[0])
    for i in range(m.shape[0]):
        lo = lo + l[i] * f[i]
        ac = ac + acc[i] * f[i][..., None]
    return M, lo, ac


def decode_query_attention_twin(q, k_cache, v_cache, lengths, *,
                                window: int = GLOBAL, k_scale=None,
                                v_scale=None):
    """Eager twin of the body of kernels A and B
    (`csrc/decode_attention.cu`): its blocked algorithm, for the tests and
    `chip_smoke.py` (never the main path). With k_scale / v_scale (B, S,
    KV), k_cache / v_cache are int8 (the int8 kernels' twin).

    Per item, the splits of DECODE_SPLIT positions that hold a visible
    position, in order; per split, eight warps of DECODE_SUB positions,
    each with its own softmax (m, l, acc) over positions outside the
    item's visible span zero-filled and masked to -inf; the warps merged
    in order, then the splits in order; rows that see nothing get the
    mean of (dequantised) V over all S positions. Sums in float32. Where
    the kernel runs on the tensor cores (`decode_uses_mma`), the scores
    are (q . k) * dk^-0.5 and P goes to P V as a bf16 high part plus a
    bf16 low part; else they are (q * dk^-0.5) . k and P stays float32.
    int8: the K scale multiplies the score right after the product, and
    the V scale is folded into P (after l is summed) before P is split.
    Each item runs on its own with shapes fixed by the split, so its
    output does not depend on the batch or its padding."""
    B, Lq, KV, G, dk = q.shape
    S, dv = k_cache.shape[1], v_cache.shape[3]
    R, dev = Lq * G, q.device
    quant = k_scale is not None
    window = min(int(window), GLOBAL)
    n_split = -(-S // DECODE_SPLIT)
    pad = n_split * DECODE_SPLIT - S

    def padded(x):
        return torch.nn.functional.pad(
            x.float(), (0, 0) * (x.dim() - 2) + (0, pad))
    kf, vf = padded(k_cache), padded(v_cache)
    if quant:
        ksf, vsf = padded(k_scale), padded(v_scale)       # (B, S', KV)
    mma = decode_uses_mma(q.dtype, dk, dv, quant)
    scale = dk ** -0.5
    qf = (q.float() * (1.0 if mma else scale)).permute(0, 2, 1, 3, 4) \
        .reshape(B, KV, R, dk)
    out = torch.empty((B, KV, R, dv), device=dev)
    w_pos = torch.arange(DECODE_SPLIT, device=dev).reshape(-1, DECODE_SUB)
    for b in range(B):
        n = int(lengths[b])
        lo, hi = _decode_span(n, Lq, S, window)
        vb = dequantize(v_cache[b], v_scale[b]) if quant else \
            v_cache[b].float()
        mean = vb.mean(0)[:, None, :].expand(KV, R, dv)
        if lo > hi:
            out[b] = mean
            continue
        q_pos = (n - Lq + torch.arange(R, device=dev) // G)[:, None]
        parts = []
        for s in range(lo // DECODE_SPLIT, hi // DECODE_SPLIT + 1):
            pos = s * DECODE_SPLIT + w_pos                 # (warps, SUB)
            inside = ((pos >= lo) & (pos <= hi))[..., None, None]
            kt = torch.where(inside, kf[b, pos], 0.0)      # (w, SUB, KV, dk)
            vt = torch.where(inside, vf[b, pos], 0.0)
            sc = torch.einsum("hrd,wphd->whrp", qf[b], kt)
            if quant:                                      # (w, KV, 1, SUB)
                ks = torch.where(inside[..., 0], ksf[b, pos], 0.0)
                sc = sc * ks.permute(0, 2, 1)[:, :, None, :]
            if mma:
                sc = sc * scale
            live = ((pos[:, None, :] <= hi) & (pos[:, None, :] <= q_pos)
                    & (q_pos - pos[:, None, :] < window))[:, None]
            x = torch.where(live, sc, -torch.inf)          # (w, KV, R, SUB)
            m = x.amax(-1)
            e = torch.where((m == -torch.inf)[..., None], 0.0,
                            torch.exp(x - m[..., None]))
            p = e
            if quant:
                vs = torch.where(inside[..., 0], vsf[b, pos], 0.0)
                p = e * vs.permute(0, 2, 1)[:, :, None, :]
            if mma:
                p_hi = p.to(torch.bfloat16).float()
                p_lo = (p - p_hi).to(torch.bfloat16).float()
                acc = torch.einsum("whrp,wphd->whrd", p_hi, vt) + \
                    torch.einsum("whrp,wphd->whrd", p_lo, vt)
            else:
                acc = torch.einsum("whrp,wphd->whrd", p, vt)
            parts.append(_merge(m, e.sum(-1), acc))
        m, l, acc = (torch.stack(t) for t in zip(*parts))
        M, l, acc = _merge(m, l, acc)
        out[b] = torch.where((M == -torch.inf)[..., None], mean,
                             acc / l.clamp(min=1e-30)[..., None])
    return out.reshape(B, KV, Lq, G, dv).permute(0, 2, 1, 3, 4) \
        .to(q.dtype).contiguous()


def decode_attention_twin(q, k_cache, v_cache, lengths, *,
                          window: int = GLOBAL, k_scale=None, v_scale=None):
    """Kernel B's twin: kernel A's at Lq = 1; (B, KV, G, dk) ->
    (B, KV, G, dv)."""
    return decode_query_attention_twin(q[:, None], k_cache, v_cache, lengths,
                                       window=window, k_scale=k_scale,
                                       v_scale=v_scale)[:, 0]


def dequantize(x, scale):
    """int8 rows times their (..., ) float32 scales, in float32."""
    return x.float() * scale[..., None].float()


def decode_attention_int8_ref(q, k_cache, v_cache, k_scale, v_scale,
                              lengths, *, window: int = GLOBAL):
    """`decode_attention_ref` over int8 K/V with (B, S, KV) scales,
    dequantised up front (the JAX package's `ref` backend does the same)."""
    return decode_attention_ref(q, dequantize(k_cache, k_scale),
                                dequantize(v_cache, v_scale), lengths,
                                window=window)


def decode_query_attention_int8_ref(q, k_cache, v_cache, k_scale, v_scale,
                                    lengths, *, window: int = GLOBAL):
    """`decode_query_attention_ref` over int8 K/V with (B, S, KV) scales,
    dequantised up front."""
    return decode_query_attention_ref(q, dequantize(k_cache, k_scale),
                                      dequantize(v_cache, v_scale), lengths,
                                      window=window)


def prefill_attention_ref(q, k, v, *, window: int = GLOBAL,
                          causal: bool = True):
    """q: (B, S, KV, G, dk); k: (B, S, KV, dk); v: (B, S, KV, dv)."""
    S, dk = q.shape[1], q.shape[-1]
    qf = q.float() * dk ** -0.5
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = (qpos - kpos) < window
    if causal:
        mask = mask & (kpos <= qpos)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.to(q.dtype)


TC_ROWS, TC_BK = 128, 64      # the tensor-core body's tile: rows, keys
LOG2E = 1.4426950408889634


def prefill_attention_tc_twin(q, k, v, *, window: int = GLOBAL,
                              causal: bool = True):
    """Eager twin of the tensor-core body of kernel D
    (`csrc/prefill_attention_tc.cu`): its blocked algorithm and rounding
    points, for the tests and `chip_smoke.py` (never the main path).

    Query tiles of 128 // G positions (x G heads); per tile, key tiles of
    64 positions in increasing order from the first the window reaches to
    the tile of the last query's diagonal, zero-filled past S. bf16 q, k
    and v; float32 scores times dk^-0.5 * log2 e, masked to -1e30; the
    online softmax in float32 with exp2; P split into a bf16 high part and
    a bf16 low part (P - high) for P V, each product summed in float32;
    out = acc / max(l, 1e-30) in q's dtype. Each item is computed on its
    own, so its rows do not depend on the batch."""
    B, S, KV, G, dk = q.shape
    dv = v.shape[-1]
    bq, bk = TC_ROWS // G, TC_BK
    n_k = -(-S // bk)
    pad = n_k * bk - S
    bf = torch.bfloat16
    kp = torch.nn.functional.pad(k.to(bf), (0, 0, 0, 0, 0, pad)).float()
    vp = torch.nn.functional.pad(v.to(bf), (0, 0, 0, 0, 0, pad)).float()
    # whole query tiles too (zero rows past S), so every product has one
    # shape whatever S is
    q_pad = -(-S // bq) * bq - S
    qf = torch.nn.functional.pad(q.to(bf), (0, 0, 0, 0, 0, 0, 0, q_pad)) \
        .float()
    scale2 = dk ** -0.5 * LOG2E
    out = torch.empty((B, S, KV, G, dv), dtype=q.dtype, device=q.device)
    for q0 in range(0, S, bq):
        q_last = min(q0 + bq, S) - 1
        k_end = q_last + 1 if causal else S
        t_first = max(0, q0 - window + 1) // bk
        qpos = torch.arange(q0, q0 + bq, device=q.device)
        for b in range(B):
            qt = qf[b, q0:q0 + bq]                        # (bq, KV, G, dk)
            m = torch.full(qt.shape[:3], NEG_INF, device=q.device)
            l = torch.zeros_like(m)
            acc = torch.zeros(qt.shape[:3] + (dv,), device=q.device)
            for t in range(t_first, (k_end - 1) // bk + 1):
                p0 = t * bk
                kt, vt = kp[b, p0:p0 + bk], vp[b, p0:p0 + bk]
                s = torch.einsum("nhgd,khd->nhgk", qt, kt) * scale2
                kpos = torch.arange(p0, p0 + bk, device=q.device)
                live = (kpos[None, :] < S) & \
                    ((qpos[:, None] - kpos[None, :]) < window)
                if causal:
                    live = live & (kpos[None, :] <= qpos[:, None])
                s = torch.where(live[:, None, None, :], s,
                                torch.full_like(s, NEG_INF))
                m_new = torch.maximum(m, s.amax(-1))
                p = torch.exp2(s - m_new[..., None])
                alpha = torch.exp2(m - m_new)
                l = l * alpha + p.sum(-1)
                p_hi = p.to(bf).float()
                p_lo = (p - p_hi).to(bf).float()
                acc = acc * alpha[..., None] + torch.einsum(
                    "nhgk,khd->nhgd", p_hi, vt) + torch.einsum(
                    "nhgk,khd->nhgd", p_lo, vt)
                m = m_new
            n = q_last + 1 - q0
            out[b, q0:q_last + 1] = (acc[:n] / torch.clamp(
                l[:n], min=1e-30)[..., None]).to(q.dtype)
    return out


FMA_ROWS, FMA_BK = 16, 32     # the FMA body's tile: rows, keys


def prefill_attention_fma_twin(q, k, v, *, window: int = GLOBAL,
                               causal: bool = True):
    """Eager twin of the FMA body of kernel D (`csrc/prefill_attention.cu`):
    its blocked algorithm, for the tests and `chip_smoke.py` (never the
    main path).

    The query rows of an (item, KV head), taken in order of position * G +
    head, in tiles of 16; per tile, key tiles of 32 positions in
    increasing order from the first the window reaches (from the tile's
    first position) to the tile of its last position's diagonal (to S when
    not causal), zero-filled past S. float32 scores of q * dk^-0.5 and k,
    masked to -1e30; the online softmax with m from -1e30 and exp; out =
    acc / max(l, 1e-30) in q's dtype. Each item runs on its own with
    shapes fixed by the tiles, so its rows do not depend on the batch."""
    B, S, KV, G, dk = q.shape
    dv = v.shape[-1]
    dev = q.device
    n_rows = S * G
    n_tiles = -(-n_rows // FMA_ROWS)
    pad = -(-S // FMA_BK) * FMA_BK - S
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    qf = (q.float() * dk ** -0.5).permute(0, 2, 1, 3, 4).reshape(B, KV,
                                                                 n_rows, dk)
    qf = torch.nn.functional.pad(qf, (0, 0, 0, n_tiles * FMA_ROWS - n_rows))
    out = torch.empty((B, KV, n_tiles * FMA_ROWS, dv), device=dev)
    kpos0 = torch.arange(FMA_BK, device=dev)
    for tile in range(n_tiles):
        f0 = tile * FMA_ROWS
        q_first, q_last = f0 // G, min((f0 + FMA_ROWS - 1) // G, S - 1)
        k_end = q_last + 1 if causal else S
        t_first = max(0, q_first - window + 1) // FMA_BK
        qpos = (f0 + torch.arange(FMA_ROWS, device=dev)) // G
        for b in range(B):
            qt = qf[b, :, f0:f0 + FMA_ROWS]                  # (KV, 16, dk)
            m = torch.full((KV, FMA_ROWS), NEG_INF, device=dev)
            l = torch.zeros_like(m)
            acc = torch.zeros((KV, FMA_ROWS, dv), device=dev)
            for t in range(t_first, (k_end - 1) // FMA_BK + 1):
                p0 = t * FMA_BK
                kt, vt = kf[b, p0:p0 + FMA_BK], vf[b, p0:p0 + FMA_BK]
                s = torch.einsum("hrd,khd->hrk", qt, kt)
                kpos = p0 + kpos0
                live = (kpos[None, :] < S) & \
                    ((qpos[:, None] - kpos[None, :]) < window)
                if causal:
                    live = live & (kpos[None, :] <= qpos[:, None])
                s = torch.where(live, s, torch.full_like(s, NEG_INF))
                m_new = torch.maximum(m, s.amax(-1))
                p = torch.exp(s - m_new[..., None])
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum("hrk,khd->hrd",
                                                            p, vt)
                m = m_new
            out[b, :, f0:f0 + FMA_ROWS] = acc / torch.clamp(
                l, min=1e-30)[..., None]
    out = out[:, :, :n_rows].reshape(B, KV, S, G, dv).permute(0, 2, 1, 3, 4)
    return out.to(q.dtype).contiguous()


def expected_attention_scores_ref(k_cache, mu, sig2):
    """k: ([L,] B, S, KV, dk); mu, sig2: ([L,] KV, G, dk) -> ([L,] B, S, KV)
    float32 (the JAX package's `jax.vmap` over layers of its oracle)."""
    if k_cache.dim() == 4:
        return expected_attention_scores_ref(k_cache[None], mu[None],
                                             sig2[None])[0]
    dk = k_cache.shape[-1]
    scale = dk ** -0.5
    kf = k_cache.float()
    lin = torch.einsum("lbshd,lhgd->lbshg", kf, mu.float())
    quad = torch.einsum("lbshd,lhgd->lbshg", kf * kf, sig2.float())
    return torch.mean(lin * scale + 0.5 * quad * scale * scale, dim=-1)


def ea_factors(dk: int, G: int):
    """Kernel C's folded factors (fa, fc) = (dk^-1/2 / G, 0.5 / dk / G),
    rounded once to float32 where they are used."""
    return dk ** -0.5 / G, 0.5 / dk / G


def ea_lanes(dtype, dk: int) -> int:
    """Lanes per K row in kernel C (`csrc/expected_attention.cu`) for
    16-byte-aligned rows: the row's count of 16-byte vectors when it is a
    power of two up to 32, 32 at 64 vectors; else 1 (the row kernel, which
    also takes KV heads x dk above 6144)."""
    nbytes = dk * torch.tensor([], dtype=dtype).element_size()
    chunks = nbytes // 16 if nbytes % 16 == 0 else 0
    if chunks and chunks & (chunks - 1) == 0 and chunks <= 64:
        return min(chunks, 32)
    return 1


def expected_attention_scores_twin(k_cache, mu, sig2):
    """Eager twin of kernel C (`csrc/expected_attention.cu`): its algorithm
    and order of sums, for the tests and `chip_smoke.py` (never the main
    path). Shapes as `expected_attention_scores_ref`.

    Per (layer, KV head) the stats summed over g in order and scaled by
    `ea_factors`: a = sum_g mu_g * fa, c = sum_g sig2_g * fc. A row of dk
    elements is `ea_lanes` slices of dk / lanes elements; a slice sums
    k (a + k c) in order, and the slices' partials are added by an xor
    butterfly (offsets lanes/2 .. 1), whose lane 0 gives the score. Sums
    in float32; the kernel's FMAs round once where this rounds twice."""
    if k_cache.dim() == 4:
        return expected_attention_scores_twin(k_cache[None], mu[None],
                                              sig2[None])[0]
    L, B, S, KV, dk = k_cache.shape
    G = mu.shape[2]
    fa, fc = (torch.tensor(f, dtype=torch.float32) for f in ea_factors(dk, G))
    sa, sc = mu[:, :, 0].float(), sig2[:, :, 0].float()
    for g in range(1, G):
        sa, sc = sa + mu[:, :, g].float(), sc + sig2[:, :, g].float()
    a = (sa * fa)[:, None, None]                     # (L, 1, 1, KV, dk)
    c = (sc * fc)[:, None, None]
    W = ea_lanes(k_cache.dtype, dk)
    epl = dk // W
    kf = k_cache.float()
    part = torch.zeros((L, B, S, KV, W), device=k_cache.device)
    x = kf.reshape(L, B, S, KV, W, epl)
    ar, cr = a.reshape(L, 1, 1, KV, W, epl), c.reshape(L, 1, 1, KV, W, epl)
    for e in range(epl):
        xe = x[..., e]
        part = part + xe * (ar[..., e] + xe * cr[..., e])
    lane = torch.arange(W, device=k_cache.device)
    off = W // 2
    while off:
        part = part + part[..., lane ^ off]
        off //= 2
    return part[..., 0]


# ---------------------------------------------------------------------------
# Beta bounds (kernel E): betainc, betaincinv and its gradient's terms
# ---------------------------------------------------------------------------

_F32 = torch.float32
_EPS = torch.finfo(_F32).eps / 2          # Lentz "small" and tolerance
_TINY = torch.finfo(_F32).tiny * 2
_CF_ITERS = 200                           # XLA's cap for float32
_LEVELS = 6                               # bisection levels per betainc call
BISECT_STEPS = 60
# Lanczos approximation (g = 7, n = 9), as XLA evaluates lgamma
_LANCZOS_G = 7.0
_LANCZOS_BASE = 0.99999999999980993227684700473478
_LANCZOS = (676.520368121885098567009190444019,
            -1259.13921672240287047156078755283,
            771.3234287776530788486528258894,
            -176.61502916214059906584551354,
            12.507343278686904814458936853,
            -0.13857109526572011689554707,
            9.984369578019570859563e-6,
            1.50563273514931155834e-7)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_F32)


def _lgamma(x: torch.Tensor) -> torch.Tensor:
    """log Gamma(x) in float32 by XLA's Lanczos recipe for x >= 0.5 (all
    the betainc calls here have a, b >= 0.5), `torch.lgamma` below."""
    z = x - 1.0
    s = torch.full_like(x, _LANCZOS_BASE)
    for i, c in enumerate(_LANCZOS):
        s = s + c / (z + float(i) + 1.0)
    t = (_LANCZOS_G + 0.5) + z
    log_t = math.log(_LANCZOS_G + 0.5) + torch.log1p(z / (_LANCZOS_G + 0.5))
    out = (0.5 * (math.log(2.0) + math.log(math.pi))
           + (z + 0.5 - t / log_t) * log_t + torch.log(s))
    return torch.where(x >= 0.5, out, torch.lgamma(x))


def betaln(a, b) -> torch.Tensor:
    """log B(a, b) = lgamma(a) + lgamma(b) - lgamma(a + b), evaluated in
    float64 (the float32 difference of three large lgammas cancels)."""
    a64 = _f32(a).double()
    b64 = _f32(b).double()
    return (torch.lgamma(a64) + torch.lgamma(b64)
            - torch.lgamma(a64 + b64)).to(_F32)


def _continued_fraction(a, b, x, host_exit: bool = True,
                        count: bool = False):
    """Modified Lentz evaluation of the incomplete beta fraction. Each
    element stops at its own convergence (as under the JAX package's vmap
    over restarts), so its value does not depend on the other elements of
    the call. The plain version leaves the loop once every element has
    converged, which reads a flag on the host; with `host_exit=False` (the
    twin) it runs every term, the converged elements masked. With `count`
    it returns (h, the number of terms each element ran)."""
    one = torch.ones_like(a)
    small = torch.full_like(a, _EPS)
    h = small.clone()                     # partial denominator 0 is 0
    c = h.clone()
    d = torch.zeros_like(a)
    active = torch.ones_like(a, dtype=torch.bool)
    terms = torch.zeros_like(a, dtype=torch.int32) if count else None
    for it in range(1, _CF_ITERS):
        if count:
            terms = terms + active.int()
        if it == 1:
            num = one
        elif it % 2 == 0:
            m = float((it - 1) // 2)
            if m == 0:
                num = -(a + b) * x / (a + one)
            else:
                num = -(a + m) * (a + b + m) * x / (
                    (a + 2 * m) * (a + 2 * m + one))
        else:
            m = float((it - 1) // 2)
            num = m * (b - m) * x / ((a + 2 * m - one) * (a + 2 * m))
        c_new = one + num / c
        c_new = torch.where(c_new.abs() < small, small, c_new)
        d_new = one + num * d
        d_new = torch.where(d_new.abs() < small, small, d_new)
        d_new = 1.0 / d_new
        delta = c_new * d_new
        h = torch.where(active, h * delta, h)
        c = torch.where(active, c_new, c)
        d = torch.where(active, d_new, d)
        active = active & ((delta - 1.0).abs() >= _EPS)
        if host_exit and not bool(active.any()):
            break
    return (h, terms) if count else h


def betainc(a, b, x, host_exit: bool = True, count: bool = False):
    """Regularized incomplete beta I(x; a, b), elementwise, float32, for
    a, b > 0 and 0 <= x <= 1. Not differentiable (betaincinv supplies its
    own gradient). With `count`: (I, continued-fraction terms run)."""
    a, b, x = torch.broadcast_tensors(_f32(a), _f32(b), _f32(x))
    with torch.no_grad():
        rapid = x < (a + 1.0) / (a + b + 2.0)
        a2 = torch.where(rapid, a, b)
        b2 = torch.where(rapid, b, a)
        x2 = torch.where(rapid, x, 1.0 - x)
        cf = _continued_fraction(a2, b2, x2, host_exit, count)
        if count:
            cf, terms = cf
        lbeta_small_a = _lgamma(b2) - _lgamma(a2 + b2)
        lbeta = _lgamma(a2) + lbeta_small_a
        factor = torch.where(
            a2 < _TINY, torch.exp(torch.log1p(-x2) * b2 - lbeta_small_a),
            torch.exp(torch.log(x2) * a2 + torch.log1p(-x2) * b2 - lbeta)
            / a2)
        out = cf * factor
        out = torch.where(rapid, out, 1.0 - out)
        return (out, terms) if count else out


def _beta_logpdf(x, a, b):
    return ((a - 1.0) * torch.log(x) + (b - 1.0) * torch.log1p(-x)
            - betaln(a, b))


def _betaincinv_bisect(a, b, q, iters: int = BISECT_STEPS):
    """The 60-step bisection of the JAX package, `_LEVELS` steps per
    betainc call: the 2^L - 1 midpoints the next L steps could visit are
    computed as the sequential steps compute them (0.5 * (lo + hi) in
    float32) and scored in one vectorised call, then the L steps walk that
    tree, so lo and hi follow exactly the sequential path. Once every
    midpoint equals lo or hi the path is fixed (lo only ever holds points
    below q, hi points at or above it) and the remaining steps are
    skipped."""
    a, b, q = torch.broadcast_tensors(a, b, q)
    lo = torch.zeros_like(q).reshape(-1, 1)
    hi = torch.ones_like(q).reshape(-1, 1)
    af, bf, qf = (t.reshape(-1, 1) for t in (a, b, q))
    done = 0
    while done < iters:
        levels = min(_LEVELS, iters - done)
        # level k holds the 2^k intervals the first k steps can reach;
        # node j's children are 2j (not below: hi = mid) and 2j + 1
        # (below: lo = mid)
        mids, l_k, h_k = [], lo, hi
        for _ in range(levels):
            m_k = 0.5 * (l_k + h_k)
            mids.append(m_k)
            l_k = torch.stack([l_k, m_k], -1).flatten(-2)
            h_k = torch.stack([m_k, h_k], -1).flatten(-2)
        if bool(((mids[0] == lo) | (mids[0] == hi)).all()):
            break
        pts = torch.cat(mids, -1)                    # (n, 2^L - 1)
        below = betainc(af, bf, pts) < qf
        node = torch.zeros_like(lo, dtype=torch.long)
        for k in range(levels):
            idx = node + ((1 << k) - 1)              # offset of level k
            mid = pts.gather(1, idx)
            bel = below.gather(1, idx)
            lo = torch.where(bel, mid, lo)
            hi = torch.where(bel, hi, mid)
            node = 2 * node + bel.long()
        done += levels
    return (0.5 * (lo + hi)).reshape(q.shape)


def betaincinv_ref(a, b, q) -> torch.Tensor:
    """x with I(x; a, b) = q, elementwise over the broadcast shape: the
    plain version of kernel E's first entry."""
    return _betaincinv_bisect(_f32(a), _f32(b), _f32(q))


def grad_steps(a, b):
    """The central-difference steps of betaincinv's gradient in a and b."""
    return 1e-4 * torch.clamp(a, min=1.0), 1e-4 * torch.clamp(b, min=1.0)


def fd_grads(fd, a, b) -> torch.Tensor:
    """dI/da and dI/db (stacked) from the four central-difference terms of
    `betaincinv_grad_terms_ref`, as betaincinv's backward forms them."""
    ha, hb = grad_steps(a, b)
    return torch.stack([(fd[0] - fd[1]) / (2 * ha),
                        (fd[2] - fd[3]) / (2 * hb)])


def betaincinv_grad_terms_ref(a, b, x, host_exit: bool = True,
                              count: bool = False):
    """The plain version of kernel E's second entry: at x clamped to
    [1e-12, 1 - 1e-12], the four central-difference evaluations of
    betainc, at (a + ha, b), (a - ha, b), (a, b + hb), (a, b - hb) stacked
    on a leading axis, and the Beta(a, b) pdf floored at 1e-30. With
    `count`, also the continued-fraction terms of each evaluation."""
    x = torch.clamp(x, 1e-12, 1.0 - 1e-12)
    pdf = torch.clamp(torch.exp(_beta_logpdf(x, a, b)), min=1e-30)
    ha, hb = grad_steps(a, b)
    # the four central-difference evaluations in one call
    fd = betainc(torch.stack([a + ha, a - ha, a, a]),
                 torch.stack([b, b, b + hb, b - hb]), x, host_exit, count)
    return (fd[0], pdf, fd[1]) if count else (fd, pdf)


def betaincinv_twin(a, b, q, count: bool = False):
    """Eager twin of kernel E's first entry: per element, the sequential
    60-step bisection, each step one betainc whose continued fraction
    runs every term with the converged elements masked, and the element's
    own exit once its midpoint equals lo or hi (a mask: an element that
    left keeps its lo and hi). No host sync. With `count`, also the
    continued-fraction terms each element's thread runs in all."""
    a, b, q = torch.broadcast_tensors(_f32(a), _f32(b), _f32(q))
    lo, hi = torch.zeros_like(q), torch.ones_like(q)
    live = torch.ones_like(q, dtype=torch.bool)
    terms = torch.zeros_like(q, dtype=torch.int32)
    for _ in range(BISECT_STEPS):
        mid = 0.5 * (lo + hi)
        live = live & (mid != lo) & (mid != hi)
        val = betainc(a, b, mid, host_exit=False, count=count)
        if count:
            val, t = val
            terms = terms + torch.where(live, t, 0)
        below = val < q
        lo = torch.where(live & below, mid, lo)
        hi = torch.where(live & ~below, mid, hi)
    x = 0.5 * (lo + hi)
    return (x, terms) if count else x


def betaincinv_grad_terms_twin(a, b, x, count: bool = False):
    """Eager twin of kernel E's second entry (the plain terms with the
    continued fraction's exits as masks)."""
    return betaincinv_grad_terms_ref(a, b, x, host_exit=False, count=count)
