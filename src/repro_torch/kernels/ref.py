"""Plain PyTorch versions of every kernel (the allclose references).

Each function computes what its twin in `repro.kernels.ref` computes,
with the same layouts, in float32, and returns the query's dtype. Masked
scores are the finite NEG_INF, so a row that sees no position gets the
mean of V over all S positions, as in the JAX package. The
wrappers in `kernels/ops.py` use them for tensors on the CPU, and
`chip_smoke.py` holds each hand kernel against them on the card.
`prefill_attention_tc_twin` is no plain version: it repeats the blocked
algorithm of kernel D's tensor-core body, for the tests and
`chip_smoke.py`, and no wrapper calls it.
"""
from __future__ import annotations

import torch

GLOBAL = 1 << 30
NEG_INF = -1e30


def decode_attention_ref(q, k_cache, v_cache, lengths, *,
                         window: int = GLOBAL):
    """q: (B, KV, G, dk); k: (B, S, KV, dk); v: (B, S, KV, dv);
    lengths: (B,). Returns (B, KV, G, dv)."""
    dk = q.shape[-1]
    S = k_cache.shape[1]
    qf = q.float() * dk ** -0.5
    s = torch.einsum("bhgd,bshd->bhgs", qf, k_cache.float())
    pos = torch.arange(S, device=q.device)[None, :]
    lengths = lengths.to(q.device).long()
    mask = (pos < lengths[:, None]) & ((lengths - 1)[:, None] - pos < window)
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    return out.to(q.dtype)


def decode_query_attention_ref(q, k_cache, v_cache, lengths, *,
                               window: int = GLOBAL):
    """Fused multi-token query decode.

    q: (B, Lq, KV, G, dk); k: (B, S, KV, dk); v: (B, S, KV, dv);
    lengths: (B,) counts all valid tokens INCLUDING the Lq query tokens.
    Query i sits at position lengths - Lq + i and attends causally within
    `window`. Returns (B, Lq, KV, G, dv)."""
    Lq, dk = q.shape[1], q.shape[-1]
    S = k_cache.shape[1]
    qf = q.float() * dk ** -0.5
    s = torch.einsum("blhgd,bshd->blhgs", qf, k_cache.float())
    dev = q.device
    lengths = lengths.to(dev).long()
    k_pos = torch.arange(S, device=dev)[None, None, :]
    q_pos = (lengths[:, None] - Lq
             + torch.arange(Lq, device=dev)[None, :])[:, :, None]
    mask = (k_pos <= q_pos) & ((q_pos - k_pos) < window)
    s = torch.where(mask[:, :, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("blhgs,bshd->blhgd", p, v_cache.float())
    return out.to(q.dtype)


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


def expected_attention_scores_ref(k_cache, mu, sig2):
    """k: (B, S, KV, dk); mu, sig2: (KV, G, dk) -> (B, S, KV) f32."""
    dk = k_cache.shape[-1]
    scale = dk ** -0.5
    kf = k_cache.float()
    lin = torch.einsum("bshd,hgd->bshg", kf, mu.float())
    quad = torch.einsum("bshd,hgd->bshg", kf * kf, sig2.float())
    return torch.mean(lin * scale + 0.5 * quad * scale * scale, dim=-1)
