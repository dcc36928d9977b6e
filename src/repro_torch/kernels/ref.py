"""Plain PyTorch versions of every kernel (the allclose references).

Each function computes what its twin in `repro.kernels.ref` computes,
with the same layouts, in float32, and returns the query's dtype. Masked
scores are the finite NEG_INF, so a row that sees no position gets the
mean of V over all S positions, as in the JAX package. The
wrappers in `kernels/ops.py` use them for tensors on the CPU, and
`chip_smoke.py` holds each hand kernel against them on the card.
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


def expected_attention_scores_ref(k_cache, mu, sig2):
    """k: (B, S, KV, dk); mu, sig2: (KV, G, dk) -> (B, S, KV) f32."""
    dk = k_cache.shape[-1]
    scale = dk ** -0.5
    kf = k_cache.float()
    lin = torch.einsum("bshd,hgd->bshg", kf, mu.float())
    quad = torch.einsum("bshd,hgd->bshg", kf * kf, sig2.float())
    return torch.mean(lin * scale + 0.5 * quad * scale * scale, dim=-1)
