"""Layer primitives of the GQA model, in PyTorch.

The port of the GQA subset of `repro.models.layers`, with the same
conventions:
  - activations x: (B, S, d_model) in the model dtype
  - reductions (softmax / norm) run in float32
  - full-sequence attention is blocked with an online softmax, so no
    (S, S) score matrix is built
  - the per-layer window is data: a plain int per layer, GLOBAL_WINDOW
    meaning full attention

Decode attention, and full-sequence attention on the card, go through
`kernels.ops`, which launches the hand-written CUDA kernels for CUDA
tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as KOPS
from repro_torch.kernels.ref import GLOBAL as GLOBAL_WINDOW  # full attention

FLASH_BLOCK = 512
NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dtype)


def rope_freqs(d: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=device) / d))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, n_heads, d_head); positions: (..., S) int. Split halves
    (not interleaved), float32 angles."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                        # (d/2,)
    angles = positions[..., None].float() * freqs                 # (..., S, d/2)
    cos = torch.cos(angles)[..., None, :]                         # (..., S, 1, d/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def silu(x):
    return F.silu(x)


def _divisor_block(n: int, target: int) -> int:
    """Largest block size <= target that divides n."""
    b = min(target, n)
    while n % b:
        b -= 1
    return b


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: int, *, block_q: int = 512, block_k: int = 512,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Blocked causal/windowed attention with an online softmax.

    q: (B, Sq, H, dh); k, v: (B, Sk, KV, dh); GQA groups = H // KV.
    Attends to [i - window + 1, i]. Never builds (Sq, Sk). Key blocks that
    lie wholly above the causal diagonal of a query block are skipped:
    they would add exact zeros, so the result is the same as computing
    every block pair."""
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    G = H // KV
    block_q = _divisor_block(Sq, block_q)
    block_k = _divisor_block(Sk, block_k)
    nq, nk = Sq // block_q, Sk // block_k
    dev = q.device
    qg = q.reshape(B, Sq, KV, G, dh)
    scale = dh ** -0.5
    blocks = []
    for qi in range(nq):
        q_blk = qg[:, qi * block_q:(qi + 1) * block_q].float() * scale
        q_pos = q_offset + qi * block_q + torch.arange(block_q, device=dev)
        m = torch.full((B, KV, G, block_q), NEG_INF, device=dev)
        l = torch.zeros((B, KV, G, block_q), device=dev)
        acc = torch.zeros((B, KV, G, block_q, dv), device=dev)
        for kj in range(nk):
            if causal and kj * block_k > q_offset + (qi + 1) * block_q - 1:
                break
            k_blk = k[:, kj * block_k:(kj + 1) * block_k].float()
            v_blk = v[:, kj * block_k:(kj + 1) * block_k].float()
            k_pos = kj * block_k + torch.arange(block_k, device=dev)
            s = torch.einsum("bqhgd,bkhd->bhgqk", q_blk, k_blk)
            mask = (q_pos[:, None] - k_pos[None, :]) < window
            if causal:
                mask = mask & (k_pos[None, :] <= q_pos[:, None])
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, v_blk)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        blocks.append(out.to(q.dtype))                 # (B, KV, G, bq, dv)
    out = torch.cat(blocks, dim=3)                      # (B, KV, G, Sq, dv)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, dv)


def gqa_project_qkv(p, x, cfg: ModelConfig, positions):
    B, S, _ = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (x @ p["wq"]).reshape(B, S, H, dh)
    k = (x @ p["wk"]).reshape(B, S, KV, dh)
    v = (x @ p["wv"]).reshape(B, S, KV, dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_attn_full(p, x, cfg: ModelConfig, window, positions, *,
                  kernels=None):
    """Prefill path. Returns (attn_out, (k, v)). Where `kernels` selects
    the CUDA kernel for these tensors (`auto` or `cuda` on the card), the
    attention is the hand-written prefill kernel; otherwise it is the
    blocked `flash_attention`, the JAX package's own route."""
    q, k, v = gqa_project_qkv(p, x, cfg, positions)
    B, S = q.shape[:2]
    if KOPS.use_kernel(kernels, q):
        KV = cfg.n_kv_heads
        out = KOPS.prefill_attention(
            q.reshape(B, S, KV, cfg.n_heads // KV, cfg.d_head), k, v,
            window=window, backend=kernels)
    else:
        out = flash_attention(q, k, v, window, block_q=FLASH_BLOCK,
                              block_k=FLASH_BLOCK)
    out = out.reshape(B, S, cfg.n_heads * cfg.d_head)
    return out @ p["wo"], (k, v)


def pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """`t` with its leading axis padded to `rows` by copies of row 0 (the
    decode paths' pinned row count: padding rows are computed, then
    dropped)."""
    n = t.shape[0]
    if rows <= n:
        return t
    return torch.cat([t, t[:1].expand((rows - n,) + tuple(t.shape[1:]))])


def gqa_attn_decode(p, x, cfg: ModelConfig, window, cache_k, cache_v,
                    lengths, *, kernels=None, k_scale=None, v_scale=None):
    """x: (R, 1, d) with R >= B, the cache's batch (rows past B pad the
    projections to a pinned row count and are not attended). cache_[kv]:
    (B, S, KV, dh) already holding this step's k/v at position lengths-1.
    Attention through kernels.ops. Returns (R, 1, d)."""
    R, B = x.shape[0], lengths.shape[0]
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    positions = pad_rows((lengths - 1)[:, None], R)
    q = (x @ p["wq"]).reshape(R, 1, H, dh)
    q = apply_rope(q, positions, cfg.rope_theta)[:B, 0]
    q = q.reshape(B, KV, H // KV, dh)
    out = KOPS.decode_attention(q, cache_k, cache_v, lengths, window=window,
                                backend=kernels, k_scale=k_scale,
                                v_scale=v_scale)
    return pad_rows(out.reshape(B, 1, H * dh), R) @ p["wo"]


def gqa_attn_decode_multi(p, x, cfg: ModelConfig, window, cache_k, cache_v,
                          lengths, *, kernels=None, k_scale=None,
                          v_scale=None):
    """Fused multi-token decode: x (R, Lq, d) with R >= B, the cache's
    batch (rows past B pad the projections to a pinned row count and are
    not attended), one attention launch for all Lq query tokens.
    cache_[kv] already holds the Lq new k/v (positions lengths-Lq ..
    lengths-1); the kernel masks causally per query token. Returns
    (R, Lq, d)."""
    R, Lq, _ = x.shape
    B = lengths.shape[0]
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    positions = pad_rows(lengths[:, None] - Lq + torch.arange(
        Lq, device=x.device)[None, :], R)
    q = (x @ p["wq"]).reshape(R, Lq, H, dh)
    q = apply_rope(q, positions, cfg.rope_theta)[:B]
    q = q.reshape(B, Lq, KV, H // KV, dh)
    out = KOPS.decode_query_attention(q, cache_k, cache_v, lengths,
                                      window=window, backend=kernels,
                                      k_scale=k_scale, v_scale=v_scale)
    return pad_rows(out.reshape(B, Lq, H * dh), R) @ p["wo"]


def gqa_new_kv(p, x, cfg: ModelConfig, lengths):
    """This step's k/v for cache insertion. x: (B, 1, d); lengths (B,)
    (callers with pinned rows pad both)."""
    B = x.shape[0]
    positions = (lengths - 1)[:, None]
    k = (x @ p["wk"]).reshape(B, 1, cfg.n_kv_heads, cfg.d_head)
    v = (x @ p["wv"]).reshape(B, 1, cfg.n_kv_heads, cfg.d_head)
    k = apply_rope(k, positions, cfg.rope_theta)
    return k, v


def gqa_new_kv_multi(p, x, cfg: ModelConfig, positions):
    """Lq steps' k/v for bulk insertion. x: (B, Lq, d); positions (B, Lq)."""
    B, Lq, _ = x.shape
    k = (x @ p["wk"]).reshape(B, Lq, cfg.n_kv_heads, cfg.d_head)
    v = (x @ p["wv"]).reshape(B, Lq, cfg.n_kv_heads, cfg.d_head)
    k = apply_rope(k, positions, cfg.rope_theta)
    return k, v


def swiglu_mlp(p, x):
    return (silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
