"""Layer primitives of the model zoo, in PyTorch.

The port of `repro.models.layers` for the families that keep an
attention cache (GQA, MLA, and their MoE feed-forwards), with the same
conventions:
  - activations x: (B, S, d_model) in the model dtype
  - reductions (softmax / norm) run in float32
  - full-sequence attention is blocked with an online softmax, so no
    (S, S) score matrix is built
  - the per-layer window is data: a plain int per layer, GLOBAL_WINDOW
    meaning full attention

GQA decode attention, and GQA full-sequence attention on the card, go
through `kernels.ops`, which launches the hand-written CUDA kernels for
CUDA tensors; hymba's attention heads are GQA and take the same route.
The kernels have no backward: training takes the differentiable route
(`differentiable=True`), the blocked `flash_attention` on any device.
MLA attention, the MoE feed-forward and the SSM mixers (Mamba, RWKV6)
are plain torch ops, as they are plain jnp in the JAX package (no Pallas
kernel there); MLA's full-sequence attention is the blocked
`flash_attention`, its decode the absorbed MQA over the latent cache in
float32. The Mamba scan runs token by token in float32 (the JAX
package's `lax.scan`); RWKV6's full-sequence form is the chunked one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as KOPS
from repro_torch.kernels.ref import GLOBAL as GLOBAL_WINDOW  # full attention

# knobs a dry run sets (launch/dryrun.py --opt flash_block=, moe=)
FLASH_BLOCK = 512
MOE_IMPL = "auto"
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
                  kernels=None, differentiable: bool = False):
    """Prefill path. Returns (attn_out, (k, v)). Where `kernels` selects
    the CUDA kernel for these tensors (`auto` or `cuda` on the card), the
    attention is the hand-written prefill kernel; otherwise, and always
    on the differentiable route (training: the kernel has no backward),
    it is the blocked `flash_attention`, the JAX package's own route."""
    q, k, v = gqa_project_qkv(p, x, cfg, positions)
    B, S = q.shape[:2]
    if not differentiable and KOPS.use_kernel(kernels, q, k, v):
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


# ---------------------------------------------------------------------------
# MLA attention (minicpm3 / deepseek-v2-lite)
# ---------------------------------------------------------------------------
# The cache is the latent stream: c_kv (B, S, kv_lora) and k_rope
# (B, S, qk_rope_dim); the compression ladder scores its rows.

def mla_project_q(p, x, cfg: ModelConfig, positions):
    """(q_nope (B, S, H, nope), q_rope (B, S, H, rope)) in x's dtype."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    if m.q_lora_rank:
        q = (x @ p["wq_a"]) @ p["wq_b"]
    else:
        q = x @ p["wq"]
    q = q.reshape(B, S, H, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def mla_latents(p, x, cfg: ModelConfig, positions):
    """Latent stream for caching: c_kv (B, S, r), k_rope (B, S, rope)."""
    m = cfg.mla
    ckv_rope = x @ p["w_kv_a"]                       # (B, S, r + rope)
    c_kv, k_rope = ckv_rope[..., :m.kv_lora_rank], \
        ckv_rope[..., m.kv_lora_rank:]
    c_kv = rms_norm(c_kv, p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[..., None, :], positions,
                        cfg.rope_theta)[..., 0, :]
    return c_kv, k_rope


def mla_attn_full(p, x, cfg: ModelConfig, window, positions):
    """Prefill path, not absorbed: K / V expanded per head, then the
    blocked `flash_attention`. Returns (attn_out, (c_kv, k_rope))."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    q_nope, q_rope = mla_project_q(p, x, cfg, positions)
    c_kv, k_rope = mla_latents(p, x, cfg, positions)
    kv = (c_kv @ p["w_kv_b"]).reshape(B, S, H, m.qk_nope_dim + m.v_head_dim)
    k_nope, v = kv[..., :m.qk_nope_dim], kv[..., m.qk_nope_dim:]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, m.qk_rope_dim)], dim=-1)
    out = flash_attention(q, k, v, window, block_q=FLASH_BLOCK,
                          block_k=FLASH_BLOCK)
    out = out.reshape(B, S, H * m.v_head_dim)
    return out @ p["wo"], (c_kv, k_rope)


def mla_attn_decode(p, x, cfg: ModelConfig, window, cache_ckv, cache_krope,
                    lengths):
    """Absorbed MLA decode: MQA over the latent cache, in float32.

        score_h(t, s) = q_nope_h W_uk_h . c_kv_s + q_rope_h . k_rope_s
        out_h         = (softmax . c_kv) W_uv_h

    x: (R, 1, d) with R >= B, the cache's batch (rows past B pad the
    projections to a pinned row count and are not attended); cache_ckv
    (B, S, r), cache_krope (B, S, rope) already holding this step's
    latents at lengths-1. Returns (R, 1, d)."""
    m = cfg.mla
    R, B = x.shape[0], lengths.shape[0]
    H = cfg.n_heads
    positions = pad_rows((lengths - 1)[:, None], R)
    q_nope, q_rope = mla_project_q(p, x, cfg, positions)     # (R, 1, H, .)
    q_nope, q_rope = q_nope[:B, 0], q_rope[:B, 0]            # (B, H, .)
    w_kv_b = p["w_kv_b"].reshape(m.kv_lora_rank, H,
                                 m.qk_nope_dim + m.v_head_dim)
    w_uk = w_kv_b[..., :m.qk_nope_dim]                       # (r, H, nope)
    w_uv = w_kv_b[..., m.qk_nope_dim:]                       # (r, H, v)
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope.float(), w_uk.float())
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    ckv = cache_ckv.float()
    s = (torch.einsum("bhr,bsr->bhs", q_lat, ckv)
         + torch.einsum("bhp,bsp->bhs", q_rope.float(),
                        cache_krope.float())) * scale
    S = cache_ckv.shape[1]
    pos = torch.arange(S, device=x.device)[None, :]
    lens = lengths.long()[:, None]
    mask = (pos < lens) & ((lens - 1) - pos < window)
    s = torch.where(mask[:, None, :], s, torch.full_like(s, NEG_INF))
    pr = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhs,bsr->bhr", pr, ckv)
    out = torch.einsum("bhr,rhv->bhv", o_lat, w_uv.float())
    out = out.reshape(B, 1, H * m.v_head_dim).to(x.dtype)
    return pad_rows(out, R) @ p["wo"]


# ---------------------------------------------------------------------------
# MoE MLP: GShard-style dense capacity dispatch, and a row-local scatter
# ---------------------------------------------------------------------------

def _top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, in
    descending order; equal values keep the lower index first, as
    `jax.lax.top_k` does (a stable descending sort)."""
    order = torch.sort(x, dim=-1, descending=True, stable=True)
    return order.values[..., :k], order.indices[..., :k]


def moe_mlp(p, x, cfg: ModelConfig, impl: str = None):
    """MoE feed-forward over x (B, S, d), as the JAX package's. The router
    softmax, top-k gates, dispatch and combine run in float32; the expert
    products in the model dtype. Capacity max(4, cf k T / E) depends on
    T = B S, so a token's output depends on the rows beside it.

    - "dense": one-hot dispatch / combine (GShard / Switch): a (T, E, C)
      dispatch tensor, each (expert, slot) holding at most one token.
    - "scatter": positions counted per batch row, tokens scattered into
      per-expert buffers of capacity max(4, cf k S / E) per row.
    "auto" picks dense for T <= 8192 and scatter above, as the JAX
    package's default does; `impl=None` (the model's layers) reads the
    module's MOE_IMPL, "auto" unless a dry run sets it."""
    e = cfg.moe
    B, S, d = x.shape
    T = B * S
    x_flat = x.reshape(T, d)
    impl = impl or MOE_IMPL
    if impl == "auto":
        impl = "dense" if T <= 8192 else "scatter"
    logits = (x_flat @ p["router"]).float()                    # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = _top_k(probs, e.top_k)                    # (T, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    ex = p["experts"]
    if impl == "dense":
        capacity = min(int(max(4, e.capacity_factor * e.top_k * T
                               / e.n_experts)), T)
        onehot = F.one_hot(idx, e.n_experts).float()           # (T, k, E)
        flat = onehot.reshape(T * e.top_k, e.n_experts)
        pos = (torch.cumsum(flat, dim=0) - flat).reshape(T, e.top_k,
                                                         e.n_experts)
        keep = (pos < capacity) & (onehot > 0)
        pos_kept = torch.where(keep, pos, torch.zeros_like(pos)).sum(-1) \
            .long()                                            # (T, k)
        keep_tok = keep.any(-1).float()                        # (T, k)
        cap_oh = F.one_hot(pos_kept, capacity).float()         # (T, k, C)
        # "tke,tkc,tk->tec": one nonzero term per (t, e), so exact in any
        # order
        disp = torch.bmm((onehot * keep_tok[..., None]).transpose(1, 2),
                         cap_oh)                               # (T, E, C)
        gate_e = (onehot * gate_vals[..., None]).sum(1)        # (T, E)
        comb = disp * gate_e[..., None]                        # (T, E, C)
        EC = e.n_experts * capacity
        xin = (disp.reshape(T, EC).t() @ x_flat.float()).reshape(
            e.n_experts, capacity, d).to(x.dtype)
        h = silu(torch.bmm(xin, ex["w_gate"])) * torch.bmm(xin, ex["w_up"])
        eo = torch.bmm(h, ex["w_down"])                        # (E, C, d)
        y = (comb.reshape(T, EC) @ eo.float().reshape(EC, d)).to(x.dtype)
        if e.n_shared_experts:
            y = y + swiglu_mlp(p["shared"], x_flat)
        return y.reshape(B, S, d)
    k = e.top_k
    cap = min(int(max(4, e.capacity_factor * k * S / e.n_experts)), S * k)
    idx_r = idx.reshape(B, S * k)
    gate_r = gate_vals.reshape(B, S * k)
    oh = F.one_hot(idx_r, e.n_experts)
    pos = ((torch.cumsum(oh, dim=1) - oh) * oh).sum(-1)        # row-local
    keep = pos < cap
    safe_pos = torch.where(keep, pos, torch.full_like(pos, cap - 1))
    # slot -> source token; dropped tokens go to a dump slot (index cap)
    src_tok = (torch.arange(S * k, device=x.device) // k).expand(B, S * k)
    scat_idx = idx_r * (cap + 1) + torch.where(
        keep, safe_pos, torch.full_like(safe_pos, cap))
    slot_flat = torch.full((B, e.n_experts * (cap + 1)), -1,
                           dtype=torch.long, device=x.device)
    slot_flat = slot_flat.scatter(1, scat_idx, src_tok)
    slot_tok = slot_flat.reshape(B, e.n_experts, cap + 1)[:, :, :cap]
    valid = slot_tok >= 0
    flat_slot = torch.clamp(slot_tok, 0, S - 1).reshape(B, -1)
    buf = torch.gather(x, 1, flat_slot[..., None].expand(-1, -1, d))
    buf = buf.reshape(B, e.n_experts, cap, d)
    buf = torch.where(valid[..., None], buf, torch.zeros_like(buf))
    h = silu(torch.einsum("becd,edf->becf", buf, ex["w_gate"])) \
        * torch.einsum("becd,edf->becf", buf, ex["w_up"])
    eo = torch.einsum("becf,efd->becd", h, ex["w_down"])
    comb_idx = idx_r * cap + safe_pos
    rows = torch.gather(eo.reshape(B, e.n_experts * cap, d), 1,
                        comb_idx[..., None].expand(-1, -1, d))
    w = torch.where(keep, gate_r, torch.zeros_like(gate_r))
    y = (rows.float() * w[..., None]).reshape(B, S, k, d).sum(2) \
        .to(x.dtype)
    if e.n_shared_experts:
        y = y + swiglu_mlp(p["shared"], x_flat).reshape(B, S, d)
    return y


# ---------------------------------------------------------------------------
# Mamba mixer (hymba's SSM heads): a depthwise causal conv, then a
# sequential scan over time carrying (B, d_inner, d_state) in float32
# ---------------------------------------------------------------------------

def _depthwise_conv(hist, w, b):
    """silu(sum_k hist[:, k:k+S] * w[:, k] + b): hist (B, S + K - 1, di),
    w (di, K). The K products are summed in float32 and cast to hist's
    dtype, as the JAX package's einsum accumulates."""
    K = w.shape[1]
    S = hist.shape[1] - K + 1
    acc = sum(hist[:, k:k + S].float() * w[:, k].float() for k in range(K))
    return silu(acc.to(hist.dtype) + b)


def _mamba_inputs(p, x, cfg: ModelConfig, conv_state=None):
    """The scan's inputs for x (B, S, d): (xi after the conv, z, dt, B_t,
    C_t, the pre-conv xi). `conv_state` (B, K-1, di) holds the earlier
    pre-conv inputs (None: zeros, the start of a sequence)."""
    K = cfg.ssm.d_conv
    xi, z = (x @ p["w_in"]).chunk(2, dim=-1)
    if conv_state is None:
        conv_state = xi.new_zeros((x.shape[0], K - 1, xi.shape[-1]))
    hist = torch.cat([conv_state, xi], dim=1)
    xc = _depthwise_conv(hist, p["conv_w"], p["conv_b"])
    dt = F.softplus((xc @ p["w_dt_a"]) @ p["w_dt_b"] + p["dt_bias"])
    return xc, z, dt, xc @ p["w_B"], xc @ p["w_C"], hist


def _mamba_out(p, y, xc, z):
    """w_out((y + xc * D) * silu(z)) for the scan's float32 output y."""
    y = y.to(xc.dtype) + xc * p["D"]
    return (y * silu(z)) @ p["w_out"]


def mamba_mix_full(p, x, cfg: ModelConfig):
    """x: (B, S, d) -> (out (B, S, d), (conv_state (B, K-1, di), state
    (B, di, ds) float32)). conv_state is the last K-1 pre-conv inputs of
    the padded sequence and the state the one after all S steps, as in
    the JAX package (right-padded items run over their pad positions)."""
    K = cfg.ssm.d_conv
    B, S, _ = x.shape
    xc, z, dt, Bm, Cm, hist = _mamba_inputs(p, x, cfg)
    A = -torch.exp(p["A_log"].float())                     # (di, ds)
    dtf = dt.float()
    dtx = dt * xc                                          # model dtype
    Cf = Cm.float()
    h = torch.zeros((B, xc.shape[-1], A.shape[-1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(S):
        dA = torch.exp(dtf[:, t, :, None] * A)
        dBx = (dtx[:, t, :, None] * Bm[:, t, None, :]).float()
        h = h * dA + dBx
        ys.append(torch.matmul(h, Cf[:, t, :, None])[..., 0])
    y = torch.stack(ys, dim=1)                             # (B, S, di)
    return _mamba_out(p, y, xc, z), (hist[:, S:S + K - 1], h)


def mamba_mix_step(p, x, cfg: ModelConfig, conv_state, ssm_state):
    """Decode step. x: (B, 1, d); conv_state (B, K-1, di); ssm_state
    (B, di, ds) float32. Returns (out (B, 1, d), new conv_state, new
    ssm_state)."""
    xc, z, dt, Bt, Ct, hist = _mamba_inputs(p, x, cfg, conv_state)
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt[:, 0, :, None].float() * A)
    dBx = ((dt * xc)[:, 0, :, None] * Bt[:, 0, None, :]).float()
    h = ssm_state * dA + dBx
    y = torch.matmul(h, Ct[:, 0, :, None].float())[..., 0]
    return _mamba_out(p, y[:, None], xc, z), hist[:, 1:], h


# ---------------------------------------------------------------------------
# Hymba layer: parallel attention heads + Mamba heads, the mean of their
# RMS-normed outputs (arXiv:2411.13676)
# ---------------------------------------------------------------------------

def hymba_mix_full(p, x, cfg: ModelConfig, window, positions, *,
                   kernels=None, differentiable: bool = False):
    """Prefill path: (out, (k, v), (conv_state, ssm_state)). The attention
    heads go through `gqa_attn_full` (the prefill kernel on the card, the
    blocked attention on the differentiable route)."""
    attn_out, kv = gqa_attn_full(p["attn"], x, cfg, window, positions,
                                 kernels=kernels,
                                 differentiable=differentiable)
    ssm_out, states = mamba_mix_full(p["ssm"], x, cfg)
    out = 0.5 * (rms_norm(attn_out, p["norm_attn"], cfg.norm_eps)
                 + rms_norm(ssm_out, p["norm_ssm"], cfg.norm_eps))
    return out, kv, states


def hymba_mix_decode(p, x, cfg: ModelConfig, window, cache_k, cache_v,
                     lengths, conv_state, ssm_state, *, kernels=None):
    """Decode step: x (R, 1, d) with R >= B, the cache's batch (the
    states carry R rows like x). The attention heads go through
    `gqa_attn_decode` (the decode kernel on the card). Returns (out,
    new conv_state, new ssm_state), R rows each."""
    attn_out = gqa_attn_decode(p["attn"], x, cfg, window, cache_k, cache_v,
                               lengths, kernels=kernels)
    ssm_out, new_conv, new_ssm = mamba_mix_step(p["ssm"], x, cfg,
                                                conv_state, ssm_state)
    out = 0.5 * (rms_norm(attn_out, p["norm_attn"], cfg.norm_eps)
                 + rms_norm(ssm_out, p["norm_ssm"], cfg.norm_eps))
    return out, new_conv, new_ssm


# ---------------------------------------------------------------------------
# RWKV-6 (Finch): a linear recurrence with data-dependent decay. The
# full-sequence path is the chunked-parallel (GLA-style) form, decode the
# O(1) state update.
# ---------------------------------------------------------------------------

RWKV_CHUNK = 32
_LOGW_MIN = -8.0 / RWKV_CHUNK   # per-step log-decay clamp for chunk stability


def _rwkv_projections(p, x, x_prev):
    """Token-shifted projections. x, x_prev: (B, S, d), x_prev shifted by
    one token. Returns (r, k, v, g, logw float32)."""
    sx = x_prev - x
    r = (x + sx * p["mu_r"]) @ p["w_r"]
    k = (x + sx * p["mu_k"]) @ p["w_k"]
    v = (x + sx * p["mu_v"]) @ p["w_v"]
    g = silu((x + sx * p["mu_g"]) @ p["w_g"])
    xw = x + sx * p["mu_w"]
    logw = -torch.exp(p["w0"] + torch.tanh(xw @ p["w_dec_a"])
                      @ p["w_dec_b"]).float()
    return r, k, v, g, torch.clamp(logw, _LOGW_MIN, -1e-6)


def _token_shift(x):
    """x shifted one token later along axis 1, zeros first."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def rwkv6_mix_full(p, x, cfg: ModelConfig):
    """Chunked-parallel RWKV6 wkv over x (B, S, d), chunks of
    `_divisor_block(S, RWKV_CHUNK)` tokens. Returns (out, (final wkv
    state (B, H, hd, hd) float32, x[:, -1]))."""
    B, S, d = x.shape
    H, hd = cfg.rwkv_n_heads, cfg.rwkv_head_size
    C = _divisor_block(S, RWKV_CHUNK)
    N = S // C
    r, k, v, g, logw = _rwkv_projections(p, x, _token_shift(x))
    u = p["u"].reshape(H, hd).float()

    def heads(t):                       # (B, S, d) -> (B, N, C, H, hd)
        return t.float().reshape(B, N, C, H, hd)

    r_f, k_f, v_f, logw = heads(r), heads(k), heads(v), heads(logw)
    cum = torch.cumsum(logw, dim=2)                    # inclusive, in-chunk
    rq = r_f * torch.exp(cum - logw)
    kq = k_f * torch.exp(-cum)
    A = torch.einsum("bnchd,bnshd->bnhcs", rq, kq)     # (B, N, H, C, C)
    A = A * torch.tril(torch.ones((C, C), device=x.device), -1)
    intra = torch.einsum("bnhcs,bnshd->bnchd", A, v_f)
    bonus = torch.einsum("bnchd,hd,bnchd->bnch", r_f, u, k_f)
    intra = intra + bonus[..., None] * v_f
    chunk_decay = torch.exp(cum[:, :, -1])             # (B, N, H, hd)
    k_to_end = k_f * torch.exp(cum[:, :, -1:] - cum)
    state = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
    inter = []
    for n in range(N):
        inter.append(torch.einsum("bchd,bhdv->bchv", rq[:, n], state))
        state = state * chunk_decay[:, n, ..., None] + torch.einsum(
            "bchd,bchv->bhdv", k_to_end[:, n], v_f[:, n])
    wkv = (intra + torch.stack(inter, dim=1)).reshape(B, S, H, hd)
    wkv = _headwise_norm(wkv, p["ln_w"], p["ln_b"], cfg.norm_eps)
    out = (wkv.reshape(B, S, d).to(x.dtype) * g) @ p["w_o"]
    return out, (state, x[:, -1])


def rwkv6_mix_step(p, x, cfg: ModelConfig, wkv_state, x_prev):
    """Decode step. x: (B, 1, d); wkv_state (B, H, hd, hd) float32;
    x_prev (B, d). Returns (out (B, 1, d), new state, x[:, 0])."""
    B, _, d = x.shape
    H, hd = cfg.rwkv_n_heads, cfg.rwkv_head_size
    r, k, v, g, logw = _rwkv_projections(p, x, x_prev[:, None, :])
    r = r.reshape(B, H, hd).float()
    k = k.reshape(B, H, hd).float()
    v = v.reshape(B, H, hd).float()
    w = torch.exp(logw.reshape(B, H, hd))
    u = p["u"].reshape(H, hd).float()
    kv = k[..., :, None] * v[..., None, :]             # (B, H, hd, hd)
    out = torch.einsum("bhd,bhdv->bhv", r, wkv_state + u[..., None] * kv)
    new_state = wkv_state * w[..., None] + kv
    out = _headwise_norm(out.reshape(B, 1, H, hd), p["ln_w"], p["ln_b"],
                         cfg.norm_eps)
    out = (out.reshape(B, 1, d).to(x.dtype) * g) @ p["w_o"]
    return out, new_state, x[:, 0]


def _headwise_norm(x, w, b, eps):
    """LayerNorm over the last axis (per head) of x (..., H, hd), in
    float32; returned in x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * w + b).to(x.dtype)


def rwkv_channel_mix(p, x, x_prev):
    """RWKV channel mix: a squared-ReLU feed-forward with token shift."""
    sx = x_prev - x
    kk = torch.square(F.relu((x + sx * p["mu_k"]) @ p["w_k"]))
    return torch.sigmoid((x + sx * p["mu_r"]) @ p["w_r"]) * (kk @ p["w_v"])
