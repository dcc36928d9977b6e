"""Query-agnostic KV-cache compression (Expected Attention; paper §5).

The port of `repro.cache.compression`. Offline pipeline:
  1. calibrate_query_stats — run the model over calibration items, take
     each layer's post-norm hidden states, project them to queries, and
     fit per-head Gaussians N(mu, diag(sig2)) of the future queries.
  2. score positions with kernels.ops.expected_attention_scores (the
     hand-written CUDA kernel on the card), one call per prefill chunk
     (`score_chunk`).
  3. keep the top (1 - ratio) positions per item per layer, ties broken
     toward the lower position as `jax.lax.top_k` does.

GQA and hymba caches compress k/v (hymba's conv / ssm states are copied
through as they are); MLA caches compress latent rows ([c_kv ; k_rope]
scored as one KV head of width r + rope against the absorbed query's
statistics, as the JAX package does). rwkv6 keeps no positional cache:
its engine stores the states whole, at ratio 0 only.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as KOPS
from repro_torch.models.transformer import SEQ_KEYS, _trunk, cache_keys


class QueryStats(NamedTuple):
    mu: torch.Tensor     # (L, KV, G, dk) in the model dtype
    sig2: torch.Tensor   # (L, KV, G, dk); MLA: (L, 1, H, r + rope)


def _gaussian(q: torch.Tensor) -> QueryStats:
    """Mean and population variance over axis 1, reduced in float32 and
    returned in q's dtype (what `jnp.mean` / `jnp.var` do for bfloat16)."""
    qf = q.float()
    mu = qf.mean(dim=1)
    sig2 = (qf - mu[:, None]).square().sum(dim=1) / qf.shape[1]
    return QueryStats(mu.to(q.dtype), sig2.to(q.dtype))


def calibrate_query_stats(params, cfg: ModelConfig, tokens=None,
                          tail_frac: float = 0.5, kernels=None,
                          embeds=None) -> QueryStats:
    """Fit per-layer, per-head query Gaussians from calibration data, on
    the trailing `tail_frac` positions (future operator queries arrive
    after the document). As in the JAX package, the queries are projected
    in the model dtype, mean and (population) variance are reduced in
    float32 (`jnp.mean` / `jnp.var` upcast bfloat16), and the stats come
    back in the model dtype. `kernels` selects the forward's attention
    route (the prefill kernel on the card). A frontend's model (llava,
    musicgen) calibrates on `embeds` (B, S, d) in place of `tokens`.

    MLA: the statistics are those of the absorbed query [q_nope W_uk ;
    q_rope] per head, (L, 1, H, r + rope): one KV head whose G = H
    "query heads" score the latent rows."""
    _, caches = _trunk(params, cfg, tokens, collect_hidden=True,
                       kernels=kernels, embeds=embeds)
    h = caches["h"]                                # (L, B, S, d)
    Ln, B, S, d = h.shape
    t0 = int(S * (1.0 - tail_frac))
    h = h[:, :, t0:, :]
    ap = params["layers"]["attn"]
    if cfg.attn_kind in ("gqa", "hymba"):
        wq = ap["attn"]["wq"] if cfg.attn_kind == "hymba" else ap["wq"]
        q = torch.einsum("lbsd,lde->lbse", h, wq)         # (L, d, H*dh)
        KV, G, dk = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, \
            cfg.d_head
        return _gaussian(q.reshape(Ln, -1, KV, G, dk))
    if cfg.attn_kind != "mla":
        raise ValueError(f"no positional cache to compress for "
                         f"{cfg.attn_kind}")
    m = cfg.mla
    if m.q_lora_rank:
        q = torch.einsum("lbse,lef->lbsf",
                         torch.einsum("lbsd,lde->lbse", h, ap["wq_a"]),
                         ap["wq_b"])
    else:
        q = torch.einsum("lbsd,lde->lbse", h, ap["wq"])
    H = cfg.n_heads
    q = q.reshape(Ln, -1, H, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    # absorbed query: q_lat = q_nope @ W_uk (r wide, per head)
    w_kv_b = ap["w_kv_b"].reshape(Ln, m.kv_lora_rank, H,
                                  m.qk_nope_dim + m.v_head_dim)
    w_uk = w_kv_b[..., :m.qk_nope_dim]                    # (L, r, H, nope)
    q_lat = torch.einsum("lthn,lrhn->lthr", q_nope, w_uk)  # (L, T, H, r)
    stats = _gaussian(torch.cat([q_lat, q_rope], dim=-1))
    return QueryStats(stats.mu[:, None], stats.sig2[:, None])


def score_rows(cache: Dict[str, Any]) -> torch.Tensor:
    """The rows kernel C scores, (L, B, S, KV, dk): a GQA cache's k, or an
    MLA cache's latent rows [c_kv ; k_rope] as one KV head (KV 1, dk
    r + rope)."""
    if "k" in cache:
        return cache["k"]
    lat = torch.cat([cache["c_kv"], cache["k_rope"]], dim=-1)
    return lat[:, :, :, None, :]


def score_chunk(cfg: ModelConfig, cache: Dict[str, Any], stats: QueryStats,
                lengths: Sequence[int], kernels=None) -> torch.Tensor:
    """Keep-scores of every item of a prefill chunk, in one call of the
    Expected-Attention kernel over all layers and items (the JAX package
    maps its kernel over the layers with `jax.vmap`, item by item).
    The cache's rows are `score_rows`: GQA k (L, B, S, KV, dk), MLA latent
    rows (L, B, S, 1, r + rope); `lengths`: B ints. Returns (L, B, S)
    float32, the mean over KV heads, -inf at and beyond each item's
    length. A score depends only on its own K row and its layer's stats,
    so an item's scores are the same, bit for bit, alone or in a chunk."""
    k = score_rows(cache)
    scores = KOPS.expected_attention_scores(
        k, stats.mu, stats.sig2, backend=kernels).mean(-1)   # (L, B, S)
    pos = torch.arange(k.shape[2], device=scores.device)
    lens = torch.tensor(list(lengths), device=scores.device)
    live = pos[None, None, :] < lens[None, :, None]
    return torch.where(live, scores, torch.full_like(scores, -float("inf")))


def score_positions(cfg: ModelConfig, cache: Dict[str, Any],
                    stats: QueryStats, length: int, kernels=None
                    ) -> torch.Tensor:
    """Per-layer keep-scores for one item (cache leaves (L, 1, S, ...)).
    Returns (L, S) float32, -inf at and beyond `length` (`score_chunk`
    at B 1)."""
    return score_chunk(cfg, cache, stats, [length], kernels)[:, 0]


def top_k_positions(scores: torch.Tensor, keep: int) -> torch.Tensor:
    """The `keep` best positions per row, in ascending position order.
    Equal scores prefer the lower position, as `jax.lax.top_k` does (a
    stable descending sort keeps the original order among ties)."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    return torch.sort(order[:, :keep], dim=-1).values


def compress_item_cache(cfg: ModelConfig, cache: Dict[str, Any],
                        stats: QueryStats, ratio: float, length: int,
                        scores: Optional[torch.Tensor] = None,
                        kernels=None) -> Tuple[Dict[str, torch.Tensor], int]:
    """Compress one item's cache (batch dim 1) to keep (1-ratio) tokens.

    Returns ({"k", "v": (L, S', KV, dh)} or MLA's {"c_kv", "k_rope":
    (L, S', .)}, with hymba's states {"conv", "ssm"} copied through; or,
    for rwkv6 (no positional cache) at ratio 0, its states; CPU tensors;
    new_length). Kept positions stay in order. `scores` (from
    score_positions) may be passed in: they do not depend on the ratio,
    so one item's scores serve every rung of its ladder."""
    seq = [k for k in cache_keys(cfg) if k in SEQ_KEYS]
    states = {key: cache[key][:, 0].cpu() for key in cache_keys(cfg)
              if key not in SEQ_KEYS}
    if ratio <= 0.0 or not seq:
        return {**{key: cache[key][:, 0, :length].cpu() for key in seq},
                **states}, length
    keep = max(4, int(round((1.0 - ratio) * length)))
    if scores is None:
        scores = score_positions(cfg, cache, stats, length, kernels)
    idx = top_k_positions(scores, keep)                   # (L, keep)
    out = {}
    for key in seq:
        arr = cache[key][:, 0]                            # (L, S, ...)
        gi = idx.reshape(idx.shape + (1,) * (arr.dim() - 2)).expand(
            idx.shape + arr.shape[2:])
        out[key] = torch.gather(arr, 1, gi).cpu()
    return {**out, **states}, keep


def quantize_kv(arrays: Dict[str, Any]) -> Dict[str, Any]:
    """int8 rung of the ladder: int8 k/v tensors plus per-(layer, token,
    head) absmax scales (L, S', KV) float32, as in the JAX package; other
    entries (hymba's conv / ssm states) pass through as they are."""
    out = dict(arrays)
    for key in ("k", "v"):
        if key not in arrays:
            continue
        x = arrays[key].float()
        scale = x.abs().amax(-1) / 127.0
        q = torch.round(x / torch.clamp(scale, min=1e-9)[..., None])
        out[key] = q.to(torch.int8)
        out[f"{key}_scale"] = scale
    return out


def prune_dominated(profiles):
    """Drop profiles strictly worse in quality with no cost/storage gain
    (paper §5 offline phase). profiles: dicts with 'ratio', 'quality',
    'cost'."""
    kept = []
    for p in profiles:
        dominated = any(
            (q["quality"] >= p["quality"] and q["cost"] <= p["cost"]
             and (q["quality"] > p["quality"] or q["cost"] < p["cost"]))
            for q in profiles if q is not p)
        if not dominated:
            kept.append(p)
    return kept
