"""Query-agnostic KV-cache compression (Expected Attention; paper §5).

The port of `repro.cache.compression`. Offline pipeline:
  1. calibrate_query_stats — run the model over calibration items, take
     each layer's post-norm hidden states, project them to queries, and
     fit per-head Gaussians N(mu, diag(sig2)) of the future queries.
  2. score positions with kernels.ops.expected_attention_scores (the
     hand-written CUDA kernel on the card).
  3. keep the top (1 - ratio) positions per item per layer, ties broken
     toward the lower position as `jax.lax.top_k` does.

The port covers GQA k/v caches (the MLA latent scoring waits with MLA).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as KOPS
from repro_torch.models.transformer import _trunk


class QueryStats(NamedTuple):
    mu: torch.Tensor     # (L, KV, G, dk) in the model dtype
    sig2: torch.Tensor   # (L, KV, G, dk) in the model dtype


def calibrate_query_stats(params, cfg: ModelConfig, tokens,
                          tail_frac: float = 0.5) -> QueryStats:
    """Fit per-layer, per-head query Gaussians from calibration data, on
    the trailing `tail_frac` positions (future operator queries arrive
    after the document). As in the JAX package, the queries are projected
    in the model dtype, mean and (population) variance are reduced in
    float32 (`jnp.mean` / `jnp.var` upcast bfloat16), and the stats come
    back in the model dtype."""
    _, caches = _trunk(params, cfg, tokens, collect_hidden=True)
    h = caches["h"]                                # (L, B, S, d)
    Ln, B, S, d = h.shape
    t0 = int(S * (1.0 - tail_frac))
    h = h[:, :, t0:, :]
    wq = params["layers"]["attn"]["wq"]            # (L, d, H*dh)
    q = torch.einsum("lbsd,lde->lbse", h, wq)
    KV, G, dk = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.d_head
    q = q.reshape(Ln, -1, KV, G, dk)
    qf = q.float()
    mu = qf.mean(dim=1)
    sig2 = (qf - mu[:, None]).square().sum(dim=1) / qf.shape[1]
    return QueryStats(mu.to(q.dtype), sig2.to(q.dtype))


def score_positions(cfg: ModelConfig, cache: Dict[str, Any],
                    stats: QueryStats, length: int, kernels=None
                    ) -> torch.Tensor:
    """Per-layer keep-scores for one item. cache["k"]: (L, 1, S, KV, dk).
    Returns (L, S) float32, -inf at and beyond `length`."""
    k = cache["k"]
    S = k.shape[2]
    scores = torch.stack([
        KOPS.expected_attention_scores(k[l], stats.mu[l], stats.sig2[l],
                                       backend=kernels)
        for l in range(k.shape[0])])               # (L, 1, S, KV)
    scores = scores[:, 0].mean(-1)                  # (L, S)
    pos = torch.arange(S, device=scores.device)[None, :]
    return torch.where(pos < length, scores,
                       torch.full_like(scores, -float("inf")))


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

    Returns ({"k", "v": (L, S', KV, dh) CPU tensors}, new_length). Kept
    positions stay in order. `scores` (from score_positions) may be passed
    in: they do not depend on the ratio, so one item's scores serve every
    rung of its ladder."""
    if ratio <= 0.0:
        return {key: cache[key][:, 0, :length].cpu()
                for key in ("k", "v")}, length
    keep = max(4, int(round((1.0 - ratio) * length)))
    if scores is None:
        scores = score_positions(cfg, cache, stats, length, kernels)
    idx = top_k_positions(scores, keep)                   # (L, keep)
    out = {}
    for key in ("k", "v"):
        arr = cache[key][:, 0]                            # (L, S, KV, dh)
        gi = idx.reshape(idx.shape + (1,) * (arr.dim() - 2)).expand(
            idx.shape + arr.shape[2:])
        out[key] = torch.gather(arr, 1, gi).cpu()
    return out, keep


def quantize_kv(arrays: Dict[str, Any]) -> Dict[str, Any]:
    """int8 rung of the ladder: int8 k/v tensors plus per-(layer, token,
    head) absmax scales (L, S', KV) float32, as in the JAX package."""
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
