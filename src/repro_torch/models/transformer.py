"""Config-driven GQA decoder LM in PyTorch: params, forward, prefill, decode.

The port of the GQA subset of `repro.models.transformer`. Parameters keep
the JAX package's layout: a nested dict whose per-layer leaves are stacked
along a leading layer axis L under the same key names,

    {"embed": (V, d), "final_norm": (d,), "head": (d, V),
     "layers": {"attn": {"wq", "wk", "wv", "wo"},
                "mlp": {"w_gate", "w_up", "w_down"},
                "norm_attn": (L, d), "norm_mlp": (L, d)}}

and caches are {"k", "v": (L, B, S, KV, dh), "lengths": (B,)} (int8 caches
add "k_scale", "v_scale": (L, B, S, KV)). A Python loop over layers takes
the place of the JAX layer scan; the per-layer window is a plain int.

Decode writes the new tokens' k/v into the cache tensors in place, at
positions cache["lengths"] and beyond. No earlier result reads those
positions, and a later flush over the same tensors (the engine's
device-resident cache, which lets one flush at a time decode over an
entry) overwrites them with its own query before reading them, so
results match the JAX package's functional update.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import layers as L


def _check_gqa(cfg: ModelConfig):
    if cfg.attn_kind != "gqa" or cfg.is_moe:
        raise NotImplementedError(
            f"the port runs dense GQA models only so far; {cfg.name!r} has "
            f"attn_kind={cfg.attn_kind!r}, moe={cfg.is_moe}")


def model_template(cfg: ModelConfig) -> Dict[str, Any]:
    """Nested dict of (shape, init) leaves, the JAX template's GQA subset
    (`transformer.py:35-42,112-118,165-183`)."""
    _check_gqa(cfg)
    d, H, KV, dh, ff, Ln = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.d_head, cfg.d_ff, cfg.n_layers)
    t = {
        "embed": ((cfg.vocab_padded, d), "normal"),
        "final_norm": ((d,), "zeros"),
        "layers": {
            "attn": {"wq": ((Ln, d, H * dh), "normal"),
                     "wk": ((Ln, d, KV * dh), "normal"),
                     "wv": ((Ln, d, KV * dh), "normal"),
                     "wo": ((Ln, H * dh, d), "normal")},
            "mlp": {"w_gate": ((Ln, d, ff), "normal"),
                    "w_up": ((Ln, d, ff), "normal"),
                    "w_down": ((Ln, ff, d), "normal")},
            "norm_attn": ((Ln, d), "zeros"),
            "norm_mlp": ((Ln, d), "zeros"),
        },
    }
    if not cfg.tie_embeddings:
        t["head"] = ((d, cfg.vocab_padded), "normal")
    return t


def _map_template(tmpl, fn, path=()):
    return {k: (_map_template(v, fn, path + (k,)) if isinstance(v, dict)
                else fn(path + (k,), *v))
            for k, v in sorted(tmpl.items())}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", dtype=None) -> Dict[str, Any]:
    """Random weights: normal x 0.02 (zeros for norm scales), drawn in
    float32 from `generator` and cast to `dtype` (default cfg.dtype).
    Stacked layer leaves are drawn one layer at a time to bound the
    float32 scratch. The numbers differ from `jax.random`'s."""
    dev = resolve_device(device)
    dtype = torch_dtype(dtype or cfg.dtype)

    def make(path, shape, init):
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=dev)
        out = torch.empty(shape, dtype=dtype, device=dev)
        rows = out if path[0] == "layers" else out[None]
        for r in rows:
            r.copy_(torch.randn(r.shape, generator=generator, device=dev,
                                dtype=torch.float32) * 0.02)
        return out

    return _map_template(model_template(cfg), make)


def _to_torch(arr, device, dtype):
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":     # ml_dtypes: reinterpret the bits
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(cfg: ModelConfig, np_tree, device="cuda", dtype=None):
    """The JAX package's parameter pytree (numpy leaves, e.g. from
    `jax.tree.map(np.asarray, params)`) as the port's parameters."""
    dev = resolve_device(device)
    dtype = torch_dtype(dtype) if dtype is not None else None

    def take(path, shape, init):
        node = np_tree
        for k in path:
            node = node[k]
        t = _to_torch(node, dev, dtype)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{'/'.join(path)}: shape {tuple(t.shape)} != "
                             f"{tuple(shape)}")
        return t

    return _map_template(model_template(cfg), take)


def build_window_array(cfg: ModelConfig) -> np.ndarray:
    """Per-layer attention window (int32). GLOBAL_WINDOW = full attention."""
    w = np.full((cfg.n_layers,), L.GLOBAL_WINDOW, np.int32)
    if cfg.window:
        w[:] = cfg.window
        if cfg.global_every:
            w[cfg.global_every - 1::cfg.global_every] = L.GLOBAL_WINDOW
        for g in cfg.global_layers:
            w[g] = L.GLOBAL_WINDOW
    return w


def _layer(tree, i: int):
    """Layer i's slice of the stacked layer parameters."""
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _head(params, cfg: ModelConfig):
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def _trunk(params, cfg: ModelConfig, tokens, collect_cache: bool = False,
           collect_hidden: bool = False, kernels=None):
    """Every layer over the full sequence. Returns (final-normed x,
    caches or None): "k"/"v" with collect_cache, "h" (the post-norm layer
    inputs) with collect_hidden, each stacked (L, B, S, ...). `kernels`
    selects the attention route (kernels.ops backends): on the card under
    auto / cuda every layer launches the prefill kernel."""
    _check_gqa(cfg)
    x = params["embed"][tokens]
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).expand(B, S)
    windows = build_window_array(cfg)
    ks, vs, hs = [], [], []
    for i in range(cfg.n_layers):
        p = _layer(params["layers"], i)
        h = L.rms_norm(x, p["norm_attn"], cfg.norm_eps)
        attn_out, (k, v) = L.gqa_attn_full(p["attn"], h, cfg,
                                           int(windows[i]), positions,
                                           kernels=kernels)
        if collect_cache:
            ks.append(k)
            vs.append(v)
        if collect_hidden:
            hs.append(h)          # post-norm layer input (EA calibration)
        x = x + attn_out
        h2 = L.rms_norm(x, p["norm_mlp"], cfg.norm_eps)
        x = x + L.swiglu_mlp(p["mlp"], h2)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    caches = {"k": torch.stack(ks), "v": torch.stack(vs)} \
        if collect_cache else {}
    if collect_hidden:
        caches["h"] = torch.stack(hs)
    return x, (caches or None)


def forward(params, cfg: ModelConfig, tokens, collect_cache: bool = False,
            collect_hidden: bool = False, kernels=None):
    """Full-sequence forward. Returns (logits (B, S, V), caches or None)."""
    x, caches = _trunk(params, cfg, tokens, collect_cache, collect_hidden,
                       kernels=kernels)
    return x @ _head(params, cfg), caches


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               quant: bool = False, device="cuda") -> Dict[str, Any]:
    """Zeroed decode cache. quant=True: int8 k/v plus per-(position, head)
    float32 scales (the layout the int8 rungs use)."""
    _check_gqa(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(dtype or cfg.dtype)
    Ln = cfg.n_layers
    c: Dict[str, Any] = {"lengths": torch.zeros((batch,), dtype=torch.int32,
                                                device=dev)}
    kv_shape = (Ln, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    kv_dtype = torch.int8 if quant else dtype
    c["k"] = torch.zeros(kv_shape, dtype=kv_dtype, device=dev)
    c["v"] = torch.zeros(kv_shape, dtype=kv_dtype, device=dev)
    if quant:
        s_shape = kv_shape[:-1]
        c["k_scale"] = torch.zeros(s_shape, dtype=torch.float32, device=dev)
        c["v_scale"] = torch.zeros(s_shape, dtype=torch.float32, device=dev)
    return c


def prefill(params, cfg: ModelConfig, tokens, max_len: Optional[int] = None,
            lengths=None, kernels=None):
    """Run the full prompt, return (last_logits (B, V), cache).

    tokens are right-padded to S; `lengths` (B,) gives true lengths
    (default S). Cache arrays are padded to `max_len` (default S). Logits
    are computed at each item's last valid position only (the JAX package
    computes them everywhere and keeps that one: the same numbers, without
    a B x S x V tensor). `kernels` selects the attention route, as in
    `_trunk`."""
    x, caches = _trunk(params, cfg, tokens, collect_cache=True,
                       kernels=kernels)
    B, S = x.shape[:2]
    dev = x.device
    max_len = max_len or S
    lengths = (torch.full((B,), S, dtype=torch.int32, device=dev)
               if lengths is None else lengths.to(device=dev,
                                                  dtype=torch.int32))
    dtype = torch_dtype(cfg.dtype)
    cache: Dict[str, Any] = {"lengths": lengths}
    for name in ("k", "v"):
        src = caches[name].to(dtype)              # (L, B, S, KV, dh)
        if max_len != S:
            buf = torch.zeros(src.shape[:2] + (max_len,) + src.shape[3:],
                              dtype=dtype, device=dev)
            buf[:, :, :S] = src
            src = buf
        cache[name] = src
    idx = torch.clamp(lengths.long() - 1, 0, S - 1)
    last = x[torch.arange(B, device=dev), idx]    # (B, d)
    return last @ _head(params, cfg), cache


def _quantize(x):
    s = x.float().abs().amax(-1) / 127.0
    q = torch.round(x / torch.clamp(s, min=1e-9)[..., None]).to(torch.int8)
    return q, s


def decode_step(params, cfg: ModelConfig, cache, tokens, kernels=None,
                rows=None):
    """One decode step. tokens: (B, 1). Returns (logits (B, V), new_cache).
    The new token sits at position cache["lengths"]; lengths are
    incremented in the returned cache. `rows` pins the dense layers' row
    count (see decode_multi)."""
    _check_gqa(cfg)
    pos = cache["lengths"].long()                 # (B,)
    new_len = (pos + 1).to(torch.int32)
    B = tokens.shape[0]
    R = max(B, rows or B)
    x = params["embed"][L.pad_rows(tokens, R)]    # (R, 1, d)
    bidx = torch.arange(B, device=x.device)
    windows = build_window_array(cfg)
    quant = "k_scale" in cache
    for i in range(cfg.n_layers):
        p = _layer(params["layers"], i)
        h = L.rms_norm(x, p["norm_attn"], cfg.norm_eps)
        k_new, v_new = L.gqa_new_kv(p["attn"], h, cfg,
                                    L.pad_rows(new_len, R))
        ck, cv = cache["k"][i], cache["v"][i]
        if quant:
            k_q, ks = _quantize(k_new)
            v_q, vs = _quantize(v_new)
            ck[bidx, pos] = k_q[:B, 0]
            cv[bidx, pos] = v_q[:B, 0]
            cache["k_scale"][i][bidx, pos] = ks[:B, 0]
            cache["v_scale"][i][bidx, pos] = vs[:B, 0]
            k_sc, v_sc = cache["k_scale"][i], cache["v_scale"][i]
        else:
            ck[bidx, pos] = k_new[:B, 0].to(ck.dtype)
            cv[bidx, pos] = v_new[:B, 0].to(cv.dtype)
            k_sc = v_sc = None
        x = x + L.gqa_attn_decode(p["attn"], h, cfg, int(windows[i]), ck, cv,
                                  new_len, kernels=kernels, k_scale=k_sc,
                                  v_scale=v_sc)
        h2 = L.rms_norm(x, p["norm_mlp"], cfg.norm_eps)
        x = x + L.swiglu_mlp(p["mlp"], h2)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x[:, 0] @ _head(params, cfg))[:B]
    new_cache = dict(cache)
    new_cache["lengths"] = new_len
    return logits, new_cache


def supports_fused_decode(cfg: ModelConfig) -> bool:
    """Fused multi-token decode covers pure-attention caches only."""
    return cfg.attn_kind == "gqa"


def decode_multi(params, cfg: ModelConfig, cache, tokens, kernels=None,
                 rows=None):
    """Fused multi-token decode: all Lq query tokens in one pass, one
    attention launch per layer. tokens: (B, Lq). Returns (logits (B, V)
    of the LAST query token, new_cache); the Lq k/v land at positions
    lengths .. lengths+Lq-1 and attention is causal per query token.

    `rows` (>= B) pins the row count of the dense layers (projections,
    SwiGLU, the head, and the row-wise norms, RoPE and quantisation
    between them): their inputs are padded with copies of row 0 to `rows`
    rows, so a matmul library that picks its algorithm by M (cuBLAS does)
    rounds an item's row the same whatever batch the item is decoded in.
    Only the attention and the cache writes see the B real rows."""
    _check_gqa(cfg)
    pos0 = cache["lengths"].long()
    B, Lq = tokens.shape
    R = max(B, rows or B)
    new_len = (pos0 + Lq).to(torch.int32)
    x = params["embed"][L.pad_rows(tokens, R)]    # (R, Lq, d)
    positions = pos0[:, None] + torch.arange(Lq, device=x.device)[None, :]
    rpositions = L.pad_rows(positions, R)
    bidx = torch.arange(B, device=x.device)[:, None]
    windows = build_window_array(cfg)
    quant = "k_scale" in cache
    for i in range(cfg.n_layers):
        p = _layer(params["layers"], i)
        h = L.rms_norm(x, p["norm_attn"], cfg.norm_eps)
        k_new, v_new = L.gqa_new_kv_multi(p["attn"], h, cfg, rpositions)
        ck, cv = cache["k"][i], cache["v"][i]
        if quant:
            k_q, ks = _quantize(k_new)
            v_q, vs = _quantize(v_new)
            ck[bidx, positions] = k_q[:B]
            cv[bidx, positions] = v_q[:B]
            cache["k_scale"][i][bidx, positions] = ks[:B]
            cache["v_scale"][i][bidx, positions] = vs[:B]
            k_sc, v_sc = cache["k_scale"][i], cache["v_scale"][i]
        else:
            ck[bidx, positions] = k_new[:B].to(ck.dtype)
            cv[bidx, positions] = v_new[:B].to(cv.dtype)
            k_sc = v_sc = None
        x = x + L.gqa_attn_decode_multi(p["attn"], h, cfg, int(windows[i]),
                                        ck, cv, new_len, kernels=kernels,
                                        k_scale=k_sc, v_scale=v_sc)
        h2 = L.rms_norm(x, p["norm_mlp"], cfg.norm_eps)
        x = x + L.swiglu_mlp(p["mlp"], h2)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x[:, -1] @ _head(params, cfg))[:B]
    new_cache = dict(cache)
    new_cache["lengths"] = new_len
    return logits, new_cache
