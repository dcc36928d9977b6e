"""Config-driven decoder LM in PyTorch: params, forward, prefill, decode.

The port of `repro.models.transformer` for the families that keep an
attention cache: dense and MoE GQA (granite, minitron, gemma3, llava,
musicgen, dbrx, stretto-llama-8b) and MLA with MoE (deepseek-v2-lite) or
dense (minicpm3). Parameters keep the JAX package's layout: a nested dict
whose per-layer leaves are stacked along a leading layer axis L under the
same key names, e.g. for GQA

    {"embed": (V, d), "final_norm": (d,), "head": (d, V),
     "layers": {"attn": {"wq", "wk", "wv", "wo"},
                "mlp": {"w_gate", "w_up", "w_down"},
                "norm_attn": (L, d), "norm_mlp": (L, d)}}

with MLA's attention leaves ("wq" or "wq_a" / "wq_b", "w_kv_a", "kv_norm",
"w_kv_b", "wo") and MoE's feed-forward ("router", "experts": {"w_gate",
"w_up", "w_down"} (L, E, ...), "shared") as `layer_template` lists them.
Caches are {"k", "v": (L, B, S, KV, dh), "lengths": (B,)} for GQA (int8
caches add "k_scale", "v_scale": (L, B, S, KV)) and {"c_kv": (L, B, S,
r), "k_rope": (L, B, S, rope), "lengths"} for MLA. A Python loop over
layers takes the place of the JAX layer scan; the per-layer window is a
plain int.

Decode writes the new tokens' cache rows into the cache tensors in place,
at positions cache["lengths"] and beyond. No earlier result reads those
positions, and a later flush over the same tensors (the engine's
device-resident cache, which lets one flush at a time decode over an
entry) overwrites them with its own query before reading them, so
results match the JAX package's functional update.

Pinned rows (`rows=` of the decode paths) pad the dense layers' inputs,
never the MoE router's: the router sees exactly the cache's batch, as in
the JAX package, because an MoE layer's capacity depends on its token
count.

Hymba and RWKV6 register as configs, but their mixers wait for a later
slice: their templates raise NotImplementedError (ROADMAP.md).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import layers as L


class ParamSpec(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axes, parallel to shape
    init: str = "normal"              # normal | zeros


def _check_ported(cfg: ModelConfig):
    if cfg.attn_kind not in ("gqa", "mla"):
        raise NotImplementedError(
            f"{cfg.name!r} (attn_kind={cfg.attn_kind!r}) is registered, but "
            f"the port runs its mixer in a later slice; see ROADMAP.md, "
            f"queue 1")


def _attn_template(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    return {
        "wq": ParamSpec((d, H * dh), ("fsdp", "heads")),
        "wk": ParamSpec((d, KV * dh), ("fsdp", "heads")),
        "wv": ParamSpec((d, KV * dh), ("fsdp", "heads")),
        "wo": ParamSpec((H * dh, d), ("heads", "fsdp")),
    }


def _mla_template(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, H, m = cfg.d_model, cfg.n_heads, cfg.mla
    qdim = H * (m.qk_nope_dim + m.qk_rope_dim)
    t: Dict[str, ParamSpec] = {}
    if m.q_lora_rank:
        t["wq_a"] = ParamSpec((d, m.q_lora_rank), ("fsdp", None))
        t["wq_b"] = ParamSpec((m.q_lora_rank, qdim), (None, "heads"))
    else:
        t["wq"] = ParamSpec((d, qdim), ("fsdp", "heads"))
    t["w_kv_a"] = ParamSpec((d, m.kv_lora_rank + m.qk_rope_dim),
                            ("fsdp", None))
    t["kv_norm"] = ParamSpec((m.kv_lora_rank,), (None,), "zeros")
    t["w_kv_b"] = ParamSpec(
        (m.kv_lora_rank, H * (m.qk_nope_dim + m.v_head_dim)),
        (None, "heads"))
    t["wo"] = ParamSpec((H * m.v_head_dim, d), ("heads", "fsdp"))
    return t


def _mlp_template(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamSpec((d, ff), ("fsdp", "ff")),
        "w_up": ParamSpec((d, ff), ("fsdp", "ff")),
        "w_down": ParamSpec((ff, d), ("ff", "fsdp")),
    }


def _moe_template(cfg: ModelConfig) -> Dict[str, Any]:
    d, e = cfg.d_model, cfg.moe
    ffe = e.d_ff_expert
    t: Dict[str, Any] = {
        "router": ParamSpec((d, e.n_experts), (None, None)),
        "experts": {
            "w_gate": ParamSpec((e.n_experts, d, ffe),
                                ("expert", "fsdp", "ffe")),
            "w_up": ParamSpec((e.n_experts, d, ffe),
                              ("expert", "fsdp", "ffe")),
            "w_down": ParamSpec((e.n_experts, ffe, d),
                                ("expert", "ffe", "fsdp")),
        },
    }
    if e.n_shared_experts:
        ffs = e.n_shared_experts * ffe
        t["shared"] = {
            "w_gate": ParamSpec((d, ffs), ("fsdp", "ff")),
            "w_up": ParamSpec((d, ffs), ("fsdp", "ff")),
            "w_down": ParamSpec((ffs, d), ("ff", "fsdp")),
        }
    return t


def layer_template(cfg: ModelConfig) -> Dict[str, Any]:
    """One layer's ParamSpecs (the JAX template's gqa / mla branches)."""
    _check_ported(cfg)
    d = cfg.d_model
    attn = _attn_template(cfg) if cfg.attn_kind == "gqa" \
        else _mla_template(cfg)
    mlp = _moe_template(cfg) if cfg.is_moe else _mlp_template(cfg)
    return {"attn": attn, "mlp": mlp,
            "norm_attn": ParamSpec((d,), (None,), "zeros"),
            "norm_mlp": ParamSpec((d,), (None,), "zeros")}


def _stack(tree, n: int):
    return {k: (_stack(v, n) if isinstance(v, dict)
                else ParamSpec((n,) + v.shape, ("layers",) + v.axes, v.init))
            for k, v in tree.items()}


def model_template(cfg: ModelConfig) -> Dict[str, Any]:
    """Nested dict of ParamSpec leaves, the JAX package's template."""
    d, V = cfg.d_model, cfg.vocab_padded
    t = {
        "embed": ParamSpec((V, d), ("vocab", None)),
        "final_norm": ParamSpec((d,), (None,), "zeros"),
        "layers": _stack(layer_template(cfg), cfg.n_layers),
    }
    if not cfg.tie_embeddings:
        t["head"] = ParamSpec((d, V), (None, "vocab"))
    return t


def param_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """Tree of logical-axes tuples (the parameters' structure), which
    `distributed.sharding.pspec_tree` resolves."""
    return _map_template(model_template(cfg), lambda path, spec: spec.axes)


def cache_axes(cfg: ModelConfig, quant: bool = False) -> Dict[str, Any]:
    """Logical axes of `init_cache`'s leaves."""
    _check_ported(cfg)
    a: Dict[str, Any] = {"lengths": ("cache_batch",)}
    if cfg.attn_kind == "gqa":
        kv = ("layers", "cache_batch", "cache_seq", "kv_heads", None)
        a["k"] = kv
        a["v"] = kv
        if quant:
            a["k_scale"] = kv[:-1]
            a["v_scale"] = kv[:-1]
    else:
        a["c_kv"] = ("layers", "cache_batch", "cache_seq", None)
        a["k_rope"] = ("layers", "cache_batch", "cache_seq", None)
    return a


def _map_template(tmpl, fn, path=()):
    return {k: (_map_template(v, fn, path + (k,)) if isinstance(v, dict)
                else fn(path + (k,), v))
            for k, v in sorted(tmpl.items())}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", dtype=None) -> Dict[str, Any]:
    """Random weights: normal x 0.02 (zeros for norm scales), drawn in
    float32 from `generator` and cast to `dtype` (default cfg.dtype).
    Stacked layer leaves are drawn one layer at a time to bound the
    float32 scratch. The numbers differ from `jax.random`'s."""
    dev = resolve_device(device)
    dtype = torch_dtype(dtype or cfg.dtype)

    def make(path, spec):
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=dev)
        out = torch.empty(spec.shape, dtype=dtype, device=dev)
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
    `jax.tree.map(np.asarray, params)`) as the port's parameters, every
    leaf of `model_template` (MLA's and MoE's included)."""
    dev = resolve_device(device)
    dtype = torch_dtype(dtype) if dtype is not None else None

    def take(path, spec):
        node = np_tree
        for k in path:
            node = node[k]
        t = _to_torch(node, dev, dtype)
        if tuple(t.shape) != tuple(spec.shape):
            raise ValueError(f"{'/'.join(path)}: shape {tuple(t.shape)} != "
                             f"{tuple(spec.shape)}")
        return t

    return _map_template(model_template(cfg), take)


def build_window_array(cfg: ModelConfig) -> np.ndarray:
    """Per-layer attention window (int32). GLOBAL_WINDOW = full attention;
    with `window`, every `global_every`-th layer and the `global_layers`
    are global."""
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


def _embed(params, cfg: ModelConfig, tokens=None, embeds=None):
    """Token embeddings, or the frontend's `embeds` (llava's patches,
    musicgen's audio frames) cast to the model dtype, times
    `cfg.embed_scale` in the model dtype where the config has one."""
    if embeds is not None:
        x = embeds.to(torch_dtype(cfg.dtype))
    else:
        x = params["embed"][tokens]
    if cfg.embed_scale is not None:
        x = x * torch.tensor(cfg.embed_scale, dtype=x.dtype, device=x.device)
    return x


def _mlp(p, h2, cfg: ModelConfig, B: Optional[int] = None):
    """The feed-forward of rows h2 (R, S, d). An MoE layer routes only
    the first B rows (the cache's batch: rows past it pad the dense
    layers to a pinned count and must not take expert capacity) and pads
    its output back to R rows."""
    if not cfg.is_moe:
        return L.swiglu_mlp(p["mlp"], h2)
    R = h2.shape[0]
    B = R if B is None else B
    return L.pad_rows(L.moe_mlp(p["mlp"], h2[:B], cfg), R)


def _trunk(params, cfg: ModelConfig, tokens=None, collect_cache: bool = False,
           collect_hidden: bool = False, kernels=None, embeds=None):
    """Every layer over the full sequence. Returns (final-normed x,
    caches or None): the cache leaves ("k"/"v", or MLA's "c_kv"/"k_rope")
    with collect_cache, "h" (the post-norm layer inputs) with
    collect_hidden, each stacked (L, B, S, ...). `kernels` selects the GQA
    attention route (kernels.ops backends): on the card under auto / cuda
    every GQA layer launches the prefill kernel; MLA layers run the
    blocked `flash_attention`, as the JAX package does."""
    _check_ported(cfg)
    x = _embed(params, cfg, tokens, embeds)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).expand(B, S)
    windows = build_window_array(cfg)
    names = cache_keys(cfg)
    cols = {n: [] for n in names}
    hs = []
    for i in range(cfg.n_layers):
        p = _layer(params["layers"], i)
        h = L.rms_norm(x, p["norm_attn"], cfg.norm_eps)
        if cfg.attn_kind == "gqa":
            attn_out, pair = L.gqa_attn_full(p["attn"], h, cfg,
                                             int(windows[i]), positions,
                                             kernels=kernels)
        else:
            attn_out, pair = L.mla_attn_full(p["attn"], h, cfg,
                                             int(windows[i]), positions)
        if collect_cache:
            for n, t in zip(names, pair):
                cols[n].append(t)
        if collect_hidden:
            hs.append(h)          # post-norm layer input (EA calibration)
        x = x + attn_out
        h2 = L.rms_norm(x, p["norm_mlp"], cfg.norm_eps)
        x = x + _mlp(p, h2, cfg)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    caches = {n: torch.stack(c) for n, c in cols.items()} \
        if collect_cache else {}
    if collect_hidden:
        caches["h"] = torch.stack(hs)
    return x, (caches or None)


def cache_keys(cfg: ModelConfig) -> Tuple[str, str]:
    """The two sequence-indexed cache leaves of a model."""
    return ("k", "v") if cfg.attn_kind == "gqa" else ("c_kv", "k_rope")


def forward(params, cfg: ModelConfig, tokens=None,
            collect_cache: bool = False, collect_hidden: bool = False,
            kernels=None, embeds=None):
    """Full-sequence forward over `tokens` (B, S) or the frontend's
    `embeds` (B, S, d). Returns (logits (B, S, V), caches or None)."""
    x, caches = _trunk(params, cfg, tokens, collect_cache, collect_hidden,
                       kernels=kernels, embeds=embeds)
    return x @ _head(params, cfg), caches


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               quant: bool = False, device="cuda") -> Dict[str, Any]:
    """Zeroed decode cache. GQA quant=True: int8 k/v plus per-(position,
    head) float32 scales (the layout the int8 rungs use). MLA: the latent
    c_kv and k_rope (no int8 form)."""
    _check_ported(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(dtype or cfg.dtype)
    Ln = cfg.n_layers
    c: Dict[str, Any] = {"lengths": torch.zeros((batch,), dtype=torch.int32,
                                                device=dev)}
    if cfg.attn_kind == "mla":
        if quant:
            raise ValueError("int8 caches need k/v; MLA keeps latents")
        m = cfg.mla
        c["c_kv"] = torch.zeros((Ln, batch, max_len, m.kv_lora_rank),
                                dtype=dtype, device=dev)
        c["k_rope"] = torch.zeros((Ln, batch, max_len, m.qk_rope_dim),
                                  dtype=dtype, device=dev)
        return c
    kv_shape = (Ln, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    kv_dtype = torch.int8 if quant else dtype
    c["k"] = torch.zeros(kv_shape, dtype=kv_dtype, device=dev)
    c["v"] = torch.zeros(kv_shape, dtype=kv_dtype, device=dev)
    if quant:
        s_shape = kv_shape[:-1]
        c["k_scale"] = torch.zeros(s_shape, dtype=torch.float32, device=dev)
        c["v_scale"] = torch.zeros(s_shape, dtype=torch.float32, device=dev)
    return c


def prefill(params, cfg: ModelConfig, tokens=None,
            max_len: Optional[int] = None, lengths=None, kernels=None,
            embeds=None):
    """Run the full prompt (`tokens` (B, S), or `embeds` (B, S, d)),
    return (last_logits (B, V), cache).

    The prompt is right-padded to S; `lengths` (B,) gives true lengths
    (default S). Cache arrays are padded to `max_len` (default S). Logits
    are computed at each item's last valid position only (the JAX package
    computes them everywhere and keeps that one: the same numbers, without
    a B x S x V tensor). `kernels` selects the attention route, as in
    `_trunk`."""
    x, caches = _trunk(params, cfg, tokens, collect_cache=True,
                       kernels=kernels, embeds=embeds)
    B, S = x.shape[:2]
    dev = x.device
    max_len = max_len or S
    lengths = (torch.full((B,), S, dtype=torch.int32, device=dev)
               if lengths is None else lengths.to(device=dev,
                                                  dtype=torch.int32))
    dtype = torch_dtype(cfg.dtype)
    cache: Dict[str, Any] = {"lengths": lengths}
    for name in cache_keys(cfg):
        src = caches[name].to(dtype)              # (L, B, S, ...)
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


def _rows_in(params, cfg: ModelConfig, tokens, embeds, R: int):
    """The decode input (R, Lq, d): embeddings of `tokens` or the
    frontend's `embeds`, padded to R rows."""
    if embeds is not None:
        return L.pad_rows(_embed(params, cfg, embeds=embeds), R)
    return _embed(params, cfg, L.pad_rows(tokens, R))


def decode_step(params, cfg: ModelConfig, cache, tokens=None, kernels=None,
                rows=None, embeds=None):
    """One decode step. tokens: (B, 1) (or embeds (B, 1, d)). Returns
    (logits (B, V), new_cache). The new token sits at position
    cache["lengths"]; lengths are incremented in the returned cache.
    `rows` pins the dense layers' row count (see decode_multi)."""
    _check_ported(cfg)
    pos = cache["lengths"].long()                 # (B,)
    new_len = (pos + 1).to(torch.int32)
    B = pos.shape[0]
    R = max(B, rows or B)
    x = _rows_in(params, cfg, tokens, embeds, R)  # (R, 1, d)
    bidx = torch.arange(B, device=x.device)
    windows = build_window_array(cfg)
    quant = "k_scale" in cache
    for i in range(cfg.n_layers):
        p = _layer(params["layers"], i)
        h = L.rms_norm(x, p["norm_attn"], cfg.norm_eps)
        if cfg.attn_kind == "mla":
            ckv_new, krope_new = L.mla_latents(
                p["attn"], h, cfg, L.pad_rows((new_len - 1)[:, None], R))
            cc, cr = cache["c_kv"][i], cache["k_rope"][i]
            cc[bidx, pos] = ckv_new[:B, 0].to(cc.dtype)
            cr[bidx, pos] = krope_new[:B, 0].to(cr.dtype)
            x = x + L.mla_attn_decode(p["attn"], h, cfg, int(windows[i]),
                                      cc, cr, new_len)
        else:
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
            x = x + L.gqa_attn_decode(p["attn"], h, cfg, int(windows[i]),
                                      ck, cv, new_len, kernels=kernels,
                                      k_scale=k_sc, v_scale=v_sc)
        h2 = L.rms_norm(x, p["norm_mlp"], cfg.norm_eps)
        x = x + _mlp(p, h2, cfg, B)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x[:, 0] @ _head(params, cfg))[:B]
    new_cache = dict(cache)
    new_cache["lengths"] = new_len
    return logits, new_cache


def supports_fused_decode(cfg: ModelConfig) -> bool:
    """Fused multi-token decode covers GQA caches only; MLA decodes token
    by token (`decode_step`), as in the JAX package."""
    return cfg.attn_kind == "gqa"


def decode_multi(params, cfg: ModelConfig, cache, tokens=None, kernels=None,
                 rows=None, embeds=None):
    """Fused multi-token decode: all Lq query tokens in one pass, one
    attention launch per layer. tokens: (B, Lq) (or embeds (B, Lq, d)).
    Returns (logits (B, V) of the LAST query token, new_cache); the Lq k/v
    land at positions lengths .. lengths+Lq-1 and attention is causal per
    query token. GQA only (`supports_fused_decode`).

    `rows` (>= B) pins the row count of the dense layers (projections,
    SwiGLU, the head, and the row-wise norms, RoPE and quantisation
    between them): their inputs are padded with copies of row 0 to `rows`
    rows, so a matmul library that picks its algorithm by M (cuBLAS does)
    rounds an item's row the same whatever batch the item is decoded in.
    Only the attention, the cache writes and an MoE layer's router see the
    B real rows."""
    if not supports_fused_decode(cfg):
        raise ValueError(f"decode_multi supports attn_kind='gqa' only, got "
                         f"{cfg.attn_kind!r}")
    pos0 = cache["lengths"].long()
    B = pos0.shape[0]
    Lq = (tokens if embeds is None else embeds).shape[1]
    R = max(B, rows or B)
    new_len = (pos0 + Lq).to(torch.int32)
    x = _rows_in(params, cfg, tokens, embeds, R)  # (R, Lq, d)
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
        x = x + _mlp(p, h2, cfg, B)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x[:, -1] @ _head(params, cfg))[:B]
    new_cache = dict(cache)
    new_cache["lengths"] = new_len
    return logits, new_cache
