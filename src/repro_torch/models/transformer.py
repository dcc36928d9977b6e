"""Config-driven decoder LM in PyTorch: params, forward, prefill, decode.

The port of `repro.models.transformer` for every registered family: dense
and MoE GQA (granite, minitron, gemma3, llava, musicgen, dbrx,
stretto-llama-8b), MLA with MoE (deepseek-v2-lite) or dense (minicpm3),
hymba (GQA heads beside Mamba heads) and rwkv6. Parameters keep the JAX
package's layout: a nested dict whose per-layer leaves are stacked along
a leading layer axis L under the same key names, e.g. for GQA

    {"embed": (V, d), "final_norm": (d,), "head": (d, V),
     "layers": {"attn": {"wq", "wk", "wv", "wo"},
                "mlp": {"w_gate", "w_up", "w_down"},
                "norm_attn": (L, d), "norm_mlp": (L, d)}}

with MLA's attention leaves ("wq" or "wq_a" / "wq_b", "w_kv_a", "kv_norm",
"w_kv_b", "wo"), MoE's feed-forward ("router", "experts": {"w_gate",
"w_up", "w_down"} (L, E, ...), "shared"), hymba's {"attn": GQA's,
"ssm": Mamba's, "norm_attn", "norm_ssm"} and rwkv6's time mix / channel
mix as `layer_template` lists them. Caches are {"k", "v": (L, B, S, KV,
dh), "lengths": (B,)} for GQA (int8 caches add "k_scale", "v_scale":
(L, B, S, KV)), {"c_kv": (L, B, S, r), "k_rope": (L, B, S, rope),
"lengths"} for MLA; hymba adds to GQA's the states "conv" (L, B, K-1, di)
and "ssm" (L, B, di, ds) float32, and rwkv6 keeps only states: "wkv"
(L, B, H, hd, hd) float32, "tm_prev" and "cm_prev" (L, B, d). A Python
loop over layers takes the place of the JAX layer scan; the per-layer
window is a plain int.

Decode writes the new tokens' cache rows into the cache tensors in place,
at positions cache["lengths"] and beyond. No earlier result reads those
positions, and a later flush over the same tensors (the engine's
device-resident cache, which lets one flush at a time decode over an
entry) overwrites them with its own query before reading them, so
results match the JAX package's functional update. The recurrent states
are never written in place: the returned cache holds new state tensors.

Pinned rows (`rows=` of the decode paths) pad the dense layers' inputs,
never the MoE router's: the router sees exactly the cache's batch, as in
the JAX package, because an MoE layer's capacity depends on its token
count. The SSM mixers' matmuls take the pinned rows too, with their
states padded like the inputs.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import layers as L


class ParamSpec(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axes, parallel to shape
    init: str = "normal"              # normal | zeros | ones | alog

# sequence-indexed cache leaves; every other leaf but "lengths" is a state
SEQ_KEYS = ("k", "v", "c_kv", "k_rope")
# states kept in float32 whatever the model dtype
F32_STATES = ("ssm", "wkv")


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


def _mamba_template(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, s = cfg.d_model, cfg.ssm
    di = s.expand * d
    rank = max(16, d // 32)
    return {
        "w_in": ParamSpec((d, 2 * di), ("fsdp", "ff")),
        "conv_w": ParamSpec((di, s.d_conv), ("ff", None)),
        "conv_b": ParamSpec((di,), ("ff",), "zeros"),
        "w_dt_a": ParamSpec((di, rank), ("ff", None)),
        "w_dt_b": ParamSpec((rank, di), (None, "ff")),
        "dt_bias": ParamSpec((di,), ("ff",), "zeros"),
        "w_B": ParamSpec((di, s.d_state), ("ff", None)),
        "w_C": ParamSpec((di, s.d_state), ("ff", None)),
        "A_log": ParamSpec((di, s.d_state), ("ff", None), "alog"),
        "D": ParamSpec((di,), ("ff",), "ones"),
        "w_out": ParamSpec((di, d), ("ff", "fsdp")),
    }


def _rwkv_template(cfg: ModelConfig) -> Dict[str, Any]:
    """rwkv6's time mix ("attn") and channel mix ("mlp")."""
    d, ff = cfg.d_model, cfg.d_ff_channel_mix
    H, hd = cfg.rwkv_n_heads, cfg.rwkv_head_size
    dec_rank = 64
    mix = {
        **{f"mu_{n}": ParamSpec((d,), (None,), "zeros") for n in "rkvwg"},
        "w_r": ParamSpec((d, d), ("fsdp", "heads")),
        "w_k": ParamSpec((d, d), ("fsdp", "heads")),
        "w_v": ParamSpec((d, d), ("fsdp", "heads")),
        "w_g": ParamSpec((d, d), ("fsdp", "heads")),
        "w_o": ParamSpec((d, d), ("heads", "fsdp")),
        "w_dec_a": ParamSpec((d, dec_rank), ("fsdp", None)),
        "w_dec_b": ParamSpec((dec_rank, d), (None, "heads"), "zeros"),
        "w0": ParamSpec((d,), ("heads",), "ones"),
        "u": ParamSpec((d,), ("heads",), "zeros"),
        "ln_w": ParamSpec((H, hd), ("heads", None), "ones"),
        "ln_b": ParamSpec((H, hd), ("heads", None), "zeros"),
    }
    cmix = {
        "mu_k": ParamSpec((d,), (None,), "zeros"),
        "mu_r": ParamSpec((d,), (None,), "zeros"),
        "w_k": ParamSpec((d, ff), ("fsdp", "ff")),
        "w_v": ParamSpec((ff, d), ("ff", "fsdp")),
        "w_r": ParamSpec((d, d), ("fsdp", None)),
    }
    return {"attn": mix, "mlp": cmix}


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
    """One layer's ParamSpecs, as the JAX template lists them."""
    d = cfg.d_model
    if cfg.attn_kind == "rwkv6":
        t = _rwkv_template(cfg)
    else:
        if cfg.attn_kind == "gqa":
            attn = _attn_template(cfg)
        elif cfg.attn_kind == "mla":
            attn = _mla_template(cfg)
        elif cfg.attn_kind == "hymba":
            attn = {"attn": _attn_template(cfg),
                    "ssm": _mamba_template(cfg),
                    "norm_attn": ParamSpec((d,), (None,), "zeros"),
                    "norm_ssm": ParamSpec((d,), (None,), "zeros")}
        else:
            raise ValueError(cfg.attn_kind)
        mlp = _moe_template(cfg) if cfg.is_moe else _mlp_template(cfg)
        t = {"attn": attn, "mlp": mlp}
    t["norm_attn"] = ParamSpec((d,), (None,), "zeros")
    t["norm_mlp"] = ParamSpec((d,), (None,), "zeros")
    return t


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
    a: Dict[str, Any] = {"lengths": ("cache_batch",)}
    if cfg.attn_kind in ("gqa", "hymba"):
        kv = ("layers", "cache_batch", "cache_seq", "kv_heads", None)
        a["k"] = kv
        a["v"] = kv
        if quant:
            a["k_scale"] = kv[:-1]
            a["v_scale"] = kv[:-1]
    if cfg.attn_kind == "mla":
        a["c_kv"] = ("layers", "cache_batch", "cache_seq", None)
        a["k_rope"] = ("layers", "cache_batch", "cache_seq", None)
    if cfg.attn_kind == "hymba":
        a["conv"] = ("layers", "cache_batch", None, "ff")
        a["ssm"] = ("layers", "cache_batch", "ff", None)
    if cfg.attn_kind == "rwkv6":
        a["wkv"] = ("layers", "cache_batch", "heads", None, None)
        a["tm_prev"] = ("layers", "cache_batch", None)
        a["cm_prev"] = ("layers", "cache_batch", None)
    return a


def _map_template(tmpl, fn, path=()):
    return {k: (_map_template(v, fn, path + (k,)) if isinstance(v, dict)
                else fn(path + (k,), v))
            for k, v in sorted(tmpl.items())}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", dtype=None) -> Dict[str, Any]:
    """Random weights: normal x 0.02, drawn in float32 from `generator`
    and cast to `dtype` (default cfg.dtype); zeros and ones where the
    template says so, and Mamba's A_log = log(1 .. d_state) per row in
    float32 whatever the dtype, as in the JAX package. Stacked layer
    leaves are drawn one layer at a time to bound the float32 scratch.
    The numbers differ from `jax.random`'s."""
    dev = resolve_device(device)
    dtype = torch_dtype(dtype or cfg.dtype)

    def make(path, spec):
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=dev)
        if spec.init == "alog":
            ds = spec.shape[-1]
            a = torch.log(torch.arange(1, ds + 1, dtype=torch.float32,
                                       device=dev))
            return a.expand(spec.shape).contiguous()
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
    leaf of `model_template` (the nested hymba and rwkv6 trees included).
    `dtype` casts every leaf but Mamba's float32 A_log."""
    dev = resolve_device(device)
    dtype = torch_dtype(dtype) if dtype is not None else None

    def take(path, spec):
        node = np_tree
        for k in path:
            node = node[k]
        t = _to_torch(node, dev, None if spec.init == "alog" else dtype)
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


def _mixer_full(p, h, cfg: ModelConfig, window: int, positions, kernels,
                differentiable: bool = False):
    """One layer's token mixer over the full sequence: (out, its cache
    leaves by name)."""
    kind = cfg.attn_kind
    if kind == "gqa":
        out, (k, v) = L.gqa_attn_full(p["attn"], h, cfg, window, positions,
                                      kernels=kernels,
                                      differentiable=differentiable)
        return out, {"k": k, "v": v}
    if kind == "mla":
        out, (c_kv, k_rope) = L.mla_attn_full(p["attn"], h, cfg, window,
                                              positions)
        return out, {"c_kv": c_kv, "k_rope": k_rope}
    if kind == "hymba":
        out, (k, v), (conv, ssm) = L.hymba_mix_full(
            p["attn"], h, cfg, window, positions, kernels=kernels,
            differentiable=differentiable)
        return out, {"k": k, "v": v, "conv": conv, "ssm": ssm}
    out, (wkv, tm_prev) = L.rwkv6_mix_full(p["attn"], h, cfg)
    return out, {"wkv": wkv, "tm_prev": tm_prev}


def _layer_full(cfg: ModelConfig, p, x, window: int, positions, kernels,
                differentiable: bool):
    """One layer over the full sequence: (x, its cache leaves, h the
    post-norm layer input)."""
    h = L.rms_norm(x, p["norm_attn"], cfg.norm_eps)
    attn_out, leaves = _mixer_full(p, h, cfg, window, positions, kernels,
                                   differentiable)
    x = x + attn_out
    h2 = L.rms_norm(x, p["norm_mlp"], cfg.norm_eps)
    if cfg.attn_kind == "rwkv6":
        x = x + L.rwkv_channel_mix(p["mlp"], h2, L._token_shift(h2))
        leaves["cm_prev"] = h2[:, -1]
    else:
        x = x + _mlp(p, h2, cfg)
    return x, leaves, h


REMAT_POLICIES = ("none", "dots")


def _saves_dots(ctx, op, *args, **kwargs):
    """The "dots" policy, the counterpart of JAX's
    `dots_with_no_batch_dims_saveable`: keep the weight products
    (`aten.mm`: every x @ W folds to one), recompute the rest, the
    batched attention einsums (`aten.bmm`) included."""
    if op is torch.ops.aten.mm.default:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _rematted(layer, remat_policy: str):
    """`layer` under activation checkpointing: "none" saves nothing and
    recomputes the layer in the backward, "dots" saves its weight
    products (a selective checkpoint)."""
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {remat_policy!r}; expected "
                         f"one of {REMAT_POLICIES}")
    kw = {}
    if remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _saves_dots)

    def run(*args):
        return ckpt.checkpoint(layer, *args, use_reentrant=False, **kw)
    return run


def _trunk(params, cfg: ModelConfig, tokens=None, collect_cache: bool = False,
           collect_hidden: bool = False, kernels=None, embeds=None,
           remat: bool = False, remat_policy: str = "none",
           differentiable: bool = False):
    """Every layer over the full sequence. Returns (final-normed x,
    caches or None): the `cache_keys` leaves with collect_cache, "h" (the
    post-norm layer inputs) with collect_hidden, each stacked (L, B, ...).
    `kernels` selects the GQA attention route (kernels.ops backends): on
    the card under auto / cuda every GQA layer (hymba's attention heads
    too) launches the prefill kernel; MLA layers run the blocked
    `flash_attention`, as the JAX package does. `differentiable` sends
    every attention to the blocked `flash_attention` (the kernels have
    no backward); `remat` checkpoints each layer under `remat_policy`."""
    x = _embed(params, cfg, tokens, embeds)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).expand(B, S)
    windows = build_window_array(cfg)
    names = cache_keys(cfg)
    cols = {n: [] for n in names}
    hs = []

    def layer(p, x, window):
        return _layer_full(cfg, p, x, window, positions, kernels,
                           differentiable)
    if remat:
        layer = _rematted(layer, remat_policy)
    for i in range(cfg.n_layers):
        x, leaves, h = layer(_layer(params["layers"], i), x, int(windows[i]))
        if collect_hidden:
            hs.append(h)          # post-norm layer input (EA calibration)
        if collect_cache:
            for n in names:
                cols[n].append(leaves[n])
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    caches = {n: torch.stack(c) for n, c in cols.items()} \
        if collect_cache else {}
    if collect_hidden:
        caches["h"] = torch.stack(hs)
    return x, (caches or None)


def cache_keys(cfg: ModelConfig) -> Tuple[str, ...]:
    """The cache leaves a model's prefill fills (all but "lengths"): the
    sequence-indexed ones (SEQ_KEYS), then the recurrent states."""
    return {"gqa": ("k", "v"), "mla": ("c_kv", "k_rope"),
            "hymba": ("k", "v", "conv", "ssm"),
            "rwkv6": ("wkv", "tm_prev", "cm_prev")}[cfg.attn_kind]


def _state_dtype(name: str, dtype):
    return torch.float32 if name in F32_STATES else dtype


def forward(params, cfg: ModelConfig, tokens=None,
            collect_cache: bool = False, collect_hidden: bool = False,
            kernels=None, embeds=None, remat: bool = False,
            remat_policy: str = "none", differentiable: bool = False):
    """Full-sequence forward over `tokens` (B, S) or the frontend's
    `embeds` (B, S, d). Returns (logits (B, S, V), caches or None).

    Training passes `differentiable=True`: GQA and hymba's attention
    heads then take the blocked `flash_attention` (the JAX package's
    route for this code) on any device, since the prefill kernel has no
    backward (reached under autograd it raises). `remat` checkpoints
    each layer (`torch.utils.checkpoint`, non-reentrant): policy "none"
    saves nothing, "dots" the weight products, as the JAX package's
    `nothing_saveable` / `dots_with_no_batch_dims_saveable`."""
    x, caches = _trunk(params, cfg, tokens, collect_cache, collect_hidden,
                       kernels=kernels, embeds=embeds, remat=remat,
                       remat_policy=remat_policy,
                       differentiable=differentiable)
    return x @ _head(params, cfg), caches


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               quant: bool = False, device="cuda") -> Dict[str, Any]:
    """Zeroed decode cache. GQA / hymba quant=True: int8 k/v plus
    per-(position, head) float32 scales (the layout the int8 rungs use).
    MLA: the latent c_kv and k_rope (no int8 form). Hymba adds its conv
    and float32 ssm states, rwkv6 keeps only states (no int8 form)."""
    dev = resolve_device(device)
    dtype = torch_dtype(dtype or cfg.dtype)
    Ln, kind = cfg.n_layers, cfg.attn_kind
    if quant and kind not in ("gqa", "hymba"):
        raise ValueError(f"int8 caches need k/v; attn_kind={kind!r} has "
                         f"none")

    def zeros(name, *shape):
        return torch.zeros((Ln, batch) + shape,
                           dtype=_state_dtype(name, dtype), device=dev)

    c: Dict[str, Any] = {"lengths": torch.zeros((batch,), dtype=torch.int32,
                                                device=dev)}
    if kind in ("gqa", "hymba"):
        kv_shape = (Ln, batch, max_len, cfg.n_kv_heads, cfg.d_head)
        kv_dtype = torch.int8 if quant else dtype
        c["k"] = torch.zeros(kv_shape, dtype=kv_dtype, device=dev)
        c["v"] = torch.zeros(kv_shape, dtype=kv_dtype, device=dev)
        if quant:
            s_shape = kv_shape[:-1]
            c["k_scale"] = torch.zeros(s_shape, dtype=torch.float32,
                                       device=dev)
            c["v_scale"] = torch.zeros(s_shape, dtype=torch.float32,
                                       device=dev)
    if kind == "mla":
        m = cfg.mla
        c["c_kv"] = zeros("c_kv", max_len, m.kv_lora_rank)
        c["k_rope"] = zeros("k_rope", max_len, m.qk_rope_dim)
    if kind == "hymba":
        di = cfg.ssm.expand * cfg.d_model
        c["conv"] = zeros("conv", cfg.ssm.d_conv - 1, di)
        c["ssm"] = zeros("ssm", di, cfg.ssm.d_state)
    if kind == "rwkv6":
        hd = cfg.rwkv_head_size
        c["wkv"] = zeros("wkv", cfg.rwkv_n_heads, hd, hd)
        c["tm_prev"] = zeros("tm_prev", cfg.d_model)
        c["cm_prev"] = zeros("cm_prev", cfg.d_model)
    return c


def prefill(params, cfg: ModelConfig, tokens=None,
            max_len: Optional[int] = None, lengths=None, kernels=None,
            embeds=None):
    """Run the full prompt (`tokens` (B, S), or `embeds` (B, S, d)),
    return (last_logits (B, V), cache).

    The prompt is right-padded to S; `lengths` (B,) gives true lengths
    (default S). Sequence-indexed cache arrays are padded to `max_len`
    (default S); the states are those after all S positions, pad
    positions included, as in the JAX package. Logits
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
        src = caches[name].to(_state_dtype(name, dtype))   # (L, B, ...)
        if name in SEQ_KEYS and max_len != S:
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


def _insert_seq(buf, new, bidx, pos, uniform: bool):
    """Write new (B, ...) into buf (B, S, ...) at each item's position pos
    (B,), in place. `uniform`: every item at pos[0], one slice copy, its
    start clamped so the row fits (the JAX package's
    `dynamic_update_slice_in_dim`)."""
    if uniform:
        buf.index_copy_(1, pos[:1].clamp(0, buf.shape[1] - 1), new[:, None])
    else:
        buf[bidx, pos] = new


def decode_step(params, cfg: ModelConfig, cache, tokens=None, kernels=None,
                rows=None, embeds=None, uniform_pos: bool = False):
    """One decode step. tokens: (B, 1) (or embeds (B, 1, d)). Returns
    (logits (B, V), new_cache). The new token sits at position
    cache["lengths"]; lengths are incremented in the returned cache.
    `uniform_pos`: every item sits at the same position, and the new K/V
    is written with one slice copy per cache tensor.
    `rows` pins the dense layers' row count (see decode_multi), the SSM
    mixers' included: their states are padded to `rows` like the inputs,
    and the returned cache holds new state tensors of the B real rows.
    On an int8 cache hymba's mixer sees k / v dequantised up front in
    bfloat16, as in the JAX package (its mixer is not int8-aware)."""
    pos = cache["lengths"].long()                 # (B,)
    new_len = (pos + 1).to(torch.int32)
    B = pos.shape[0]
    R = max(B, rows or B)
    x = _rows_in(params, cfg, tokens, embeds, R)  # (R, 1, d)
    bidx = torch.arange(B, device=x.device)
    windows = build_window_array(cfg)
    quant = "k_scale" in cache
    kind = cfg.attn_kind
    states = {n: [] for n in cache_keys(cfg) if n not in SEQ_KEYS}

    def state(name, i):
        return L.pad_rows(cache[name][i], R)

    def keep(name, t):
        states[name].append(t[:B].to(cache[name].dtype))

    for i in range(cfg.n_layers):
        p = _layer(params["layers"], i)
        h = L.rms_norm(x, p["norm_attn"], cfg.norm_eps)
        if kind == "mla":
            ckv_new, krope_new = L.mla_latents(
                p["attn"], h, cfg, L.pad_rows((new_len - 1)[:, None], R))
            cc, cr = cache["c_kv"][i], cache["k_rope"][i]
            _insert_seq(cc, ckv_new[:B, 0].to(cc.dtype), bidx, pos,
                        uniform_pos)
            _insert_seq(cr, krope_new[:B, 0].to(cr.dtype), bidx, pos,
                        uniform_pos)
            x = x + L.mla_attn_decode(p["attn"], h, cfg, int(windows[i]),
                                      cc, cr, new_len)
        elif kind == "rwkv6":
            out, wkv, tm_prev = L.rwkv6_mix_step(
                p["attn"], h, cfg, state("wkv", i), state("tm_prev", i))
            keep("wkv", wkv)
            keep("tm_prev", tm_prev)
            x = x + out
        else:
            ap = p["attn"]["attn"] if kind == "hymba" else p["attn"]
            k_new, v_new = L.gqa_new_kv(ap, h, cfg, L.pad_rows(new_len, R))
            ck, cv = cache["k"][i], cache["v"][i]
            if quant:
                k_q, ks = _quantize(k_new)
                v_q, vs = _quantize(v_new)
                k_sc, v_sc = cache["k_scale"][i], cache["v_scale"][i]
                for buf, new in ((ck, k_q), (cv, v_q), (k_sc, ks),
                                 (v_sc, vs)):
                    _insert_seq(buf, new[:B, 0], bidx, pos, uniform_pos)
            else:
                _insert_seq(ck, k_new[:B, 0].to(ck.dtype), bidx, pos,
                            uniform_pos)
                _insert_seq(cv, v_new[:B, 0].to(cv.dtype), bidx, pos,
                            uniform_pos)
                k_sc = v_sc = None
            if kind == "gqa":
                x = x + L.gqa_attn_decode(p["attn"], h, cfg, int(windows[i]),
                                          ck, cv, new_len, kernels=kernels,
                                          k_scale=k_sc, v_scale=v_sc)
            else:
                if quant:
                    ck, cv = _dequant_bf16(ck, k_sc), _dequant_bf16(cv, v_sc)
                out, conv, ssm = L.hymba_mix_decode(
                    p["attn"], h, cfg, int(windows[i]), ck, cv, new_len,
                    state("conv", i), state("ssm", i), kernels=kernels)
                keep("conv", conv)
                keep("ssm", ssm)
                x = x + out
        h2 = L.rms_norm(x, p["norm_mlp"], cfg.norm_eps)
        if kind == "rwkv6":
            x = x + L.rwkv_channel_mix(p["mlp"], h2,
                                       state("cm_prev", i)[:, None, :])
            keep("cm_prev", h2[:, 0])
        else:
            x = x + _mlp(p, h2, cfg, B)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x[:, 0] @ _head(params, cfg))[:B]
    new_cache = dict(cache)
    new_cache.update({n: torch.stack(ts) for n, ts in states.items()})
    new_cache["lengths"] = new_len
    return logits, new_cache


def _dequant_bf16(q8, scale):
    """int8 rows times their scales, both cast to bfloat16 first and
    multiplied in bfloat16 (the JAX package's hymba decode)."""
    return q8.to(torch.bfloat16) * scale[..., None].to(torch.bfloat16)


def supports_fused_decode(cfg: ModelConfig) -> bool:
    """Fused multi-token decode covers GQA caches only; MLA and the
    mixers that carry recurrent state (hymba, rwkv6) decode token by
    token (`decode_step`), as in the JAX package."""
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
