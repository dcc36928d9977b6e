"""Shape stand-ins and shardings for every (arch x shape) cell.

The port of `repro.launch.specs`. Where the JAX package builds
`jax.ShapeDtypeStruct`s, the port builds tensors on the "meta" device:
shape and dtype, no storage, so the bytes a step will hold can be
reckoned before anything is allocated (`tree_bytes`). Shardings resolve
the logical axes with the port's rules (`distributed/sharding.py`) over a
`launch.mesh.Mesh`; on one card every rule resolves to replicated.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import torch_dtype
from repro_torch.distributed import sharding as sh
from repro_torch.models.transformer import init_cache, model_template
from repro_torch.training.optimizer import AdamWState
from repro_torch.training.tree import leaves, map_axes, tree_map

PyTree = Any
META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _map_specs(tmpl, fn):
    return {k: (_map_specs(v, fn) if isinstance(v, dict) else fn(v))
            for k, v in sorted(tmpl.items())}


def params_sds(cfg: ModelConfig) -> PyTree:
    """Meta tensors matching `init_params` exactly (Mamba's A_log float32
    whatever the model dtype)."""
    dtype = torch_dtype(cfg.dtype)
    return _map_specs(model_template(cfg), lambda spec: _sds(
        spec.shape, torch.float32 if spec.init == "alog" else dtype))


def opt_state_sds(cfg: ModelConfig) -> AdamWState:
    p = params_sds(cfg)
    f32 = lambda s: _sds(s.shape, torch.float32)  # noqa: E731
    return AdamWState(step=_sds((), torch.int32), m=tree_map(f32, p),
                      v=tree_map(f32, p))


def cache_sds(cfg: ModelConfig, batch: int, max_len: int,
              quant: bool = False) -> PyTree:
    return init_cache(cfg, batch, max_len, quant=quant, device=META)


def batch_sds(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    dtype = torch_dtype(cfg.dtype)
    if shape.kind == "decode":
        if cfg.frontend == "none":
            return {"tokens": _sds((B, 1), torch.int32)}
        return {"embeds": _sds((B, 1, cfg.d_model), dtype)}
    if cfg.frontend == "none":
        return {"tokens": _sds((B, S), torch.int32)}
    return {"embeds": _sds((B, S, cfg.d_model), dtype),
            "labels": _sds((B, S), torch.int32)}


def tree_bytes(tree) -> int:
    """Bytes of every tensor leaf of `tree` (meta tensors included)."""
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def batch_axes(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    if shape.kind == "decode":
        if cfg.frontend == "none":
            return {"tokens": ("batch", None)}
        return {"embeds": ("batch", None, None)}
    if cfg.frontend == "none":
        return {"tokens": ("batch", "seq")}
    return {"embeds": ("batch", "seq", None),
            "labels": ("batch", "seq")}


def _n_devices(mesh) -> int:
    return mesh.size


def rules_for(cfg: ModelConfig, shape: ShapeConfig, mesh,
              fsdp: Optional[str] = "data") -> Dict[str, Any]:
    """Sharding rules for one cell, as the reference's:

    - train/prefill: DP over (pod, data), TP/EP over model, FSDP over data.
    - decode: params replicated over data (serving replicas) unless TP
      alone leaves more than 8 GB a device; cache batch over (pod, data).
      When n_kv_heads doesn't divide the model axis (or MLA's latent
      caches), the cache *sequence* dim is sharded over model instead.
    - a batch that the data axis does not divide: sequence parallelism,
      cache_seq additionally over data.
    """
    model_size = mesh.shape["model"]
    dp_size = _n_devices(mesh) // model_size
    overrides: Dict[str, Any] = {}
    if shape.kind == "decode":
        tp_bytes = 2.0 * cfg.n_params / model_size
        overrides["fsdp"] = "data" if tp_bytes > 8e9 else None
        seq_axes = []
        kv_shardable = (cfg.attn_kind in ("gqa", "hymba")
                        and cfg.n_kv_heads % model_size == 0)
        if not kv_shardable:
            overrides["kv_heads"] = None
            seq_axes.append("model")
        if shape.global_batch % dp_size != 0:
            overrides["batch"] = None
            overrides["cache_batch"] = None
            seq_axes.insert(0, "data")
        if seq_axes:
            overrides["cache_seq"] = (tuple(seq_axes) if len(seq_axes) > 1
                                      else seq_axes[0])
    else:
        overrides["fsdp"] = fsdp
    return sh.make_rules(**overrides)


class NamedSharding(NamedTuple):
    """A placement: the mesh and the PartitionSpec's entries (`sh.resolve`)."""
    mesh: Any
    spec: Tuple[Any, ...]


def shardings_for(tree_axes: PyTree, mesh) -> PyTree:
    """Logical-axes tree -> NamedSharding tree (active rules required:
    `sh.use_rules`)."""
    return map_axes(lambda axes: NamedSharding(mesh, sh.resolve(axes)),
                    tree_axes)
