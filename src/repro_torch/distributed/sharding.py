"""Logical-axis sharding rules, the port of `repro.distributed.sharding`.

Model code names tensor axes logically ("batch", "heads", "ff", ...;
`models.transformer.param_axes` / `cache_axes`). A rules mapping resolves
the logical names to mesh axes: `resolve` gives the entries of the
PartitionSpec the JAX package would build, as a plain tuple (None =
replicated along that dimension, trailing Nones dropped).

Mesh layout of the JAX package's production meshes:
    single-pod: (data=16, model=16)
    multi-pod:  (pod=2, data=16, model=16)

Parallelism mapping:
    DP   : batch            -> ("pod", "data")
    TP   : heads / ff / vocab -> "model"
    EP   : expert           -> "model"
    FSDP : embed (param d_model rows of big matrices) -> "data"  (optional)
    SP   : cache_seq        -> "data" for long-context decode (batch=1)

On one card every rule resolves to replicated: the dispatch mesh
(`launch.mesh`) holds its devices on the "data" axis one per shard, and
an engine's weights go whole onto each shard's device
(`ServingEngine.place_on`). The port has no counterpart of the JAX
package's `sc` (`with_sharding_constraint`) or `replicated_on`: PyTorch
tensors carry no sharding, and no path of the port splits a tensor
across devices, so nothing on the run path reads these rules yet.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

Axes = Union[None, str, Tuple[str, ...]]

# logical axis -> mesh axes
DEFAULT_RULES: Dict[str, Axes] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,          # d_model dim of activations (replicated)
    "vocab": "model",
    "heads": "model",       # fused head*d_head projection columns
    "kv_heads": "model",    # KV-head dim of decode caches
    "ff": "model",
    "expert": "model",
    "ffe": None,            # per-expert FFN width; "model" under 2D EP
    "kv_lora": None,
    "cache_seq": None,      # set to "data" for long_500k SP decode
    "cache_batch": ("pod", "data"),
    "layers": None,
    "fsdp": None,           # set to "data" to FSDP-shard big param rows
    "opt_fsdp": "data",     # ZeRO-1: Adam moments sharded over data
}


class _State(threading.local):
    def __init__(self):
        self.rules: Optional[Dict[str, Axes]] = None
        self.mesh_axes: Tuple[str, ...] = ()


_STATE = _State()


def _axis_names(mesh) -> Tuple[str, ...]:
    """A mesh object's axis names, or the names themselves."""
    names = getattr(mesh, "axis_names", mesh)
    return tuple(names)


@contextlib.contextmanager
def use_rules(rules: Dict[str, Axes], mesh):
    """Activate `rules` over `mesh` (a `launch.mesh.Mesh`, or a sequence
    of axis names) for this thread; nests and restores."""
    prev = (_STATE.rules, _STATE.mesh_axes)
    _STATE.rules = rules
    _STATE.mesh_axes = _axis_names(mesh)
    try:
        yield
    finally:
        _STATE.rules, _STATE.mesh_axes = prev


def make_rules(**overrides) -> Dict[str, Axes]:
    r = dict(DEFAULT_RULES)
    r.update(overrides)
    return r


def resolve(axes: Sequence[Optional[str]]) -> Tuple[Axes, ...]:
    """Logical axes -> the PartitionSpec's entries under the active rules
    (mesh axes the mesh lacks drop out; trailing Nones are dropped)."""
    rules, mesh_axes = _STATE.rules, _STATE.mesh_axes
    if rules is None:
        raise RuntimeError("resolve() needs active rules (use_rules)")
    out = []
    for a in axes:
        m = rules.get(a) if a is not None else None
        if isinstance(m, tuple):
            m = tuple(x for x in m if x in mesh_axes) or None
            if m is not None and len(m) == 1:
                m = m[0]
        elif isinstance(m, str) and m not in mesh_axes:
            m = None
        out.append(m)
    while out and out[-1] is None:   # trailing Nones are implicit
        out.pop()
    return tuple(out)


def pspec_tree(axes_tree):
    """Map a tree (nested dicts) whose leaves are logical-axes tuples to
    PartitionSpec entry tuples. Requires active rules (`use_rules`)."""
    if isinstance(axes_tree, dict):
        return {k: pspec_tree(v) for k, v in axes_tree.items()}
    return resolve(axes_tree)
