"""The parameter layout the benchmark fills, from a configuration file.

The same nested dict of stacked leaves that the port's `init_params`
allocates (its `model_template`), worked out here from the published
keys so that the plain reference can read the weights without the port.
The harness checks, before every run, that the port's template has the
same leaves with the same shapes.

Norm leaves hold the offset from 1 (a scale of 1 + w), as in the port.
The vocabulary is padded to a multiple of 256 rows.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

Leaf = Tuple[Tuple[str, ...], Tuple[int, ...]]


def vocab_padded(model: dict) -> int:
    return (int(model["vocab_size"]) + 255) // 256 * 256


def leaves(model: dict) -> List[Leaf]:
    """(path, shape) of every weight leaf, in sorted path order."""
    d = int(model["hidden_size"])
    L = int(model["num_hidden_layers"])
    H = int(model["num_attention_heads"])
    V = vocab_padded(model)
    out: Dict[Tuple[str, ...], Tuple[int, ...]] = {
        ("embed",): (V, d), ("final_norm",): (d,), ("head",): (d, V),
        ("layers", "norm_attn"): (L, d), ("layers", "norm_mlp"): (L, d)}
    if int(model.get("first_k_dense_replace", 0)):
        raise ValueError("leading dense layers are not laid out: the port "
                         "stacks uniform layers")
    if "kv_lora_rank" in model:
        r, nope = int(model["kv_lora_rank"]), int(model["qk_nope_head_dim"])
        rope, dv = int(model["qk_rope_head_dim"]), int(model["v_head_dim"])
        if model.get("q_lora_rank"):
            raise ValueError("a low-rank query projection is not laid out")
        a = {"wq": (d, H * (nope + rope)), "w_kv_a": (d, r + rope),
             "kv_norm": (r,), "w_kv_b": (r, H * (nope + dv)),
             "wo": (H * dv, d)}
    else:
        KV = int(model["num_key_value_heads"])
        dh = int(model.get("head_dim") or d // H)
        a = {"wq": (d, H * dh), "wk": (d, KV * dh), "wv": (d, KV * dh),
             "wo": (H * dh, d)}
    for k, s in a.items():
        out[("layers", "attn", k)] = (L,) + s
    E = int(model.get("n_routed_experts") or 0)
    if E:
        ffe = int(model["moe_intermediate_size"])
        ffs = int(model.get("n_shared_experts") or 0) * ffe
        out[("layers", "mlp", "router")] = (L, d, E)
        for k, s in (("w_gate", (d, ffe)), ("w_up", (d, ffe)),
                     ("w_down", (ffe, d))):
            out[("layers", "mlp", "experts", k)] = (L, E) + s
        if ffs:
            for k, s in (("w_gate", (d, ffs)), ("w_up", (d, ffs)),
                         ("w_down", (ffs, d))):
                out[("layers", "mlp", "shared", k)] = (L,) + s
    else:
        ff = int(model["intermediate_size"])
        for k, s in (("w_gate", (d, ff)), ("w_up", (d, ff)),
                     ("w_down", (ff, d))):
            out[("layers", "mlp", k)] = (L,) + s
    return sorted(out.items())


ALIGN = 128          # elements: every leaf starts 256-byte aligned in bf16


def offsets(model: dict) -> Tuple[List[Tuple[Tuple[str, ...], Tuple[int, ...],
                                             int]], int]:
    """([(path, shape, offset)], total elements) of the flat buffer."""
    out, off = [], 0
    for path, shape in leaves(model):
        n = 1
        for s in shape:
            n *= s
        out.append((path, shape, off))
        off += (n + ALIGN - 1) // ALIGN * ALIGN
    return out, off


def nest(flat, model: dict) -> dict:
    """The nested dict of views of `flat` (1-D) in the layout."""
    tree: dict = {}
    table, total = offsets(model)
    if flat.numel() < total:
        raise ValueError(f"buffer of {flat.numel()} elements, layout needs "
                         f"{total}")
    for path, shape, off in table:
        n = 1
        for s in shape:
            n *= s
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = flat[off:off + n].view(shape)
    return tree
