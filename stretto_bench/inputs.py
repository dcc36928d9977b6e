"""Every input of a run, made from its seed.

Weights, caches and query statistics are drawn on the device with a
`torch.Generator` of their own stream, in a few large calls, in the type
they are served in (bfloat16). Lengths, token ids and task draws come
from numpy generators on the host. A stream's numbers depend only on the
seed and the stream's name, so the harness can make the same inputs
again, after the program's state is freed, for the plain reference.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from stretto_bench import layout

CHUNK = 1 << 28          # elements per generator call
WEIGHT_STD = 0.02


def stream_seed(seed: int, name: str) -> int:
    """A 63-bit seed for stream `name` of run seed `seed` (any integer)."""
    h = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def host_rng(seed: int, name: str) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, name))


def device_gen(seed: int, name: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, name))
    return g


def fill_normal_(t: torch.Tensor, gen: torch.Generator, std: float):
    """t (contiguous) filled with N(0, std^2), CHUNK elements a call."""
    flat = t.view(-1)
    for i in range(0, flat.numel(), CHUNK):
        flat[i:i + CHUNK].normal_(0.0, std, generator=gen)
    return t


def weights(model: dict, seed: int, device, dtype=torch.bfloat16):
    """(flat buffer, nested dict of its views in the port's layout): every
    leaf N(0, 0.02^2), norm scales included (1 + w, w ~ N(0, 0.02^2))."""
    _, total = layout.offsets(model)
    flat = torch.empty(total, dtype=dtype, device=device)
    fill_normal_(flat, device_gen(seed, "weights", device), WEIGHT_STD)
    return flat, layout.nest(flat, model)


def log_uniform_grid(n: int, lo: int, hi: int) -> List[int]:
    """n lengths at the quantiles (i + 1/2) / n of the log-uniform law on
    [lo, hi]: the same set for every seed."""
    return [int(round(lo * math.exp(math.log(hi / lo) * (i + 0.5) / n)))
            for i in range(n)]


def round_up(n: int, m: int) -> int:
    return (int(n) + m - 1) // m * m


def zero_past_(t: torch.Tensor, lengths: Sequence[int]):
    """Zero t (L, B, S, ...) at positions >= each item's length."""
    for b, n in enumerate(lengths):
        t[:, b, int(n):] = 0
    return t


def cache(model: dict, lengths: Sequence[int], S: int, seed: int, device,
          stds: Dict[str, float], dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """A decode cache in the layout of the port's `init_cache(cfg, B, S)`
    ({"k", "v": (L, B, S, KV, dh)} or MLA's {"c_kv": (L, B, S, r),
    "k_rope": (L, B, S, rope)}, and "lengths" (B,) int32): each leaf
    N(0, stds[leaf]^2) below each item's length, zeros past it."""
    L = int(model["num_hidden_layers"])
    B = len(lengths)
    if "kv_lora_rank" in model:
        shapes = {"c_kv": (L, B, S, int(model["kv_lora_rank"])),
                  "k_rope": (L, B, S, int(model["qk_rope_head_dim"]))}
    else:
        d, H = int(model["hidden_size"]), int(model["num_attention_heads"])
        kv = (L, B, S, int(model["num_key_value_heads"]),
              int(model.get("head_dim") or d // H))
        shapes = {"k": kv, "v": kv}
    out = {}
    for name, shape in shapes.items():
        t = torch.empty(shape, dtype=dtype, device=device)
        fill_normal_(t, device_gen(seed, "cache/" + name, device),
                     float(stds[name]))
        out[name] = zero_past_(t, lengths)
    out["lengths"] = torch.tensor([int(n) for n in lengths],
                                  dtype=torch.int32, device=device)
    return out


def query_stats(model: dict, seed: int, device, std: float,
                dtype=torch.bfloat16):
    """(mu, sig2), each (L, KV, G, dk) (MLA: (L, 1, H, r + rope)), the
    Gaussian of future queries that kernel C scores against: mu
    N(0, std^2), sig2 the square of another N(0, std^2) draw."""
    L = int(model["num_hidden_layers"])
    H = int(model["num_attention_heads"])
    if "kv_lora_rank" in model:
        shape = (L, 1, H, int(model["kv_lora_rank"])
                 + int(model["qk_rope_head_dim"]))
    else:
        d, KV = int(model["hidden_size"]), int(model["num_key_value_heads"])
        shape = (L, KV, H // KV, int(model.get("head_dim") or d // H))
    g = device_gen(seed, "stats", device)
    mu = fill_normal_(torch.empty(shape, dtype=dtype, device=device), g, std)
    sig = fill_normal_(torch.empty(shape, dtype=dtype, device=device), g, std)
    return mu, sig * sig
