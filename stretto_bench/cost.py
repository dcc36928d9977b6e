"""The benchmark's yardstick for work: flops, bytes and the least time.

A frozen copy of the port's per-kernel arithmetic (`kernels/cost.py` of
`repro_torch`, as it stood when this benchmark was defined) and of its
H100 peaks (`launch/mesh.H100_SXM`), plus the flops and bytes of a whole
model step reckoned from shapes. Nothing here imports the port: the
program may change its own copy, and the benchmark keeps pricing with
this one.

Kernels (each input read once, each output written once; flops are what
these inputs need):

  A / B  decode: 4 flops per query row per K or V element of a visible
         row; the visible K/V rows, `scale_bytes` per visible (position,
         head) of int8 scales, q and the output, 4 bytes of length per item
  C      Expected-Attention scores: 4 flops per K element, 2 per stats
         element; k, mu and sig2 and the float32 scores
  D      prefill: 2 (dk + dv) flops per query row per live key; q, k, v
         and the output

Model steps (`decode_step_work`, `prefill_step_work`) count the weights
a step's live rows need, read once, and the flops its live tokens need:
padding rows and padding positions are not work.
"""
from __future__ import annotations

from typing import Iterable, Sequence

# NVIDIA H100 SXM data sheet: bf16 dense tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12          # float32 outside the tensor cores
GLOBAL = 1 << 30


def bound_s(nbytes: float, flops: float, itemsize: int = 2):
    """(seconds, "bytes" | "operations"): the larger of the bytes over the
    memory rate and the flops over the peak rate for 2-byte operands (the
    bf16 tensor cores) or 4-byte ones (float32 outside them)."""
    peak = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_F32_FLOPS
    tb, tf = nbytes / PEAK_BYTES_S, flops / peak
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# ---------------------------------------------------------------------------
# kernels (frozen from repro_torch/kernels/cost.py)
# ---------------------------------------------------------------------------

def decode_visible(lengths: Iterable[int], S: int, Lq: int,
                   window: int) -> int:
    """Cache rows some query row sees, summed over the items."""
    vis = 0
    for n in lengths:
        hi = min(int(n), S)
        lo = max(0, int(n) - Lq - window + 1)
        vis += max(0, hi - lo)
    return vis


def decode_work(B, Lq, KV, G, dk, dv, S, lengths, window, q_itemsize,
                kv_itemsize, scale_bytes=0):
    """(flops, bytes) of one decode call (A with Lq query tokens, B with
    one); `lengths` count the query tokens."""
    vis = decode_visible(lengths, S, Lq, window)
    q_bytes = B * Lq * KV * G * dk * q_itemsize
    nbytes = (vis * KV * ((dk + dv) * kv_itemsize + scale_bytes)
              + q_bytes * (1 + dv / dk) + 4 * B)
    return vis * KV * Lq * G * 2 * (dk + dv), nbytes


def prefill_live_pairs(S: int, window: int, causal: bool) -> int:
    """(query, key) pairs the mask admits, per (item, KV head)."""
    w = min(int(window), GLOBAL)
    if causal:
        if w >= S:
            return S * (S + 1) // 2
        return w * (w + 1) // 2 + (S - w) * w
    if w >= S:
        return S * S
    return S * S - (S - w) * (S - w + 1) // 2


def prefill_work(B, S, KV, G, dk, dv, itemsize, window, causal):
    """(flops, bytes) of one prefill-attention call over S positions."""
    nbytes = (B * S * KV * G * dk + B * S * KV * (dk + dv)
              + B * S * KV * G * dv) * itemsize
    return B * KV * G * prefill_live_pairs(S, window, causal) * 2 * (
        dk + dv), nbytes


def expected_attention_work(k_numel, k_itemsize, stats_numel,
                            stats_itemsize, out_numel):
    """(flops, bytes) of one Expected-Attention call."""
    nbytes = (k_numel * k_itemsize + 2 * stats_numel * stats_itemsize
              + out_numel * 4)
    return k_numel * 4 + 2 * stats_numel * 2, nbytes


# ---------------------------------------------------------------------------
# model steps, from the configuration file's published keys
# ---------------------------------------------------------------------------

def dims(model: dict) -> dict:
    """The sizes a step's arithmetic needs, from a configuration file's
    keys (Hugging Face names)."""
    d = int(model["hidden_size"])
    H = int(model["num_attention_heads"])
    out = {"d": d, "H": H, "L": int(model["num_hidden_layers"]),
           "V": int(model["vocab_size"]),
           "mla": "kv_lora_rank" in model,
           "moe": int(model.get("n_routed_experts") or 0)}
    if out["mla"]:
        out.update(r=int(model["kv_lora_rank"]),
                   nope=int(model["qk_nope_head_dim"]),
                   rope=int(model["qk_rope_head_dim"]),
                   dv=int(model["v_head_dim"]))
    else:
        dh = int(model.get("head_dim") or d // H)
        out.update(KV=int(model["num_key_value_heads"]), dh=dh)
    if out["moe"]:
        out.update(E=out["moe"], k=int(model["num_experts_per_tok"]),
                   ffe=int(model["moe_intermediate_size"]),
                   shared=int(model.get("n_shared_experts") or 0),
                   dense_layers=int(model.get("first_k_dense_replace", 0)),
                   ff=int(model["intermediate_size"]))
    else:
        out.update(ff=int(model["intermediate_size"]))
    return out


def attn_params(m: dict) -> int:
    """One layer's attention projections (the weights of its products)."""
    d, H = m["d"], m["H"]
    if m["mla"]:
        n = d * H * (m["nope"] + m["rope"])                 # wq
        n += d * (m["r"] + m["rope"])                       # w_kv_a
        n += m["r"] * H * (m["nope"] + m["dv"])             # w_kv_b
        return n + H * m["dv"] * d                          # wo
    return 2 * d * H * m["dh"] + 2 * d * m["KV"] * m["dh"]


def norm_params(m: dict) -> int:
    """One layer's norm scales (MLA's latent norm too)."""
    return 2 * m["d"] + (m["r"] if m["mla"] else 0)


def expected_experts(E: int, k: int, T: int) -> float:
    """Expected distinct experts that T tokens routed uniformly, k each
    without repeats, select: E (1 - (1 - k / E)^T)."""
    return E * (1.0 - (1.0 - k / E) ** T)


def ffn_params(m: dict, layer: int, T: int):
    """(weights a step of T tokens reads, weights one token's products
    use) of one layer's feed-forward."""
    d = m["d"]
    if not m["moe"] or layer < m["dense_layers"]:
        n = 3 * d * m["ff"]
        return n, n
    per = 3 * d * m["ffe"]
    shared = m["shared"] * per + d * m["E"]                 # + router
    return (shared + expected_experts(m["E"], m["k"], T) * per,
            shared + m["k"] * per)


def attn_pair_flops(m: dict, absorbed: bool) -> int:
    """Flops per (query row, visible key) pair, over all heads."""
    if m["mla"]:
        if absorbed:        # scores over [c_kv ; k_rope], output over c_kv
            return m["H"] * 2 * (2 * m["r"] + m["rope"])
        return m["H"] * 2 * (m["nope"] + m["rope"] + m["dv"])
    return m["H"] * 2 * 2 * m["dh"]


def cache_row_bytes(m: dict, itemsize: int = 2) -> int:
    """Bytes of one cached position of one layer."""
    if m["mla"]:
        return (m["r"] + m["rope"]) * itemsize
    return m["KV"] * 2 * m["dh"] * itemsize


def decode_step_work(model: dict, lengths: Sequence[int], itemsize=2):
    """(flops, bytes) of one decode step of one query token per item over
    a cache of the items' `lengths` (the query's own row comes on top):
    every layer's weights the live rows need (MoE: the experts their
    routing selects, reckoned as uniform routing's expectation), the
    final norm and the head once, the live rows' embeddings, every
    layer's visible cache rows, and the float logits written once."""
    m = dims(model)
    B = len(lengths)
    vis = sum(int(n) + 1 for n in lengths)
    flops = nbytes = 0.0
    for layer in range(m["L"]):
        read, used = ffn_params(m, layer, B)
        a = attn_params(m)
        nbytes += (a + norm_params(m) + read) * itemsize \
            + vis * cache_row_bytes(m, itemsize)
        flops += 2 * B * (a + used) + vis * attn_pair_flops(m, True)
    head = m["d"] * m["V"]
    nbytes += (head + m["d"]) * itemsize + B * m["d"] * itemsize \
        + B * m["V"] * itemsize
    flops += 2 * B * head
    return flops, nbytes


def prefill_step_work(model: dict, lengths: Sequence[int], itemsize=2,
                      score: bool = True):
    """(flops, bytes) the live tokens of one prefill chunk need: every
    layer's products and causal attention over each item's own length,
    the head at each item's last position, and (`score`) kernel C over
    the live cache rows. Bytes: the weights once, each live token's cache
    row written once, C's reads and scores."""
    m = dims(model)
    flops = nbytes = 0.0
    for n in lengths:
        n = int(n)
        pairs = n * (n + 1) // 2
        for layer in range(m["L"]):
            _, used = ffn_params(m, layer, n)
            flops += 2 * n * (attn_params(m) + used) \
                + pairs * attn_pair_flops(m, False)
            nbytes += n * cache_row_bytes(m, itemsize)
        flops += 2 * m["d"] * m["V"]
        if score:
            krow = (m["r"] + m["rope"]) if m["mla"] else m["KV"] * m["dh"]
            stats = ((m["H"] * krow) if m["mla"]
                     else m["H"] * m["dh"])
            f, b = expected_attention_work(n * krow, itemsize, stats,
                                           itemsize, n * (1 if m["mla"]
                                                          else m["KV"]))
            flops += m["L"] * f
            nbytes += m["L"] * b
    for layer in range(m["L"]):
        read, _ = ffn_params(m, layer, sum(int(n) for n in lengths))
        nbytes += (attn_params(m) + norm_params(m) + read) * itemsize
    nbytes += (m["d"] * m["V"] + m["d"]) * itemsize
    return flops, nbytes
