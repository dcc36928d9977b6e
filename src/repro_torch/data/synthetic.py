"""Planted-signal synthetic corpora + constructed model weights.

The port of `repro.data.synthetic`: the same corpora from the same seeds,
and the same constructed ("planted") weights, built in numpy and handed
to the port as torch tensors. See the JAX module for how the planted
geometry makes the quality ladders over model size and cache compression
emerge from the attention mechanism.

Vocabulary layout (vocab = 256):
  0 pad | 1 no-answer | 2 yes-answer | 3-7 punctuation-distractors
  16+k   filter-task-k query token
  32+k   map-task-k query token
  8+v    value-answer tokens (8 values)
  64 + 8k + 4y + i   filter signal token (task k<16, label y, variant i<4)
  192 + 8k + v       map signal token (task k<8, value v<8)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import model_template, params_from_jax

VOCAB = 256
TOK_NO, TOK_YES = 1, 2
N_VALUES = 8


def filter_query_token(k): return 16 + k
def map_query_token(k): return 32 + k
def value_token(v): return 8 + v
def filter_signal_token(k, y, i): return 64 + 8 * k + 4 * y + i
def map_signal_token(k, v): return 192 + 8 * k + v


@dataclass
class Item:
    item_id: int
    tokens: List[int]
    row: Dict[str, Any]
    labels: Dict[int, bool]          # filter task -> latent label
    map_vals: Dict[int, int]         # map task -> latent value
    modality: str = "text"


@dataclass
class Dataset:
    name: str
    items: List[Item]
    n_filter_tasks: int
    n_map_tasks: int
    modality: str = "text"


CATEGORIES = ("news", "sport", "science", "art")


def make_dataset(name: str, n_items: int, n_filter_tasks: int = 10,
                 n_map_tasks: int = 8, seq_len: int = 160,
                 n_signal: int = 5, modality: str = "text",
                 seed: int = 0) -> Dataset:
    assert n_filter_tasks <= 16 and n_map_tasks <= 8
    rng = np.random.default_rng(seed)
    items: List[Item] = []
    for i in range(n_items):
        labels = {k: bool(rng.random() < 0.45)
                  for k in range(n_filter_tasks)}
        map_vals = {k: int(rng.integers(N_VALUES))
                    for k in range(n_map_tasks)}
        toks = list(rng.integers(3, 8, size=seq_len))
        # non-overlapping planting slots so signals don't overwrite each
        # other; remaining positions stay distractors
        free = list(rng.permutation(seq_len))

        def take(n):
            out, rest = free[:n], free[n:]
            free[:] = rest
            return out

        for k in range(n_filter_tasks):
            if labels[k] or rng.random() < 0.5:
                y = int(labels[k])
                for p in take(n_signal):
                    toks[p] = filter_signal_token(k, y, int(rng.integers(4)))
        for k in range(n_map_tasks):
            for p in take(n_signal):
                toks[p] = map_signal_token(k, map_vals[k])
        row = {"year": int(rng.integers(1990, 2025)),
               "category": CATEGORIES[int(rng.integers(len(CATEGORIES)))],
               "length": seq_len}
        items.append(Item(i, [int(t) for t in toks], row, labels, map_vals,
                          modality))
    return Dataset(name, items, n_filter_tasks, n_map_tasks, modality)


def make_join_corpora(n_left: int = 120, n_right: int = 120, seed: int = 0,
                      id_offset: int = 1_000_000
                      ) -> Tuple[Dataset, Dataset]:
    """Two independently planted corpora for `sem_join` experiments.

    Both carry the full task layout (a join on map task k matches pairs
    whose latent `map_vals[k]` agree — ~1/8 of pairs) and the shared
    structured `category` column for equi-join blocking. Right-corpus
    item ids are offset into a disjoint id space: serving profiles are
    keyed by item id, so the two corpora can share one engine/cache
    store without collisions."""
    left = make_dataset("join-left", n_left, seed=seed)
    right = make_dataset("join-right", n_right, seed=seed + 101)
    for it in right.items:
        it.item_id += id_offset
    return left, right


# ---------------------------------------------------------------------------
# constructed ("planted") model weights
# ---------------------------------------------------------------------------

def planted_config(size: str) -> ModelConfig:
    """Reduced same-family model configs. 'sm' ~ the paper's 8B analogue,
    'lg' ~ the 70B analogue (gold)."""
    if size == "sm":
        return ModelConfig(
            name="planted-sm", family="dense", n_layers=2, d_model=32,
            n_heads=2, n_kv_heads=2, d_head=16, d_ff=64, vocab_size=VOCAB,
            attn_kind="gqa", rope_theta=1e8, dtype="float32")
    if size == "lg":
        return ModelConfig(
            name="planted-lg", family="dense", n_layers=2, d_model=96,
            n_heads=4, n_kv_heads=4, d_head=24, d_ff=128, vocab_size=VOCAB,
            attn_kind="gqa", rope_theta=1e8, dtype="float32")
    raise ValueError(size)


def make_planted_params(cfg: ModelConfig, seed: int = 0, beta: float = 2.0,
                        device="cuda"):
    """Construct weights so the attention pathway decodes planted signals.

    Geometry: each task has a *content* direction c_k (what its query token
    embeds), a *signal* direction u_k (what its signal tokens' keys carry)
    and a *label* direction r_k (what their values carry). The query
    projection is the rotation  wq = beta * sum_k c_k u_k^T, so the query
    attends to signal keys (q ~ beta*u_k) with ZERO self-attention score
    (c_k ⟂ u_k). The answer head reads sum_k r_k. Distractor embeddings are
    sampled in the orthogonal complement of all task directions — in the
    large model that complement exists and distractor keys score ~0; in the
    small model the directions can't all be orthogonal, so crosstalk makes
    it genuinely noisier. The quality ladders over model size AND cache
    compression therefore *emerge* from the mechanism.
    """
    D = cfg.d_model
    rng = np.random.default_rng(seed)
    n_dirs = 16 * 3 + 8 * 3     # u,r,c per filter task; m,w,cm per map task

    # as-orthogonal-as-possible direction bank
    raw = rng.normal(size=(max(n_dirs, D), D))
    qmat, _ = np.linalg.qr(raw.T)           # (D, D) orthonormal columns
    basis = qmat.T                          # D orthonormal rows
    dirs = np.empty((n_dirs, D))
    for i in range(n_dirs):
        if i < D:
            dirs[i] = basis[i]
        else:  # more directions than dimensions: random unit (crosstalk)
            v = rng.normal(size=D)
            dirs[i] = v / np.linalg.norm(v)
    u, r, c = dirs[0:16], dirs[16:32], dirs[32:48]
    m, w, cm = dirs[48:56], dirs[56:64], dirs[64:72]

    used = dirs[:min(n_dirs, D)]
    proj = np.eye(D) - used.T @ np.linalg.pinv(used.T)   # complement proj

    def distract():
        v = proj @ rng.normal(size=D)
        n = np.linalg.norm(v)
        if n < 1e-6:                      # sm model: complement is empty
            v = rng.normal(size=D)
            n = np.linalg.norm(v)
        return v / n

    E = np.stack([distract() for _ in range(VOCAB)]) * 0.5
    for k in range(16):
        E[filter_query_token(k)] = c[k]
        for y in (0, 1):
            s = 1.0 if y else -1.0
            for i in range(4):
                E[filter_signal_token(k, y, i)] = (
                    u[k] + s * r[k] + 0.25 * rng.normal(size=D) / np.sqrt(D))
    for k in range(8):
        E[map_query_token(k)] = cm[k]
        for v in range(8):
            E[map_signal_token(k, v)] = (
                m[k] + w[v] + 0.25 * rng.normal(size=D) / np.sqrt(D))

    head = 0.02 * rng.normal(size=(D, cfg.vocab_padded))
    r_sum = r.sum(0)
    head[:, TOK_YES] = +r_sum / np.sqrt(16)
    head[:, TOK_NO] = -r_sum / np.sqrt(16)
    for v in range(8):
        head[:, value_token(v)] = w[v]

    # query rotation: content dirs -> signal dirs
    wq_rot = beta * (np.einsum("kd,ke->de", c, u)
                     + np.einsum("kd,ke->de", cm, m))

    # every GQA leaf of the template is planted; the JAX version calls
    # init_params for the shapes only, so no RNG is drawn here
    eye = np.eye(D, dtype=np.float32)
    L_ = cfg.n_layers
    tmpl = model_template(cfg)["layers"]

    def stack(a):
        return np.broadcast_to(a, (L_,) + a.shape).copy()

    wo = np.zeros((L_, D, D), np.float32)
    wo[-1] = 0.7 * eye
    params = {
        "embed": E.astype(np.float32),
        "head": head.astype(np.float32),
        "final_norm": np.zeros(D, np.float32),
        "layers": {
            "norm_attn": np.zeros((L_, D), np.float32),
            "norm_mlp": np.zeros((L_, D), np.float32),
            # o-proj: only the LAST layer writes attention output into the
            # residual (keeps token identity intact in every layer's cache;
            # the last layer is the retrieval layer)
            "attn": {"wq": stack(wq_rot.astype(np.float32)),
                     "wk": stack(eye), "wv": stack(eye), "wo": wo},
            "mlp": {k: np.zeros(tmpl["mlp"][k][0], np.float32)
                    for k in ("w_gate", "w_up", "w_down")},
        },
    }
    return params_from_jax(cfg, params, device=device)
