"""Deterministic sharded token data pipeline.

The port of `repro.data.pipeline`, numpy only and kept as it is there, so
both packages draw the same batches from the same seeds.

Host-side: each data-parallel host reads its shard of a deterministic
token stream (synthetic LM corpus here; swap `source_tokens` for a real
reader on a fleet). Determinism makes resume-from-checkpoint exact: the
loop fast-forwards the stream by the restored step count.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np


def source_tokens(vocab: int, seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def lm_batches(vocab: int, global_batch: int, seq_len: int, *,
               host_id: int = 0, n_hosts: int = 1, seed: int = 1234,
               embeds_dim: Optional[int] = None
               ) -> Iterator[Dict[str, np.ndarray]]:
    """Yields {'tokens': (B_host, S)} (or embeds+labels for stub-frontend
    archs). Each host yields its slice of the global batch."""
    assert global_batch % n_hosts == 0
    b = global_batch // n_hosts
    rng = np.random.default_rng(seed + 17 * host_id)
    # Zipfian unigram distribution: uniform tokens carry no learnable
    # signal (loss is already ln V); real corpora are heavy-tailed
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    while True:
        tokens = rng.choice(vocab, size=(b, seq_len),
                            p=probs).astype(np.int32)
        if embeds_dim is None:
            yield {"tokens": tokens}
        else:
            yield {"embeds": rng.normal(size=(b, seq_len, embeds_dim)
                                        ).astype(np.float32),
                   "labels": tokens}
