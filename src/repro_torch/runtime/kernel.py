"""Shared accept/reject/unsure decision rule (paper Eq. 16, tau -> 0).

The port of `repro.runtime.kernel`: `decide` in numpy for the executor,
`decide_traced` in torch for the relaxation's hard extraction. The rule
is the argmax of the three logits [s - thr_hi, thr_lo - s, 0] (not simply
`s > thr_hi`: learned thresholds may cross, and the argmax is the
softmax's tau -> 0 limit). Maps have no reject branch: a map commits
(accept) or defers.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def decide_traced(scores, thr_hi, thr_lo, is_map: bool):
    """The rule on torch tensors; thresholds broadcast against `scores`.
    Returns boolean tensors (accept, reject, unsure) of `scores`' shape.
    It compares only, so it carries no gradient."""
    z_acc = scores - thr_hi
    z_rej = thr_lo - scores
    if is_map:
        z_rej = torch.full_like(z_rej, -float("inf"))
    acc = (z_acc > 0) & (z_acc >= z_rej)
    rej = (z_rej > 0) & (z_rej > z_acc)
    uns = ~(acc | rej)
    return acc, rej, uns


def _bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def decide(scores, thr_hi, thr_lo, is_map: bool
           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(accept, reject, unsure) bool arrays of `scores`' shape.

    1-D inputs are padded to the next power of two, as the JAX version
    pads them to bound its compiled shapes; the rule is elementwise, so
    padding lanes cannot perturb real ones."""
    scores = np.asarray(scores, np.float32)
    n = scores.shape[0] if scores.ndim == 1 else None
    if n is not None and _bucket(n) != n:
        scores = np.pad(scores, (0, _bucket(n) - n))
    thr_hi = np.float32(thr_hi)
    thr_lo = np.float32(thr_lo)
    with np.errstate(invalid="ignore", over="ignore"):
        z_acc = scores - thr_hi
        z_rej = thr_lo - scores
        if is_map:
            z_rej = np.full_like(z_rej, -np.inf)
        acc = (z_acc > 0) & (z_acc >= z_rej)
        rej = (z_rej > 0) & (z_rej > z_acc)
    uns = ~(acc | rej)
    if n is not None:
        acc, rej, uns = acc[:n], rej[:n], uns[:n]
    return acc, rej, uns


def gold_decide(scores, is_map: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Gold operators decide at log-odds 0 and are never unsure; gold maps
    always commit. Returns (accept, reject)."""
    scores = np.asarray(scores)
    if is_map:
        return np.ones(scores.shape, bool), np.zeros(scores.shape, bool)
    acc = scores > 0
    return acc, ~acc
