"""The numbers `correct` is decided on, each beside its limit.

Every number is a relative gap between what the timed path produced and
the plain reference's float32 result on the same inputs, the widest over
what was compared:

  logits_err  flushes: ||p - r|| / ||r|| of one item's logits over the
              whole vocabulary; prefill: max |p - r| / rms(r), the widest
              gap of one logit in units of the item's logits' spread
  logits_err_mean
              the mean over items of ||p - r|| / ||r|| (flushes): steady
              where top-k routing sends a few items' tokens to other
              experts, and still moved by a fault in many items
  answer_err  |(p[yes] - p[no]) - (r[yes] - r[no])| / rms(r): the gap of
              an item's log-odds answer, in units of its logits' spread
  cache_err   ||p - r|| / ||r|| of one cached K or V row (one layer, item
              and position, all heads), the widest over the live rows
  score_err   |p - r| / rms(r) of one position's keep-score, in units of
              the spread of its layer's and item's live scores

A workload file's `limits` gives the numbers its cell compares, each
with its limit, set between the readings of sound runs and of the
control (see PERF.md); the others are not judged or printed.
"""
from __future__ import annotations

from typing import Dict

import torch


def rel_l2(p: torch.Tensor, r: torch.Tensor) -> float:
    """||p - r|| / ||r|| in float64."""
    p, r = p.double(), r.double()
    return float((p - r).norm() / r.norm().clamp(min=1e-300))


def row_gap(p: torch.Tensor, r: torch.Tensor) -> float:
    """The widest ||p - r|| / ||r|| over the rows of p, r (n, ...)."""
    p, r = p.double().flatten(1), r.double().flatten(1)
    return float(((p - r).norm(dim=1)
                  / r.norm(dim=1).clamp(min=1e-300)).max())


def scaled_gap(p: torch.Tensor, r: torch.Tensor) -> float:
    """The widest |p - r| over the entries, over rms(r)."""
    p, r = p.double(), r.double()
    return float((p - r).abs().max()
                 / r.square().mean().sqrt().clamp(min=1e-300))


def logit_gaps(prog: torch.Tensor, ref: torch.Tensor, yes, no,
               answers: torch.Tensor) -> Dict[str, float]:
    """`logits_err` and `answer_err` over steps f and items b: prog, ref
    (F, B, V) logits; yes, no (F,) token ids; answers (F, B) the log-odds
    the timed path handed to the host."""
    prog, ref = prog.double(), ref.double()
    F, B, _ = ref.shape
    num = (prog - ref).norm(dim=-1)
    den = ref.norm(dim=-1).clamp(min=1e-300)
    f = torch.arange(F)
    lo_ref = ref[f, :, yes] - ref[f, :, no]                    # (F, B)
    rms = ref.square().mean(-1).sqrt().clamp(min=1e-300)
    gap = (answers.double() - lo_ref).abs() / rms
    err = num / den
    return {"logits_err": float(err.max()),
            "logits_err_mean": float(err.mean()),
            "answer_err": float(gap.max())}


def judged(values: Dict[str, float], limits: Dict[str, float]) -> dict:
    """{name: {"value", "limit"}} of the numbers that have a limit."""
    missing = sorted(set(limits) - set(values))
    if missing:
        raise KeyError(f"limits for numbers not read: {missing}")
    return {k: {"value": values[k], "limit": float(v)}
            for k, v in limits.items()}
