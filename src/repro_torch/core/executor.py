"""The quality metric of an executed plan against the gold execution.

The port of `repro.core.executor`'s `evaluate_vs_gold`, which
`api/result.py` reports (its `execute_plan` wrapper has no caller in the
port: new code calls `runtime.run_plan`).
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np

from repro_torch.core.logical import SemMap


def evaluate_vs_gold(result, gold, sem_ops: Sequence[Any]) -> Dict[str, float]:
    """Global precision/recall of an executed plan vs the gold execution
    (paper's quality metric — result-set comparison incl. map values).

    Accepts any result objects exposing `.accepted` and `.map_values`
    (a runtime RuntimeResult)."""
    ours, theirs = result.accepted, gold.accepted
    good = ours & theirs
    # map values must match gold for a tuple to count as a true positive
    for li, op in enumerate(sem_ops):
        if isinstance(op, SemMap):
            gv = gold.map_values.get(li)
            ov = result.map_values.get(li)
            if gv is None:
                continue
            if ov is None:
                good &= False
            else:
                good = good & (ov == gv)
    tp = float(np.sum(good))
    fp = float(np.sum(ours & ~good))
    fn = float(np.sum(theirs & ~good))
    precision = tp / max(tp + fp, 1e-9)
    recall = tp / max(tp + fn, 1e-9)
    return {"tp": tp, "fp": fp, "fn": fn,
            "precision": precision, "recall": recall}
