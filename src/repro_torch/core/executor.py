"""Compatibility shim over the streaming runtime, and the quality metric
of an executed plan against the gold execution.

The port of `repro.core.executor`: `execute_plan` keeps the original
signature (plan, query, items, registry) and result shape for callers of
the baselines (`core/baselines.py`) and the paper's experiments; new code
calls `runtime.run_plan` directly. `evaluate_vs_gold` is what
`api/result.py` reports.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.logical import Query, SemMap
from repro_torch.core.physical import PhysicalPlan


@dataclass
class ExecutionResult:
    accepted: np.ndarray                   # (N,) bool — in the result set
    map_values: Dict[int, np.ndarray]      # logical idx -> values (N,)
    runtime_s: float                       # sum of measured operator time
    stage_times: List[Tuple[str, float, int]]   # (op, seconds, n_tuples)
    n_llm_tuples: int                      # tuples processed by LLM ops


def execute_plan(plan: PhysicalPlan, query: Query, items: Sequence[Any],
                 registry: Callable,
                 partition_size: Optional[int] = None,
                 coalesce: Optional[int] = None) -> ExecutionResult:
    """Execute a plan through the streaming runtime; seed-shaped result."""
    # deferred import: the runtime depends on core's plan dataclasses
    from repro_torch.runtime.backend import as_backend
    from repro_torch.runtime.executor import run_plan
    rr = run_plan(plan, query, items, as_backend(registry),
                  partition_size=partition_size, coalesce=coalesce)
    return ExecutionResult(
        accepted=rr.accepted, map_values=rr.map_values,
        runtime_s=rr.runtime_s, stage_times=rr.stage_times,
        n_llm_tuples=rr.n_llm_tuples)


def evaluate_vs_gold(result, gold, sem_ops: Sequence[Any]) -> Dict[str, float]:
    """Global precision/recall of an executed plan vs the gold execution
    (paper's quality metric — result-set comparison incl. map values).

    Accepts any result objects exposing `.accepted` and `.map_values`
    (ExecutionResult or runtime RuntimeResult)."""
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
