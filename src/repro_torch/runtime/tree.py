"""Join-tree execution over the streaming runtime.

The port of `repro.runtime.tree` (numpy only; a copy with the imports
pointed at the port).

A planned `TreePlan` executes as three streaming cascade runs through the
*same* run_plan machinery (same FlushTask dispatch, same StageStats
telemetry, same decision kernel):

  1. the `left` side plan over the left corpus,
  2. the `right` side plan over the right corpus,
  3. the `pair` plan over the blocked survivor pairs — every (l, r) with
     both sides accepted and (when the join declares `on`) equal block
     column values, wrapped as `PairItem`s.

Per-tuple decisions of each run are dispatcher-invariant (the runtime's
standing parity guarantee), the survivor pair-corpus is built in
deterministic left-major order from those decisions, so the whole tree's
result is bit-identical across the inline and threads dispatchers with
zero extra machinery.

`PairItem` is the pair corpus's item type: `item_id` is the
``(left_id, right_id)`` tuple (side corpora must use disjoint id spaces —
serving profiles are keyed by item id), and `row` merges both sides'
structured rows under ``left_`` / ``right_`` prefixes (columns whose
values agree on both sides additionally keep their bare name, so
relational predicates over shared/blocked columns keep working on pairs).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.physical import TREE_ROLES, TreePlan
from repro_torch.runtime.backend import as_backend
from repro_torch.runtime.executor import RuntimeResult, StageStats, run_plan
from repro_torch.runtime.plan_utils import gold_plan_for


@dataclass(frozen=True)
class PairItem:
    """One candidate join pair — the pair cascade's corpus element."""
    left: Any
    right: Any
    item_id: Tuple[Any, Any]            # (left.item_id, right.item_id)
    row: Dict[str, Any]


def make_pair(left: Any, right: Any) -> PairItem:
    lrow = getattr(left, "row", {}) or {}
    rrow = getattr(right, "row", {}) or {}
    row = {f"left_{k}": v for k, v in lrow.items()}
    row.update({f"right_{k}": v for k, v in rrow.items()})
    for k, v in lrow.items():           # agreeing shared columns: bare name
        if k in rrow and rrow[k] == v:
            row[k] = v
    return PairItem(left, right,
                    (getattr(left, "item_id", None),
                     getattr(right, "item_id", None)), row)


def make_pairs(left_items: Sequence[Any],
               right_items: Sequence[Any]) -> List[PairItem]:
    """Zip two equal-length item lists into PairItems (the planner's
    sample-pair construction; survivor pairing goes through
    `survivor_pairs`)."""
    if len(left_items) != len(right_items):
        raise ValueError("make_pairs zips equal-length lists; for the "
                         "cross/blocked product use survivor_pairs")
    return [make_pair(l, r) for l, r in zip(left_items, right_items)]


def survivor_pairs(left_items: Sequence[Any], right_items: Sequence[Any],
                   on: Optional[str]) -> List[PairItem]:
    """The blocked pair corpus over two survivor sets, in deterministic
    left-major order: every (l, r), restricted to equal `on` column
    values when the join declares a blocking column. Rows missing the
    block column never pair (SQL equi-join semantics)."""
    if on is None:
        return [make_pair(l, r) for l in left_items for r in right_items]
    by_val: Dict[Any, List[Any]] = {}
    for r in right_items:
        v = (getattr(r, "row", {}) or {}).get(on)
        if v is not None:
            by_val.setdefault(v, []).append(r)
    out: List[PairItem] = []
    for l in left_items:
        v = (getattr(l, "row", {}) or {}).get(on)
        if v is None:
            continue
        for r in by_val.get(v, ()):
            out.append(make_pair(l, r))
    return out


@dataclass
class TreeResult:
    """Result of executing a TreePlan: the three role runs plus the final
    accepted pair ids. Telemetry composes from the role runs — the
    `stage_stats` property retags each role's stages with tree-unique
    logical indices (`TreePlan.role_base`), so merged tree telemetry
    tiles exactly like single-pipeline telemetry does."""
    roles: Dict[str, RuntimeResult]       # keyed by TREE_ROLES
    pair_items: List[PairItem]            # the blocked survivor pair corpus
    pair_ids: List[Tuple[Any, Any]]       # accepted (left_id, right_id)s
    plan: TreePlan
    wall_s: float = 0.0                   # end-to-end elapsed (3 runs +
    #                                       pair construction)

    @property
    def runtime_s(self) -> float:
        return sum(r.runtime_s for r in self.roles.values())

    @property
    def n_llm_tuples(self) -> int:
        return sum(r.n_llm_tuples for r in self.roles.values())

    @property
    def stage_stats(self) -> List[StageStats]:
        out: List[StageStats] = []
        for role in TREE_ROLES:
            base = self.plan.role_base(role)
            for sg in self.roles[role].stage_stats:
                retagged = sg.copy()
                retagged.logical_idx += base
                out.append(retagged)
        return out

    @property
    def map_values(self) -> Dict[int, np.ndarray]:
        """Pair-cascade map values under tree-unique logical indices
        (aligned with `pair_items`)."""
        base = self.plan.role_base("pair")
        return {base + li: vals
                for li, vals in self.roles["pair"].map_values.items()}

    def id_set(self) -> Set[Tuple[Any, Any]]:
        return set(self.pair_ids)


def _run_roles(role_plans: Dict[str, Any], queries: Dict[str, Any],
               join, left_items: Sequence[Any], right_items: Sequence[Any],
               backend, plan: TreePlan, **exec_kwargs) -> TreeResult:
    t0 = time.perf_counter()
    backend = as_backend(backend)
    res: Dict[str, RuntimeResult] = {}
    res["left"] = run_plan(role_plans["left"], queries["left"], left_items,
                           backend, **exec_kwargs)
    res["right"] = run_plan(role_plans["right"], queries["right"],
                            right_items, backend, **exec_kwargs)
    pairs = survivor_pairs(
        [left_items[i] for i in np.flatnonzero(res["left"].accepted)],
        [right_items[j] for j in np.flatnonzero(res["right"].accepted)],
        join.on)
    res["pair"] = run_plan(role_plans["pair"], queries["pair"], pairs,
                           backend, **exec_kwargs)
    pair_ids = [pairs[t].item_id
                for t in np.flatnonzero(res["pair"].accepted)]
    return TreeResult(roles=res, pair_items=pairs, pair_ids=pair_ids,
                      plan=plan, wall_s=time.perf_counter() - t0)


def run_tree(plan: TreePlan, left_items: Sequence[Any],
             right_items: Sequence[Any], backend, *,
             partition_size: Optional[int] = None,
             coalesce: Optional[int] = None,
             dispatcher=None) -> TreeResult:
    """Execute a planned join tree: left side, right side, then the pair
    cascade over the blocked survivor pairs. Accepts the same execution
    knobs as `run_plan`; every role run uses them uniformly."""
    return _run_roles(plan.roles, plan.queries, plan.join, left_items,
                      right_items, backend, plan,
                      partition_size=partition_size, coalesce=coalesce,
                      dispatcher=dispatcher)


def run_gold_tree(plan: TreePlan, left_items: Sequence[Any],
                  right_items: Sequence[Any], backend,
                  **exec_kwargs) -> TreeResult:
    """The tree's quality reference: every role executes its gold-only
    plan (each semantic operator's gold physical implementation on every
    tuple), pairing the gold survivors. The resulting pair-id set is what
    tree recall/precision are measured against."""
    backend = as_backend(backend)
    gold_plans = {role: gold_plan_for(plan.queries[role], backend)
                  for role in TREE_ROLES}
    return _run_roles(gold_plans, plan.queries, plan.join, left_items,
                      right_items, backend, plan, **exec_kwargs)


def evaluate_pairs(result: TreeResult, gold: TreeResult
                   ) -> Dict[str, float]:
    """Pair-id-set recall / precision / F1 of a tree result against the
    gold tree reference."""
    got, want = result.id_set(), gold.id_set()
    tp = len(got & want)
    rec = tp / max(len(want), 1)
    prec = tp / max(len(got), 1)
    return {"recall": rec, "precision": prec,
            "f1": 2 * rec * prec / max(rec + prec, 1e-9),
            "n_result": len(got), "n_gold": len(want),
            "n_pairs_scored": len(result.pair_items)}
