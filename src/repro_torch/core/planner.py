"""End-to-end planner: normalize -> profile -> gradient optimize -> reorder.

The port of `repro.core.planner`: the paper's Figure 2 pipeline, producing
a PhysicalPlan the streaming runtime can execute over the full dataset.
Profile/plan helpers live in runtime.plan_utils.

`plan_query` plans one linear pipeline (filters / maps / top-k / agg over
one corpus). `plan_tree` (join trees) is not ported yet and raises.
"""
from __future__ import annotations

import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import ordering as ORD
from repro_torch.core import relaxation as R
from repro_torch.core.logical import (Query, SemAgg, SemTopK,
                                      leading_relational, normalize,
                                      pinned_relational)
from repro_torch.core.optimizer import PlannerConfig, optimize_query
from repro_torch.core.physical import PhysicalPlan, PhysicalPlanStage
from repro_torch.core.profiling import profile_query
from repro_torch.runtime.dispatch import DEFAULT_COALESCE
from repro_torch.runtime.plan_utils import (estimate_selectivities,
                                            gold_membership, pipelines_data)


def _effective_targets(query: Query, items: Sequence[Any]
                       ) -> Tuple[float, float]:
    """Group-wise guarantee tightening for SemAgg: a group's aggregate is
    right when its members' extractions are, so a per-*group* target T
    over groups of mean size n needs per-item quality >= T^(1/n)
    (p_item^n >= T). Queries without a grouped SemAgg keep their declared
    targets untouched."""
    mean_gs = 0.0
    for op in query.semantic_ops:
        if isinstance(op, SemAgg) and op.group_by is not None:
            groups = {}
            for it in items:
                key = getattr(it, "row", {}).get(op.group_by)
                groups[key] = groups.get(key, 0) + 1
            if groups:
                mean_gs = max(mean_gs, len(items) / len(groups))
    if mean_gs <= 1.0:
        return query.target_recall, query.target_precision
    rec = min(query.target_recall ** (1.0 / mean_gs), 0.999)
    prec = min(query.target_precision ** (1.0 / mean_gs), 0.999)
    return rec, prec


def _shift_topk_gold(profiles, sem_ops, n_items: int) -> None:
    """Re-anchor each SemTopK pipeline's gold scores at the sample rank
    cut, in place: with k' = k scaled to the sample and tau the midpoint
    between the k'-th and (k'+1)-th best gold scores (among tuples the
    *other* gold filters admit), shifted scores make `score > 0` mean
    "in the sample top-k" — so the unchanged gold-membership /
    gold-accept machinery composes the rank cut with the rest of the
    query."""
    if not profiles:
        return                 # bare pipeline (no semantic operators)
    n_sample = profiles[0].scores.shape[1]
    for li, op in enumerate(sem_ops):
        if not isinstance(op, SemTopK):
            continue
        base = np.ones(n_sample, bool)
        for lj, other in enumerate(sem_ops):
            if lj == li or profiles[lj].is_map \
                    or isinstance(other, SemTopK):
                continue
            base &= profiles[lj].scores[-1] > 0
        gold = profiles[li].scores[-1]
        n_base = int(base.sum())
        if n_base == 0:
            tau = float(gold.max()) + 1.0      # nothing survives: empty
        else:
            kk = max(1, int(round(op.k * n_sample / max(n_items, 1))))
            kk = min(kk, n_base)
            ranked = np.sort(gold[base])[::-1]
            if kk >= n_base:
                tau = float(ranked[-1]) - 1.0  # everything in base passes
            else:
                tau = float(ranked[kk - 1] + ranked[kk]) / 2.0
        scores = profiles[li].scores.copy()
        scores[-1] = scores[-1] - tau
        profiles[li].scores = scores


def _build_stages(profiles, plan, sel, hint: R.BatchHint, n_items: int,
                  measured, sem_ops=None):
    """The planner's stage-materialization tail: per selected physical op,
    derive the expected coalesced flush batch (measured width if the
    feedback store has seen the op, else the hint width; capped by the
    op's memory budget and by how many tuples reach it), price the stage
    at that batch on its fitted cost curve, and emit the DP reorderer's
    PhysOp next to the runtime's PhysicalPlanStage.

    SemTopK pipelines (via `sem_ops`) are reject-only: every non-gold
    stage's accept boundary is forced to +inf so the shared decision
    kernel can never admit early — admission is the global rank cut."""
    phys_ops: List[ORD.PhysOp] = []
    stage_meta: List[PhysicalPlanStage] = []
    for li, (p, params, mask) in enumerate(
            zip(profiles, plan.params, plan.selected)):
        topk = sem_ops is not None and isinstance(sem_ops[li], SemTopK)
        stage_no = 0
        for i in range(p.scores.shape[0]):
            if not mask[i]:
                continue
            inter, intra, reach = sel[li][i]
            cap = float(p.batch_caps[i]) if p.batch_caps is not None \
                else np.inf
            w_i = hint.width
            if measured is not None:
                meas = measured.mean_batch(p.op_names[i])
                if meas is not None:
                    w_i = max(meas, 1.0)
            exp_batch = max(1.0, min(w_i, cap, reach * n_items))
            curve = p.cost_curves[i] if p.cost_curves is not None else None
            cost = curve.per_tuple_at(exp_batch) if curve is not None \
                else float(p.costs[i])
            phys_ops.append(ORD.PhysOp(
                op_id=len(phys_ops), logical_id=li, stage=stage_no,
                cost=cost, sel_inter=inter, sel_intra=intra))
            is_gold = i == p.scores.shape[0] - 1
            thr_hi = float(params.thr_hi[i])
            if topk and not is_gold:
                thr_hi = float("inf")
            engine = p.op_engines[i] if p.op_engines is not None else ""
            stage_meta.append(PhysicalPlanStage(
                logical_idx=li, stage=stage_no, op_name=p.op_names[i],
                thr_hi=thr_hi, thr_lo=float(params.thr_lo[i]),
                is_map=p.is_map, is_gold=is_gold, cost=cost,
                sel_inter=inter, sel_intra=intra, exp_batch=exp_batch,
                engine=engine))
            stage_no += 1
    return phys_ops, stage_meta


def _order_stages(phys_ops, stage_meta, n_items: int, reorder: bool):
    if reorder and len(phys_ops) <= 14:                   # step 4
        order, _ = ORD.reorder(phys_ops, n_tuples=float(n_items))
    elif reorder:
        order, _ = ORD.greedy_order(phys_ops, n_tuples=float(n_items))
    else:
        order = list(range(len(phys_ops)))
    return [stage_meta[i] for i in order]


def _hint_width(profiles, coalesce: int, measured) -> float:
    """The static BatchHint width: the coalesce default unless the
    measured store has seen these ops execute."""
    width = float(max(coalesce, 1))
    if measured is not None and len(measured):
        all_ops = [name for p in profiles for name in p.op_names]
        blended = measured.blended_width(all_ops)
        if blended is not None:
            width = max(blended, 1.0)
    return width


def plan_query(query: Query, items: Sequence[Any], registry: Callable,
               cfg: Optional[PlannerConfig] = None,
               sample_frac: float = 0.15, seed: int = 0,
               reorder: bool = True,
               coalesce: int = DEFAULT_COALESCE,
               measured=None) -> PhysicalPlan:
    """Plan `query` over `items`. `measured` (an optional
    core.profiling.MeasuredBatchStore) activates the measured-batch
    feedback loop: operators with recorded execution telemetry are priced
    at their *measured* mean flush width instead of the static `coalesce`
    default, both inside the gradient optimizer's differentiable cost
    (per-op, via PipelineData.meas_width) and in the DP reorderer's
    per-stage `exp_batch`."""
    # default constructed per call — a shared default instance would leak
    # mutations between unrelated plans
    cfg = cfg if cfg is not None else PlannerConfig()
    t0 = time.perf_counter()
    query = normalize(query)                              # step 1 (checked)
    sem_ops = query.semantic_ops
    profiles, sample_idx = profile_query(                 # step 2
        query, items, registry, sample_frac, seed)
    _shift_topk_gold(profiles, sem_ops, len(items))
    g = gold_membership(profiles)
    pipelines = pipelines_data(profiles, measured, sem_ops=sem_ops)
    # batch-size-aware costing: amortize fixed per-call cost over the
    # coalesced flush batches the streaming executor will actually run.
    # The hint width is the static coalesce default unless the measured
    # store has seen these ops execute, in which case their tuple-weighted
    # measured flush width seeds the hint (per-op measured widths override
    # it again inside the relaxation where individual ops were recorded).
    hint = R.BatchHint(width=_hint_width(profiles, coalesce, measured),
                       scale=len(items) / max(len(sample_idx), 1))
    t_rec, t_prec = _effective_targets(query, items)
    plan = optimize_query(pipelines, g,                   # step 3
                          t_rec, t_prec, cfg,
                          batch_hint=hint)
    sel = estimate_selectivities(profiles, plan, sem_ops=sem_ops)

    # build stage list (cascades in cost order) for the DP reorderer
    phys_ops, stage_meta = _build_stages(
        profiles, plan, sel, hint, len(items), measured, sem_ops)
    stages = _order_stages(phys_ops, stage_meta, len(items), reorder)

    return PhysicalPlan(
        stages=stages, relational=leading_relational(query),
        est_cost=plan.est_cost / max(len(sample_idx), 1) * len(items),
        recall_bound=plan.recall_bound,
        precision_bound=plan.precision_bound,
        feasible=plan.feasible,
        planning_time_s=time.perf_counter() - t0,
        post_relational=pinned_relational(query))


def plan_tree(*args, **kwargs):
    """Join-tree planning waits with the port's join runtime."""
    raise NotImplementedError(
        "plan_tree is not ported yet: join trees (runtime/tree.py, "
        "plan_tree, JoinFrame) are queued in ROADMAP queue 1")
