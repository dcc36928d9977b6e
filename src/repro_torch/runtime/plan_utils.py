"""Public plan/profile utilities shared by the planner and the baselines.

The port of `repro.runtime.plan_utils`; the relaxation's inputs are torch
tensors here (float32, on the device the planner's optimizer runs on).

  gold_membership         — (N,) gold-result-set indicator from profiles
  pipelines_data          — ProfiledPipeline -> relaxation PipelineData
  estimate_selectivities  — per-selected-op inter/intra selectivities by
                            hard-simulating the chosen cascades on the
                            profiled sample (shared decision kernel)
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import relaxation as R
from repro_torch.core.logical import Query, SemMap, SemTopK
from repro_torch.core.physical import (PhysicalPlan, PhysicalPlanStage,
                                       ProfiledPipeline)
from repro_torch.runtime.kernel import decide, gold_decide


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def gold_plan_for(query: Query, backend) -> PhysicalPlan:
    """The reference plan: every semantic operator runs its gold physical
    implementation on every tuple (no thresholds, no cascades)."""
    from repro_torch.runtime.backend import as_backend
    backend = as_backend(backend)
    stages = []
    for li, op in enumerate(query.semantic_ops):
        gold = backend.candidates(op)[-1]
        stages.append(PhysicalPlanStage(
            logical_idx=li, stage=0, op_name=gold.name,
            thr_hi=0.0, thr_lo=0.0, is_map=isinstance(op, SemMap),
            is_gold=True, cost=1.0,
            engine=getattr(gold, "engine_name", "")))
    return PhysicalPlan(stages=stages,
                        relational=list(query.relational_ops),
                        est_cost=0.0, recall_bound=1.0, precision_bound=1.0,
                        feasible=True)


def gold_membership(profiles: Sequence[ProfiledPipeline]) -> np.ndarray:
    """(N,) {0,1}: tuple is in the gold plan's result set (all gold filters
    accept; maps are correct vs themselves by construction)."""
    g = None
    for p in profiles:
        if p.is_map:
            continue
        acc = (p.scores[-1] > 0).astype(np.float32)
        g = acc if g is None else g * acc
    if g is None:   # map-only query: every tuple is in the gold result
        g = np.ones(profiles[0].scores.shape[1], np.float32)
    return g


def pipelines_data(profiles: Sequence[ProfiledPipeline], measured=None,
                   sem_ops: Sequence = None,
                   device=None) -> List[R.PipelineData]:
    """Lift numpy profiling results into the relaxation's PipelineData.

    Profiles carrying fitted CostCurves split cost into marginal per-tuple
    and fixed per-call components (plus the op's memory-budgeted batch
    cap), activating the batch-size-aware cost model; profiles without
    curves keep the scalar measured per-tuple cost.

    `measured` (a core.profiling.MeasuredBatchStore, optional) supplies
    each op's measured flush width from past executions: ops with a
    recorded `mean_batch` are priced at it instead of the static
    BatchHint width (unmeasured ops get NaN, the relaxation's
    fall-back-to-hint marker).

    `sem_ops` (optional, aligned with `profiles`) marks SemTopK
    pipelines as reject-only (`no_accept`): their non-gold stages may
    terminate hopeless tuples early but never admit — admission is the
    gold rank cut.

    `device` places the tensors (default: the CPU)."""
    out = []
    for li, p in enumerate(profiles):
        no_accept = sem_ops is not None and isinstance(sem_ops[li], SemTopK)
        if p.cost_curves is not None:
            costs = _f32([c.per_tuple_s for c in p.cost_curves], device)
            fixed = _f32([c.fixed_s for c in p.cost_curves], device)
        else:
            costs = _f32(p.costs, device)
            fixed = None
        meas_width = None
        if measured is not None and len(measured):
            widths = [measured.mean_batch(name) for name in p.op_names]
            if any(w is not None for w in widths):
                meas_width = _f32(
                    [np.nan if w is None else w for w in widths], device)
        out.append(R.PipelineData(
            scores=_f32(p.scores, device),
            costs=costs,
            is_map=p.is_map,
            correct=None if p.correct is None else _f32(p.correct, device),
            fixed=fixed,
            batch_cap=None if p.batch_caps is None
            else _f32(p.batch_caps, device),
            meas_width=meas_width,
            no_accept=no_accept))
    return out


def estimate_selectivities(profiles: Sequence[ProfiledPipeline], plan,
                           sem_ops: Sequence = None
                           ) -> List[Dict[int, Tuple[float, float, float]]]:
    """Hard-simulate the chosen cascades on the sample to estimate each
    selected op's inter/intra selectivity over the tuples reaching it.

    plan: an OptimizedPlan (params + selected masks per pipeline).
    Returns, per pipeline, {op_index: (sel_inter, sel_intra, reach_frac)}
    where inter = fraction not rejected, intra = fraction still unsure,
    and reach_frac = fraction of the sample the op scores at all — the
    quantity the batch-aware cost model turns into an expected flush
    batch size.
    """
    sel = []
    for li, (p, params, mask) in enumerate(
            zip(profiles, plan.params, plan.selected)):
        acc_i, rej_i, _ = decide(
            p.scores, np.asarray(params.thr_hi)[:, None],
            np.asarray(params.thr_lo)[:, None], p.is_map)
        if sem_ops is not None and isinstance(sem_ops[li], SemTopK):
            # reject-only cascade: at execution the non-gold accept
            # boundary is +inf, so a learned accept never fires
            acc_i = np.zeros_like(np.asarray(acc_i), bool)
        n_ops, N = p.scores.shape
        unsure = np.ones(N, bool)
        per_op: Dict[int, Tuple[float, float, float]] = {}
        for i in range(n_ops):
            if not mask[i]:
                continue
            if i == n_ops - 1:   # gold decides at its natural boundary
                acc, rej = gold_decide(p.scores[-1], p.is_map)
            else:
                acc, rej = acc_i[i], rej_i[i]
            reach = unsure
            n_reach = max(int(reach.sum()), 1)
            n_rej = int((reach & rej).sum())
            n_uns = int((reach & ~acc & ~rej).sum())
            per_op[i] = (1.0 - n_rej / n_reach,   # inter: not rejected
                         n_uns / n_reach,         # intra: still unsure
                         n_reach / max(N, 1))     # reach over the sample
            unsure = reach & ~acc & ~rej
        sel.append(per_op)
    return sel
