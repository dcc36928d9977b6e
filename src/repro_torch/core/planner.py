"""End-to-end planner: normalize -> profile -> gradient optimize -> reorder.

The port of `repro.core.planner`: the paper's Figure 2 pipeline, producing
a PhysicalPlan the streaming runtime can execute over the full dataset.
Profile/plan helpers live in runtime.plan_utils.

`plan_query` plans one linear pipeline (filters / maps / top-k / agg over
one corpus). Both take `device`, where the gradient optimizer runs
(default: the CPU; a Session passes its own device, so on the card one
Adam step is a CUDA graph). `plan_tree` plans a logical join tree: both side pipelines
and the pairing cascade are profiled on their own samples and optimized
*jointly* through the grouped relaxation (`relaxation.tree_counts`), so
the query-level recall/precision budget is allocated across every
pipeline of the tree by one gradient descent.
"""
from __future__ import annotations

import dataclasses
import time
from types import SimpleNamespace
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import ordering as ORD
from repro_torch.core import relaxation as R
from repro_torch.core.logical import (JoinNode, PipelineLeaf, Query, SemAgg,
                                      SemTopK, leading_relational,
                                      lower_tree, normalize,
                                      pinned_relational)
from repro_torch.core.optimizer import PlannerConfig, optimize_query
from repro_torch.core.physical import (TREE_ROLES, PhysicalPlan,
                                       PhysicalPlanStage, TreePlan)
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
    """The planner's stage-materialization tail, shared verbatim between
    `plan_query` and each `plan_tree` role: per selected physical op,
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
               measured=None, device=None) -> PhysicalPlan:
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
    pipelines = pipelines_data(profiles, measured, sem_ops=sem_ops,
                               device=device)
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
                          t_rec, t_prec, cfg, batch_hint=hint)
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


# ---------------------------------------------------------------------------
# tree planning (joins)
# ---------------------------------------------------------------------------

def _block_pairs(sample_l, sample_r, on: Optional[str], seed: int,
                 max_pairs: int = 256):
    """Sample pair coordinates (i into sample_l, j into sample_r) after
    equi-join blocking on `on`; uniformly subsampled to `max_pairs` so
    pair profiling stays bounded."""
    ii, jj = [], []
    for i, l in enumerate(sample_l):
        lv = getattr(l, "row", {}).get(on) if on else None
        if on is not None and lv is None:
            continue          # rows missing the block column never pair
        for j, r in enumerate(sample_r):
            if on is not None \
                    and getattr(r, "row", {}).get(on) != lv:
                continue
            ii.append(i)
            jj.append(j)
    ii = np.asarray(ii, np.int64)
    jj = np.asarray(jj, np.int64)
    if len(ii) > max_pairs:
        keep = np.sort(np.random.default_rng(seed).choice(
            len(ii), size=max_pairs, replace=False))
        ii, jj = ii[keep], jj[keep]
    return ii, jj


def _broadcast_profile(p, idx: np.ndarray):
    """A side profile re-indexed onto pair coordinates (score[op, t] =
    score[op, side_index(t)]) — the relaxation then optimizes all roles
    over one shared coordinate set."""
    return dataclasses.replace(
        p,
        scores=p.scores[:, idx],
        values=None if p.values is None else p.values[:, idx],
        correct=None if p.correct is None else p.correct[:, idx])


def plan_tree(tree, left_items: Sequence[Any], right_items: Sequence[Any],
              registry: Callable, cfg: Optional[PlannerConfig] = None, *,
              target_recall: float = 0.9, target_precision: float = 0.9,
              sample_frac: float = 0.15, seed: int = 0,
              reorder: bool = True, coalesce: int = DEFAULT_COALESCE,
              measured=None, device=None) -> TreePlan:
    """Plan a logical join tree over two corpora.

    Both sides and the pairing cascade are profiled on their own samples;
    side scores are broadcast onto the blocked sample-pair coordinates
    and ONE grouped gradient optimization (`optimize_query(groups=...)`)
    places thresholds for every pipeline at once against the pair-level
    gold membership — the error budget allocation across the tree the
    paper formulates, generalized past the linear chain. Each role then
    materializes its own PhysicalPlan (reordered independently) for the
    runtime to execute in sequence: left side, right side, pair cascade
    over blocked survivor pairs.
    """
    cfg = cfg if cfg is not None else PlannerConfig()
    t0 = time.perf_counter()
    tree = lower_tree(tree)
    if not isinstance(tree, JoinNode):
        raise ValueError("plan_tree expects a join tree; linear pipelines "
                         "go through plan_query")
    if not isinstance(tree.left, PipelineLeaf) \
            or not isinstance(tree.right, PipelineLeaf):
        raise ValueError("nested joins are not supported yet — each join "
                         "side must be a linear pipeline")
    join = tree.op
    queries = {
        "left": normalize(Query(list(tree.left.nodes),
                                target_recall, target_precision)),
        "right": normalize(Query(list(tree.right.nodes),
                                 target_recall, target_precision)),
        "pair": Query([join, *tree.pair_nodes],
                      target_recall, target_precision),
    }
    corpora = {"left": left_items, "right": right_items}

    # profile each side on its own sample
    profiles_l, sidx_l = profile_query(queries["left"], left_items,
                                       registry, sample_frac, seed)
    profiles_r, sidx_r = profile_query(queries["right"], right_items,
                                       registry, sample_frac, seed + 1)
    sample_l = [left_items[i] for i in sidx_l]
    sample_r = [right_items[i] for i in sidx_r]
    _shift_topk_gold(profiles_l, queries["left"].semantic_ops,
                     len(left_items))
    _shift_topk_gold(profiles_r, queries["right"].semantic_ops,
                     len(right_items))

    # blocked sample-pair corpus + pair-cascade profiling over it
    ii, jj = _block_pairs(sample_l, sample_r, join.on, seed)
    if len(ii) == 0:
        raise ValueError(
            f"join blocking on {join.on!r} eliminated every sample pair — "
            f"the corpora share no block values; drop `on` or check the "
            f"column")
    from repro_torch.runtime.tree import make_pairs
    pair_sample = make_pairs([sample_l[i] for i in ii],
                             [sample_r[j] for j in jj])
    profiles_p, _ = profile_query(queries["pair"], pair_sample, registry,
                                  sample_frac=1.0, seed=seed)

    n_l, n_r = len(left_items), len(right_items)
    n_ls, n_rs, n_p = len(sidx_l), len(sidx_r), len(ii)
    block_frac = n_p / max(n_ls * n_rs, 1)

    # pair-level gold membership: both sides' gold plans admit AND the
    # gold pair scorer matches — the per-tuple product form, unchanged.
    # A bare side (no semantic operators) admits everything.
    g = ((gold_membership(profiles_l)[ii] if profiles_l
          else np.ones(len(ii), np.float32))
         * (gold_membership(profiles_r)[jj] if profiles_r
            else np.ones(len(jj), np.float32))
         * gold_membership(profiles_p))

    sem_ops_all = (queries["left"].semantic_ops
                   + queries["right"].semantic_ops
                   + queries["pair"].semantic_ops)
    pipelines_all = pipelines_data(
        [_broadcast_profile(p, ii) for p in profiles_l]
        + [_broadcast_profile(p, jj) for p in profiles_r]
        + list(profiles_p),
        measured, sem_ops=sem_ops_all, device=device)

    # per-group reach->corpus weights (see relaxation.TreeGroup): a side
    # op's pair-coordinate reach sum overcounts by its pairing degree,
    # so sides weigh n_side / n_pairs; the pair cascade scales straight
    # from sample pairs to the blocked corpus pair count
    width = _hint_width(profiles_l + profiles_r + profiles_p, coalesce,
                        measured)
    cw = {"left": n_l / max(n_p, 1), "right": n_r / max(n_p, 1),
          "pair": (n_l * n_r) / max(n_ls * n_rs, 1)}
    groups = [
        R.TreeGroup(len(profiles_l), "side", cw["left"],
                    R.BatchHint(width, cw["left"])),
        R.TreeGroup(len(profiles_r), "side", cw["right"],
                    R.BatchHint(width, cw["right"])),
        R.TreeGroup(len(profiles_p), "pair", cw["pair"],
                    R.BatchHint(width, cw["pair"])),
    ]
    plan = optimize_query(pipelines_all, g, target_recall,
                          target_precision, cfg, groups=groups)

    # slice the joint solution back into roles and materialize each
    role_profiles = {"left": profiles_l, "right": profiles_r,
                     "pair": profiles_p}
    counts = [len(profiles_l), len(profiles_r), len(profiles_p)]
    offsets = np.cumsum([0] + counts)
    role_plans, split = {}, {}
    # side survivor fractions drive the expected pair-corpus size
    surv = {}
    for role, lo, hi in zip(TREE_ROLES, offsets[:-1], offsets[1:]):
        profs = role_profiles[role]
        if not profs:
            # bare side (no semantic operators): nothing to optimize —
            # every item survives its (at most relational) pipeline
            split[role] = (1.0, 1.0)
            surv[role] = 1.0
            role_plans[role] = PhysicalPlan(
                stages=[], relational=leading_relational(queries[role]),
                est_cost=0.0, recall_bound=1.0, precision_bound=1.0,
                feasible=plan.feasible,
                post_relational=pinned_relational(queries[role]))
            continue
        rp = SimpleNamespace(params=plan.params[lo:hi],
                             selected=plan.selected[lo:hi])
        role_ops = queries[role].semantic_ops
        # role-local hard evaluation on the role's own sample: the
        # budget split EXPLAIN renders, and the role's own cost estimate
        role_data = pipelines_data(profs, measured, sem_ops=role_ops)
        role_gold = gold_membership(profs)
        c = R.query_counts(role_data, rp.params,
                           np.asarray(role_gold, np.float32), 0.0,
                           hard=True,
                           batch_hint=R.BatchHint(width, 1.0))
        tp, fp, fn = float(c.tp), float(c.fp), float(c.fn)
        split[role] = (tp / max(tp + fn, 1e-9), tp / max(tp + fp, 1e-9))
        n_sample = profs[0].scores.shape[1]
        surv[role] = (tp + fp) / max(n_sample, 1)

        sel = estimate_selectivities(profs, rp, sem_ops=role_ops)
        if role == "pair":
            n_role = max(1, int(round(block_frac
                                      * surv["left"] * n_l
                                      * surv["right"] * n_r)))
        else:
            n_role = len(corpora[role])
        phys_ops, stage_meta = _build_stages(
            profs, rp, sel, R.BatchHint(width, 1.0), n_role, measured,
            role_ops)
        stages = _order_stages(phys_ops, stage_meta, n_role, reorder)
        role_plans[role] = PhysicalPlan(
            stages=stages, relational=leading_relational(queries[role]),
            est_cost=float(c.cost) / max(n_sample, 1) * n_role,
            recall_bound=split[role][0], precision_bound=split[role][1],
            feasible=plan.feasible,
            post_relational=pinned_relational(queries[role]))

    est_pairs = max(1, int(round(block_frac * surv["left"] * n_l
                                 * surv["right"] * n_r)))
    return TreePlan(
        roles=role_plans, queries=queries, join=join,
        est_cost=plan.est_cost,
        recall_bound=plan.recall_bound,
        precision_bound=plan.precision_bound,
        feasible=plan.feasible, split=split, est_pairs=est_pairs,
        planning_time_s=time.perf_counter() - t0)
