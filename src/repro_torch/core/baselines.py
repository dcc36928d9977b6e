"""Baseline optimizers from the paper's Exp 1 / Exp 3, integrated into the
same planning/execution stack as Stretto (the port of
`repro.core.baselines`):

  LotusSupG       — per-operator guarantees, global target split evenly,
                    two-stage cascades (small uncompressed model -> gold),
                    thresholds from frequentist normal-approx bounds (SupG).
  ParetoCascades  — Abacus-style combinatorial search over cascade configs
                    with fixed default thresholds; picks the cheapest plan
                    meeting targets ON THE SAMPLE (no statistical guarantee).
  StrettoLocal    — ablation: the gradient optimizer, but per-operator with
                    evenly split targets (Exp 3).
  StrettoIndependent — ablation: joint optimization, but the global bound is
                    the product of per-operator bounds at credibility
                    alpha^(1/m) (independence assumption; Exp 3).

Every planner takes `device`, where its tensor work runs (default: the
CPU): Pareto-Cascades' hard counts over every configuration are one
batched `query_counts` there (the reference's jit(vmap)); both ablations
run the optimizer's loop there (`optimizer.adam_loop`: a CUDA graph per
Adam step on the card). Lotus is host arithmetic over the profiled
sample and takes `device` only for a uniform call.
"""
from __future__ import annotations

import itertools
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import bounds as B
from repro_torch.core import relaxation as R
from repro_torch.core.logical import Query, pull_up_semantic
from repro_torch.core.optimizer import (PlannerConfig, adam_loop,
                                        flatten_params, init_pipeline_params,
                                        optimize_query, unflatten_params)
from repro_torch.core.physical import PhysicalPlan, PhysicalPlanStage
from repro_torch.core.profiling import profile_query
from repro_torch.runtime.plan_utils import gold_membership, pipelines_data


def _normal_lower(p_hat: float, n: int, z: float = 1.645) -> float:
    """One-sided 95% normal-approximation lower bound (Lotus/SupG style)."""
    if n == 0:
        return 0.0
    return p_hat - z * np.sqrt(max(p_hat * (1 - p_hat), 1e-9) / n)


def _plan_from_selection(profiles, selections, thresholds, items_n,
                         bounds=(0.0, 0.0), feasible=True,
                         est_cost=0.0, t_plan=0.0) -> PhysicalPlan:
    """selections: per logical op, list of chosen op indices (gold last).
    thresholds: dict (li, i) -> (thr_hi, thr_lo)."""
    stages = []
    for li, p in enumerate(profiles):
        n_ops = p.scores.shape[0]
        for stage_no, i in enumerate(selections[li]):
            hi, lo = thresholds.get((li, i), (0.0, 0.0))
            stages.append(PhysicalPlanStage(
                logical_idx=li, stage=stage_no, op_name=p.op_names[i],
                thr_hi=hi, thr_lo=lo, is_map=p.is_map,
                is_gold=(i == n_ops - 1), cost=float(p.costs[i]),
                engine=p.op_engines[i] if p.op_engines is not None else ""))
    return PhysicalPlan(stages=stages, relational=[], est_cost=est_cost,
                        recall_bound=bounds[0], precision_bound=bounds[1],
                        feasible=feasible, planning_time_s=t_plan)


def _gold_vector(p) -> np.ndarray:
    """A pipeline's own gold indicator: gold accepts (filters), every
    tuple (maps)."""
    if p.is_map:
        return np.ones(p.scores.shape[1], np.float32)
    return (p.scores[-1] > 0).astype(np.float32)


# ---------------------------------------------------------------------------
# Lotus / SupG
# ---------------------------------------------------------------------------

def plan_lotus(query: Query, items, registry, sample_frac: float = 0.15,
               seed: int = 0, small_index: int = -2,
               device=None) -> PhysicalPlan:
    """Two-stage cascades (small uncompressed -> gold) with per-operator
    targets T^(1/m) and SupG-style threshold selection (numpy on the
    host, whatever `device` says)."""
    t0 = time.perf_counter()
    query = pull_up_semantic(query)
    profiles, sample_idx = profile_query(query, items, registry,
                                         sample_frac, seed)
    m = max(len(profiles), 1)
    t_rec = query.target_recall ** (1.0 / m)
    t_prec = query.target_precision ** (1.0 / m)

    selections, thresholds = [], {}
    for li, p in enumerate(profiles):
        n_ops = p.scores.shape[0]
        # "small model" = uncompressed small LLM: by convention the highest
        # -cost sm op; callers pass registries where that op exists.
        small = n_ops + small_index if small_index < 0 else small_index
        small = max(0, min(small, n_ops - 2))
        gold_i = n_ops - 1
        s_small = p.scores[small]
        if p.is_map:
            corr = p.correct[small]
            # threshold on confidence: commit only above thr; choose the
            # smallest thr whose committed accuracy has lb >= t_rec
            cand = np.quantile(s_small, np.linspace(0.0, 0.95, 24))
            thr = float("inf")
            for t in cand:
                mask = s_small > t
                if mask.sum() == 0:
                    continue
                acc = corr[mask].mean()
                if _normal_lower(acc, int(mask.sum())) >= min(t_rec, t_prec):
                    thr = float(t)
                    break
            thresholds[(li, small)] = (thr, -np.inf)
        else:
            gold_acc = p.scores[gold_i] > 0
            pos = gold_acc
            cand = np.quantile(s_small, np.linspace(0.02, 0.98, 33))
            # accept-threshold: precision of {s > hi} >= t_prec
            hi = float("inf")
            for t in cand[::-1]:
                mask = s_small > t
                if mask.sum() < 3:
                    continue
                prec = pos[mask].mean()
                if _normal_lower(prec, int(mask.sum())) >= t_prec:
                    hi = float(t)
            # reject-threshold: recall of kept positives >= t_rec
            lo = -float("inf")
            for t in cand:
                kept = s_small >= t
                if pos.sum() == 0:
                    break
                rec = (kept & pos).sum() / max(pos.sum(), 1)
                if _normal_lower(rec, int(pos.sum())) >= t_rec:
                    lo = float(t)
                else:
                    break
            thresholds[(li, small)] = (hi, lo)
        selections.append([small, gold_i])

    return _plan_from_selection(
        profiles, selections, thresholds, len(items),
        bounds=(t_rec ** m, t_prec ** m), feasible=True,
        t_plan=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# Abacus Pareto-Cascades
# ---------------------------------------------------------------------------

DEFAULT_LLM_THR = (1.5, -1.5)
DEFAULT_MAP_THR = (1.0, -np.inf)


def plan_pareto_cascades(query: Query, items, registry,
                         sample_frac: float = 0.15, seed: int = 0,
                         max_stages: int = 2, device=None) -> PhysicalPlan:
    """Enumerate per-operator cascade configurations (fixed default
    thresholds — the method cannot tune continuous parameters), simulate on
    the sample, keep the Pareto frontier, pick the cheapest configuration
    that meets the targets on the sample. No statistical guarantee. Every
    configuration's hard counts come from one batched `query_counts` on
    `device` (the configurations are a leading dimension of the
    parameters)."""
    t0 = time.perf_counter()
    query = pull_up_semantic(query)
    profiles, sample_idx = profile_query(query, items, registry,
                                         sample_frac, seed)
    pipelines = pipelines_data(profiles, device=device)
    dev = pipelines[0].scores.device
    g = torch.as_tensor(gold_membership(profiles), device=dev)

    per_op_choices = []
    for p in profiles:
        n_ops = p.scores.shape[0]
        non_gold = list(range(n_ops - 1))
        choices = [()]
        choices += [(i,) for i in non_gold]
        choices += list(itertools.combinations(non_gold, 2))[:12]
        per_op_choices.append(choices[:16])

    def params_for(config) -> List[tuple]:
        out = []
        for p, chosen in zip(profiles, config):
            n_ops = p.scores.shape[0]
            picks = np.full(n_ops, -10.0, np.float32)
            picks[-1] = 10.0
            hi = np.zeros(n_ops, np.float32)
            lo = np.zeros(n_ops, np.float32)
            for i in chosen:
                picks[i] = 10.0
                d = DEFAULT_MAP_THR if p.is_map else DEFAULT_LLM_THR
                hi[i], lo[i] = d
            out.append((picks, hi, lo))
        return out

    rng = np.random.default_rng(seed)
    all_configs = list(itertools.product(*per_op_choices))
    if len(all_configs) > 400:
        idx = rng.choice(len(all_configs), 400, replace=False)
        all_configs = [all_configs[i] for i in idx]

    # one batched hard evaluation over every candidate configuration
    stacked = [params_for(c) for c in all_configs]
    batched = [R.PipelineParams(*(
        torch.from_numpy(np.stack([s[li][f] for s in stacked])).to(dev)
        for f in range(3))) for li in range(len(profiles))]
    with torch.no_grad():
        c = R.query_counts(pipelines, batched, g, 0.0, hard=True)
    tp, fp, fn, cost = torch.stack([c.tp, c.fp, c.fn, c.cost]).cpu().numpy()
    prec_all = tp / np.maximum(tp + fp, 1e-9)
    rec_all = tp / np.maximum(tp + fn, 1e-9)
    ok = (rec_all >= query.target_recall) & \
         (prec_all >= query.target_precision)
    best = None
    if ok.any():
        i = int(np.argmin(np.where(ok, cost, np.inf)))
        best = (all_configs[i], float(cost[i]), float(rec_all[i]),
                float(prec_all[i]))
    if best is None:
        best = (tuple(() for _ in profiles), 0.0, 1.0, 1.0)

    config, cost, rec, prec = best
    selections, thresholds = [], {}
    for li, (p, chosen) in enumerate(zip(profiles, config)):
        n_ops = p.scores.shape[0]
        sel = sorted(chosen) + [n_ops - 1]
        selections.append(sel)
        for i in chosen:
            d = DEFAULT_MAP_THR if p.is_map else DEFAULT_LLM_THR
            thresholds[(li, i)] = d
    return _plan_from_selection(profiles, selections, thresholds, len(items),
                                bounds=(rec, prec), feasible=True,
                                est_cost=cost,
                                t_plan=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# Exp 3 ablations
# ---------------------------------------------------------------------------

def plan_stretto_local(query: Query, items, registry,
                       cfg: Optional[PlannerConfig] = None,
                       sample_frac: float = 0.15, seed: int = 0,
                       device=None) -> PhysicalPlan:
    """Gradient optimizer per logical operator with evenly split targets,
    each run on `device`."""
    cfg = cfg if cfg is not None else PlannerConfig()
    t0 = time.perf_counter()
    query = pull_up_semantic(query)
    profiles, _ = profile_query(query, items, registry, sample_frac, seed)
    m = max(len(profiles), 1)
    t_rec = query.target_recall ** (1.0 / m)
    t_prec = query.target_precision ** (1.0 / m)

    selections, thresholds = [], {}
    tot_cost, rb, pb = 0.0, 1.0, 1.0
    feas = True
    for li, p in enumerate(profiles):
        data = pipelines_data([p], device=device)[0]
        plan = optimize_query([data], _gold_vector(p), t_rec, t_prec, cfg)
        sel = [i for i in range(p.scores.shape[0]) if plan.selected[0][i]]
        selections.append(sel)
        for i in sel[:-1]:
            thresholds[(li, i)] = (float(plan.params[0].thr_hi[i]),
                                   float(plan.params[0].thr_lo[i]))
        tot_cost += plan.est_cost
        rb *= plan.recall_bound
        pb *= plan.precision_bound
        feas &= plan.feasible
    return _plan_from_selection(profiles, selections, thresholds, len(items),
                                bounds=(rb, pb), feasible=feas,
                                est_cost=tot_cost,
                                t_plan=time.perf_counter() - t0)


def plan_stretto_independent(query: Query, items, registry,
                             cfg: Optional[PlannerConfig] = None,
                             sample_frac: float = 0.15, seed: int = 0,
                             device=None) -> PhysicalPlan:
    """Joint gradient optimization, but the global bound is the product of
    per-operator bounds at credibility alpha^(1/m) (independence). One
    start (a restart dimension of 1) through the optimizer's loop on
    `device`."""
    cfg = cfg if cfg is not None else PlannerConfig()
    t0 = time.perf_counter()
    query = pull_up_semantic(query)
    profiles, _ = profile_query(query, items, registry, sample_frac, seed)
    pipelines = pipelines_data(profiles, device=device)
    dev = pipelines[0].scores.device
    m = max(len(profiles), 1)
    alpha = cfg.credibility ** (1.0 / m)
    sizes = [p.scores.shape[0] for p in profiles]
    gs = [torch.as_tensor(_gold_vector(p), device=dev) for p in profiles]
    N = gs[0].shape[0]
    max_cost = sum(float(p.costs.sum()) for p in pipelines) * N

    def loss_fn(flat, tau):
        plist = unflatten_params(flat, sizes)
        tps, fns, fps = [], [], []
        cost = 0.0
        for data, params, g in zip(pipelines, plist, gs):
            accept, c, decided = R.simulate_pipeline(params, data, tau,
                                                     pick_tau=cfg.pick_tau)
            if data.is_map:
                pc = R.pipeline_value_correct(decided, data.correct)
                tps.append(pc.sum(-1))
                fns.append((1.0 - pc).sum(-1))
                fps.append(fns[-1])
            else:
                tps.append((accept * g).sum(-1))
                fps.append((accept * (1 - g)).sum(-1))
                fns.append(((1 - accept) * g).sum(-1))
            cost = cost + c.sum(-1)
        # every pipeline's recall and precision bound in one call
        lb = B.beta_lower_bound(torch.stack(tps + tps),
                                torch.stack(fns + fps), alpha)
        rb, pb = 1.0, 1.0
        for j in range(len(pipelines)):
            rb = rb * lb[j]
            pb = pb * lb[len(pipelines) + j]
        pen = (torch.relu(query.target_recall + cfg.margin - rb)
               + torch.relu(query.target_precision + cfg.margin - pb))
        return cost / max_cost + cfg.beta * pen, (rb, pb, cost)

    flat0 = flatten_params([init_pipeline_params(p, 2.0, 0.5)
                            for p in pipelines])[None]          # (1, P)
    run = adam_loop(lambda flat, tau: loss_fn(flat, tau)[0], flat0, cfg, [])
    with torch.no_grad():
        _, aux = loss_fn(run.flat, 0.0)
    rb, pb, cost = (float(x) for x in torch.cat(aux).cpu())
    plist = unflatten_params(run.flat[0].cpu(), sizes)
    selections, thresholds = [], {}
    for li, (p, params) in enumerate(zip(profiles, plist)):
        n_ops = p.scores.shape[0]
        mask = (torch.sigmoid(params.pick_logits) > 0.5).numpy()
        mask[-1] = True
        sel = [i for i in range(n_ops) if mask[i]]
        selections.append(sel)
        for i in sel[:-1]:
            thresholds[(li, i)] = (float(params.thr_hi[i]),
                                   float(params.thr_lo[i]))
    return _plan_from_selection(
        profiles, selections, thresholds, len(items),
        bounds=(rb, pb),
        feasible=bool(rb >= query.target_recall
                      and pb >= query.target_precision),
        est_cost=cost, t_plan=time.perf_counter() - t0)
