"""Gradient-based global query optimizer (paper §4, Eq. 10-15).

The port of `repro.core.optimizer`. Minimize expected cost subject to
Bayesian lower bounds on global recall and precision exceeding the user
targets:

    L = L_cost + beta * ReLU(T_P - l_P) + beta * ReLU(T_R - l_R)

over pick logits and thresholds of every physical operator, through the
soft cascade simulation (relaxation.py) and the Beta credible bounds
(bounds.py), with Adam and an exponential temperature schedule. At
tau -> 0 the plan is extracted discretely and re-verified with *hard*
counts; if the hard bounds miss the targets the planner falls back to
more conservative candidates and ultimately the gold-only plan.

The JAX package runs its restarts under `jax.jit(jax.vmap(run_one))` with
a hand-written Adam inside a `lax.scan`. Here the parameters carry a
leading restart dimension `(K, P)`: the relaxation broadcasts over it,
the K independent losses are summed, and one `backward` gives every
restart its own gradient (no restart's loss depends on another's
parameters). The Adam arithmetic, the init grid, the tau schedule and the
snapshot extraction are the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import bounds as B
from repro_torch.core import relaxation as R

_F32 = torch.float32


@dataclasses.dataclass
class PlannerConfig:
    steps: int = 400
    lr: float = 5e-2
    beta: float = 25.0
    tau_start: float = 1.0
    tau_end: float = 0.02
    pick_tau: float = 1.0    # constant: annealing the pick sigmoid kills its
    #                          gradient once an op drifts off (sigmoid sat.)
    restarts: int = 6        # multi-start (local optima are real)
    snapshots: int = 4       # candidates along the annealing path: early
    #                          snapshots are conservative, late aggressive
    margin: float = 0.02     # optimize against target+margin: keeps slack
    #                          for the soft->hard extraction gap
    credibility: float = 0.95
    seed: int = 0


class OptimizedPlan(NamedTuple):
    params: List[R.PipelineParams]       # final (discrete-ready) parameters
    selected: List[np.ndarray]           # bool mask per pipeline
    sample_tp: float
    sample_fp: float
    sample_fn: float
    recall_bound: float
    precision_bound: float
    est_cost: float                      # expected cost on sample (s)
    feasible: bool
    loss_history: Optional[np.ndarray] = None


def flatten_params(params_list):
    """Concatenate per-pipeline (pick, thr_hi, thr_lo) along the last
    dimension: the optimizer's parameter layout."""
    return torch.cat([torch.cat([p.pick_logits, p.thr_hi, p.thr_lo], -1)
                      for p in params_list], -1)


def unflatten_params(flat, sizes):
    """Inverse of flatten_params given each pipeline's operator count;
    leading dimensions are kept."""
    out, off = [], 0
    for n in sizes:
        out.append(R.PipelineParams(flat[..., off:off + n],
                                    flat[..., off + n:off + 2 * n],
                                    flat[..., off + 2 * n:off + 3 * n]))
        off += 3 * n
    return out


def _median(x):
    """jnp.median along the last axis: the midpoint of the two middle
    values for an even count (torch.median returns the lower one)."""
    s = torch.sort(x, dim=-1).values
    n = s.shape[-1]
    if n % 2:
        return s[..., n // 2]
    lo, hi = s[..., n // 2 - 1], s[..., n // 2]
    return lo + (hi - lo) * 0.5


def init_pipeline_params(data: R.PipelineData, pick0: float = 0.5,
                         width: float = 0.5) -> R.PipelineParams:
    """Thresholds straddling the median score; everything mildly picked."""
    n = data.scores.shape[0]
    med = _median(data.scores)
    spread = torch.clamp(data.scores.std(dim=1, unbiased=False), min=1e-3)
    return R.PipelineParams(
        pick_logits=torch.zeros(n) + pick0,
        thr_hi=med + width * spread,
        thr_lo=med - width * spread,
    )


def _bounds(c: R.QueryCounts, credibility: float):
    """(recall, precision) lower bounds, both in one betaincinv call."""
    both = B.beta_lower_bound(torch.stack([c.tp, c.tp]),
                              torch.stack([c.fn, c.fp]), credibility)
    return both[0], both[1]


def optimize_query(pipelines: Sequence[R.PipelineData],
                   gold_membership: np.ndarray,
                   target_recall: float, target_precision: float,
                   cfg: Optional[PlannerConfig] = None,
                   batch_hint: Optional[R.BatchHint] = None,
                   groups: Optional[Sequence[R.TreeGroup]] = None
                   ) -> OptimizedPlan:
    """batch_hint activates the batch-size-aware cost model for pipelines
    carrying fixed per-call costs (see relaxation.BatchHint).

    groups switches the simulation from the linear `query_counts` chain
    to the grouped `tree_counts` (join trees: side pipelines reset their
    reach, the pairing cascade's entry mass is the product of the side
    survivals, and per-group cost weights / hints price each pipeline
    against its own corpus), so the query-level error budget is
    allocated across every pipeline of the tree by the same joint
    gradient relaxation."""
    cfg = cfg if cfg is not None else PlannerConfig()
    pipelines = list(pipelines)
    sizes = [p.scores.shape[0] for p in pipelines]
    g = torch.as_tensor(np.asarray(gold_membership), dtype=_F32)

    max_cost = sum(
        float(p.costs.sum())
        + (float(p.fixed.sum()) if p.fixed is not None else 0.0)
        for p in pipelines) * g.shape[0]
    max_cost = max(max_cost, 1e-9)
    t_rec = min(target_recall + cfg.margin, 0.999)
    t_prec = min(target_precision + cfg.margin, 0.999)

    def counts_fn(params_list, tau, hard=False, pick_tau=None):
        if groups is not None:
            return R.tree_counts(pipelines, params_list, g, groups, tau,
                                 hard=hard, pick_tau=pick_tau)
        return R.query_counts(pipelines, params_list, g, tau, hard=hard,
                              pick_tau=pick_tau, batch_hint=batch_hint)

    def loss_fn(flat, tau):
        c = counts_fn(unflatten_params(flat, sizes), tau,
                      pick_tau=cfg.pick_tau)
        l_rec, l_prec = _bounds(c, cfg.credibility)
        l_cost = c.cost / max_cost                                 # Eq. 12
        pen = torch.relu(t_rec - l_rec) + torch.relu(t_prec - l_prec)
        return l_cost + cfg.beta * pen                             # (K,)

    # multi-start inits: a collapsed pick factor has a dead sigmoid
    # gradient, so Adam runs from several starts at once
    grid = [(2.0, 0.3), (2.0, 1.0), (0.5, 0.5), (3.0, 0.1), (0.5, 1.5),
            (4.0, 0.6)][:max(1, cfg.restarts)]
    flat = torch.stack([flatten_params(
        [init_pipeline_params(p, pick0, width) for p in pipelines])
        for pick0, width in grid])                              # (K, P)
    decay = torch.tensor((cfg.tau_end / cfg.tau_start)
                         ** (1.0 / max(cfg.steps - 1, 1)), dtype=_F32)
    snap_every = max(cfg.steps // max(cfg.snapshots, 1), 1)
    snap_steps = {j * snap_every - 1 for j in range(1, cfg.snapshots)
                  if 0 <= j * snap_every - 1 < cfg.steps - 1}

    m = torch.zeros_like(flat)
    v = torch.zeros_like(flat)
    losses, traj = [], {}
    b1, b2 = torch.tensor(0.9, dtype=_F32), torch.tensor(0.999, dtype=_F32)
    for i in range(cfg.steps):
        step = torch.tensor(float(i), dtype=_F32)
        tau = cfg.tau_start * decay ** step
        x = flat.detach().requires_grad_(True)
        loss = loss_fn(x, tau)
        grad, = torch.autograd.grad(loss.sum(), x)
        with torch.no_grad():
            m = 0.9 * m + 0.1 * grad
            v = 0.999 * v + 0.001 * torch.square(grad)
            t = step + 1.0
            mhat = m / (1 - b1 ** t)
            vhat = v / (1 - b2 ** t)
            flat = flat - cfg.lr * mhat / (torch.sqrt(vhat) + 1e-8)
        losses.append(loss.detach()[0])
        if i in snap_steps:
            traj[i] = flat

    # --- discrete extraction: cheapest feasible candidate wins ---
    K = flat.shape[0]
    cands = [flat[k] for k in range(K)]
    # annealing-path snapshots per restart (conservative -> aggressive)
    for k in range(K):
        for j in range(1, cfg.snapshots):
            step_i = j * snap_every - 1
            if step_i in traj:
                cands.append(traj[step_i][k])
    # fallback: gold-only, identical to the reference by construction
    gold_only = []
    for n in sizes:
        pick = torch.full((n,), -10.0)
        pick[-1] = 10.0
        gold_only.append(R.PipelineParams(pick, torch.zeros(n),
                                          torch.zeros(n)))
    cands.append(flatten_params(gold_only))
    with torch.no_grad():
        c = counts_fn(unflatten_params(torch.stack(cands), sizes), 0.0,
                      hard=True)
        l_rec, l_prec = _bounds(c, cfg.credibility)
    best = None
    for ci in range(len(cands)):
        cost = float(c.cost[ci])
        if float(l_rec[ci]) >= target_recall \
                and float(l_prec[ci]) >= target_precision:
            if best is None or cost < best[1]:
                best = (ci, cost)
    feasible = best is not None
    ci = best[0] if feasible else len(cands) - 1   # gold-only otherwise
    cand = unflatten_params(cands[ci], sizes)
    sel = [(torch.sigmoid(p.pick_logits) > 0.5).numpy() for p in cand]
    for s in sel:
        s[-1] = True  # gold always on
    return OptimizedPlan(
        params=cand, selected=sel, sample_tp=float(c.tp[ci]),
        sample_fp=float(c.fp[ci]), sample_fn=float(c.fn[ci]),
        recall_bound=float(l_rec[ci]), precision_bound=float(l_prec[ci]),
        est_cost=float(c.cost[ci]), feasible=feasible,
        loss_history=torch.stack(losses).numpy() if losses
        else np.zeros(0, np.float32))
