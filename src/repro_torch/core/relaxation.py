"""Continuous relaxation of cascade plans (paper §4.1, Eq. 1-7 & 16).

The port of `repro.core.relaxation`, in float32 torch. Everything here is
a differentiable program over the *profiled sample*: given per-(operator,
tuple) raw scores, pick logits and thresholds, simulate the soft cascade
and produce soft TP/FP/FN and expected cost. The planner differentiates
through this (and through the Beta credible bounds) with Adam.

Conventions
-----------
A *logical* operator is implemented by a pipeline (cascade) of physical
operators sorted by cost; the LAST one is the gold operator: always
selected, never unsure.

Per logical op j we have tensors over its pipeline of n_j physical ops:
  scores   (n_j, N)  raw decision scores on the sample (log-odds / cosine)
  costs    (n_j,)    per-tuple cost seconds
and trainable params:
  pick_logits (..., n_j)       sigma_i = sigmoid(pick/tau)
  thr_hi, thr_lo (..., n_j)    accept if score > thr_hi, reject if < thr_lo

The parameters may carry leading dimensions (the optimizer's restarts,
`(K, n_j)`): every function broadcasts over them, and the outputs gain
the same leading dimensions. The JAX package's `lax.scan` over stages is
a Python loop over stages here.

For maps, scores are *confidences* and correctness (n_j, N) in {0,1} says
whether op i's output value equals the gold op's value for tuple t; the
reject branch is disabled (a map commits or defers).

`tree_counts` generalises `query_counts` to a grouped join tree (two side
pipelines and a pairing cascade over shared pair coordinates).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.runtime.dispatch import DEFAULT_COALESCE
from repro_torch.runtime.kernel import decide_traced


class PipelineParams(NamedTuple):
    pick_logits: torch.Tensor   # (..., n)
    thr_hi: torch.Tensor        # (..., n)
    thr_lo: torch.Tensor        # (..., n)


class PipelineData(NamedTuple):
    scores: torch.Tensor        # (n, N) raw scores per op per sample tuple
    costs: torch.Tensor         # (n,) marginal per-tuple cost (seconds)
    is_map: bool                # map pipelines have no reject branch
    correct: Optional[torch.Tensor] = None   # (n, N) for maps: value == gold
    fixed: Optional[torch.Tensor] = None     # (n,) per-call fixed cost (s);
    #                                          None: scalar cost model
    batch_cap: Optional[torch.Tensor] = None  # (n,) memory-budgeted max
    #                                           batch per op (inf: unbounded)
    meas_width: Optional[torch.Tensor] = None  # (n,) measured flush width
    #                                            per op (nan: unmeasured)
    no_accept: bool = False     # SemTopK pipelines: non-gold stages may only
    #                             reject (their accept mass stays unsure)


class BatchHint(NamedTuple):
    """Execution-batching context for the batch-size-aware cost model:
    the executor flushes each stage in coalesced batches of ~`width`
    tuples (capped by the op's memory-budgeted max batch and by how many
    tuples reach it); `scale` converts sample-tuple reach mass into corpus
    tuples (N_corpus / N_sample)."""
    width: float = float(DEFAULT_COALESCE)
    scale: float = 1.0


def _max(x, v: float):
    """jnp.maximum against a constant: at a tie the gradient splits in
    half, as in JAX (`torch.clamp` would pass all of it). The constant is
    filled on x's device (a fill, not a host copy: CUDA-graph safe)."""
    return torch.maximum(x, x.new_full((), v))


def _clip(x, lo: float, hi: float):
    """jnp.clip, with JAX's gradient at the bounds."""
    return torch.minimum(_max(x, lo), x.new_full((), hi))


def _clamp_tau(tau):
    """A temperature floored at 1e-6: a tensor stays a tensor on its own
    device (the optimizer's annealed tau, read by no host code), a
    number stays a number."""
    if isinstance(tau, torch.Tensor):
        return torch.clamp(tau, min=1e-6)
    return max(float(tau), 1e-6)


def soft_decisions(scores, thr_hi, thr_lo, tau, is_map: bool):
    """Eq. 16: softmax_tau([s - thr_hi, thr_lo - s, 0]) -> (acc, rej, uns),
    each of shape (..., n, N)."""
    z_acc = scores - thr_hi[..., None]
    z_rej = thr_lo[..., None] - scores
    z_uns = torch.zeros_like(z_acc)
    if is_map:
        z_rej = torch.full_like(z_rej, -1e9)
    z = torch.stack([z_acc, z_rej, z_uns], dim=0) / _clamp_tau(tau)
    p = torch.softmax(z, dim=0)
    return p[0], p[1], p[2]


def hard_decisions(scores, thr_hi, thr_lo, is_map: bool):
    """tau -> 0 limit of soft_decisions: argmax of the three logits, via
    the shared runtime decision rule."""
    return decide_traced(scores, thr_hi[..., None], thr_lo[..., None],
                         is_map)


def _set_last(x, last, dim):
    """x with its last entry along `dim` replaced by `last` (out of place,
    so gradients flow to the other entries)."""
    head = x.narrow(dim, 0, x.shape[dim] - 1)
    return torch.cat([head, last.unsqueeze(dim)], dim=dim)


def simulate_pipeline(params: PipelineParams, data: PipelineData, tau,
                      hard: bool = False, pick_tau=None,
                      batch_hint: Optional[BatchHint] = None,
                      reach_weight=None):
    """Soft cascade (Eq. 1-3) for one logical operator.

    Returns (p_accept (..., N), expected_cost (..., N), p_chosen
    (..., n, N)). p_chosen[i, t] = probability tuple t is *decided* by op
    i; maps use it to weight value correctness.

    When `data.fixed` is set, per-op cost is batch-size-aware: the
    expected flush batch at op i is min(reach_i * scale, width_i, cap_i),
    and cost becomes per_tuple + fixed / batch. width_i is the op's
    measured flush width (`data.meas_width`) where recorded, else the
    hint's width. `reach_weight` (..., N) is each tuple's probability of
    reaching this pipeline at all (upstream filters' survival).
    """
    n, N = data.scores.shape
    hint = batch_hint if batch_hint is not None else BatchHint()
    costs = data.costs
    fixed = data.fixed if data.fixed is not None \
        else torch.zeros_like(costs)
    cap = data.batch_cap if data.batch_cap is not None \
        else torch.full_like(costs, float("inf"))
    base_w = torch.full_like(costs, hint.width) \
        if data.meas_width is None \
        else torch.where(torch.isnan(data.meas_width),
                         torch.full_like(costs, hint.width), data.meas_width)
    width = torch.minimum(cap, base_w)          # (n,) max feasible flush
    dev = data.scores.device
    weight = torch.ones(N, device=dev) if reach_weight is None \
        else reach_weight
    if hard:
        sigma = (torch.sigmoid(params.pick_logits) > 0.5).float()
        acc_i, rej_i, uns_i = (t.float() for t in hard_decisions(
            data.scores, params.thr_hi, params.thr_lo, data.is_map))
    else:
        pt = tau if pick_tau is None else pick_tau
        sigma = torch.sigmoid(params.pick_logits / _clamp_tau(pt))
        acc_i, rej_i, uns_i = soft_decisions(
            data.scores, params.thr_hi, params.thr_lo, tau, data.is_map)
    if data.no_accept:
        # reject-only cascade (SemTopK): a non-gold accept stays unsure
        uns_i = uns_i + acc_i
        acc_i = torch.zeros_like(acc_i)
    # gold (last) op: always selected, never unsure, decides at log-odds
    # 0; maps always commit
    sigma = _set_last(sigma, sigma.new_ones(sigma.shape[:-1]), -1)
    if data.is_map:
        gold_acc = torch.ones(N, device=dev)
    elif hard:
        gold_acc = (data.scores[-1] > 0.0).float()
    else:
        gold_acc = torch.sigmoid(data.scores[-1] / _clamp_tau(tau))
    batch = acc_i.shape[:-2]
    gold_acc = gold_acc.expand(batch + (N,))
    acc_i = _set_last(acc_i, gold_acc, -2)
    rej_i = _set_last(rej_i, 1.0 - gold_acc, -2)
    uns_i = _set_last(uns_i, torch.zeros_like(gold_acc), -2)

    shape = torch.broadcast_shapes(batch + (N,), weight.shape)
    accept = torch.zeros(shape, device=dev)
    reject = torch.zeros(shape, device=dev)
    unsure = torch.ones(shape, device=dev)
    cost = torch.zeros(shape, device=dev)
    decided = []
    for i in range(n):
        s = sigma[..., i, None]
        a_i, r_i = acc_i[..., i, :], rej_i[..., i, :]
        reach = unsure * s       # P(op i scores tuple t | reaches pipeline)
        # expected coalesced flush batch at this op
        b_i = _max(torch.minimum(
            (reach * weight).sum(-1) * hint.scale, width[i]), 1.0)
        cost = cost + reach * (costs[i] + fixed[i] / b_i[..., None])
        new_accept = accept + unsure * s * a_i            # Eq. 1
        new_reject = reject + unsure * s * r_i            # Eq. 2
        decided.append(unsure * s * (a_i + r_i))
        accept, reject = new_accept, new_reject
        unsure = 1.0 - new_accept - new_reject            # Eq. 3
    accept = _clip(accept, 0.0, 1.0)
    return accept, cost, torch.stack(decided, dim=-2)


def pipeline_value_correct(decided, correct):
    """Maps: P(value correct) = sum_i P(decided by i) * correct_i."""
    total = _max(decided.sum(-2), 1e-9)
    return (decided * correct).sum(-2) / total \
        * _clip(decided.sum(-2), 0.0, 1.0)


class QueryCounts(NamedTuple):
    tp: torch.Tensor
    fp: torch.Tensor
    fn: torch.Tensor
    cost: torch.Tensor          # total expected cost over sample (seconds)


def query_counts(pipelines, params_list, gold_membership, tau,
                 hard: bool = False, pick_tau=None,
                 batch_hint: Optional[BatchHint] = None) -> QueryCounts:
    """Global soft TP/FP/FN over a query with several logical operators.

    pipelines: list[PipelineData]; params_list: list[PipelineParams]
    gold_membership: (N,) {0,1}, the tuple is in the gold plan's result.

    TP_t = prod_j p_agree_j(t) * g_t ; FP_t = p_in_o(t) - TP_t ;
    FN_t = g_t - TP_t (paper §4.2: per-tuple products over the same
    sample, no independence assumption). A linear chain is a tree of one
    side group of weight 1, so this is `tree_counts` over that group.
    """
    return tree_counts(pipelines, params_list, gold_membership,
                       [TreeGroup(len(pipelines), "side", 1.0, batch_hint)],
                       tau, hard=hard, pick_tau=pick_tau)


class TreeGroup(NamedTuple):
    """One pipeline group of a tree-shaped query in the relaxation.

    The join relaxation runs over *pair coordinates*: every sample tuple
    t = (i, j) pairs a left-sample item with a right-sample item, and
    each side's per-op scores are broadcast onto those coordinates
    (score[op, t] = score[op, i]). Groups structure the survive chain:

      kind "side" — an independent input pipeline (a join side). Its
        reach resets to 1 (the side scans its own corpus regardless of
        the other side's outcomes) and its survival multiplies the
        downstream entry mass.
      kind "pair" — a downstream pairing cascade: a pair is only scored
        when BOTH sides survived, so its entry reach is the product of
        the completed side survivals.

    cost_weight converts summed pair-coordinate reach mass into corpus
    tuples for this group (a left op's reach is constant across the j
    axis, so its pair-coordinate sum overcounts by n_right_sample; the
    weight divides that back out and folds in the sample->corpus scale),
    making QueryCounts.cost the corpus-level expected cost directly.
    hint is the group's own BatchHint (each group flushes against its
    own corpus, so each amortizes fixed costs over its own widths)."""
    count: int               # number of pipelines in this group
    kind: str                # "side" | "pair"
    cost_weight: float       # pair-coordinate reach -> corpus tuples
    hint: Optional[BatchHint]  # group-local batch context (None: default)


def tree_counts(pipelines, params_list, gold_membership, groups, tau,
                hard: bool = False, pick_tau=None) -> QueryCounts:
    """`query_counts` generalized to a grouped plan tree (the query-level
    budget allocation across pipelines, extended past the linear chain).

    pipelines/params_list are concatenated group-major ([left ops...,
    right ops..., pair ops...]); `groups` names the boundaries. TP/FP/FN
    keep the exact per-tuple product form of `query_counts`: a pair is
    in the result iff its left side passes, its right side passes, and
    the pairing cascade accepts, which is the product of accepts over
    all three groups on the shared pair coordinates. Parameters may carry
    leading (restart) dimensions, as in `query_counts`.
    """
    dev = pipelines[0].scores.device
    g = torch.as_tensor(gold_membership, device=dev).float()
    N = g.shape[0]
    p_in = torch.ones(N, device=dev)
    p_good = torch.ones(N, device=dev)
    total_cost = torch.zeros(N, device=dev)
    entry_acc = torch.ones(N, device=dev)   # completed side-group survivals
    idx = 0
    for grp in groups:
        survive = torch.ones(N, device=dev) if grp.kind == "side" \
            else entry_acc
        for _ in range(grp.count):
            data, params = pipelines[idx], params_list[idx]
            idx += 1
            accept, cost, decided = simulate_pipeline(
                params, data, tau, hard, pick_tau, grp.hint,
                reach_weight=survive)
            total_cost = total_cost + grp.cost_weight * survive * cost
            if data.is_map:
                p_good = p_good * pipeline_value_correct(decided,
                                                         data.correct)
            else:
                p_in = p_in * accept
                p_good = p_good * accept
                survive = survive * accept
        if grp.kind == "side":
            entry_acc = entry_acc * survive
    tp = (p_good * g).sum(-1)
    fp = _max(p_in - p_good * g, 0.0).sum(-1)
    fn = _max(g - p_good * g, 0.0).sum(-1)
    return QueryCounts(tp, fp, fn, total_cost.sum(-1))
