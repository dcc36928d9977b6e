"""Operator reordering by subset dynamic programming (paper §4.3, Alg. 1).

A copy of `repro.core.ordering` (plain Python, no framework).

After the gradient planner fixes the physical-operator selection, choose the
execution order minimizing total cost. Each physical operator o has
  inter-selectivity: fraction not *rejected* by o  (survivors for OTHER
                     logical operators)
  intra-selectivity: fraction left *unsure* by o   (work left for LATER
                     stages of the SAME logical operator)
DP state: for each subset S of physical operators, the minimal cost and the
remaining tuple count per logical operator. Exact for m <= ~16 operators.
A precedence constraint keeps each cascade's stages in cost order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class PhysOp:
    op_id: int               # index into the global physical-operator list
    logical_id: int          # which logical operator it implements
    stage: int               # position within its cascade (cost order)
    cost: float              # per-tuple cost (seconds)
    sel_inter: float         # P(not rejected)    = accept + unsure
    sel_intra: float         # P(unsure)


def reorder(ops: Sequence[PhysOp], n_tuples: float
            ) -> Tuple[List[int], float]:
    """Returns (op_ids in execution order, estimated total cost)."""
    m = len(ops)
    n_logical = 1 + max((o.logical_id for o in ops), default=0)
    full = (1 << m) - 1

    # DP over subsets: state = (cost, tuple counts per logical op)
    INF = float("inf")
    dp: List[Optional[Tuple[float, Tuple[float, ...]]]] = \
        [None] * (1 << m)
    parent: List[Tuple[int, int]] = [(-1, -1)] * (1 << m)
    dp[0] = (0.0, tuple([float(n_tuples)] * n_logical))

    # precedence: stage k of a cascade requires stages < k already executed
    stage_mask: Dict[Tuple[int, int], int] = {}
    for i, o in enumerate(ops):
        mask = 0
        for j, p in enumerate(ops):
            if p.logical_id == o.logical_id and p.stage < o.stage:
                mask |= 1 << j
        stage_mask[(o.logical_id, o.stage)] = mask

    order_bits = sorted(range(1 << m), key=lambda s: bin(s).count("1"))
    for S in order_bits:
        if dp[S] is None:
            continue
        cost_S, counts = dp[S]
        for i, o in enumerate(ops):
            if S & (1 << i):
                continue
            if (S & stage_mask[(o.logical_id, o.stage)]) != \
                    stage_mask[(o.logical_id, o.stage)]:
                continue
            S2 = S | (1 << i)
            c = cost_S + o.cost * counts[o.logical_id]
            if dp[S2] is None or c < dp[S2][0]:
                new_counts = list(counts)
                for l in range(n_logical):
                    if l == o.logical_id:
                        new_counts[l] = counts[l] * o.sel_intra
                    else:
                        new_counts[l] = counts[l] * o.sel_inter
                dp[S2] = (c, tuple(new_counts))
                parent[S2] = (S, i)

    assert dp[full] is not None
    # reconstruct
    order: List[int] = []
    S = full
    while S:
        S_prev, i = parent[S]
        order.append(ops[i].op_id)
        S = S_prev
    order.reverse()
    return order, dp[full][0]


def greedy_order(ops: Sequence[PhysOp], n_tuples: float
                 ) -> Tuple[List[int], float]:
    """Rank-based heuristic (cost / (1 - sel)) for m too large for exact DP;
    also the baseline the paper contrasts with."""
    def rank(o: PhysOp):
        sel = 0.5 * (o.sel_inter + o.sel_intra)
        return o.cost / max(1.0 - sel, 1e-6)

    by_logical: Dict[int, List[PhysOp]] = {}
    for o in ops:
        by_logical.setdefault(o.logical_id, []).append(o)
    for l in by_logical:
        by_logical[l].sort(key=lambda o: o.stage)
    # interleave cascades by rank of their next stage
    order = []
    counts = {l: float(n_tuples) for l in by_logical}
    total = 0.0
    heads = {l: 0 for l in by_logical}
    while any(heads[l] < len(by_logical[l]) for l in by_logical):
        cands = [(rank(by_logical[l][heads[l]]), l)
                 for l in by_logical if heads[l] < len(by_logical[l])]
        _, l = min(cands)
        o = by_logical[l][heads[l]]
        heads[l] += 1
        total += o.cost * counts[l]
        for l2 in counts:
            counts[l2] *= o.sel_intra if l2 == l else o.sel_inter
        order.append(o.op_id)
    return order, total
