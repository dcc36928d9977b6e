"""Physical operator interface + plan representation.

A physical operator evaluates one semantic operator over a batch of corpus
items and returns raw decision scores (filters: log-odds; maps: values +
confidences). Implementations:

  repro_torch.serving.operators.KVCacheLLMOperator   — the paper's contribution:
      batched forward over precomputed (compressed) KV caches, prefill
      skipped; one profile per (model, compression ratio)
  repro_torch.serving.operators.EmbeddingFilterOperator — cosine-similarity filter
  repro_torch.serving.operators.PythonMapOperator       — generated-code extractor

Costs are measured during profiling (wall-clock per tuple), exactly as the
paper's Step 2 does.
"""
from __future__ import annotations

import abc
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


class PhysicalOperator(abc.ABC):
    """One physical implementation of a semantic operator."""

    name: str
    is_gold: bool = False

    @abc.abstractmethod
    def run_filter(self, items: Sequence[Any], op) -> np.ndarray:
        """Return log-odds scores (N,) for a SemFilter."""

    def run_map(self, items: Sequence[Any], op
                ) -> Tuple[np.ndarray, np.ndarray]:
        """Return (values (N,), confidences (N,)) for a SemMap."""
        raise NotImplementedError

    def cost_model(self) -> float:
        """Static per-tuple cost estimate (seconds); refined by profiling."""
        return 1.0

    def max_batch(self) -> Optional[int]:
        """Largest batch this operator can score per call, or None when
        unbounded. KV-cache operators derive it from the serving engine's
        memory budget: higher compression -> smaller caches -> larger
        batches (the paper's batching speedup, §5), which the batch-aware
        cost model exploits."""
        return None


@dataclass(frozen=True)
class CostCurve:
    """Batch-size-aware operator cost: one call on b tuples costs
    ``fixed_s + per_tuple_s * b`` seconds. Fitted from profiling the
    operator at several batch sizes; the planner amortizes ``fixed_s``
    over the coalesced flush width the executor will actually run
    (bounded by the operator's memory-budgeted max batch), instead of
    assuming the scalar per-tuple cost of one full-sample batch."""
    fixed_s: float          # per-call overhead (dispatch, cache load, jit)
    per_tuple_s: float      # marginal cost of one more tuple in the batch

    def per_tuple_at(self, batch: float) -> float:
        """Effective per-tuple seconds when flushed in batches of size b."""
        return self.per_tuple_s + self.fixed_s / max(float(batch), 1.0)

    def call_cost(self, batch: float) -> float:
        """Wall seconds for one call on a batch of size b."""
        return self.fixed_s + self.per_tuple_s * max(float(batch), 0.0)


@dataclass
class ProfiledPipeline:
    """Profiling result for one logical operator (paper Step 2)."""
    logical_idx: int
    is_map: bool
    op_names: List[str]
    scores: np.ndarray            # (n_ops, N_sample)
    costs: np.ndarray             # (n_ops,) measured per-tuple seconds
    values: Optional[np.ndarray] = None     # (n_ops, N) map outputs
    correct: Optional[np.ndarray] = None    # (n_ops, N) value == gold value
    cost_curves: Optional[List[CostCurve]] = None   # (n_ops,) batch-aware
    batch_caps: Optional[np.ndarray] = None  # (n_ops,) max batch (inf: none)
    op_engines: Optional[List[str]] = None   # (n_ops,) owning engine per op
    #                                          ("" / None: single-engine
    #                                          backend, no pool routing)


@dataclass
class PhysicalPlanStage:
    logical_idx: int
    stage: int                    # position within the cascade
    op_name: str
    thr_hi: float
    thr_lo: float
    is_map: bool
    is_gold: bool
    cost: float                   # effective per-tuple cost at exp_batch
    sel_inter: float = 1.0
    sel_intra: float = 1.0
    exp_batch: float = 0.0        # expected coalesced flush size (0: n/a)
    engine: str = ""              # owning engine of the physical operator
    #                               ("" for single-engine backends) — the
    #                               placement the planner decided, carried
    #                               through FlushTask / StageStats / EXPLAIN


@dataclass
class PhysicalPlan:
    stages: List[PhysicalPlanStage]      # in execution order
    relational: List[Any]                # RelFilter list (executed first)
    est_cost: float
    recall_bound: float
    precision_bound: float
    feasible: bool
    planning_time_s: float = 0.0
    # post-filters a checked pushdown could NOT move ahead of the LLM
    # stages: [(RelFilter, producing_map_logical_idx | None)]. An entry
    # with a map index filters that SemMap's extracted value; None means
    # a structured-row predicate pinned behind a SemTopK/SemAgg barrier.
    # Applied by the executor at result assembly, after the cascades.
    post_relational: List[Tuple[Any, Optional[int]]] = field(
        default_factory=list)

    def describe(self) -> str:
        lines = [f"PhysicalPlan(est_cost={self.est_cost:.2f}s, "
                 f"R>={self.recall_bound:.3f}, P>={self.precision_bound:.3f},"
                 f" feasible={self.feasible})"]
        for r in self.relational:
            lines.append(f"  rel: {r}")
        for s in self.stages:
            tag = " [gold]" if s.is_gold else ""
            batch = f" b~{s.exp_batch:.0f}" if s.exp_batch else ""
            lines.append(
                f"  L{s.logical_idx}/s{s.stage} {s.op_name}{tag} "
                f"thr=({s.thr_lo:+.2f},{s.thr_hi:+.2f}) "
                f"cost={s.cost * 1e3:.2f}ms/t{batch}")
        for r, li in self.post_relational:
            where = f"map L{li} value" if li is not None else "row"
            lines.append(f"  post-rel ({where}): {r}")
        return "\n".join(lines)


# role order of a join tree's pipelines: the planner concatenates
# profiles/params group-major in exactly this order
TREE_ROLES = ("left", "right", "pair")


@dataclass
class TreePlan:
    """A planned logical tree: one PhysicalPlan per role pipeline
    (`left` / `right` sides, then the `pair` cascade over blocked
    survivor pairs), plus the jointly optimized query-level bounds.

    The roles were optimized *together* through one grouped relaxation
    (`relaxation.tree_counts`), so the query-level recall/precision
    budget is split across them; `split` records each role's achieved
    sample-level (recall, precision) under the chosen thresholds — the
    visible budget allocation EXPLAIN renders."""
    roles: Dict[str, PhysicalPlan]       # keyed by TREE_ROLES
    queries: Dict[str, Any]              # role -> Query driving that plan
    join: Any                            # the SemJoin node
    est_cost: float                      # corpus-level expected seconds
    recall_bound: float                  # joint Bayesian lower bounds
    precision_bound: float
    feasible: bool
    split: Dict[str, Tuple[float, float]] = field(default_factory=dict)
    est_pairs: int = 0                   # expected blocked pair-corpus size
    planning_time_s: float = 0.0

    def role_base(self, role: str) -> int:
        """Logical-index offset of a role's pipelines in the flattened
        tree view (left ops first, then right, then pair) — the retag
        that keeps (logical_idx, stage, op_name) unique across roles in
        merged telemetry."""
        base = 0
        for r in TREE_ROLES:
            if r == role:
                return base
            base += len(self.queries[r].semantic_ops)
        raise ValueError(role)

    @property
    def stages(self) -> List[PhysicalPlanStage]:
        """Every role's stages with tree-unique logical indices
        (scheduler/EXPLAIN view; execution uses the role-local plans)."""
        import dataclasses as _dc
        out: List[PhysicalPlanStage] = []
        for role in TREE_ROLES:
            base = self.role_base(role)
            for s in self.roles[role].stages:
                out.append(_dc.replace(
                    s, logical_idx=s.logical_idx + base))
        return out

    @property
    def relational(self) -> List[Any]:
        return [r for role in TREE_ROLES
                for r in self.roles[role].relational]
