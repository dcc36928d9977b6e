"""Profiling of semantic operators on a data sample (paper Fig. 2, step 2).

The port of `repro.core.profiling` (numpy, no framework; a copy with the
imports pointed at the port).

Runs every available physical operator on an i.i.d. sample through the
runtime's single operator-invocation path (`runtime.run_operator`),
recording raw outputs (log-odds / values) and measured per-tuple cost.
Storing outputs lets the planner simulate any search-space configuration
without further LLM calls — exactly the paper's approach — and because
profiling and execution share one invocation path, profiled costs are
measured under the same batching/telemetry regime the executor uses.

Cost is batch-size-aware: each operator is timed at two warmed sub-sample
batch sizes (so jit compilation pollutes neither point) and a
`CostCurve(fixed_s, per_tuple_s)` is fitted through them, so the planner
can amortize fixed
per-call overhead over the coalesced flush width the executor will really
use — a scalar per-tuple cost from one full-sample batch hides exactly
the batching speedup (paper §5) the KV-compression ladder buys.
Operators also report their memory-budgeted `max_batch` (higher
compression -> larger batches), recorded as the pipeline's batch caps.

Sample profiling predicts; `MeasuredBatchStore` remembers. The store
aggregates per-operator StageStats from *real* executions — fed live by
`Session` or loaded from the benchmark trajectory's
``stage_stats-<ts>-<sha>.json`` snapshots — and answers the two questions
the planner's batch-aware cost model otherwise guesses from static
defaults: what flush batch does this op actually see (`mean_batch`), and
what does a tuple actually cost there (`wall_per_tuple`). That closes the
measure -> plan loop: `plan_query(measured=...)` prices operators at
their measured flush widths instead of the static coalesce width.

`registry` may be a legacy `op -> [PhysicalOperator]` callable or any
runtime Backend.
"""
from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.logical import Query, SemMap
from repro_torch.core.physical import CostCurve, ProfiledPipeline


@dataclass
class _OpMeasure:
    """Accumulated measured telemetry for one physical operator."""
    wall_s: float = 0.0
    n_tuples: int = 0
    n_batches: int = 0
    kv_bytes: int = 0

    def add(self, wall_s: float, n_tuples: int, n_batches: int,
            kv_bytes: int = 0) -> None:
        self.wall_s += float(wall_s)
        self.n_tuples += int(n_tuples)
        self.n_batches += int(n_batches)
        self.kv_bytes += int(kv_bytes)


class MeasuredBatchStore:
    """Per-operator measured execution feedback (paper's measure->plan
    loop; cf. cost-aware re-optimization in agentic query execution).

    Accumulates StageStats — from live RuntimeResults or from the
    benchmark trajectory's ``stage_stats*.json`` artifacts — keyed by
    physical operator name, and exposes the measured flush width
    (`mean_batch`) and measured per-tuple wall cost (`wall_per_tuple`)
    the planner's batch-aware cost model can price against instead of
    static defaults. `version` increments on every record/load so plan
    memoizers can key on the store's state.
    """

    def __init__(self) -> None:
        self._by_op: Dict[str, _OpMeasure] = {}
        self.version = 0

    # ---------------- recording ----------------

    def record_stats(self, stage_stats: Sequence[Any]) -> None:
        """Fold in per-stage stats: StageStats objects or their as_dict /
        trajectory-row form (anything with op_name/wall_s/n_tuples/
        n_batches [+ kv_bytes])."""
        for s in stage_stats:
            row = s if isinstance(s, dict) else s.as_dict()
            if not row.get("n_batches"):
                continue            # never flushed: nothing measured
            m = self._by_op.setdefault(row["op_name"], _OpMeasure())
            m.add(row["wall_s"], row["n_tuples"], row["n_batches"],
                  row.get("kv_bytes", 0))
        self.version += 1

    def record_result(self, result: Any) -> None:
        """Fold in a RuntimeResult's stage_stats."""
        self.record_stats(result.stage_stats)

    # ---------------- persistence (the benchmark trajectory) ----------

    def load_file(self, path: str) -> None:
        """Fold in one stage-stats artifact: either the flat list
        ``stage_stats.json`` writes or a timestamped snapshot
        ``{"meta": ..., "stages": [...]}``."""
        with open(path) as f:
            data = json.load(f)
        rows = data.get("stages", []) if isinstance(data, dict) else data
        self.record_stats(rows)

    @classmethod
    def from_dir(cls, root: str, pattern: str = "stage_stats-*.json"
                 ) -> "MeasuredBatchStore":
        """Aggregate every *timestamped* trajectory snapshot under
        `root` (oldest first; the store sums, so order only matters for
        reproducibility of float accumulation). The pattern deliberately
        excludes the flat ``stage_stats.json`` "latest" file — the
        benchmark harness writes the same rows to both, and folding both
        in would double-weight the most recent run against the rest of
        the trajectory."""
        store = cls()
        for path in sorted(glob.glob(os.path.join(root, pattern))):
            try:
                store.load_file(path)
            except (OSError, ValueError):
                continue            # unreadable snapshot: skip, don't fail
        return store

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({op: vars(m) for op, m in self._by_op.items()}, f,
                      indent=1)

    # ---------------- queries the planner asks ----------------

    def __len__(self) -> int:
        return len(self._by_op)

    def __contains__(self, op_name: str) -> bool:
        return op_name in self._by_op

    def op_names(self) -> List[str]:
        return sorted(self._by_op)

    def mean_batch(self, op_name: str) -> Optional[float]:
        """Measured mean coalesced flush width for this op, or None."""
        m = self._by_op.get(op_name)
        if m is None or m.n_batches == 0:
            return None
        return m.n_tuples / m.n_batches

    def wall_per_tuple(self, op_name: str) -> Optional[float]:
        """Measured wall seconds per scored tuple, or None."""
        m = self._by_op.get(op_name)
        if m is None or m.n_tuples == 0:
            return None
        return m.wall_s / m.n_tuples

    def blended_width(self, op_names: Optional[Sequence[str]] = None
                      ) -> Optional[float]:
        """Tuple-weighted mean measured flush width over `op_names` (or
        every recorded op) — the scalar BatchHint.width replacement when
        per-op widths are unavailable downstream. None if nothing
        measured. Duplicate names (an op shared by several logical
        pipelines) are counted once — the store's totals are already
        cross-pipeline sums."""
        names = dict.fromkeys(op_names) if op_names is not None \
            else list(self._by_op)
        tot_t = tot_b = 0
        for name in names:
            m = self._by_op.get(name)
            if m is not None:
                tot_t += m.n_tuples
                tot_b += m.n_batches
        if tot_b == 0:
            return None
        return tot_t / tot_b


def batch_drift(plan, stage_stats: Sequence[Any]) -> float:
    """Largest planned-vs-measured flush-width divergence across a plan's
    executed stages: max over stages of ratio(mean_batch, exp_batch),
    taken both ways so shrink and growth both count. 1.0 = perfect
    agreement; stages the planner gave no batch expectation (exp_batch 0)
    or that never flushed are skipped.
    """
    planned = {(st.logical_idx, st.stage, st.op_name): st.exp_batch
               for st in plan.stages}
    worst = 1.0
    for sg in stage_stats:
        exp = planned.get((sg.logical_idx, sg.stage, sg.op_name), 0.0)
        if not exp or not sg.n_batches:
            continue
        measured = max(sg.mean_batch, 1e-9)
        worst = max(worst, measured / exp, exp / measured)
    return worst


def fit_cost_curve(points: Sequence[Tuple[int, float]]) -> CostCurve:
    """Least-squares fit of wall = fixed + per_tuple * batch through
    (batch_size, wall_s) points; both coefficients clamped non-negative
    (timing noise can produce a negative intercept or slope)."""
    if len(points) < 2:
        b, w = points[0]
        return CostCurve(0.0, max(w / max(b, 1), 1e-9))
    bs = np.asarray([p[0] for p in points], np.float64)
    ws = np.asarray([p[1] for p in points], np.float64)
    var = float(np.sum((bs - bs.mean()) ** 2))
    slope = float(np.sum((bs - bs.mean()) * (ws - ws.mean()))) / max(var,
                                                                     1e-12)
    slope = max(slope, 1e-9)
    fixed = max(float(ws.mean()) - slope * float(bs.mean()), 0.0)
    return CostCurve(fixed, slope)


def profile_query(query: Query, items: Sequence[Any],
                  registry, sample_frac: float = 0.15,
                  seed: int = 0, min_sample: int = 20):
    """Returns (profiles: list[ProfiledPipeline], sample_idx).

    registry: Backend, or callable (semantic_op) -> list[PhysicalOperator]
    sorted by cost_model(), gold LAST.
    """
    # deferred import: the runtime depends on core's plan dataclasses
    from repro_torch.runtime.backend import as_backend
    from repro_torch.runtime.executor import run_operator

    backend = as_backend(registry)
    rng = np.random.default_rng(seed)
    n = len(items)
    k = max(min_sample, int(round(sample_frac * n)))
    k = min(k, n)
    sample_idx = np.sort(rng.choice(n, size=k, replace=False))
    sample = [items[i] for i in sample_idx]
    # cost-curve points: two sub-sample batch sizes, each timed on a
    # *second* (warmed) call so jit compilation lands in neither point —
    # the full-sample scoring run stays cold (its compile would otherwise
    # masquerade as per-tuple cost in the fit)
    b_small = max(2, k // 8) if k >= 9 else 0
    b_mid = max(b_small + 1, k // 3) if b_small else 0

    profiles: List[ProfiledPipeline] = []
    for li, op in enumerate(query.semantic_ops):
        ops = backend.candidates(op)
        assert ops[-1].is_gold, "gold operator must be last in the registry"
        scores, costs, values, curves, caps = [], [], [], [], []
        for phys in ops:
            out = run_operator(backend, op, phys.name, sample)
            scores.append(np.asarray(out.scores, np.float32))
            costs.append(max(out.wall_s / max(len(sample), 1), 1e-9))
            if out.values is not None:
                values.append(np.asarray(out.values))
            points = []
            if b_small:
                for b in (b_small, b_mid):
                    run_operator(backend, op, phys.name, sample[:b])  # warm
                    timed = run_operator(backend, op, phys.name, sample[:b])
                    points.append((b, timed.wall_s))
            else:       # sample too small to fit a line: scalar model
                points.append((len(sample), out.wall_s))
            curves.append(fit_cost_curve(points))
            cap_fn = getattr(phys, "max_batch", None)
            cap = cap_fn() if callable(cap_fn) else None
            caps.append(float(cap) if cap else np.inf)
        is_map = isinstance(op, SemMap)
        prof = ProfiledPipeline(
            logical_idx=li, is_map=is_map,
            op_names=[p.name for p in ops],
            scores=np.stack(scores),
            costs=np.asarray(costs, np.float32),
            cost_curves=curves,
            batch_caps=np.asarray(caps, np.float64),
            op_engines=[getattr(p, "engine_name", "") for p in ops],
        )
        if is_map:
            vals = np.stack(values)
            prof.values = vals
            prof.correct = (vals == vals[-1][None, :]).astype(np.float32)
        profiles.append(prof)
    return profiles, sample_idx
