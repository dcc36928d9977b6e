"""EXPLAIN / EXPLAIN ANALYZE: structured plan report + table renderer.

The port of `repro.api.explain` (ExplainReport; the tree-shaped report
waits with join trees, and the scheduler / remote footers with their
subsystems).

`SemFrame.explain()` returns an ExplainReport — the logical plan, the
physical cascade in execution order (thresholds, expected coalesced batch,
batch-aware per-tuple cost), the planner's Bayesian quality bounds and
feasibility verdict, and the execution configuration the session would
run it with. `str(report)` renders the table; `.rows()` gives the stage
table as dicts for programmatic use.

`QueryResult.explain_analyze()` re-renders the same report with the
*measured* execution telemetry (`with_measured`) in columns next to the
planned numbers: per-stage measured per-tuple cost, mean flush batch,
tuples scored and KV bytes, plus the run's `runtime_s` (summed operator
time) and `wall_s` (elapsed wall clock) — the planned-vs-measured
comparison that makes cost-model drift visible instead of latent.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.logical import (Query, RelFilter, SemAgg, SemFilter,
                                      SemJoin, SemMap, SemTopK)
from repro_torch.core.physical import PhysicalPlan


@dataclass(frozen=True)
class ExplainStage:
    """One physical cascade stage, in execution order. The ``meas_*``
    fields are None for a plain EXPLAIN and filled by EXPLAIN ANALYZE
    (``ExplainReport.with_measured``); a stage the executed cascade never
    flushed keeps them None."""
    order: int                 # position in the execution schedule
    logical_idx: int           # which logical operator it implements
    stage: int                 # position within that operator's cascade
    op_name: str               # physical operator (model @ compression)
    kind: str                  # "filter" | "map"
    is_gold: bool
    thr_lo: float              # reject below (filters) / n.a. (maps)
    thr_hi: float              # accept above / commit above (maps)
    cost_per_tuple_s: float    # batch-aware effective per-tuple cost
    exp_batch: float           # expected coalesced flush size (0: n/a)
    engine: str = ""           # engine the planner placed this stage on
    #                            ("" for single-engine sessions)
    meas_cost_per_tuple_s: Optional[float] = None   # measured wall/tuple
    meas_batch: Optional[float] = None     # measured mean flush size
    meas_tuples: Optional[int] = None      # tuples actually scored
    meas_kv_bytes: Optional[int] = None    # exact KV bytes materialized
    meas_batches: Optional[int] = None     # flushes executed

    def as_dict(self) -> Dict[str, Any]:
        out = {"order": self.order, "logical_idx": self.logical_idx,
               "stage": self.stage, "op_name": self.op_name,
               "kind": self.kind, "is_gold": self.is_gold,
               "engine": self.engine,
               "thr_lo": self.thr_lo, "thr_hi": self.thr_hi,
               "cost_per_tuple_s": self.cost_per_tuple_s,
               "exp_batch": self.exp_batch}
        if self.meas_tuples is not None:
            out.update({"meas_cost_per_tuple_s": self.meas_cost_per_tuple_s,
                        "meas_batch": self.meas_batch,
                        "meas_tuples": self.meas_tuples,
                        "meas_kv_bytes": self.meas_kv_bytes,
                        "meas_batches": self.meas_batches})
        return out


def _describe_node(node) -> str:
    # subclass checks first: SemTopK is a SemFilter, SemAgg a SemMap
    if isinstance(node, SemTopK):
        return f"SemTopK k={node.k} {node.text!r} (task {node.task_id})"
    if isinstance(node, SemAgg):
        grp = f" group_by={node.group_by!r}" if node.group_by else ""
        return (f"SemAgg {node.how}{grp} {node.text!r} "
                f"(task {node.task_id} -> {node.out_column!r})")
    if isinstance(node, SemJoin):
        on = f", on={node.on!r}" if node.on else ""
        return f"SemJoin {node.text!r} (task {node.task_id}{on})"
    if isinstance(node, SemFilter):
        return f"SemFilter {node.text!r} (task {node.task_id})"
    if isinstance(node, SemMap):
        return (f"SemMap {node.text!r} (task {node.task_id} "
                f"-> {node.out_column!r})")
    if isinstance(node, RelFilter):
        return f"RelFilter {node.column} {node.op} {node.value!r}"
    return repr(node)


@dataclass(frozen=True)
class ExplainReport:
    """Structured EXPLAIN output for one (query, corpus, session)."""
    n_items: int
    target_recall: float
    target_precision: float
    logical: Tuple[str, ...]            # declared plan, user order
    relational: Tuple[str, ...]         # pulled-up relational prefilters
    stages: Tuple[ExplainStage, ...]    # physical cascade, execution order
    est_cost_s: float                   # planner's full-corpus estimate
    recall_bound: float                 # Bayesian lower bounds the plan
    precision_bound: float              # certifies at the credibility level
    feasible: bool                      # targets attainable on the sample
    planning_time_s: float
    backend: str                        # runtime backend name
    dispatcher: str                     # session execution defaults
    partition_size: Optional[int]
    coalesce: Optional[int]
    # RelFilters the checked pushdown could NOT move ahead of the LLM
    # stages (they reference a SemMap's output column, or sit behind a
    # SemTopK/SemAgg barrier) — executed as post-filters
    post_relational: Tuple[str, ...] = ()
    # physical candidates the planner profiled per logical operator (cost
    # order, gold last), e.g. the int8 rungs a plan may have dropped
    candidates: Tuple[Tuple[str, ...], ...] = ()
    # measured execution summary — None until with_measured() (ANALYZE)
    measured_runtime_s: Optional[float] = None    # summed operator time
    measured_wall_s: Optional[float] = None       # elapsed wall clock
    measured_partitions: Optional[int] = None
    measured_dispatcher: Optional[str] = None     # what actually ran it
    measured_workers: Optional[int] = None
    # transfer overlap telemetry (serving engines only): H2D copy time
    # the engine hid behind decode compute, and KV cache bytes the jitted
    # decode released for reuse — None until ANALYZE
    measured_h2d_overlap_s: Optional[float] = None
    measured_donated_bytes: Optional[int] = None
    # per-engine measured totals (engine, wall_s, n_tuples, n_llm_calls,
    # kv_bytes) — exact partition of the run totals; empty until ANALYZE,
    # rendered only for pooled (multi-engine-tagged) executions
    measured_engines: Tuple[Tuple[str, float, int, int, int], ...] = ()

    @property
    def analyzed(self) -> bool:
        """True once measured execution telemetry has been attached."""
        return self.measured_runtime_s is not None

    @classmethod
    def from_plan(cls, session, query: Query, items: Sequence[Any],
                  plan: PhysicalPlan) -> "ExplainReport":
        from repro_torch.runtime.dispatch import DEFAULT_COALESCE, effective_spec
        cfg = session.config
        candidates = tuple(
            tuple(p.name for p in session.backend.candidates(op))
            for op in query.semantic_ops)
        stages = tuple(
            ExplainStage(
                order=i, logical_idx=st.logical_idx, stage=st.stage,
                op_name=st.op_name, kind="map" if st.is_map else "filter",
                is_gold=st.is_gold, thr_lo=st.thr_lo, thr_hi=st.thr_hi,
                cost_per_tuple_s=st.cost, exp_batch=st.exp_batch,
                engine=getattr(st, "engine", ""))
            for i, st in enumerate(plan.stages))
        return cls(
            n_items=len(items),
            target_recall=query.target_recall,
            target_precision=query.target_precision,
            logical=tuple(_describe_node(n) for n in query.nodes),
            relational=tuple(_describe_node(r) for r in plan.relational),
            stages=stages,
            est_cost_s=plan.est_cost,
            recall_bound=plan.recall_bound,
            precision_bound=plan.precision_bound,
            feasible=plan.feasible,
            planning_time_s=plan.planning_time_s,
            backend=getattr(session.backend, "name", "backend"),
            dispatcher=effective_spec(cfg.dispatcher),
            partition_size=cfg.partition_size,
            coalesce=cfg.coalesce if cfg.coalesce is not None
            else DEFAULT_COALESCE,
            post_relational=tuple(
                f"{_describe_node(r)} "
                + (f"[over map L{li}'s extracted value]" if li is not None
                   else "[post-barrier row filter]")
                for r, li in getattr(plan, "post_relational", ())),
            candidates=candidates)

    def with_measured(self, result) -> "ExplainReport":
        """EXPLAIN ANALYZE: a new report with the measured per-stage
        telemetry of `result` (a RuntimeResult) filled in next to the
        planned columns. Stages are matched by (logical_idx, stage,
        op_name) — the StageStats identity key — so a stage the cascade
        never flushed keeps its measured fields None and renders as
        ``--``."""
        by_key = {(sg.logical_idx, sg.stage, sg.op_name): sg
                  for sg in result.stage_stats}
        stages = []
        for s in self.stages:
            sg = by_key.get((s.logical_idx, s.stage, s.op_name))
            if sg is None or not sg.n_batches:
                stages.append(s)
                continue
            stages.append(replace(
                s,
                meas_cost_per_tuple_s=sg.wall_s / max(sg.n_tuples, 1),
                meas_batch=sg.mean_batch,
                meas_tuples=sg.n_tuples,
                meas_kv_bytes=sg.kv_bytes,
                meas_batches=sg.n_batches))
        # the execution line must describe the run that produced these
        # measurements, not the session defaults — per-call overrides
        # (dispatcher / partition_size / coalesce) are carried on the
        # RuntimeResult (coalesce is always recorded by the runtime, so
        # its presence marks a result with recorded execution config)
        exec_cfg = {}
        if result.coalesce is not None:
            exec_cfg = {"dispatcher": f"{result.dispatcher}",
                        "partition_size": result.partition_size,
                        "coalesce": result.coalesce}
        from repro_torch.runtime.executor import stage_stats_by_engine
        per_engine = tuple(
            (eng, d["wall_s"], d["n_tuples"], d["n_llm_calls"],
             d["kv_bytes"])
            for eng, d in sorted(
                stage_stats_by_engine(result.stage_stats).items()))
        return replace(
            self, stages=tuple(stages),
            measured_runtime_s=result.runtime_s,
            measured_wall_s=result.wall_s,
            measured_partitions=result.n_partitions,
            measured_dispatcher=result.dispatcher,
            measured_workers=result.n_workers,
            measured_h2d_overlap_s=sum(
                getattr(sg, "h2d_overlap_s", 0.0)
                for sg in result.stage_stats),
            measured_donated_bytes=sum(
                getattr(sg, "donated_bytes", 0)
                for sg in result.stage_stats),
            measured_engines=per_engine,
            **exec_cfg)

    def rows(self) -> List[Dict[str, Any]]:
        """The stage table as dicts (execution order)."""
        return [s.as_dict() for s in self.stages]

    # ---------------- rendering ----------------

    def render(self) -> str:
        verb = "EXPLAIN ANALYZE" if self.analyzed else "EXPLAIN"
        head = (f"{verb} — {len(self.logical)} operators over "
                f"{self.n_items} items, guarantees R>={self.target_recall} "
                f"P>={self.target_precision}")
        out = [head, "logical plan (declared order):"]
        out += [f"  {i}: {d}" for i, d in enumerate(self.logical)]
        if self.relational:
            out.append("relational prefilters (pushed down, run first):")
            out += [f"  {d}" for d in self.relational]
        if self.post_relational:
            out.append("post-filters (pinned — pushdown illegal):")
            out += [f"  {d}" for d in self.post_relational]
        if self.candidates:
            out.append("candidates profiled (cost order, gold last):")
            out += [f"  L{i}: {' '.join(names)}"
                    for i, names in enumerate(self.candidates)]
        verdict = "feasible" if self.feasible else "INFEASIBLE on sample"
        out.append(
            f"physical cascade ({verdict}, est_cost={self.est_cost_s:.2f}s,"
            f" bounds R>={self.recall_bound:.3f} "
            f"P>={self.precision_bound:.3f}, "
            f"planned in {self.planning_time_s:.2f}s):")
        # the engine column appears as soon as any stage carries a pool
        # placement; single-engine sessions keep the pre-pool table shape
        engines = any(s.engine for s in self.stages)
        cols = [("#", 2), ("op", 24)]
        if engines:
            eng_w = max(6, max(len(s.engine) for s in self.stages))
            cols += [("engine", eng_w)]
        cols += [("L/s", 5), ("kind", 6),
                 ("thr_lo", 7), ("thr_hi", 7), ("cost/t", 9), ("batch", 6)]
        if self.analyzed:
            # measured columns, planned-vs-measured side by side
            cols += [("meas/t", 9), ("mbatch", 6), ("tuples", 7),
                     ("kvMB", 7)]
        out.append("  " + " ".join(f"{name:>{w}}" for name, w in cols))
        for s in self.stages:
            gold = " [gold]" if s.is_gold else ""
            # pooled operator names carry the engine prefix; the table
            # shows the placement in its own column instead of twice
            op = s.op_name
            if s.engine and op.startswith(s.engine + "/"):
                op = op[len(s.engine) + 1:]
            row = [
                f"{s.order:>2}",
                f"{op + gold:>24}",
            ]
            if engines:
                row.append(f"{s.engine or '--':>{eng_w}}")
            row += [
                f"{f'{s.logical_idx}/{s.stage}':>5}",
                f"{s.kind:>6}",
                "     --" if s.is_gold else f"{s.thr_lo:>+7.2f}",
                "     --" if s.is_gold else f"{s.thr_hi:>+7.2f}",
                f"{s.cost_per_tuple_s * 1e3:>7.2f}ms",
                f"{s.exp_batch:>6.0f}" if s.exp_batch else "    --",
            ]
            if self.analyzed:
                if s.meas_tuples is None:
                    row += ["       --", "    --", "     --", "     --"]
                else:
                    row += [
                        f"{s.meas_cost_per_tuple_s * 1e3:>7.2f}ms",
                        f"{s.meas_batch:>6.1f}",
                        f"{s.meas_tuples:>7d}",
                        f"{s.meas_kv_bytes / 1e6:>7.1f}",
                    ]
            out.append("  " + " ".join(row))
        psize = self.partition_size if self.partition_size is not None \
            else "whole-corpus"
        out.append(
            f"execution: backend={self.backend} "
            f"dispatcher={self.dispatcher} "
            f"partition_size={psize} "
            f"coalesce={self.coalesce}")
        if self.analyzed:
            out.append(
                f"measured: runtime_s={self.measured_runtime_s:.2f} "
                f"(operator-time sum) wall_s={self.measured_wall_s:.2f} "
                f"(elapsed) partitions={self.measured_partitions} "
                f"dispatcher={self.measured_dispatcher}"
                f":{self.measured_workers}")
            if self.measured_h2d_overlap_s or self.measured_donated_bytes:
                out.append(
                    f"transfers: h2d_overlap_s="
                    f"{self.measured_h2d_overlap_s:.3f} (H2D hidden "
                    f"behind decode) donated_MB="
                    f"{self.measured_donated_bytes / 1e6:.1f} "
                    f"(KV buffers released for reuse)")
            if any(eng for eng, *_ in self.measured_engines):
                for eng, wall, tuples, llm, kv in self.measured_engines:
                    out.append(
                        f"  engine {eng or '--'}: wall_s={wall:.2f} "
                        f"tuples={tuples} llm_calls={llm} "
                        f"kvMB={kv / 1e6:.1f}")
        return "\n".join(out)

    def __str__(self) -> str:
        return self.render()
