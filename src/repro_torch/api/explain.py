"""EXPLAIN / EXPLAIN ANALYZE: structured plan report + table renderer.

The port of `repro.api.explain` (ExplainReport with its scheduler and
remote footers, and the tree-shaped TreeExplainReport).

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
from repro_torch.core.physical import TREE_ROLES, PhysicalPlan, TreePlan


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
    # cross-query coalescing telemetry: flushes of this query that rode a
    # merged engine batch, and the summed width of those shared batches —
    # zero unless the run went through the QueryScheduler's FlushHub
    measured_shared_batches: Optional[int] = None
    measured_shared_width: Optional[int] = None
    # scheduler footer (key, value) pairs attached by with_scheduler()
    # when the result came through concurrent admission
    scheduler_info: Tuple[Tuple[str, Any], ...] = ()
    # remote footer (key, value) pairs attached by with_remote() when the
    # run touched remote engine members (wire calls, retries, fallbacks,
    # rtt percentiles, bytes on wire)
    remote_info: Tuple[Tuple[str, Any], ...] = ()

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
            measured_shared_batches=sum(
                getattr(sg, "shared_batches", 0)
                for sg in result.stage_stats),
            measured_shared_width=sum(
                getattr(sg, "shared_width", 0)
                for sg in result.stage_stats),
            **exec_cfg)

    def with_scheduler(self, sched) -> "ExplainReport":
        """Attach per-query scheduler telemetry (a QueryTelemetry from
        repro_torch.scheduler) so ANALYZE renders a "scheduler:" footer:
        tenant and tier, queue wait, slot occupancy, and how much of this
        query's work rode cross-query coalesced batches."""
        info = sched.as_dict() if hasattr(sched, "as_dict") else dict(sched)
        return replace(self, scheduler_info=tuple(info.items()))

    def with_remote(self, remote) -> "ExplainReport":
        """Attach per-run remote-engine telemetry (the RuntimeResult's
        `remote` dict from repro_torch.remote.client.remote_run_info) so
        ANALYZE renders a "remote:" footer: wire calls, retries,
        fallbacks, rtt_ms p50/p95, and bytes on wire — per engine."""
        return replace(self, remote_info=tuple(dict(remote).items()))

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
            if self.remote_info:
                info = dict(self.remote_info)
                out.append(
                    f"remote: calls={info.get('calls', 0)} "
                    f"retries={info.get('retries', 0)} "
                    f"fallbacks={info.get('fallbacks', 0)} "
                    f"rtt_ms p50={info.get('rtt_ms_p50', 0.0)} "
                    f"p95={info.get('rtt_ms_p95', 0.0)} "
                    f"wire_kb={info.get('wire_kb', 0.0)}")
                for eng, d in sorted((info.get("engines") or {}).items()):
                    out.append(
                        f"  remote {eng}: calls={d.get('calls', 0)} "
                        f"retries={d.get('retries', 0)} "
                        f"fallbacks={d.get('fallbacks', 0)} "
                        f"wire_kb={d.get('wire_kb', 0.0)}")
            if self.scheduler_info:
                info = dict(self.scheduler_info)
                tenant = info.pop("tenant", "default")
                tier = info.pop("tier", "standard")
                out.append(f"scheduler: tenant={tenant} ({tier})")
                keys = ("queue_wait_s", "run_wall_s", "slots",
                        "shared_batches", "shared_width")
                parts = []
                for k in keys:
                    v = info.pop(k, None)
                    if v is None:
                        continue
                    parts.append(f"{k}={v:.3f}" if isinstance(v, float)
                                 else f"{k}={v}")
                parts += [f"{k}={v}" for k, v in info.items()
                          if k not in ("query_id", "weight")]
                if parts:
                    out.append("  " + " ".join(parts))
            elif self.measured_shared_batches:
                out.append(
                    f"scheduler: shared_batches="
                    f"{self.measured_shared_batches} shared_width="
                    f"{self.measured_shared_width} (flushes merged with "
                    f"concurrent queries)")
        return "\n".join(out)

    def __str__(self) -> str:
        return self.render()


@dataclass(frozen=True)
class TreeExplainReport:
    """Tree-shaped EXPLAIN for a planned semantic join.

    One section per role pipeline (left side, right side, pair cascade)
    rendered under a tree spine, around the *joint* header: the
    query-level bounds the grouped relaxation certifies and the budget
    split — each role's achieved sample-level (recall, precision) under
    the jointly chosen thresholds, i.e. where the query's error budget
    actually went. `JoinResult.explain_analyze()` re-renders it with
    each role's measured execution telemetry (`with_measured`)."""
    n_left: int
    n_right: int
    est_pairs: int
    join_desc: str
    target_recall: float
    target_precision: float
    recall_bound: float                 # joint Bayesian lower bounds
    precision_bound: float
    feasible: bool
    est_cost_s: float
    planning_time_s: float
    # (role, sample_recall, sample_precision) — the budget allocation
    split: Tuple[Tuple[str, float, float], ...]
    sections: Tuple[Tuple[str, ExplainReport], ...]
    measured_runtime_s: Optional[float] = None
    measured_wall_s: Optional[float] = None
    measured_pairs: Optional[int] = None      # pairs actually scored
    measured_accepted: Optional[int] = None   # pairs in the result

    @property
    def analyzed(self) -> bool:
        return self.measured_runtime_s is not None

    @classmethod
    def from_plan(cls, session, plan: TreePlan, n_left: int,
                  n_right: int) -> "TreeExplainReport":
        n_role = {"left": n_left, "right": n_right, "pair": plan.est_pairs}
        sections = tuple(
            (role, ExplainReport.from_plan(session, plan.queries[role],
                                           range(n_role[role]),
                                           plan.roles[role]))
            for role in TREE_ROLES)
        q = plan.queries["pair"]
        return cls(
            n_left=n_left, n_right=n_right, est_pairs=plan.est_pairs,
            join_desc=_describe_node(plan.join),
            target_recall=q.target_recall,
            target_precision=q.target_precision,
            recall_bound=plan.recall_bound,
            precision_bound=plan.precision_bound,
            feasible=plan.feasible, est_cost_s=plan.est_cost,
            planning_time_s=plan.planning_time_s,
            split=tuple((r, *plan.split[r]) for r in TREE_ROLES
                        if r in plan.split),
            sections=sections)

    def with_measured(self, result) -> "TreeExplainReport":
        """EXPLAIN ANALYZE for a tree: each role section gets its own
        run's measured telemetry (`result` is a runtime TreeResult)."""
        sections = tuple((role, rep.with_measured(result.roles[role]))
                         for role, rep in self.sections)
        return replace(self, sections=sections,
                       measured_runtime_s=result.runtime_s,
                       measured_wall_s=result.wall_s,
                       measured_pairs=len(result.pair_items),
                       measured_accepted=len(result.pair_ids))

    def rows(self) -> List[Dict[str, Any]]:
        """Every role's stage table as dicts, with a `role` column."""
        return [dict(r, role=role)
                for role, rep in self.sections for r in rep.rows()]

    def render(self) -> str:
        verb = "EXPLAIN ANALYZE" if self.analyzed else "EXPLAIN"
        verdict = "feasible" if self.feasible else "INFEASIBLE on sample"
        out = [
            f"{verb} — semantic join tree over {self.n_left} x "
            f"{self.n_right} items, guarantees R>={self.target_recall} "
            f"P>={self.target_precision}",
            self.join_desc,
            f"joint bounds R>={self.recall_bound:.3f} "
            f"P>={self.precision_bound:.3f} ({verdict}), "
            f"est_cost={self.est_cost_s:.2f}s, "
            f"est_pairs~{self.est_pairs}, "
            f"planned in {self.planning_time_s:.2f}s",
            "budget split across pipelines (sample R/P at the jointly "
            "chosen thresholds):",
        ]
        out += [f"  {role:>5}: R={rec:.3f} P={prec:.3f}"
                for role, rec, prec in self.split]
        for i, (role, rep) in enumerate(self.sections):
            last = i == len(self.sections) - 1
            head, bar = ("└─ ", "   ") if last else ("├─ ", "│  ")
            if role == "pair":
                out.append(f"{head}pair (~{self.est_pairs} blocked "
                           f"survivor pairs)")
            else:
                n = self.n_left if role == "left" else self.n_right
                out.append(f"{head}{role} ({n} items)")
            out += [bar + line for line in rep.render().splitlines()]
        if self.analyzed:
            out.append(
                f"measured: runtime_s={self.measured_runtime_s:.2f} "
                f"(operator-time sum) wall_s={self.measured_wall_s:.2f} "
                f"(elapsed, 3 runs + pairing) "
                f"pairs_scored={self.measured_pairs} "
                f"accepted={self.measured_accepted}")
        return "\n".join(out)

    def __str__(self) -> str:
        return self.render()
