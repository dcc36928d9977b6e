"""Query results: enriched wrapper over the runtime's RuntimeResult.

The port of `repro.api.result` (QueryResult, JoinResult and
ResultStream).

QueryResult delegates the raw execution fields (`accepted`, `map_values`,
`stage_stats`, ...) and adds the query-level conveniences the examples
and benchmarks kept re-implementing: lazy gold comparison
(`.metrics()` — the gold execution runs at most once per (corpus, query),
memoized by the Session), accepted-item access, speedup reporting, and
`.explain_analyze()` — the planned ExplainReport re-rendered with this
execution's measured per-stage telemetry next to the planner's numbers.

ResultStream is the `.stream()` terminal verb's iterator: it yields
PartitionResult objects as partitions settle, and exposes the
whole-corpus QueryResult as `.result` once the stream finishes (accessing
it early drains the remaining partitions). Because every PartitionResult
carries its per-partition StageStats delta, the stream maintains live
merged telemetry (`.stage_stats`, `.tuples_settled`, `.progress`) over
the partitions consumed so far — truthful progress reporting at zero
extra execution cost.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.executor import evaluate_vs_gold
from repro_torch.core.logical import Query
from repro_torch.runtime.executor import (PartitionResult, RuntimeResult,
                                          StageStats)


class QueryResult:
    """Result of executing a SemFrame (or a plan) over a corpus."""

    def __init__(self, session, query: Query, items: Sequence[Any],
                 raw: RuntimeResult):
        self.session = session
        self.query = query
        self.items = items
        self.raw = raw
        self._metrics_cache: Optional[Dict[str, float]] = None
        # Populated by the QueryScheduler when this result came through
        # concurrent admission: a QueryTelemetry with queue wait, slot
        # occupancy, and cross-query coalescing counters.
        self.sched = None

    # ---------------- raw execution fields ----------------

    @property
    def accepted(self) -> np.ndarray:
        return self.raw.accepted

    @property
    def map_values(self) -> Dict[int, np.ndarray]:
        return self.raw.map_values

    @property
    def runtime_s(self) -> float:
        """Summed measured operator time across all flushes (total work;
        dispatcher-invariant up to timing noise)."""
        return self.raw.runtime_s

    @property
    def wall_s(self) -> float:
        """Elapsed wall clock of the execution — what the caller waited.
        Under a parallel dispatcher wall_s < runtime_s; the ratio is the
        realized overlap speedup."""
        return self.raw.wall_s

    @property
    def stage_stats(self) -> List[StageStats]:
        return self.raw.stage_stats

    def engine_totals(self) -> Dict[str, Dict[str, Any]]:
        """Measured execution totals per engine (wall_s, n_tuples,
        n_llm_calls, kv_bytes, n_batches) — an exact partition of the
        run's totals, since every stage runs on exactly one engine.
        Single-engine sessions report one "" bucket."""
        from repro_torch.runtime.executor import stage_stats_by_engine
        return stage_stats_by_engine(self.raw.stage_stats)

    @property
    def n_llm_tuples(self) -> int:
        return self.raw.n_llm_tuples

    @property
    def n_partitions(self) -> int:
        return self.raw.n_partitions

    @property
    def dispatcher(self) -> str:
        return self.raw.dispatcher

    # ---------------- conveniences ----------------

    def matches(self) -> List[Any]:
        """The accepted corpus items, in corpus order."""
        return [it for it, ok in zip(self.items, self.accepted) if ok]

    def gold(self) -> "QueryResult":
        """The gold reference execution for the same (query, corpus) —
        memoized by the session, so repeated calls are free."""
        raw = self.session.gold(self.query, self.items)
        return QueryResult(self.session, self.query, self.items, raw)

    def metrics(self, vs: Any = None) -> Dict[str, float]:
        """Global precision/recall (+ tp/fp/fn) of this result.

        vs=None compares against the session's gold reference execution
        (computed lazily, once). Pass another QueryResult/RuntimeResult
        to compare against that instead.
        """
        if vs is None:
            if self._metrics_cache is None:
                self._metrics_cache = evaluate_vs_gold(
                    self.raw, self.session.gold(self.query, self.items),
                    self.query.semantic_ops)
            return self._metrics_cache
        ref = vs.raw if isinstance(vs, QueryResult) else vs
        return evaluate_vs_gold(self.raw, ref, self.query.semantic_ops)

    def aggregate(self) -> Dict[Any, Any]:
        """Group-wise aggregates of the query's SemAgg operator: a dict
        keyed by `group_by` column value (a single None key when
        ungrouped) over the accepted survivors. ``how="mode"`` returns
        the most common committed extraction per group (ties break
        toward the smallest value token, deterministically);
        ``how="count"`` the surviving member count per group."""
        from repro_torch.core.logical import SemAgg
        aggs = [(li, op) for li, op in enumerate(self.query.semantic_ops)
                if isinstance(op, SemAgg)]
        if not aggs:
            raise ValueError("aggregate() needs a SemAgg in the query "
                             "(add .sem_agg before the terminal verb)")
        li, op = aggs[-1]
        vals = self.map_values.get(li)
        groups: Dict[Any, List[int]] = {}
        for i, (it, ok) in enumerate(zip(self.items, self.accepted)):
            if not ok:
                continue
            key = None if op.group_by is None else \
                (getattr(it, "row", {}) or {}).get(op.group_by)
            groups.setdefault(key, []).append(i)
        out: Dict[Any, Any] = {}
        for gkey, idxs in groups.items():
            if op.how == "count":
                out[gkey] = len(idxs)
            else:
                counts: Dict[int, int] = {}
                for i in idxs:
                    v = int(vals[i])
                    counts[v] = counts.get(v, 0) + 1
                out[gkey] = max(counts.items(),
                                key=lambda kv: (kv[1], -kv[0]))[0]
        return out

    def explain_analyze(self):
        """EXPLAIN ANALYZE: the planned ExplainReport for this (query,
        corpus) with this execution's measured telemetry filled in —
        per-stage measured cost/batch/KV next to the planned columns,
        plus runtime_s vs wall_s for the whole run. The planned columns
        come from the plan that *produced this result* (carried on the
        RuntimeResult), never a re-derived one — measured-feedback
        recording after the run can change what session.plan() would
        return today, and pairing those stages with this run's stats
        would be exactly the kind of telemetry lie this report exists
        to rule out."""
        from repro_torch.api.explain import ExplainReport
        plan = self.raw.plan
        if plan is None:     # result constructed outside the runtime
            plan = self.session.plan(self.query, self.items)
        report = ExplainReport.from_plan(self.session, self.query,
                                         self.items, plan)
        report = report.with_measured(self.raw)
        if getattr(self.raw, "remote", None):
            report = report.with_remote(self.raw.remote)
        if self.sched is not None:
            report = report.with_scheduler(self.sched)
        return report

    def speedup_vs_gold(self) -> float:
        """Measured speedup over the gold reference execution, on elapsed
        wall clock when both sides measured it (so parallel dispatch
        shows its real speedup), else on summed operator time."""
        gold = self.session.gold(self.query, self.items)
        if self.raw.wall_s > 0 and gold.wall_s > 0:
            return gold.wall_s / max(self.raw.wall_s, 1e-9)
        return gold.runtime_s / max(self.raw.runtime_s, 1e-9)

    def __len__(self) -> int:
        return int(self.accepted.sum())

    def __repr__(self) -> str:
        return (f"QueryResult({int(self.accepted.sum())}/"
                f"{self.accepted.size} accepted, "
                f"runtime={self.runtime_s:.2f}s, "
                f"partitions={self.n_partitions})")


class JoinResult:
    """Result of executing a two-corpus semantic join (a JoinFrame).

    Wraps the runtime TreeResult: one RuntimeResult per role (left /
    right side cascades, pair cascade over the blocked survivor pairs)
    plus the accepted ``(left_id, right_id)`` pairs. `.metrics()`
    compares the pair-id set against the gold join — both sides' gold
    plans and the gold pair scorer — memoized by the Session so it runs
    at most once per (corpora, tree)."""

    def __init__(self, session, left_items: Sequence[Any],
                 right_items: Sequence[Any], raw):
        self.session = session
        self.left_items = left_items
        self.right_items = right_items
        self.raw = raw                       # runtime.tree.TreeResult
        self._metrics_cache: Optional[Dict[str, float]] = None

    # ---------------- raw execution fields ----------------

    @property
    def pair_ids(self) -> List[Any]:
        """Accepted (left_id, right_id) tuples, deterministic order."""
        return self.raw.pair_ids

    @property
    def pair_items(self) -> List[Any]:
        """The blocked survivor pair corpus the pair cascade scored."""
        return self.raw.pair_items

    @property
    def stage_stats(self) -> List[StageStats]:
        """Merged tree telemetry: every role's stages under tree-unique
        logical indices (tiles exactly like single-pipeline stats)."""
        return self.raw.stage_stats

    @property
    def runtime_s(self) -> float:
        return self.raw.runtime_s

    @property
    def wall_s(self) -> float:
        return self.raw.wall_s

    @property
    def n_llm_tuples(self) -> int:
        return self.raw.n_llm_tuples

    def role(self, name: str) -> RuntimeResult:
        """One role's raw RuntimeResult ('left' | 'right' | 'pair')."""
        return self.raw.roles[name]

    # ---------------- conveniences ----------------

    def matches(self) -> List[Any]:
        """The accepted PairItems, in deterministic left-major order."""
        acc = self.raw.roles["pair"].accepted
        return [p for p, ok in zip(self.raw.pair_items, acc) if ok]

    def gold(self):
        """The gold tree execution for the same (corpora, tree) —
        memoized by the session."""
        return self.session.gold_tree(self.raw.plan, self.left_items,
                                      self.right_items)

    def metrics(self) -> Dict[str, float]:
        """Pair-id-set recall / precision / F1 against the gold join
        (computed lazily, gold runs at most once)."""
        if self._metrics_cache is None:
            from repro_torch.runtime.tree import evaluate_pairs
            self._metrics_cache = evaluate_pairs(self.raw, self.gold())
        return self._metrics_cache

    def explain_analyze(self):
        """Tree-shaped EXPLAIN ANALYZE: the planned TreeExplainReport
        with each role's measured execution telemetry filled in."""
        from repro_torch.api.explain import TreeExplainReport
        report = TreeExplainReport.from_plan(
            self.session, self.raw.plan, len(self.left_items),
            len(self.right_items))
        return report.with_measured(self.raw)

    def __len__(self) -> int:
        return len(self.raw.pair_ids)

    def __repr__(self) -> str:
        return (f"JoinResult({len(self.raw.pair_ids)} pairs of "
                f"{len(self.raw.pair_items)} scored, "
                f"runtime={self.runtime_s:.2f}s)")


class ResultStream(Iterator[PartitionResult]):
    """Iterator over per-partition results; `.result` is the final
    whole-corpus QueryResult (draining any unconsumed partitions).

    Live telemetry over the partitions consumed so far — every
    PartitionResult carries the per-stage StageStats delta accounted
    since the previous emission, and the stream folds them together:

      .stage_stats     — merged per-stage stats (plan order of first
                         appearance); equals the final result's stats
                         once the stream is exhausted
      .tuples_settled  — corpus tuples whose decisions are final
      .progress        — settled fraction of the corpus, 0.0 .. 1.0
    """

    def __init__(self, session, query: Query, items: Sequence[Any], gen):
        self.session = session
        self.query = query
        self.items = items
        self._gen = gen
        self._final: Optional[QueryResult] = None
        self._closed = False
        self._live: Dict[Tuple[int, int, str], StageStats] = {}
        self._settled = 0

    def __iter__(self) -> "ResultStream":
        return self

    def __next__(self) -> PartitionResult:
        if self._final is not None or self._closed:
            raise StopIteration
        try:
            part = next(self._gen)
        except StopIteration as stop:
            self._final = QueryResult(self.session, self.query, self.items,
                                      stop.value)
            raise StopIteration from None
        self._settled += len(part)
        for sg in part.stage_stats:
            key = (sg.logical_idx, sg.stage, sg.op_name)
            m = self._live.get(key)
            if m is None:
                self._live[key] = sg.copy()
            else:
                m.merge(sg)
        return part

    @property
    def stage_stats(self) -> List[StageStats]:
        """Merged per-stage stats over the partitions consumed so far."""
        return list(self._live.values())

    @property
    def tuples_settled(self) -> int:
        return self._settled

    @property
    def progress(self) -> float:
        """Fraction of the corpus whose decisions are final."""
        return self._settled / max(len(self.items), 1)

    @property
    def result(self) -> QueryResult:
        """The whole-corpus QueryResult; exhausts the stream if partitions
        remain unconsumed."""
        while self._final is None:
            if self._closed:
                raise RuntimeError("ResultStream was closed before the "
                                   "execution finished")
            try:
                next(self)
            except StopIteration:
                break
        assert self._final is not None
        return self._final

    def close(self) -> None:
        """Abandon the stream without executing remaining partitions."""
        self._closed = True
        self._gen.close()
