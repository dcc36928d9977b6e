"""SemFrame: a lazy, immutable semantic-query builder.

The port of `repro.api.frame` (SemFrame; the two-corpus JoinFrame waits
with join trees, and `sem_join` raises).

Every chain method returns a *new* frame — frames are never mutated, so a
partially built chain can be reused and branched freely::

    base = sess.frame(items).sem_filter("is about sports", task_id=1)
    strict = base.with_guarantees(recall=0.95, precision=0.95)
    loose = base.with_guarantees(recall=0.6, precision=0.6)

Nothing executes until a terminal verb:

    .explain()   — plan only: a structured ExplainReport (logical plan,
                   physical cascade stages with thresholds and batch-aware
                   costs, bounds, feasibility), rendered as a table
    .execute()   — plan + run through the streaming runtime; returns a
                   QueryResult with lazy `.metrics()` gold comparison
    .stream()    — plan + run incrementally; a ResultStream yielding
                   PartitionResult per corpus partition as soon as its
                   decisions are final (the whole-corpus QueryResult is
                   available afterwards as `.result`)

A frame compiles to the stable internal layer verbatim: `.to_query()` is
the exact `core.logical.Query` a hand-built pipeline would construct, and
planning/execution run through `plan_query` / `run_plan` unchanged — the
API-parity tests pin bit-identical decisions between the two paths.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

from repro_torch.core.logical import (Query, RelFilter, SemAgg, SemFilter,
                                      SemMap, SemTopK)
from repro_torch.core.physical import PhysicalPlan

from repro_torch.api.session import _UNSET, _not_ported


class SemFrame:
    """Lazy query over one corpus, bound to a Session."""

    __slots__ = ("_session", "_items", "_nodes", "_recall", "_precision")

    def __init__(self, session, items: Sequence[Any],
                 nodes: Tuple[Any, ...] = (),
                 recall: Optional[float] = None,
                 precision: Optional[float] = None):
        self._session = session
        self._items = items
        self._nodes = tuple(nodes)
        self._recall = recall
        self._precision = precision

    # ---------------- chainable builders (each returns a new frame) ----

    def _with(self, node) -> "SemFrame":
        return SemFrame(self._session, self._items, self._nodes + (node,),
                        self._recall, self._precision)

    def sem_filter(self, text: str, task_id: int,
                   modality: str = "text") -> "SemFrame":
        """Keep items satisfying an LLM-powered natural-language
        predicate (`task_id` names the dataset task it evaluates)."""
        return self._with(SemFilter(text, task_id, modality))

    def sem_map(self, text: str, task_id: int, *,
                out_column: str = "extracted",
                modality: str = "text") -> "SemFrame":
        """Extract a new column with an LLM-powered map."""
        return self._with(SemMap(text, task_id, out_column, modality))

    def sem_topk(self, text: str, task_id: int, k: int, *,
                 modality: str = "text") -> "SemFrame":
        """Keep the k best items under an LLM-scored ranking criterion.

        Scored like a sem_filter, but admission is a global rank cut:
        the cascade's cheap stages may only *reject* early (early
        termination), and the final result is the k top gold-scored
        survivors — so the accept boundary is schedule-invariant."""
        return self._with(SemTopK(text, task_id, modality=modality, k=k))

    def sem_agg(self, text: str, task_id: int, *,
                group_by: Optional[str] = None, how: str = "mode",
                out_column: str = "aggregated",
                modality: str = "text") -> "SemFrame":
        """Group-wise aggregate of an LLM-extracted value: executes as
        the underlying extraction (one committed value per survivor),
        aggregated per `group_by` group by `QueryResult.aggregate()`.
        The planner tightens per-item budgets so the *group-level*
        guarantee holds (see core.logical.SemAgg)."""
        return self._with(SemAgg(text, task_id, out_column=out_column,
                                 modality=modality, group_by=group_by,
                                 how=how))

    def filter(self, column: str, op: str, value: Any) -> "SemFrame":
        """Classical relational predicate over structured columns (cheap;
        the optimizer pushes these ahead of every semantic operator when
        legal — a predicate over a sem_map's output column, or one
        declared after a sem_topk/sem_agg barrier, stays pinned and runs
        as a post-filter)."""
        return self._with(RelFilter(column, op, value))

    def sem_join(self, other: Any, text: str, task_id: int, *,
                 on: Optional[str] = None, modality: str = "text"):
        """Two-corpus semantic joins are not ported yet."""
        _not_ported("SemFrame.sem_join (join trees)")

    def with_guarantees(self, recall: Optional[float] = None,
                        precision: Optional[float] = None) -> "SemFrame":
        """Declare end-to-end quality targets the plan must satisfy
        (either side defaults to the previously declared value)."""
        return SemFrame(
            self._session, self._items, self._nodes,
            self._recall if recall is None else float(recall),
            self._precision if precision is None else float(precision))

    # ---------------- compilation ----------------

    @property
    def nodes(self) -> Tuple[Any, ...]:
        return self._nodes

    @property
    def items(self) -> Sequence[Any]:
        return self._items

    def to_query(self) -> Query:
        """Compile to the internal logical Query (the exact object a
        hand-built pipeline would pass to plan_query)."""
        kwargs = {}
        if self._recall is not None:
            kwargs["target_recall"] = self._recall
        if self._precision is not None:
            kwargs["target_precision"] = self._precision
        return Query(list(self._nodes), **kwargs)

    def plan(self) -> PhysicalPlan:
        """The physical cascade plan (memoized by the session, so
        explain/execute/stream on equal frames plan once)."""
        self._check_nonempty()
        return self._session.plan(self.to_query(), self._items)

    # ---------------- terminal verbs ----------------

    def explain(self):
        """Plan without executing: a structured, renderable report of the
        logical plan, cascade stages, bounds and costs."""
        from repro_torch.api.explain import ExplainReport
        return ExplainReport.from_plan(
            self._session, self.to_query(), self._items, self.plan())

    def execute(self, *, partition_size=_UNSET, coalesce=_UNSET,
                dispatcher=_UNSET, replan_on_drift=None):
        """Plan + execute over the full corpus; returns a QueryResult.
        `replan_on_drift` forwards to Session.run: re-plan + re-execute
        once if measured flush batches diverge from planned by more than
        the given factor."""
        from repro_torch.api.result import QueryResult
        query = self.to_query()
        raw = self._session.run(self.plan(), query, self._items,
                                partition_size=partition_size,
                                coalesce=coalesce, dispatcher=dispatcher,
                                replan_on_drift=replan_on_drift)
        return QueryResult(self._session, query, self._items, raw)

    def stream(self, *, partition_size=_UNSET, coalesce=_UNSET,
               dispatcher=_UNSET):
        """Plan + execute incrementally: a ResultStream yielding one
        PartitionResult per corpus partition as soon as every tuple in it
        has cleared the cascade — million-tuple corpora can be consumed
        while later partitions are still executing."""
        from repro_torch.api.result import ResultStream
        query = self.to_query()
        gen = self._session.iter_run(self.plan(), query, self._items,
                                     partition_size=partition_size,
                                     coalesce=coalesce,
                                     dispatcher=dispatcher)
        return ResultStream(self._session, query, self._items, gen)

    # ---------------- misc ----------------

    def _check_nonempty(self) -> None:
        if not self._nodes:
            raise ValueError("empty SemFrame: add sem_filter / sem_map / "
                             "filter operators before a terminal verb")

    def __repr__(self) -> str:
        q = self.to_query()
        parts = [f"{type(n).__name__}({getattr(n, 'text', getattr(n, 'column', ''))!r})"
                 for n in self._nodes]
        return (f"SemFrame({len(self._items)} items, "
                f"[{', '.join(parts)}], R>={q.target_recall}, "
                f"P>={q.target_precision})")
