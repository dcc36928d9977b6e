"""SemFrame: a lazy, immutable semantic-query builder.

The port of `repro.api.frame`: SemFrame, and the two-corpus JoinFrame
that `SemFrame.sem_join` builds.

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

from repro_torch.core.logical import (JoinNode, PipelineLeaf, Query,
                                      RelFilter, SemAgg, SemFilter, SemJoin,
                                      SemMap, SemTopK)
from repro_torch.core.physical import PhysicalPlan

from repro_torch.api.session import _UNSET


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
                 on: Optional[str] = None,
                 modality: str = "text") -> "JoinFrame":
        """Join this frame against a second corpus on an LLM-evaluated
        pair predicate (`task_id` names the extraction task whose
        agreement defines a match). `other` is another SemFrame (its
        chained operators become the right side's pipeline) or a bare
        item sequence / Dataset. `on` optionally names a structured row
        column both corpora carry: candidate pairs are then blocked on
        equality of that column before any LLM stage prices them.

        Returns a JoinFrame — the two-corpus builder whose terminal
        verbs plan through `Session.plan_tree` (one grouped relaxation
        allocating the recall/precision budget across the left / right /
        pair pipelines) and execute through the tree runtime."""
        if isinstance(other, SemFrame):
            right_items, right_nodes = other._items, other._nodes
        else:
            right_items = getattr(other, "items", other)
            right_nodes = ()
        return JoinFrame(self._session, self._items, right_items,
                         self._nodes, tuple(right_nodes),
                         SemJoin(text, task_id, on, modality), (),
                         self._recall, self._precision)

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


class JoinFrame:
    """Lazy two-corpus semantic join, bound to a Session.

    Built by `SemFrame.sem_join`; immutable like SemFrame. Compiles to a
    logical `JoinNode` tree (each side a PipelineLeaf) that
    `Session.plan_tree` optimizes *jointly*: one grouped gradient
    relaxation places thresholds for the left side, right side, and
    pairing cascade at once, splitting the query-level recall/precision
    budget across all three pipelines (visible in `.explain()`).

    Terminal verbs:
      .explain()  — the tree-shaped TreeExplainReport (per-role cascade
                    tables around the joint bounds + budget split)
      .execute()  — run left side, right side, then the pair cascade
                    over blocked survivor pairs; returns a JoinResult
                    with lazy `.metrics()` against the gold join
    """

    __slots__ = ("_session", "_left_items", "_right_items", "_left_nodes",
                 "_right_nodes", "_join", "_pair_nodes", "_recall",
                 "_precision")

    def __init__(self, session, left_items: Sequence[Any],
                 right_items: Sequence[Any], left_nodes: Tuple[Any, ...],
                 right_nodes: Tuple[Any, ...], join: SemJoin,
                 pair_nodes: Tuple[Any, ...] = (),
                 recall: Optional[float] = None,
                 precision: Optional[float] = None):
        self._session = session
        self._left_items = left_items
        self._right_items = right_items
        self._left_nodes = tuple(left_nodes)
        self._right_nodes = tuple(right_nodes)
        self._join = join
        self._pair_nodes = tuple(pair_nodes)
        self._recall = recall
        self._precision = precision

    # ---------------- chainable builders ----------------

    def filter(self, column: str, op: str, value: Any) -> "JoinFrame":
        """Relational predicate over the joined pair rows (``left_`` /
        ``right_`` prefixed columns, plus bare names for shared columns
        whose values agree on both sides). Runs in the pair cascade."""
        return JoinFrame(self._session, self._left_items,
                         self._right_items, self._left_nodes,
                         self._right_nodes, self._join,
                         self._pair_nodes + (RelFilter(column, op, value),),
                         self._recall, self._precision)

    def with_guarantees(self, recall: Optional[float] = None,
                        precision: Optional[float] = None) -> "JoinFrame":
        """Declare end-to-end quality targets for the whole join — the
        planner allocates them across the tree's pipelines."""
        return JoinFrame(
            self._session, self._left_items, self._right_items,
            self._left_nodes, self._right_nodes, self._join,
            self._pair_nodes,
            self._recall if recall is None else float(recall),
            self._precision if precision is None else float(precision))

    # ---------------- compilation ----------------

    def to_tree(self) -> JoinNode:
        """Compile to the internal logical join tree."""
        return JoinNode(PipelineLeaf(self._left_nodes),
                        PipelineLeaf(self._right_nodes),
                        self._join, self._pair_nodes)

    def plan(self):
        """The jointly optimized TreePlan (memoized by the session)."""
        return self._session.plan_tree(
            self.to_tree(), self._left_items, self._right_items,
            target_recall=0.9 if self._recall is None else self._recall,
            target_precision=0.9 if self._precision is None
            else self._precision)

    # ---------------- terminal verbs ----------------

    def explain(self):
        """Plan without executing: the tree-shaped report — joint
        bounds, the per-pipeline budget split, and each role's cascade
        table."""
        from repro_torch.api.explain import TreeExplainReport
        return TreeExplainReport.from_plan(
            self._session, self.plan(), len(self._left_items),
            len(self._right_items))

    def execute(self, *, partition_size=_UNSET, coalesce=_UNSET,
                dispatcher=_UNSET):
        """Plan + execute the tree; returns a JoinResult."""
        from repro_torch.api.result import JoinResult
        raw = self._session.run_tree(
            self.plan(), self._left_items, self._right_items,
            partition_size=partition_size, coalesce=coalesce,
            dispatcher=dispatcher)
        return JoinResult(self._session, self._left_items,
                          self._right_items, raw)

    def __repr__(self) -> str:
        return (f"JoinFrame({len(self._left_items)} x "
                f"{len(self._right_items)} items, "
                f"join={self._join.text!r}, on={self._join.on!r}, "
                f"R>={0.9 if self._recall is None else self._recall}, "
                f"P>={0.9 if self._precision is None else self._precision})")
