"""Logical plans: relational + semantic operators over multimodal corpora.

Mirrors the paper's execution model: a logical plan *tree* of relational
and semantic operators with natural-language parameters. Linear
filter/map pipelines remain first-class (a `Query` — what the gradient
relaxation optimizes directly); the tree IR (`LogicalNode`) generalizes
them:

  PipelineLeaf  — one pipeline over one corpus (a Query's nodes)
  JoinNode      — `SemJoin` over two corpora: each side is a sub-tree,
                  survivors are paired (optionally blocked by a cheap
                  structured equi-join column) and scored by a pairing
                  cascade
  TopKNode      — `SemTopK`: the k best-scoring survivors of the child
                  (reject-only early termination in the cascade; the
                  accept boundary is the global rank cut)
  AggNode       — `SemAgg` / group-wise aggregation of an extracted
                  value over the child's survivors

Single-corpus TopK/Agg lower into the child pipeline's node list
(`SemTopK`/`SemAgg` are legal `Query` nodes); only `SemJoin` genuinely
needs the tree, because it spans two corpora.

`normalize` subsumes the old `pull_up_semantic` with a *checked*
pushdown: cheap `RelFilter` predicates move ahead of LLM stages (so the
cascade prices a smaller corpus) only when legal — a predicate must not
cross a `SemMap` that defines the column it references, and nothing
crosses a `SemTopK`/`SemAgg` boundary (filtering before a rank cut is a
different query). Illegal-to-move predicates stay in place and execute
as post-filters.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class SemFilter:
    """LLM-powered predicate over an item's unstructured payload."""
    text: str                     # natural-language predicate
    task_id: int                  # dataset task the predicate evaluates
    modality: str = "text"        # text | image


@dataclass(frozen=True)
class SemMap:
    """LLM-powered extraction producing a new column."""
    text: str
    task_id: int
    out_column: str = "extracted"
    modality: str = "text"


@dataclass(frozen=True)
class SemTopK(SemFilter):
    """The k best items under an LLM-scored ranking criterion.

    Scored exactly like a SemFilter (same physical candidates), but the
    accept boundary is a global rank cut, not a per-item threshold: the
    cascade may only *reject* early (early termination — items whose
    cheap scores are hopeless never reach the gold scorer), and the
    final result is the k top gold-scored survivors. Recall is measured
    against the gold top-k; precision equals recall (both sets have at
    most k members)."""
    k: int = 10

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"SemTopK.k must be >= 1, got {self.k}")


@dataclass(frozen=True)
class SemAgg(SemMap):
    """Group-wise aggregate of an LLM-extracted value.

    Executes as the SemMap it subclasses (one extracted value per
    surviving item); the aggregation (`how` over `group_by` groups) is a
    cheap post-pass. The planner tightens the per-item budget so the
    *group-wise* guarantee holds: a group's aggregate is right when its
    members' extractions are, so per-item quality is raised to
    target^(1/mean_group_size)."""
    group_by: Optional[str] = None   # structured row column (None: global)
    how: str = "mode"                # mode | count

    def __post_init__(self):
        if self.how not in ("mode", "count"):
            raise ValueError(
                f"SemAgg.how must be 'mode' or 'count', got {self.how!r}")


@dataclass(frozen=True)
class SemJoin:
    """LLM-powered join predicate over pairs drawn from two corpora.

    `task_id` names the extraction task whose agreement defines the
    match (a pair joins when both sides express the same latent value).
    `on` optionally names a structured row column both corpora carry:
    pairs are then *blocked* on equality of that column before any LLM
    stage prices them — the structured pushdown that shrinks the pair
    corpus quadratically."""
    text: str
    task_id: int
    on: Optional[str] = None
    modality: str = "text"


_REL_OPS = ("==", "!=", "<", ">", "<=", ">=", "in", "contains")


@dataclass(frozen=True)
class RelFilter:
    """Classical relational predicate over structured columns (cheap).

    Missing columns never match (SQL semantics: a comparison against an
    absent value is not-true), so `<`/`>` on a row without the column is
    a clean reject instead of a TypeError."""
    column: str
    op: str                       # one of _REL_OPS
    value: Any

    def __post_init__(self):
        if self.op not in _REL_OPS:
            raise ValueError(
                f"RelFilter op {self.op!r} not supported (use one of "
                f"{', '.join(_REL_OPS)})")

    def apply(self, row: Dict[str, Any]) -> bool:
        v = row.get(self.column)
        if v is None:
            return False
        try:
            if self.op == "==":
                return v == self.value
            if self.op == "!=":
                return v != self.value
            if self.op == "<":
                return v < self.value
            if self.op == ">":
                return v > self.value
            if self.op == "<=":
                return v <= self.value
            if self.op == ">=":
                return v >= self.value
            if self.op == "in":
                return v in self.value
            if self.op == "contains":
                return self.value in v
        except TypeError:
            return False          # incomparable types: non-matching
        raise ValueError(self.op)


SemanticOp = Any   # SemFilter | SemMap | SemTopK | SemAgg | SemJoin
PlanNode = Any     # SemanticOp | RelFilter


@dataclass
class Query:
    nodes: List[PlanNode]
    target_recall: float = 0.9
    target_precision: float = 0.9

    @property
    def semantic_ops(self) -> List[SemanticOp]:
        return [n for n in self.nodes
                if isinstance(n, (SemFilter, SemMap, SemJoin))]

    @property
    def relational_ops(self) -> List[RelFilter]:
        return [n for n in self.nodes if isinstance(n, RelFilter)]


# ---------------------------------------------------------------------------
# the logical plan tree
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LogicalNode:
    """Base of the logical plan tree."""


@dataclass(frozen=True)
class PipelineLeaf(LogicalNode):
    """One linear pipeline over one corpus — a Query's node list."""
    nodes: Tuple[PlanNode, ...]

    def query(self, target_recall: float = 0.9,
              target_precision: float = 0.9) -> Query:
        return Query(list(self.nodes), target_recall, target_precision)


@dataclass(frozen=True)
class JoinNode(LogicalNode):
    """`SemJoin` over two sub-trees: survivors of each side are paired
    (blocked on `op.on` when declared) and scored by the pairing cascade
    `pair_nodes` (the SemJoin itself plus any post-join predicates)."""
    left: LogicalNode
    right: LogicalNode
    op: SemJoin
    pair_nodes: Tuple[PlanNode, ...] = ()

    def __post_init__(self):
        if not isinstance(self.left, LogicalNode) \
                or not isinstance(self.right, LogicalNode):
            raise ValueError("JoinNode children must be LogicalNodes")


@dataclass(frozen=True)
class TopKNode(LogicalNode):
    """`SemTopK` over the child's survivors."""
    child: LogicalNode
    op: SemTopK


@dataclass(frozen=True)
class AggNode(LogicalNode):
    """`SemAgg` over the child's survivors."""
    child: LogicalNode
    op: SemAgg


# ---------------------------------------------------------------------------
# normalization: checked relational pushdown
# ---------------------------------------------------------------------------

def _split_pushable(nodes: Sequence[PlanNode]
                    ) -> Tuple[List[RelFilter], List[PlanNode]]:
    """Partition a pipeline's nodes into (pushable relational prefilters,
    remaining nodes in original relative order).

    A RelFilter is pushable to the front iff moving it is legal:
      - it must not cross a SemMap that defines the column it references
        (the value it filters does not exist before the map runs);
      - it must not cross a SemTopK/SemAgg (filtering before a rank cut
        or an aggregation changes which items are ranked/aggregated).
    Unpushable RelFilters stay in place and execute as post-filters.
    """
    pushable: List[RelFilter] = []
    rest: List[PlanNode] = []
    defined: set = set()          # SemMap out_columns seen so far
    barrier = False               # a SemTopK/SemAgg has been crossed
    for n in nodes:
        if isinstance(n, RelFilter):
            if barrier or n.column in defined:
                rest.append(n)    # pinned: runs after its producer
            else:
                pushable.append(n)
            continue
        if isinstance(n, (SemTopK, SemAgg)):
            barrier = True
        elif isinstance(n, SemMap):
            defined.add(n.out_column)
        rest.append(n)
    return pushable, rest


def normalize(query: Query) -> Query:
    """Step 1 of optimization: run cheap relational predicates first so
    LLM-powered operators see fewer tuples (paper Fig. 2, step 1) —
    with the legality check `pull_up_semantic` used to skip.

    Pushable RelFilters move to the front (relative order preserved);
    a RelFilter referencing a SemMap's `out_column`, or one declared
    after a SemTopK/SemAgg, keeps its place and the planner executes it
    as a post-filter over the extracted values / surviving set."""
    pushable, rest = _split_pushable(query.nodes)
    return Query(nodes=pushable + rest,
                 target_recall=query.target_recall,
                 target_precision=query.target_precision)


def pull_up_semantic(query: Query) -> Query:
    """Backward-compatible alias of `normalize`.

    The historical version moved *every* RelFilter above the semantic
    operators and claimed the pull-up "always legal" — false once a
    RelFilter references a SemMap's out_column (the filtered value does
    not exist yet) or follows a SemTopK (pre-rank filtering changes the
    ranked set). `normalize` keeps those pinned in place."""
    return normalize(query)


def pinned_relational(query: Query) -> List[Tuple[RelFilter, Optional[int]]]:
    """The post-filters a normalized query retains among its semantic
    nodes: [(rel, producing_map_logical_idx | None)]. The index is the
    position (among `semantic_ops`) of the last SemMap before the
    RelFilter that defines its column — the filter then applies to that
    map's extracted value; None means it filters the structured row
    (pinned only by a SemTopK/SemAgg barrier)."""
    out: List[Tuple[RelFilter, Optional[int]]] = []
    producer: Dict[str, int] = {}
    li = -1
    for n in query.nodes:
        if isinstance(n, RelFilter):
            if li >= 0:       # leading prefilters run at ingestion instead
                out.append((n, producer.get(n.column)))
            continue
        li += 1
        if isinstance(n, SemMap):
            producer[n.out_column] = li
    return out


def leading_relational(query: Query) -> List[RelFilter]:
    """The relational prefilters of a normalized query: the RelFilters
    before the first semantic node (these run at ingestion and shrink
    the corpus every cascade stage prices)."""
    out: List[RelFilter] = []
    for n in query.nodes:
        if isinstance(n, RelFilter):
            out.append(n)
        else:
            break
    return out


def as_tree(query: Query) -> LogicalNode:
    """The degenerate tree of a linear query: one PipelineLeaf."""
    return PipelineLeaf(tuple(query.nodes))


def lower_tree(tree: LogicalNode) -> LogicalNode:
    """Normalize a logical tree: TopK/Agg wrappers lower into their
    child pipeline's node list (they are legal pipeline nodes), each
    leaf is relationally normalized, and joins recurse into both sides.
    The result is a PipelineLeaf or a JoinNode of lowered sub-trees."""
    if isinstance(tree, PipelineLeaf):
        return PipelineLeaf(tuple(normalize(Query(list(tree.nodes))).nodes))
    if isinstance(tree, TopKNode):
        child = lower_tree(tree.child)
        if not isinstance(child, PipelineLeaf):
            raise ValueError("SemTopK over a join is not supported yet — "
                             "apply .sem_topk to one corpus")
        return PipelineLeaf(child.nodes + (tree.op,))
    if isinstance(tree, AggNode):
        child = lower_tree(tree.child)
        if not isinstance(child, PipelineLeaf):
            raise ValueError("SemAgg over a join is not supported yet — "
                             "apply .sem_agg to one corpus")
        return PipelineLeaf(child.nodes + (tree.op,))
    if isinstance(tree, JoinNode):
        return JoinNode(lower_tree(tree.left), lower_tree(tree.right),
                        tree.op, tree.pair_nodes)
    raise ValueError(f"unknown logical node {tree!r}")
