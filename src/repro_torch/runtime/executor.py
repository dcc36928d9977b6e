"""Streaming cascade executor — the single plan-execution path.

The port of `repro.runtime.executor`.

Executes a PhysicalPlan over a corpus in fixed-size partitions: relational
operators first, then the DP-ordered physical stages. Each stage runs
batched on exactly the tuples that (a) survived every other logical filter
so far and (b) are still unsure for its own logical operator; accept /
reject / unsure is the shared decision rule (runtime.kernel), gold stages
always decide.

Why streaming: the seed executor materialized every stage's batch over the
full dataset at once, so the working set scaled with the corpus. Here the
corpus flows through the cascade partition by partition — per-tuple
decisions are independent, so partitioning is result-invariant — and each
stage keeps a *coalescing buffer*: survivors from several partitions
accumulate until at least ``coalesce`` tuples are pending (or input is
exhausted), then flush as one batch. Cross-stage batch coalescing keeps
late cascade stages (which see few survivors per partition) running at
engine-friendly batch sizes instead of degenerating to tiny calls.

Stage flushes are independent batch calls, so *where* they run is
pluggable (runtime/dispatch.py): inline on the calling thread, overlapped
on a thread pool, or — at the partition-loop level — scattered across
corpus shards whose bool decision arrays merge at the end. The executor
owns all scheduling state; dispatchers only run the pure batch -> scores
operator call, and completions are applied in strict submission order, so
every dispatcher produces identical per-tuple decisions.

Every stage flush is timed and counted into per-stage StageStats — wall
time, tuple counts, LLM calls, KV-cache bytes touched — the uniform
telemetry the benchmarks record. All StageStats counters are *exact*
under every dispatcher: KV bytes come from thread-scoped counters (a
flush runs entirely on one dispatcher thread), so overlapping flushes
cannot double-count each other's loads. The final RuntimeResult reports
both ``runtime_s`` (the sum of measured operator time across all flushes
— total work) and ``wall_s`` (elapsed wall clock — what a caller actually
waited); under a parallel dispatcher wall_s < runtime_s is precisely the
overlap speedup, which a single summed number used to hide.

Two consumption modes share one implementation: ``run_plan`` returns the
final RuntimeResult, and ``iter_plan`` is a generator that additionally
yields a PartitionResult the moment every tuple of a partition has fully
cleared the cascade — decisions for a partition are final as soon as its
tuples have passed (or been skipped by) every stage, which under
coalescing can happen well before later partitions execute. That is the
incremental-delivery path the api layer's ``SemFrame.stream()`` exposes.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import (Any, Deque, Dict, Generator, List, Optional, Sequence,
                    Tuple)

import numpy as np

from repro_torch.core.logical import Query, SemFilter, SemMap, SemTopK
from repro_torch.core.physical import PhysicalPlan, PhysicalPlanStage
from repro_torch.runtime.backend import Backend, as_backend
from repro_torch.runtime.dispatch import (DEFAULT_COALESCE, FlushTask,
                                          InlineDispatcher,
                                          resolve_dispatcher)
from repro_torch.runtime.kernel import decide, gold_decide


@dataclass
class StageStats:
    """Per-stage execution telemetry, aggregated over all partition
    flushes of that stage."""
    op_name: str
    logical_idx: int
    stage: int                 # position within its logical op's cascade
    wall_s: float = 0.0        # measured operator wall time
    n_tuples: int = 0          # tuples this stage scored
    n_llm_calls: int = 0       # tuples scored by LLM-backed operators
    kv_bytes: int = 0          # KV-cache bytes of the scored tuples'
    #                            profiles (exact + schedule-invariant:
    #                            backends count per calling thread and
    #                            per requested tuple, so neither flush
    #                            overlap nor shape-bucket padding can
    #                            distort the counter)
    n_batches: int = 0         # flushes (coalesced batches) executed
    engine: str = ""           # owning engine of the stage's physical
    #                            operator ("" for single-engine sessions);
    #                            a stage runs on exactly one engine, so
    #                            grouping stage rows by this field yields
    #                            exact per-engine cost / KV-bytes totals
    h2d_overlap_s: float = 0.0  # H2D transfer time hidden behind decode
    #                            compute by the engine's async prefetch —
    #                            time that WOULD have serialized with
    #                            wall_s but did not (counted per flush on
    #                            the dispatching thread, like kv_bytes)
    donated_bytes: int = 0     # bytes of consumed KV cache buffers the
    #                            engine released for reuse right after
    #                            enqueueing the decode
    shared_batches: int = 0    # flushes of this stage that executed as
    #                            part of a merged cross-query engine call
    #                            (scheduler coalescing) — 0 for solo runs
    shared_width: int = 0      # total tuples of those merged calls (all
    #                            participating queries' segments), so
    #                            shared_width / shared_batches is the
    #                            mean coalesced batch this query rode in

    @property
    def mean_batch(self) -> float:
        """Mean coalesced flush size — the batch size the cost model's
        CostCurve amortizes fixed per-call overhead over."""
        return self.n_tuples / max(self.n_batches, 1)

    def add_flush(self, out: "_OperatorOutcome", n_scored: int) -> None:
        """Account one completed flush of `n_scored` tuples."""
        self.wall_s += out.wall_s
        self.n_tuples += n_scored
        self.n_batches += 1
        self.kv_bytes += out.kv_bytes
        self.h2d_overlap_s += out.h2d_overlap_s
        self.donated_bytes += out.donated_bytes
        if out.merged_queries > 1:
            self.shared_batches += 1
            self.shared_width += out.merged_width
        if out.uses_llm:
            self.n_llm_calls += n_scored

    def merge(self, other: "StageStats") -> None:
        """Fold another stats row for the same stage into this one — the
        single counter-summation used by shard merging and the stream's
        live telemetry, so a new counter field cannot be summed in one
        place and silently dropped in another."""
        self.wall_s += other.wall_s
        self.n_tuples += other.n_tuples
        self.n_llm_calls += other.n_llm_calls
        self.kv_bytes += other.kv_bytes
        self.n_batches += other.n_batches
        self.h2d_overlap_s += other.h2d_overlap_s
        self.donated_bytes += other.donated_bytes
        self.shared_batches += other.shared_batches
        self.shared_width += other.shared_width

    def copy(self) -> "StageStats":
        return StageStats(self.op_name, self.logical_idx, self.stage,
                          self.wall_s, self.n_tuples, self.n_llm_calls,
                          self.kv_bytes, self.n_batches, self.engine,
                          self.h2d_overlap_s, self.donated_bytes,
                          self.shared_batches, self.shared_width)

    def as_dict(self) -> Dict[str, Any]:
        return {"op_name": self.op_name, "logical_idx": self.logical_idx,
                "stage": self.stage, "engine": self.engine,
                "wall_s": self.wall_s,
                "n_tuples": self.n_tuples, "n_llm_calls": self.n_llm_calls,
                "kv_bytes": self.kv_bytes, "n_batches": self.n_batches,
                "h2d_overlap_s": self.h2d_overlap_s,
                "donated_bytes": self.donated_bytes,
                "shared_batches": self.shared_batches,
                "shared_width": self.shared_width,
                "mean_batch": round(self.mean_batch, 2)}


@dataclass
class RuntimeResult:
    """Result of executing a plan through the streaming runtime.

    Two time fields, deliberately distinct: ``runtime_s`` sums measured
    operator wall time over every flush (total work done — invariant
    across dispatchers up to timing noise), while ``wall_s`` is the
    elapsed wall clock of the execution itself, including scheduling.
    Time the ``iter_plan`` generator spends *suspended at a yield* (the
    consumer holding a partition) is excluded — wall_s measures the
    engine, not the caller's loop body, so ``.stream()`` and
    ``.execute()`` of the same query report comparable numbers. Under a
    parallel dispatcher ``wall_s < runtime_s``; their ratio is the
    realized overlap speedup.
    """
    accepted: np.ndarray                  # (N,) bool — in the result set
    map_values: Dict[int, np.ndarray]     # logical idx -> values (N,)
    runtime_s: float                      # sum of measured operator time
    stage_stats: List[StageStats]         # plan order, executed stages only
    n_llm_tuples: int                     # tuples processed by LLM ops
    n_partitions: int = 1
    dispatcher: str = "inline"            # dispatch layer that executed it
    n_workers: int = 1                    # its concurrency (1 = serial)
    wall_s: float = 0.0                   # elapsed wall clock, end to end
    plan: Optional[PhysicalPlan] = None   # the plan that produced this
    #                                       result — EXPLAIN ANALYZE must
    #                                       pair measured stats with the
    #                                       plan that actually executed,
    #                                       never a re-derived one
    partition_size: Optional[int] = None  # effective ingest step actually
    #                                       used (None: whole corpus)
    coalesce: Optional[int] = None        # effective flush threshold
    #                                       actually used
    # SemTopK deferred-cut export (sharded execution only): when a shard
    # runs with the rank cut deferred, it reports per-pipeline raw gold
    # ranking scores (NaN = never gold-scored) and the candidacy mask;
    # the shard merger concatenates them and applies ONE global cut, so
    # no shard ever cuts locally. None on every normally-cut result.
    topk_scores: Optional[Dict[int, np.ndarray]] = None
    topk_cand: Optional[Dict[int, np.ndarray]] = None
    # wire telemetry of the run's remote engine members (calls, retries,
    # fallbacks, rtt percentiles, bytes on wire — see
    # repro_torch.remote.client.remote_run_info). None when the session has
    # no remote members or the run made no wire calls.
    remote: Optional[Dict[str, Any]] = None

    @property
    def stage_times(self) -> List[Tuple[str, float, int]]:
        """Seed-executor-shaped view: (op_name, seconds, n_tuples)."""
        return [(s.op_name, s.wall_s, s.n_tuples) for s in self.stage_stats]


@dataclass
class PartitionResult:
    """Finalized decisions for one contiguous corpus slice ``[lo, hi)``,
    emitted by ``iter_plan`` as soon as every tuple in the slice has
    cleared the whole cascade. Concatenating the slices of all emitted
    partitions (in order) reproduces the final RuntimeResult's
    ``accepted`` / ``map_values`` exactly.

    ``stage_stats`` carries the per-stage telemetry *delta* accounted
    since the previous partition was emitted (stages with no activity in
    the window are omitted; when several partitions settle at the same
    instant the first carries the whole window and the rest are empty).
    Summing the deltas of every emitted partition reproduces the final
    RuntimeResult.stage_stats exactly — integer counters bit-for-bit,
    float wall times up to summation order — so a streaming consumer can
    maintain live, truthful progress telemetry at zero extra cost. Under
    a sharding dispatcher each partition is one corpus shard and its
    stage_stats are that shard's full per-stage stats."""
    index: int                            # partition ordinal, corpus order
    lo: int                               # global start index (inclusive)
    hi: int                               # global stop index (exclusive)
    accepted: np.ndarray                  # (hi-lo,) bool — in the result set
    map_values: Dict[int, np.ndarray]     # logical idx -> values (hi-lo,);
    #                                       one entry per SemMap in the query
    #                                       (uncommitted tuples hold 0)
    stage_stats: List[StageStats] = field(default_factory=list)
    wall_s: float = 0.0                   # streaming dispatch: engine
    #                                       time elapsed since the
    #                                       previous emission (first:
    #                                       since start; consumer hold at
    #                                       yields excluded) — deltas sum
    #                                       to <= the run's wall_s.
    #                                       Sharding dispatch: the shard's
    #                                       own elapsed execution; shards
    #                                       overlap, so these do NOT sum
    #                                       to elapsed time (they sum to
    #                                       ~n_workers x it) — use the
    #                                       final RuntimeResult.wall_s
    #                                       for end-to-end elapsed

    def __len__(self) -> int:
        return self.hi - self.lo


@dataclass
class _OperatorOutcome:
    scores: np.ndarray
    values: Optional[np.ndarray]
    wall_s: float
    kv_bytes: int
    uses_llm: bool
    h2d_overlap_s: float = 0.0
    donated_bytes: int = 0
    # cross-query coalescing provenance (scheduler FlushHub): when this
    # outcome is one query's slice of a merged engine call, merged_width
    # is the merged call's total tuple count and merged_queries how many
    # distinct queries rode in it. Solo flushes keep (0, 1).
    merged_width: int = 0
    merged_queries: int = 1


def run_operator(backend: Backend, op, op_name: str,
                 items: Sequence[Any]) -> _OperatorOutcome:
    """Invoke one physical operator on one batch, with uniform telemetry.

    This is the only place in the tree that calls into a backend's
    score_filter / run_map — the profiler and the streaming executor both
    batch through here, so cost and KV-bytes accounting are identical in
    planning and execution.
    """
    phys = backend.resolve(op, op_name)
    kv0 = backend.kv_bytes_loaded()
    # transfer telemetry is optional on the Backend protocol: serving
    # backends expose (h2d_overlap_s, donated_bytes) per calling thread,
    # oracle/custom backends simply have no transfers to report
    xfer = getattr(backend, "transfer_stats", None)
    x0 = xfer() if xfer is not None else (0.0, 0)
    t0 = time.perf_counter()
    if isinstance(op, SemMap):
        values, scores = backend.run_map(op, op_name, items)
    else:
        # filter-like: SemFilter, SemTopK (scored like a filter, accepted
        # by rank cut) and SemJoin (pair-scoring) all return log-odds
        scores = backend.score_filter(op, op_name, items)
        values = None
    wall = time.perf_counter() - t0
    x1 = xfer() if xfer is not None else (0.0, 0)
    return _OperatorOutcome(
        scores=scores, values=values, wall_s=wall,
        kv_bytes=backend.kv_bytes_loaded() - kv0,
        uses_llm=bool(getattr(phys, "uses_llm", True)),
        h2d_overlap_s=x1[0] - x0[0], donated_bytes=x1[1] - x0[1])


class _CascadeState:
    """Per-tuple decision state over the full corpus (bool arrays only —
    O(N) bits, never item payloads, so it stays tiny even when the items
    themselves would not fit in memory)."""

    def __init__(self, n_items: int, sem_ops: Sequence[Any],
                 post_rels: Sequence[Tuple[Any, Optional[int]]] = (),
                 items: Optional[Sequence[Any]] = None):
        self.n_logical = len(sem_ops)
        self.sem_ops = sem_ops
        self.alive = np.ones(n_items, bool)
        self.accepted = {li: np.zeros(n_items, bool)
                         for li in range(self.n_logical)}
        self.rejected = {li: np.zeros(n_items, bool)
                         for li in range(self.n_logical)}
        self.unsure = {li: np.zeros(n_items, bool)
                       for li in range(self.n_logical)}
        self.map_values: Dict[int, np.ndarray] = {}
        self.n_items = n_items
        # pinned post-filters the checked pushdown could not move (see
        # PhysicalPlan.post_relational): value predicates (producer map
        # index) gate candidacy, row predicates (None) filter the result
        self.post_rels = list(post_rels)
        self.items = items
        # SemTopK: the gold stage *records* scores instead of deciding;
        # admission is the global rank cut applied at finalize (NaN =
        # never gold-scored, e.g. early-terminated by a reject stage)
        self.topk_scores: Dict[int, np.ndarray] = {
            li: np.full(n_items, np.nan)
            for li, op in enumerate(sem_ops) if isinstance(op, SemTopK)}

    def admit(self, idx: np.ndarray, alive: np.ndarray):
        """Register a partition: relational survivors become unsure
        everywhere (eligible for every cascade)."""
        self.alive[idx] = alive
        for li in range(self.n_logical):
            self.unsure[li][idx[alive]] = True

    def eligible(self, st: PhysicalPlanStage, idx: np.ndarray) -> np.ndarray:
        """Of tuples `idx`, which must stage `st` score: still unsure for
        its own logical op and not rejected by any other logical filter."""
        mask = self.unsure[st.logical_idx][idx]
        for lj in range(self.n_logical):
            if lj != st.logical_idx and not isinstance(self.sem_ops[lj],
                                                       SemMap):
                mask &= ~self.rejected[lj][idx]
        return mask

    def apply(self, st: PhysicalPlanStage, idx: np.ndarray,
              out: _OperatorOutcome):
        li = st.logical_idx
        if st.is_gold and li in self.topk_scores:
            # top-k gold: record ranking scores, settle the tuples; the
            # accept decision is the global rank cut at finalize_topk
            self.topk_scores[li][idx] = out.scores
            self.unsure[li][idx] = False
            return
        if st.is_gold:
            acc, rej = gold_decide(out.scores, st.is_map)
        else:
            acc, rej, _ = decide(out.scores, st.thr_hi, st.thr_lo, st.is_map)
        if st.is_map:
            if li not in self.map_values:
                self.map_values[li] = np.zeros(self.n_items, object)
            commit = acc | st.is_gold
            commit_idx = idx[commit]
            self.map_values[li][commit_idx] = out.values[commit]
            self.unsure[li][commit_idx] = False
        else:
            self.accepted[li][idx[acc]] = True
            self.rejected[li][idx[rej]] = True
            self.unsure[li][idx[acc]] = False
            self.unsure[li][idx[rej]] = False

    def _value_rel_mask(self, lo: int, hi: int) -> np.ndarray:
        """Pinned predicates over extracted map values, evaluated on the
        committed values of slice [lo, hi). Uncommitted tuples hold 0,
        which never matches — they are rejected elsewhere anyway."""
        m = np.ones(hi - lo, bool)
        for rel, mli in self.post_rels:
            if mli is None:
                continue
            vals = self.map_values.get(mli)
            for t in range(hi - lo):
                v = vals[lo + t] if vals is not None else 0
                if not rel.apply({rel.column: v}):
                    m[t] = False
        return m

    def _row_rel_mask(self, lo: int, hi: int) -> np.ndarray:
        """Pinned structured-row predicates (behind a SemTopK/SemAgg
        barrier): filter the *result* — after the rank cut, never before
        (filtering candidacy would be a different query)."""
        m = np.ones(hi - lo, bool)
        rels = [rel for rel, mli in self.post_rels if mli is None]
        if not rels or self.items is None:
            return m
        for t in range(hi - lo):
            row = getattr(self.items[lo + t], "row", {}) or {}
            if not all(rel.apply(row) for rel in rels):
                m[t] = False
        return m

    def topk_candidates(self, li: int) -> np.ndarray:
        """Rank-cut candidacy for SemTopK pipeline `li`: gold-scored
        (not early-terminated), admitted by every other non-top-k filter,
        and passing any pinned value predicates. Schedule-invariant:
        whether a tuple got gold-scored before or after another filter
        rejected it cannot change membership, because the other filter's
        accept is required anyway."""
        cand = self.alive & ~np.isnan(self.topk_scores[li])
        for lj, op in enumerate(self.sem_ops):
            if lj == li or isinstance(op, (SemMap, SemTopK)):
                continue
            cand &= self.accepted[lj]
        cand &= self._value_rel_mask(0, self.n_items)
        return cand

    def finalize_topk(self):
        """Apply each SemTopK's global rank cut: the k best gold scores
        among candidates, ties broken by lower corpus index (lexsort) —
        fully deterministic, so every dispatcher cuts identically."""
        for li, scores in self.topk_scores.items():
            cand = self.topk_candidates(li)
            order = np.lexsort((np.arange(self.n_items), -scores))
            chosen = order[cand[order]][:self.sem_ops[li].k]
            self.accepted[li][chosen] = True

    def result_mask(self, ignore_topk: bool = False) -> np.ndarray:
        result = self.alive.copy()
        for li, op in enumerate(self.sem_ops):
            if isinstance(op, SemMap):
                continue            # maps never reject
            if ignore_topk and isinstance(op, SemTopK):
                continue            # deferred cut (sharded merge owns it)
            result &= self.accepted[li]
        result &= self._value_rel_mask(0, self.n_items)
        result &= self._row_rel_mask(0, self.n_items)
        return result

    def partition_result(self, index: int, lo: int, hi: int
                         ) -> PartitionResult:
        """Snapshot the (final) decisions for corpus slice [lo, hi)."""
        accepted = self.alive[lo:hi].copy()
        for li, op in enumerate(self.sem_ops):
            if not isinstance(op, SemMap):
                accepted &= self.accepted[li][lo:hi]
        accepted &= self._value_rel_mask(lo, hi)
        accepted &= self._row_rel_mask(lo, hi)
        map_values = {}
        for li, op in enumerate(self.sem_ops):
            if isinstance(op, SemMap):
                vals = self.map_values.get(li)
                map_values[li] = vals[lo:hi].copy() if vals is not None \
                    else np.zeros(hi - lo, object)
        return PartitionResult(index, lo, hi, accepted, map_values)


def run_plan(plan: PhysicalPlan, query: Query, items: Sequence[Any],
             backend, *, partition_size: Optional[int] = None,
             coalesce: Optional[int] = None,
             dispatcher=None) -> RuntimeResult:
    """Execute `plan` over `items` through `backend`.

    partition_size — tuples ingested per streaming step (None: whole
        corpus at once, the non-streaming special case).
    coalesce — minimum pending tuples before a stage's buffer flushes
        mid-stream (default: DEFAULT_COALESCE, the flush width the
        planner's batch-aware cost model amortizes fixed per-call costs
        over — keep them in sync when overriding). Buffers always flush
        once ingestion finishes.
    dispatcher — where stage flushes run: a runtime.dispatch Dispatcher,
        a spec string (``inline`` | ``threads[:N]`` | ``sharded[:N]``),
        or None to read the STRETTO_DISPATCHER environment variable.
        Scheduling is deterministic under every dispatcher; accepted /
        map_values are bit-identical whenever per-tuple scores do not
        depend on batch composition (true for the oracle operators by
        construction, and for the serving engine on equal-length corpora
        where batch padding cannot shift reductions — async dispatchers
        regroup flush batches, so a backend whose scores wobble with
        padding could flip a tuple sitting within float noise of a
        threshold).
    """
    return _drain(iter_plan(plan, query, items, backend,
                            partition_size=partition_size,
                            coalesce=coalesce, dispatcher=dispatcher))


def iter_plan(plan: PhysicalPlan, query: Query, items: Sequence[Any],
              backend, *, partition_size: Optional[int] = None,
              coalesce: Optional[int] = None, dispatcher=None
              ) -> Generator[PartitionResult, None, RuntimeResult]:
    """Generator form of ``run_plan``: yields a PartitionResult per
    partition the moment all of its tuples have cleared the cascade, and
    returns the final RuntimeResult as the generator's StopIteration
    value. Execution is identical to ``run_plan`` (same schedule, same
    decisions) — the yields only observe state, never steer it.

    With a flush dispatcher (inline / threads) delivery is genuinely
    incremental: early partitions are emitted while later ones are still
    executing. A sharding dispatcher scatters the partition loop itself,
    so it emits one PartitionResult per corpus shard, after the scatter
    completes.
    """
    backend = as_backend(backend)
    disp, owned = resolve_dispatcher(dispatcher)
    try:
        # sharding dispatchers scatter the partition loop itself (a
        # 1-shard scatter degenerates to one inline streaming pass);
        # flush dispatchers plug into the streaming loop directly
        if hasattr(disp, "map_shards"):
            result = yield from _stream_sharded(plan, query, items, backend,
                                                partition_size, coalesce,
                                                disp)
        else:
            result = yield from _stream_streaming(plan, query, items,
                                                  backend, partition_size,
                                                  coalesce, disp)
        return result
    finally:
        if owned:
            disp.close()


def _drain(gen) -> RuntimeResult:
    """Exhaust an iter_plan generator, returning its RuntimeResult."""
    while True:
        try:
            next(gen)
        except StopIteration as stop:
            return stop.value


def _run_streaming(plan: PhysicalPlan, query: Query, items: Sequence[Any],
                   backend: Backend, partition_size: Optional[int],
                   coalesce: Optional[int], disp,
                   topk_cut: bool = True) -> RuntimeResult:
    return _drain(_stream_streaming(plan, query, items, backend,
                                    partition_size, coalesce, disp,
                                    topk_cut=topk_cut))


def _stream_streaming(plan: PhysicalPlan, query: Query, items: Sequence[Any],
                      backend: Backend, partition_size: Optional[int],
                      coalesce: Optional[int], disp, topk_cut: bool = True
                      ) -> Generator[PartitionResult, None, RuntimeResult]:
    sem_ops = query.semantic_ops
    N = len(items)
    S = len(plan.stages)
    part = max(N, 1) if partition_size is None \
        else max(int(partition_size), 1)
    coalesce = DEFAULT_COALESCE if coalesce is None \
        else max(int(coalesce), 1)

    t_start = time.perf_counter()
    # execution-active wall clock: accumulated across segments between
    # yields, so time the consumer spends holding a partition does not
    # masquerade as engine time
    active_s = 0.0
    seg_t0 = t_start
    state = _CascadeState(N, sem_ops,
                          post_rels=getattr(plan, "post_relational", ()),
                          items=items)
    # SemTopK makes delivery blocking: a tuple's membership depends on
    # the global rank cut, which needs every candidate scored — emission
    # is held back until the drain completes and the cut is applied
    holdback = bool(state.topk_scores)

    def fresh_stats() -> List[StageStats]:
        return [StageStats(st.op_name, st.logical_idx, st.stage,
                           engine=getattr(st, "engine", ""))
                for st in plan.stages]

    stats = fresh_stats()
    # per-partition telemetry window: every completed flush is accounted
    # twice — into the run totals above and into this delta window, which
    # the next emitted partition carries away (and resets). Windows
    # therefore tile the run's stats exactly: summing the stage_stats of
    # all emitted partitions reproduces the final totals.
    window = fresh_stats()
    t_last_emit = t_start
    # incremental delivery: a tuple is *settled* once it has passed (or
    # been skipped by) every stage — no later flush can touch it, so its
    # decisions are final. Partitions are emitted in corpus order as soon
    # as every tuple in them is settled.
    settled = np.zeros(N, bool)
    bounds: List[Tuple[int, int]] = []    # partition [lo, hi) slices
    next_emit = 0

    def take_window() -> Tuple[List[StageStats], float]:
        """Hand the current telemetry window (active stages only + wall
        elapsed since the previous emission) to a settling partition and
        start a fresh one."""
        nonlocal window, t_last_emit
        taken = [sg for sg in window if sg.n_batches > 0]
        window = fresh_stats()
        now = time.perf_counter()
        elapsed, t_last_emit = now - t_last_emit, now
        return taken, elapsed

    def ready_partitions() -> List[PartitionResult]:
        nonlocal next_emit
        if holdback:
            return []
        out = []
        while next_emit < len(bounds):
            lo, hi = bounds[next_emit]
            if not settled[lo:hi].all():
                break
            pr = state.partition_result(next_emit, lo, hi)
            pr.stage_stats, pr.wall_s = take_window()
            out.append(pr)
            next_emit += 1
        return out

    def emit(parts: List[PartitionResult]):
        """Yield settled partitions with the execution clock paused — a
        consumer holding the generator between yields must not inflate
        wall_s or the next partition's telemetry window."""
        nonlocal active_s, seg_t0, t_last_emit
        if not parts:
            return
        paused = time.perf_counter()
        active_s += paused - seg_t0
        for pr in parts:
            yield pr
        resumed = time.perf_counter()
        seg_t0 = resumed
        t_last_emit += resumed - paused
    # pending[s]: global indices that stages < s have fully processed and
    # stage s has not yet looked at (its coalescing buffer). n_pending
    # counts the tuples stage s would actually SCORE — a tuple's
    # eligibility at s is fixed the moment it clears stage s-1 (its own
    # state can only change when it is processed), so counting at enqueue
    # time is safe, and low-survivor stages keep accumulating across
    # partitions instead of flushing tiny batches.
    pending: List[List[np.ndarray]] = [[] for _ in plan.stages]
    n_pending = np.zeros(S, np.int64)
    # in-flight flushes, completed strictly in submission (FIFO) order.
    # Cohorts in flight are disjoint (a tuple lives in exactly one buffer
    # or one flush), so operator calls never race on state; all state
    # mutation happens on this thread at completion.
    inflight: Deque[Tuple[int, np.ndarray, np.ndarray, Any]] = deque()

    def runner(task: FlushTask) -> _OperatorOutcome:
        return run_operator(backend, task.sem_op, task.op_name, task.items)

    def enqueue(s: int, idx: np.ndarray):
        # a cohort with nothing for stage s to score passes straight
        # through — buffering it would stall every downstream stage until
        # drain without coalescing anything
        while s < S and idx.size:
            n_eligible = int(state.eligible(plan.stages[s], idx).sum())
            if n_eligible:
                pending[s].append(idx)
                n_pending[s] += n_eligible
                return
            s += 1
        settled[idx] = True           # cleared the whole cascade: final

    def complete_oldest():
        """Apply the oldest in-flight flush: decisions, stats, downstream
        hand-off. The only place operator results touch executor state."""
        s, idx, run_idx, handle = inflight.popleft()
        out = handle.result()
        st = plan.stages[s]
        state.apply(st, run_idx, out)
        stats[s].add_flush(out, int(run_idx.size))
        window[s].add_flush(out, int(run_idx.size))
        enqueue(s + 1, idx)

    def submit_flush(s: int):
        """Dispatch stage s's buffered cohort; eligibility is settled
        because every tuple in the buffer arrived via a *completed*
        upstream flush (or pass-through over settled state)."""
        idx = np.concatenate(pending[s])
        pending[s].clear()
        n_pending[s] = 0
        st = plan.stages[s]
        mask = state.eligible(st, idx)
        run_idx = idx[mask]
        if not run_idx.size:
            enqueue(s + 1, idx)
            return
        op = sem_ops[st.logical_idx]
        backend.resolve(op, st.op_name)   # warm the op cache on this thread
        batch = [items[i] for i in run_idx]
        handle = disp.submit(
            FlushTask(s, op, st.op_name, batch,
                      engine=getattr(st, "engine", "")), runner)
        inflight.append((s, idx, run_idx, handle))
        while len(inflight) > disp.max_pending:
            complete_oldest()

    def pump():
        """Flush every stage at/above its coalesce threshold; completing a
        windowed flush may refill an earlier stage, so sweep to fixpoint
        (with an inline dispatcher one sweep reproduces the pre-dispatch
        schedule exactly and the second is a no-op)."""
        progressed = True
        while progressed:
            progressed = False
            for s in range(S):
                if n_pending[s] >= coalesce:
                    submit_flush(s)
                    progressed = True

    n_parts = 0
    for start in range(0, max(N, 1), part):
        idx = np.arange(start, min(start + part, N))
        if idx.size == 0:
            break
        n_parts += 1
        bounds.append((start, int(idx[-1]) + 1))
        alive = np.ones(idx.size, bool)
        for rel in plan.relational:
            alive &= np.array([rel.apply(getattr(items[i], "row", {}) or {})
                               for i in idx])
        state.admit(idx, alive)
        settled[idx[~alive]] = True   # relational rejects never enter
        enqueue(0, idx[alive])
        pump()
        yield from emit(ready_partitions())
    # drain: a stage's final flush runs only once nothing upstream —
    # buffered or in flight — can still feed it; otherwise settle the
    # oldest in-flight flush and re-examine
    while inflight or any(pending):
        s = next((j for j in range(S) if pending[j]), None)
        if s is not None and not any(f[0] < s for f in inflight):
            submit_flush(s)
        else:
            complete_oldest()
        yield from emit(ready_partitions())
    if holdback:
        # every tuple is settled: apply (or defer) the rank cut, then
        # release all held partitions at once
        if topk_cut:
            state.finalize_topk()
        holdback = False
    yield from emit(ready_partitions())   # all settled post-drain

    deferred = None if topk_cut or not state.topk_scores else (
        {li: s.copy() for li, s in state.topk_scores.items()},
        {li: state.topk_candidates(li) for li in state.topk_scores})
    executed = [sg for sg in stats if sg.n_batches > 0]
    return RuntimeResult(
        accepted=state.result_mask(ignore_topk=deferred is not None),
        map_values=state.map_values,
        runtime_s=sum(sg.wall_s for sg in executed),
        stage_stats=executed,
        n_llm_tuples=sum(sg.n_llm_calls for sg in executed),
        n_partitions=n_parts,
        dispatcher=disp.name, n_workers=disp.n_workers,
        wall_s=active_s + (time.perf_counter() - seg_t0), plan=plan,
        partition_size=None if partition_size is None else part,
        coalesce=coalesce,
        topk_scores=None if deferred is None else deferred[0],
        topk_cand=None if deferred is None else deferred[1])


def stage_stats_by_engine(stage_stats: Sequence[StageStats]
                          ) -> Dict[str, Dict[str, Any]]:
    """Exact per-engine execution totals: each stage runs on exactly one
    engine, so summing its counters by the engine tag partitions the
    run's totals — per-engine wall_s / n_tuples / n_llm_calls / kv_bytes
    sum back to the whole-run numbers bit-for-bit (integer counters) /
    up to summation order (floats). Single-engine runs report one ""
    bucket."""
    out: Dict[str, Dict[str, Any]] = {}
    for sg in stage_stats:
        d = out.setdefault(sg.engine, {"wall_s": 0.0, "n_tuples": 0,
                                       "n_llm_calls": 0, "kv_bytes": 0,
                                       "n_batches": 0})
        d["wall_s"] += sg.wall_s
        d["n_tuples"] += sg.n_tuples
        d["n_llm_calls"] += sg.n_llm_calls
        d["kv_bytes"] += sg.kv_bytes
        d["n_batches"] += sg.n_batches
    return out


def merge_stage_stats(per_shard: Sequence[Sequence[StageStats]],
                      plan: PhysicalPlan) -> List[StageStats]:
    """Sum per-shard StageStats keyed by (logical_idx, stage, op_name),
    returned in plan order (executed stages only)."""
    merged: Dict[Tuple[int, int, str], StageStats] = {}
    for shard_stats in per_shard:
        for sg in shard_stats:
            key = (sg.logical_idx, sg.stage, sg.op_name)
            m = merged.get(key)
            if m is None:
                merged[key] = sg.copy()
            else:
                m.merge(sg)
    out = []
    for st in plan.stages:
        key = (st.logical_idx, st.stage, st.op_name)
        if key in merged:
            out.append(merged.pop(key))
    return out


def _stream_sharded(plan: PhysicalPlan, query: Query, items: Sequence[Any],
                    backend: Backend, partition_size: Optional[int],
                    coalesce: Optional[int], disp
                    ) -> Generator[PartitionResult, None, RuntimeResult]:
    """Scatter the partition loop across contiguous corpus shards.

    Per-tuple decisions are partition-invariant (the existing streaming
    parity guarantee), so each shard can stream through the full cascade
    independently; only the per-shard bool decision arrays are merged back
    into corpus order and the StageStats summed. A shard is the natural
    unit to place on a device of the dispatch mesh or a separate host
    process: shards fan out on a thread pool over one shared engine, and a
    dispatcher that exposes ``shard_context`` (MeshDispatcher)
    additionally pins each shard's engine state and computation onto its
    own device for the duration of that shard's streaming pass. One
    PartitionResult is emitted per shard once the scatter
    completes (shards finish in parallel, so finer-grained emission would
    not be in corpus order anyway); each carries its shard's full
    per-stage StageStats, so the per-partition deltas still sum to the
    merged final stats exactly.

    ``runtime_s`` sums operator time over every shard (total work), while
    ``wall_s`` is the elapsed scatter wall clock — a K-worker scatter
    with balanced shards reports wall_s ~= runtime_s / K, the parallel
    speedup the summed number cannot show.
    """
    t_start = time.perf_counter()
    active_s = 0.0                # engine time only: the clock pauses
    seg_t0 = t_start              # while the consumer holds a yield
    N = len(items)
    bounds = disp.shard_bounds(N)
    inline = InlineDispatcher()
    sem_ops = query.semantic_ops
    map_lis = [li for li, op in enumerate(sem_ops)
               if isinstance(op, SemMap)]
    topk_lis = [li for li, op in enumerate(sem_ops)
                if isinstance(op, SemTopK)]

    shard_ctx = getattr(disp, "shard_context", None)

    def one_shard(i: int, lo: int, hi: int) -> RuntimeResult:
        # SemTopK: shards must never cut locally — each exports raw gold
        # ranking scores + candidacy, and ONE global cut runs at merge
        cut = not topk_lis
        if shard_ctx is None:
            return _run_streaming(plan, query, items[lo:hi], backend,
                                  partition_size, coalesce, inline,
                                  topk_cut=cut)
        with shard_ctx(i, backend):
            return _run_streaming(plan, query, items[lo:hi], backend,
                                  partition_size, coalesce, inline,
                                  topk_cut=cut)

    shards = disp.map_shards(one_shard, bounds)

    # global rank cut over the merged shards: identical candidacy and
    # deterministic tie-break (lower corpus index) reproduce the solo
    # streaming cut bit-for-bit
    chosen: Dict[int, np.ndarray] = {}
    for li in topk_lis:
        g_scores = np.full(N, np.nan)
        g_cand = np.zeros(N, bool)
        for (lo, hi), rr in zip(bounds, shards):
            g_scores[lo:hi] = rr.topk_scores[li]
            g_cand[lo:hi] = rr.topk_cand[li]
        order = np.lexsort((np.arange(N), -g_scores))
        keep = order[g_cand[order]][:sem_ops[li].k]
        mask = np.zeros(N, bool)
        mask[keep] = True
        chosen[li] = mask

    accepted = np.zeros(N, bool)
    map_values: Dict[int, np.ndarray] = {}
    for pi, ((lo, hi), rr) in enumerate(zip(bounds, shards)):
        acc = rr.accepted
        for li in topk_lis:
            acc = acc & chosen[li][lo:hi]
        accepted[lo:hi] = acc
        for li, vals in rr.map_values.items():
            if li not in map_values:
                map_values[li] = np.zeros(N, object)
            map_values[li][lo:hi] = vals
        pr = PartitionResult(
            pi, lo, hi, acc.copy(),
            {li: (rr.map_values[li].copy() if li in rr.map_values
                  else np.zeros(hi - lo, object)) for li in map_lis},
            stage_stats=rr.stage_stats, wall_s=rr.wall_s)
        active_s += time.perf_counter() - seg_t0
        yield pr
        seg_t0 = time.perf_counter()
    stats = merge_stage_stats([rr.stage_stats for rr in shards], plan)
    return RuntimeResult(
        accepted=accepted,
        map_values=map_values,
        runtime_s=sum(rr.runtime_s for rr in shards),
        stage_stats=stats,
        n_llm_tuples=sum(rr.n_llm_tuples for rr in shards),
        n_partitions=sum(rr.n_partitions for rr in shards),
        dispatcher=disp.name, n_workers=disp.n_workers,
        wall_s=active_s + (time.perf_counter() - seg_t0), plan=plan,
        partition_size=None if partition_size is None
        else max(int(partition_size), 1),
        coalesce=DEFAULT_COALESCE if coalesce is None
        else max(int(coalesce), 1))
