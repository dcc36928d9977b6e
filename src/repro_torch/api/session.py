"""Session: engine lifecycle + configuration behind the declarative API.

The port of `repro.api.session`, for one local engine. A Session owns
what `examples/quickstart.py` would otherwise hand-wire: the CacheStore,
the ServingEngine, planted-model registration, KV-cache profile building
(the paper's offline phase), runtime backend construction, and the
planner/executor configuration, all declared once in a `SessionConfig`.
Queries are built against it with ``session.frame(items)`` (see
api/frame.py).

The engine runs on `EngineSpec.device` (a torch device; "cuda" unless the
caller says otherwise, as every entry point of the port): on the card its
decode flushes and profile scoring launch the hand-written CUDA kernels,
and a missing card raises instead of running on the CPU.

Not ported yet (each raises NotImplementedError and is queued in ROADMAP
queue 1): engine pools (several EngineSpecs), remote engine members
(`EngineSpec.address`), tenants and the query scheduler, and join trees
(`plan_tree` / `run_tree` / `gold_tree`).

The Session compiles to, and never bypasses, the internal layer: plans
come from `core.planner.plan_query`, execution goes through
`runtime.executor.run_plan`/`iter_plan`, gold references through
`runtime.plan_utils.gold_plan_for`. It adds lifecycle + memoization only
(profile building per corpus, plans and gold executions per (corpus,
query)).
"""
from __future__ import annotations

import shutil
import tempfile
import threading
import weakref
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.logical import Query
from repro_torch.core.optimizer import PlannerConfig
from repro_torch.core.planner import plan_query
from repro_torch.core.physical import PhysicalPlan
from repro_torch.core.profiling import MeasuredBatchStore, batch_drift
from repro_torch.runtime.backend import Backend, as_backend
from repro_torch.runtime.dispatch import DEFAULT_COALESCE
from repro_torch.runtime.executor import RuntimeResult, iter_plan, run_plan
from repro_torch.runtime.plan_utils import gold_plan_for

_UNSET = object()     # "inherit the session default" sentinel


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP queue 1: pools, "
        f"the scheduler, remote members and join trees come in later "
        f"slices)")


@dataclass(frozen=True)
class EngineSpec:
    """The serving engine of a Session.

      name             — engine name (single-engine sessions leave operator
                         names unprefixed)
      models           — planted-zoo model names this engine registers;
                         models[0] is the "sm" tier, models[-1] the "lg"
                         tier (a single entry serves as both)
      sm_ratios / lg_ratios / include_cheap — candidate ladder
      profile_ratios   — offline ladder to prefill (None: union of the
                         candidate ladders, plus 0.0 for gold)
      cache_dir        — this engine's store root (None: session-owned
                         tempdir, removed on close)
      prefill_batch / memory_budget_bytes / max_batch / model_seed —
                         serving limits and the planted weights' seed
      kernels          — attention kernel backend for this engine's decode
                         flushes: "auto" | "cuda" | "ref" (None: the
                         STRETTO_TORCH_KERNELS env var, read at flush time,
                         defaulting to "auto": the CUDA kernels on the card)
      fused            — feed the whole operator query through one fused
                         attention launch per flush instead of a per-token
                         scan (None: STRETTO_FUSED, default on)
      device_cache     — keep loaded profile batches device-resident in an
                         LRU bounded by memory_budget_bytes (None:
                         STRETTO_DEVICE_CACHE, default on)
      async_h2d        — overlap H2D copies with decode (None:
                         STRETTO_ASYNC_H2D, default on). Never changes
                         results.
      device           — the torch device the engine runs on ("cuda" by
                         default; "cpu" runs the plain kernel versions)
      sm_int8 / lg_int8 — compression ratios to ALSO store as int8
                         quantized profiles; each becomes a distinct
                         cascade candidate (operator suffix ``i8``) whose
                         flushes launch the int8 decode kernels
      address          — a remote engine member; not ported yet (raises)
    """
    name: str
    models: Tuple[str, ...] = ("sm", "lg")
    sm_ratios: Tuple[float, ...] = (0.8, 0.5, 0.0)
    lg_ratios: Tuple[float, ...] = (0.8, 0.5, 0.3)
    include_cheap: bool = True
    profile_ratios: Optional[Tuple[float, ...]] = None
    cache_dir: Optional[str] = None
    prefill_batch: int = 16
    memory_budget_bytes: float = 2e9
    max_batch: int = 128
    model_seed: int = 1
    kernels: Optional[str] = None
    fused: Optional[bool] = None
    device_cache: Optional[bool] = None
    async_h2d: Optional[bool] = None
    device: Any = "cuda"
    sm_int8: Tuple[float, ...] = ()
    lg_int8: Tuple[float, ...] = ()
    address: Optional[str] = None

    def __post_init__(self):
        if not self.name or not isinstance(self.name, str):
            raise ValueError("EngineSpec.name must be a non-empty string")
        if self.address is not None:
            _not_ported(f"engine {self.name!r}: a remote engine member "
                        f"(EngineSpec.address)")
        if self.kernels is not None:
            from repro_torch.kernels.ops import VALID_BACKENDS
            if self.kernels not in VALID_BACKENDS:
                raise ValueError(
                    f"engine {self.name!r}: kernels={self.kernels!r} is "
                    f"not one of {VALID_BACKENDS}")
        if "/" in self.name:
            raise ValueError(
                f"EngineSpec.name {self.name!r} must not contain '/' — it "
                f"is the engine/op separator in pooled operator names")
        if not self.models:
            raise ValueError(f"engine {self.name!r} declares no models")

    @property
    def sm_model(self) -> str:
        return self.models[0]

    @property
    def lg_model(self) -> str:
        return self.models[-1]

    def ladder(self) -> Tuple[float, ...]:
        """Compression ratios this engine's profiles are built at (gold
        0.0 always included — its gold operator needs it)."""
        if self.profile_ratios is not None:
            return tuple(sorted({0.0, *self.profile_ratios}))
        return tuple(sorted({0.0, *self.sm_ratios, *self.lg_ratios}))


@dataclass(frozen=True)
class SessionConfig:
    """Everything a Session needs, declared once.

    Engine — two equivalent declarations:
      engines          — a tuple holding one EngineSpec (pools of several
                         engines are not ported yet and raise)
      <flat fields>    — the single-engine form below; it compiles to one
                         EngineSpec named "default" (see resolved_engines)
      The engine's gold operator defines the quality reference.

    Engine / offline phase (flat form)
      cache_dir        — on-disk cache store root (None: fresh tempdir,
                         removed when the session closes)
      models           — planted-zoo model names to register
      profile_ratios   — compression ladder to prefill (None: union of the
                         backend ladders below, plus 0.0 for gold)
      prefill_batch    — items per prefill call during profile building
      memory_budget_bytes / max_batch — serving engine limits
      device           — torch device of the engine ("cuda" by default)

    Backend (cascade candidate ladder)
      sm_ratios / lg_ratios / include_cheap — KVCacheBackend ladder
      sm_int8 / lg_int8 — int8 rungs (distinct ``…i8`` candidates)

    Planner
      planner          — PlannerConfig (None: library defaults, per call)
      sample_frac      — profiling sample fraction
      seed             — profiling sample seed
      reorder          — enable the DP/greedy stage reorderer

    Execution
      partition_size   — tuples ingested per streaming step (None: whole
                         corpus at once)
      coalesce         — min pending tuples before a stage flush (None:
                         DEFAULT_COALESCE; also what the planner's
                         batch-aware cost model amortizes over)
      dispatcher       — runtime dispatcher spec ("inline" |
                         "threads[:N]"), a Dispatcher instance, or None to
                         read STRETTO_DISPATCHER

    Measured feedback (the measure -> plan loop)
      feedback         — seeds the session's MeasuredBatchStore: a store
                         instance, a directory of stage_stats*.json
                         snapshots to aggregate, or None for a fresh store

    `tenants` (the query scheduler) is not ported yet and raises.
    """
    cache_dir: Optional[str] = None
    models: Tuple[str, ...] = ("sm", "lg")
    profile_ratios: Optional[Tuple[float, ...]] = None
    prefill_batch: int = 16
    memory_budget_bytes: float = 2e9
    max_batch: int = 128
    model_seed: int = 1
    device: Any = "cuda"

    sm_ratios: Tuple[float, ...] = (0.8, 0.5, 0.0)
    lg_ratios: Tuple[float, ...] = (0.8, 0.5, 0.3)
    include_cheap: bool = True

    # kernel path + transfer overlap (see EngineSpec for semantics)
    kernels: Optional[str] = None
    fused: Optional[bool] = None
    device_cache: Optional[bool] = None
    async_h2d: Optional[bool] = None
    sm_int8: Tuple[float, ...] = ()
    lg_int8: Tuple[float, ...] = ()

    engines: Optional[Tuple[EngineSpec, ...]] = None
    tenants: Optional[Tuple[Any, ...]] = None

    planner: Optional[PlannerConfig] = None
    sample_frac: float = 0.15
    seed: int = 0
    reorder: bool = True

    partition_size: Optional[int] = None
    coalesce: Optional[int] = None
    dispatcher: Optional[Any] = None

    feedback: Optional[Any] = None

    def __post_init__(self):
        if self.engines is not None:
            object.__setattr__(self, "engines", tuple(self.engines))
            if not self.engines:
                raise ValueError(
                    "SessionConfig(engines=()) declares no engines — "
                    "declare one EngineSpec, or omit `engines` for the "
                    "flat single-engine form")
            if len(self.engines) > 1:
                _not_ported("an engine pool (several EngineSpecs)")
        if self.tenants is not None:
            _not_ported("SessionConfig.tenants (the query scheduler)")

    def resolved_engines(self) -> Tuple[EngineSpec, ...]:
        """The engine this config declares. The flat fields (models /
        sm_ratios / lg_ratios / cache_dir / ...) compile to a single spec
        named "default"."""
        if self.engines is not None:
            return self.engines
        return (EngineSpec(
            name="default", models=self.models,
            sm_ratios=self.sm_ratios, lg_ratios=self.lg_ratios,
            include_cheap=self.include_cheap,
            profile_ratios=self.profile_ratios, cache_dir=self.cache_dir,
            prefill_batch=self.prefill_batch,
            memory_budget_bytes=self.memory_budget_bytes,
            max_batch=self.max_batch, model_seed=self.model_seed,
            kernels=self.kernels, fused=self.fused,
            device_cache=self.device_cache, async_h2d=self.async_h2d,
            device=self.device,
            sm_int8=tuple(self.sm_int8), lg_int8=tuple(self.lg_int8)),)

    def ladder(self) -> Tuple[float, ...]:
        """The compression ratios profiles are built at (gold 0.0 always
        included — the reference backend needs it)."""
        return self.resolved_engines()[0].ladder()


class Session:
    """Context-managed front door to the engine.

    Three construction modes:

      Session()                      — owns everything: fresh cache store,
                                       planted models on the configured
                                       device, profiles built lazily per
                                       corpus on first use
      Session(engine=eng)            — adopts an existing ServingEngine
                                       (models are the caller's; call
                                       .prepare(items) to build profiles)
      Session(backend=b)             — wraps any runtime Backend (e.g. an
                                       OracleBackend over a registry);
                                       no engine, no profile building —
                                       gold references come from the
                                       backend's own gold operators
    """

    def __init__(self, config: Optional[SessionConfig] = None, *,
                 engine=None, backend=None, reference=None, **overrides):
        if config is None:
            config = SessionConfig(**overrides)
        elif overrides:
            config = replace(config, **overrides)
        self.config = config
        self._closed = False
        # serializes the session's memo state (plan/gold caches, profile
        # preparation, corpus tokens, measured feedback). Reentrant: plan()
        # takes it and calls prepare(), which takes it again. Execution
        # itself (run_plan flushes) never holds it.
        self._state_lock = threading.RLock()
        self._owned_cache_dirs: List[str] = []
        self._prepared: set = set()
        self._gold_cache: Dict[Any, RuntimeResult] = {}
        self._plan_cache: Dict[Any, PhysicalPlan] = {}
        # stable per-object corpus tokens for items without an item_id:
        # CPython reuses id() after GC, so raw ids must never key a memo
        self._obj_tokens: "weakref.WeakKeyDictionary[Any, int]" = \
            weakref.WeakKeyDictionary()
        self._pinned_tokens: Dict[int, int] = {}
        self._id_pins: List[Any] = []
        self._next_token = 0
        # measured execution feedback driving the measure -> plan loop
        fb = config.feedback
        if isinstance(fb, MeasuredBatchStore):
            self.measured = fb
        elif isinstance(fb, str):
            self.measured = MeasuredBatchStore.from_dir(fb)
        else:
            self.measured = MeasuredBatchStore()
        self.n_replans = 0

        self.engine_specs: Tuple[EngineSpec, ...] = config.resolved_engines()
        self._specs_by_name = {s.name: s for s in self.engine_specs}

        self._owns_engine = engine is None and backend is None
        if backend is not None and engine is None:
            self.engines: Dict[str, Any] = {}
            self.engine = None
        elif engine is not None:
            self.engines = {self.engine_specs[0].name: engine}
            self.engine = engine
        else:
            self.engines = self._build_engines()
            self.engine = self.engines[self.engine_specs[0].name]
        self.backend: Backend = as_backend(backend) \
            if backend is not None else self.backend_for()
        if reference is not None:
            self.reference = as_backend(reference)
        elif self.engines:
            from repro_torch.runtime.backend import ReferenceBackend
            self.reference = ReferenceBackend(
                self.engine, lg=self.engine_specs[0].lg_model)
        else:
            # no engine: the backend's own gold operators (candidates
            # list, gold last) are the reference
            self.reference = self.backend

    # ---------------- lifecycle ----------------

    def _build_engines(self) -> Dict[str, Any]:
        from repro_torch.cache.store import CacheStore
        from repro_torch.data.synthetic import (make_planted_params,
                                                planted_config)
        from repro_torch.serving.engine import ServingEngine
        engines: Dict[str, Any] = {}
        for spec in self.engine_specs:
            cache_dir = spec.cache_dir
            if cache_dir is None:
                cache_dir = tempfile.mkdtemp(
                    prefix=f"stretto_session_{spec.name}_")
                self._owned_cache_dirs.append(cache_dir)
            eng = ServingEngine(
                CacheStore(cache_dir),
                memory_budget_bytes=spec.memory_budget_bytes,
                max_batch=spec.max_batch, kernels=spec.kernels,
                fused=spec.fused, device_cache=spec.device_cache,
                async_h2d=spec.async_h2d, device=spec.device)
            for name in spec.models:
                mcfg = planted_config(name)
                eng.register_model(
                    name, mcfg, make_planted_params(
                        mcfg, seed=spec.model_seed, device=eng.device))
            engines[spec.name] = eng
        return engines

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Release session-owned resources (idempotent). Only cache
        directories the session created itself are removed."""
        if self._closed:
            return
        self._closed = True
        for d in self._owned_cache_dirs:
            shutil.rmtree(d, ignore_errors=True)
        self._owned_cache_dirs = []

    # ---------------- offline phase ----------------

    def _object_token(self, it: Any) -> int:
        """A session-stable token for an item without an item_id. Unlike
        raw id(), tokens are never recycled: weak-referenceable items get
        a fresh counter entry that disappears with the object (a new
        object can never inherit it), everything else is pinned so its id
        stays unique for the session's lifetime."""
        try:
            tok = self._obj_tokens.get(it)
            if tok is None:
                tok = self._next_token
                self._next_token += 1
                self._obj_tokens[it] = tok
            return tok
        except TypeError:       # unhashable / no weakref support: pin it
            key = id(it)
            tok = self._pinned_tokens.get(key)
            if tok is None:
                self._id_pins.append(it)
                tok = self._next_token
                self._next_token += 1
                self._pinned_tokens[key] = tok
            return tok

    def _corpus_key(self, items: Sequence[Any]) -> Tuple:
        """Cheap corpus fingerprint for profile/plan/gold memoization:
        length plus (item_id, lead token) at a spread of sample
        positions. Items without an `item_id` use a session-held stable
        token (see _object_token) — never a raw id(), which CPython
        recycles after GC; distinct same-length corpora must never share
        a key (over-invalidation is safe, collision is not)."""
        n = len(items)
        step = max(n // 16, 1)
        probe = []
        for it in items[::step]:
            toks = getattr(it, "tokens", None)
            lead = toks[0] if toks is not None and len(toks) else None
            item_id = getattr(it, "item_id", None)
            probe.append((item_id if item_id is not None
                          else ("obj", self._object_token(it)), lead))
        return (n, tuple(probe))

    def corpus_key(self, items: Sequence[Any]) -> Tuple:
        """The session's stable corpus fingerprint, thread-safe (the
        scheduler keys per-tenant warm state on it)."""
        with self._state_lock:
            return self._corpus_key(items)

    def prepare(self, items: Sequence[Any],
                ratios: Optional[Sequence[float]] = None) -> None:
        """Build KV-cache profiles for this corpus (offline phase) at the
        engine's ladder (`ratios` overrides it), plus its int8 rungs. Safe
        to call repeatedly: each (engine, corpus, ladder) is built once."""
        if not self.engines:
            return                      # backend-only session: nothing to do
        with self._state_lock:
            self._prepare_locked(items, ratios)

    def _prepare_locked(self, items: Sequence[Any],
                        ratios: Optional[Sequence[float]]) -> None:
        for spec in self.engine_specs:
            eng = self.engines.get(spec.name)
            if eng is None:
                continue
            ladder = tuple(sorted({0.0, *(ratios or spec.ladder())}))
            key = (spec.name, self._corpus_key(items), ladder,
                   tuple(spec.sm_int8), tuple(spec.lg_int8))
            if key in self._prepared:
                continue
            for name in spec.models:
                quant: set = set()
                if name == spec.sm_model:
                    quant |= set(spec.sm_int8)
                if name == spec.lg_model:
                    quant |= set(spec.lg_int8)
                eng.build_profiles(name, items, ratios=list(ladder),
                                   prefill_batch=spec.prefill_batch,
                                   quant_ratios=sorted(quant))
            self._prepared.add(key)

    def _ensure_prepared(self, items: Sequence[Any]) -> None:
        # adopted engines manage their own profiles; session-owned
        # engines build lazily on first use of a corpus
        if self._owns_engine:
            self.prepare(items)

    # ---------------- backends ----------------

    def backend_for(self, *, engine: Optional[str] = None,
                    sm_ratios: Optional[Tuple[float, ...]] = None,
                    lg_ratios: Optional[Tuple[float, ...]] = None,
                    include_cheap: Optional[bool] = None) -> Backend:
        """A KVCacheBackend over the session engine with an alternative
        candidate ladder (defaults: the engine's declared ladder)."""
        if not self.engines:
            raise RuntimeError("session has no engine: it wraps an "
                               "externally supplied backend")
        name = engine if engine is not None else self.engine_specs[0].name
        spec = self._specs_by_name.get(name)
        if spec is None or name not in self.engines:
            raise ValueError(f"unknown engine {name!r}; session engines: "
                             f"{sorted(self.engines)}")
        from repro_torch.runtime.backend import KVCacheBackend
        return KVCacheBackend(
            self.engines[name], sm=spec.sm_model, lg=spec.lg_model,
            sm_ratios=sm_ratios if sm_ratios is not None else spec.sm_ratios,
            lg_ratios=lg_ratios if lg_ratios is not None else spec.lg_ratios,
            sm_int8=spec.sm_int8, lg_int8=spec.lg_int8,
            include_cheap=spec.include_cheap if include_cheap is None
            else include_cheap)

    # ---------------- query building ----------------

    def frame(self, items: Sequence[Any], query: Optional[Query] = None):
        """A lazy SemFrame over `items` (a sequence of corpus items, or
        anything exposing `.items` such as a Dataset). Pass `query` to
        seed the frame from an existing logical Query."""
        from repro_torch.api.frame import SemFrame
        items = getattr(items, "items", items)
        if query is not None:
            return SemFrame(self, items, tuple(query.nodes),
                            query.target_recall, query.target_precision)
        return SemFrame(self, items)

    # ---------------- internal layer (plan / execute / gold) ----------

    def _exec_kwargs(self, partition_size=_UNSET, coalesce=_UNSET,
                     dispatcher=_UNSET) -> Dict[str, Any]:
        cfg = self.config
        return {
            "partition_size": cfg.partition_size
            if partition_size is _UNSET else partition_size,
            "coalesce": cfg.coalesce if coalesce is _UNSET else coalesce,
            "dispatcher": cfg.dispatcher if dispatcher is _UNSET
            else dispatcher,
        }

    def plan(self, query: Query, items: Sequence[Any]) -> PhysicalPlan:
        """Plan `query` over `items` with the session's planner settings
        (memoized per (corpus, query, measured-feedback version) —
        explain + execute share a plan; recording new measured telemetry
        bumps the store version, so the next plan() re-plans against the
        updated flush widths). When the session's MeasuredBatchStore
        holds telemetry, BatchHint is seeded from measured flush widths
        instead of the static coalesce default."""
        with self._state_lock:
            self._ensure_prepared(items)
            key = (self._corpus_key(items), tuple(query.nodes),
                   query.target_recall, query.target_precision,
                   self.measured.version if len(self.measured) else 0)
            plan = self._plan_cache.get(key)
            if plan is None:
                cfg = self.config
                plan = plan_query(
                    query, items, self.backend, cfg.planner,
                    sample_frac=cfg.sample_frac, seed=cfg.seed,
                    reorder=cfg.reorder,
                    coalesce=cfg.coalesce if cfg.coalesce is not None
                    else DEFAULT_COALESCE,
                    measured=self.measured if len(self.measured) else None)
                self._plan_cache[key] = plan
            return plan

    def record_measured(self, result: RuntimeResult) -> None:
        """Feed a result's measured StageStats into the session's
        MeasuredBatchStore, so subsequent plan() calls price operators at
        the flush widths execution actually delivered."""
        with self._state_lock:
            self.measured.record_result(result)

    def run(self, plan: PhysicalPlan, query: Query, items: Sequence[Any],
            backend: Optional[Backend] = None, *, partition_size=_UNSET,
            coalesce=_UNSET, dispatcher=_UNSET,
            replan_on_drift: Optional[float] = None) -> RuntimeResult:
        """Execute a prebuilt plan through the streaming runtime with the
        session's execution defaults.

        replan_on_drift — when set (a factor > 1), compare each executed
        stage's measured mean flush batch against the plan's expected
        batch after the run; if any stage diverges by more than the
        factor (either direction), record the measured telemetry into the
        session's MeasuredBatchStore, re-plan the query against the
        measured widths, and re-execute once with the corrected plan
        (returning the second result). Only valid when the run executes
        the session's own backend.
        """
        self._ensure_prepared(items)
        if replan_on_drift is not None and backend is not None \
                and backend is not self.backend:
            raise ValueError(
                "replan_on_drift requires the session backend: re-planning "
                "profiles against session.backend, which is not the "
                "backend this run would execute on")
        kwargs = self._exec_kwargs(partition_size, coalesce, dispatcher)
        result = run_plan(plan, query, items, backend or self.backend,
                          **kwargs)
        if replan_on_drift is not None:
            drift = batch_drift(plan, result.stage_stats)
            if drift > float(replan_on_drift):
                self.record_measured(result)
                self.n_replans += 1
                new_plan = self.plan(query, items)
                result = run_plan(new_plan, query, items,
                                  backend or self.backend, **kwargs)
        return result

    def iter_run(self, plan: PhysicalPlan, query: Query,
                 items: Sequence[Any], backend: Optional[Backend] = None, *,
                 partition_size=_UNSET, coalesce=_UNSET, dispatcher=_UNSET):
        """Generator form of `run` (yields PartitionResult per settled
        partition; StopIteration.value is the RuntimeResult)."""
        self._ensure_prepared(items)
        return iter_plan(plan, query, items, backend or self.backend,
                         **self._exec_kwargs(partition_size, coalesce,
                                             dispatcher))

    def gold(self, query: Query, items: Sequence[Any]) -> RuntimeResult:
        """The gold reference execution for `query` over `items` (every
        semantic op resolved by the reference backend's gold operator),
        memoized per (corpus, query nodes)."""
        with self._state_lock:
            self._ensure_prepared(items)
            key = (self._corpus_key(items), tuple(query.nodes))
            got = self._gold_cache.get(key)
            if got is None:
                gold_plan = gold_plan_for(query, self.reference)
                got = run_plan(gold_plan, query, items, self.reference,
                               **self._exec_kwargs())
                self._gold_cache[key] = got
            return got

    # ---------------- not ported yet ----------------

    def plan_tree(self, *args, **kwargs):
        _not_ported("Session.plan_tree (join trees)")

    def run_tree(self, *args, **kwargs):
        _not_ported("Session.run_tree (join trees)")

    def gold_tree(self, *args, **kwargs):
        _not_ported("Session.gold_tree (join trees)")

    def scheduler(self, **kwargs):
        _not_ported("Session.scheduler (the query scheduler)")
