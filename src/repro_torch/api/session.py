"""Session: engine lifecycle + configuration behind the declarative API.

The port of `repro.api.session`. A Session owns what
`examples/quickstart.py` would otherwise hand-wire: the CacheStore(s),
the ServingEngine(s), planted-model registration, KV-cache profile
building (the paper's offline phase), runtime backend construction, and
the planner/executor configuration, all declared once in a
`SessionConfig`. Queries are built against it with
``session.frame(items)`` (see api/frame.py).

Engines are declarative and may be heterogeneous: ``SessionConfig(
engines=(EngineSpec("fast", ...), EngineSpec("accurate", ...)))``
declares a named pool. Each spec owns its model zoo, compression ladder,
cache store and serving limits; the runtime backend becomes a
`PoolBackend` whose candidate union lets the planner place every cascade
stage on one engine, and `gold_engine` names the engine whose gold
operator is the reference. The flat fields (`models` / `sm_ratios` /
...) compile to a single spec named "default" and keep the bare
single-engine backend.

Every engine runs on its `EngineSpec.device` (a torch device; "cuda"
unless the caller says otherwise, as every entry point of the port): on
the card its decode flushes and profile scoring launch the hand-written
CUDA kernels, and a missing card raises instead of running on the CPU.
Planning runs its gradient optimizer on the same device
(`Session.device`): on the card one Adam step is a CUDA graph replayed
per step, and a `device="cpu"` session plans eagerly on the host.

Join trees go through `plan_tree` / `run_tree` / `gold_tree` (and
`SemFrame.sem_join`). `Session.scheduler()` admits concurrent queries
under the tenants of `SessionConfig.tenants` (see repro_torch.scheduler).
A spec with `address="host:port"` is a remote engine member, served by a
`repro_torch.launch.remote_worker` process over the wire protocol (see
repro_torch.remote); the gold engine stays local.

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
from repro_torch.device import resolve_device
from repro_torch.core.optimizer import PlannerConfig
from repro_torch.core.planner import plan_query
from repro_torch.core.physical import PhysicalPlan
from repro_torch.core.profiling import MeasuredBatchStore, batch_drift
from repro_torch.runtime.backend import Backend, as_backend
from repro_torch.runtime.dispatch import DEFAULT_COALESCE
from repro_torch.runtime.executor import RuntimeResult, iter_plan, run_plan
from repro_torch.runtime.plan_utils import gold_plan_for

_UNSET = object()     # "inherit the session default" sentinel


def _affinity_workers(dispatcher) -> Optional[int]:
    """Normalize an EngineSpec.dispatcher affinity declaration to a thread
    count: an int, or a ``threads[:N]`` spec string. None: no affinity."""
    if dispatcher is None:
        return None
    if isinstance(dispatcher, int):
        n = dispatcher
    elif isinstance(dispatcher, str):
        kind, _, arg = dispatcher.partition(":")
        if kind != "threads":
            raise ValueError(
                f"engine dispatcher affinity {dispatcher!r}: only "
                f"'threads[:N]' (or an int worker count) is supported")
        n = int(arg) if arg else 1
    else:
        raise ValueError(f"cannot read engine dispatcher affinity "
                         f"{dispatcher!r} (int or 'threads[:N]')")
    if n <= 0:
        raise ValueError(f"engine dispatcher affinity must be positive, "
                         f"got {n}")
    return n


@dataclass(frozen=True)
class EngineSpec:
    """One named serving engine of a Session's pool.

      name             — unique engine name; pooled operators are keyed
                         ``name/op`` everywhere (plans, StageStats,
                         EXPLAIN's engine column); single-engine sessions
                         leave operator names unprefixed
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
      dispatcher       — optional thread-affinity hint (int workers or
                         ``threads[:N]``): under a "threads" session
                         dispatcher this engine's flushes get a dedicated
                         pool of that size
      cost_scale       — static cost multiplier applied to this engine's
                         candidates when the pool orders them
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
      device           — the torch device the engine runs on (None, the
                         default, resolves to "cuda"; "cpu" runs the plain
                         kernel versions). A remote engine is placed by
                         its worker: address= with a device is an error
      sm_int8 / lg_int8 — compression ratios to ALSO store as int8
                         quantized profiles; each becomes a distinct
                         cascade candidate (operator suffix ``i8``) whose
                         flushes launch the int8 decode kernels
      address          — serve this engine REMOTELY: "host:port" of a
                         running `repro_torch.launch.remote_worker` (which
                         owns the actual model zoo / ladder / store /
                         device — launch it with the same values for
                         bit-parity with a local spec). The session builds
                         no local engine for the slot; the pool member
                         becomes a RemoteEngineMember whose flushes go
                         over the wire. Mutually exclusive with `device`
                         and `dispatcher` affinity. The gold engine must
                         stay local (fallback + reference execution need
                         an in-process engine).
      on_unavailable   — remote degradation policy: "fallback" (default)
                         re-routes failed flushes to the gold/local
                         engine mid-run and records it in telemetry;
                         "fail" raises RemoteEngineError
      timeout_s        — per-call wire timeout for a remote engine
      remote_retries   — transport retries per idempotent remote call
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
    dispatcher: Optional[Any] = None
    cost_scale: float = 1.0
    kernels: Optional[str] = None
    fused: Optional[bool] = None
    device_cache: Optional[bool] = None
    async_h2d: Optional[bool] = None
    device: Any = None
    sm_int8: Tuple[float, ...] = ()
    lg_int8: Tuple[float, ...] = ()
    address: Optional[str] = None
    on_unavailable: str = "fallback"
    timeout_s: float = 30.0
    remote_retries: int = 2

    def __post_init__(self):
        if not self.name or not isinstance(self.name, str):
            raise ValueError("EngineSpec.name must be a non-empty string")
        if self.address is not None:
            if ":" not in self.address:
                raise ValueError(
                    f"engine {self.name!r}: address must be 'host:port', "
                    f"got {self.address!r}")
            # a remote engine's placement/affinity belongs to its worker
            # process — declaring both is a contradiction
            if self.device is not None:
                raise ValueError(
                    f"engine {self.name!r}: address= and device= are "
                    f"mutually exclusive — a remote engine is placed by "
                    f"its worker process, not this session")
            if self.dispatcher is not None:
                raise ValueError(
                    f"engine {self.name!r}: address= and dispatcher= "
                    f"affinity are mutually exclusive — a remote "
                    f"engine's flushes run on its worker, not a local "
                    f"thread pool")
        if self.on_unavailable not in ("fallback", "fail"):
            raise ValueError(
                f"engine {self.name!r}: on_unavailable must be "
                f"'fallback' or 'fail', got {self.on_unavailable!r}")
        if self.timeout_s <= 0:
            raise ValueError(f"engine {self.name!r}: timeout_s must be "
                             f"positive, got {self.timeout_s}")
        if self.remote_retries < 0:
            raise ValueError(f"engine {self.name!r}: remote_retries must "
                             f"be >= 0, got {self.remote_retries}")
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
        if self.cost_scale <= 0:
            raise ValueError(f"engine {self.name!r}: cost_scale must be "
                             f"positive, got {self.cost_scale}")
        _affinity_workers(self.dispatcher)      # validate eagerly

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

    Engines — two equivalent declarations:
      engines          — a tuple of named EngineSpec entries: the session
                         serves a heterogeneous pool, the runtime backend
                         is a PoolBackend unioning every engine's
                         candidate ladder, and the planner places each
                         stage on one engine. Names must be unique;
                         engines=() is an error.
      <flat fields>    — the single-engine form below; it compiles to one
                         EngineSpec named "default" (see resolved_engines)
      gold_engine      — which engine's gold operator defines the quality
                         reference (default: the first declared engine)

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
                         "threads[:N]" | "sharded[:N]" | "mesh[:N]"), a
                         Dispatcher instance, or None to read
                         STRETTO_DISPATCHER. "mesh:N" scatters the
                         partition loop over N corpus shards, each with
                         its engines placed on a device of the dispatch
                         mesh (every shard on one card when there is
                         one); decisions stay bit-identical to "inline"

    Measured feedback (the measure -> plan loop)
      feedback         — seeds the session's MeasuredBatchStore: a store
                         instance, a directory of stage_stats*.json
                         snapshots to aggregate, or None for a fresh store

    Tenants
      tenants          — TenantSpec entries (repro_torch.scheduler)
                         declaring tier / fair-share weight / keep-warm
                         cache policy for Session.scheduler(). None: every
                         scheduled query runs under an implicit "default"
                         standard tenant.
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
    gold_engine: Optional[str] = None
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
                    "declare at least one EngineSpec, or omit `engines` "
                    "for the flat single-engine form")
            names = [e.name for e in self.engines]
            dups = sorted({n for n in names if names.count(n) > 1})
            if dups:
                raise ValueError(f"duplicate engine name(s): {dups}")
        if self.gold_engine is not None:
            names = [e.name for e in self.resolved_engines()]
            if self.gold_engine not in names:
                raise ValueError(
                    f"gold_engine {self.gold_engine!r} is not a declared "
                    f"engine (engines: {names})")
        specs = self.resolved_engines()
        gold = self.gold_engine if self.gold_engine is not None \
            else specs[0].name
        gold_spec = next(s for s in specs if s.name == gold)
        if gold_spec.address is not None:
            raise ValueError(
                f"gold engine {gold!r} is remote (address="
                f"{gold_spec.address!r}) — the gold engine must be local: "
                f"it anchors the quality reference and serves as the "
                f"on_unavailable='fallback' target, both of which need an "
                f"in-process engine. Declare a local gold engine (or set "
                f"gold_engine to a local spec).")
        if self.tenants is not None:
            from repro_torch.scheduler.tenants import validate_tenants
            object.__setattr__(self, "tenants",
                               validate_tenants(self.tenants))

    def resolved_engines(self) -> Tuple[EngineSpec, ...]:
        """The engine pool this config declares. The flat fields (models /
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
        included — the reference backend needs it). Single-engine view
        only: a pool has one ladder per engine, so ask each resolved
        EngineSpec instead."""
        specs = self.resolved_engines()
        if len(specs) > 1:
            raise ValueError(
                "a multi-engine SessionConfig has per-engine ladders; "
                "call .ladder() on each spec in resolved_engines()")
        return specs[0].ladder()


class Session:
    """Context-managed front door to the engine.

    Three construction modes:

      Session()                      — owns everything: fresh cache
                                       store(s), planted models on each
                                       spec's device, profiles built
                                       lazily per corpus on first use
      Session(engine=eng)            — adopts one existing ServingEngine
                                       (models are the caller's; call
                                       .prepare(items) to build profiles)
      Session(backend=b)             — wraps any runtime Backend (e.g. an
                                       OracleBackend over a registry, or
                                       a PoolBackend over prebuilt
                                       engines); no engine, no profile
                                       building — gold references come
                                       from `reference=` or the backend's
                                       own gold operators
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

        # the declared engine pool: every session resolves to named specs
        # (flat configs become one spec named "default")
        self.engine_specs: Tuple[EngineSpec, ...] = config.resolved_engines()
        self._specs_by_name = {s.name: s for s in self.engine_specs}
        self.gold_engine_name: str = config.gold_engine \
            if config.gold_engine is not None else self.engine_specs[0].name
        # remote engine members (EngineSpec(address=...)), built alongside
        # the pool backend; profile sync rides on prepare()
        self._remote_members: Dict[str, Any] = {}
        self._engine_workers: Dict[str, int] = {}
        for spec in self.engine_specs:
            w = _affinity_workers(spec.dispatcher)
            if w is not None:
                self._engine_workers[spec.name] = w
        self._affinity_disp = None

        self._owns_engine = engine is None and backend is None
        if backend is not None and engine is None:
            self.engines: Dict[str, Any] = {}
            self.engine = None
        elif engine is not None:
            if len(self.engine_specs) > 1:
                raise ValueError(
                    "Session(engine=...) adopts exactly one engine; a "
                    "multi-engine SessionConfig must let the session "
                    "build its own pool (or wrap a prebuilt PoolBackend "
                    "via Session(backend=...))")
            self.engines = {self.engine_specs[0].name: engine}
            self.engine = engine
        else:
            self.engines = self._build_engines()
            # the session's "primary" engine: the first *local* spec's
            # (remote specs build no in-process engine; the gold engine
            # is guaranteed local, so this always resolves)
            first_local = next(s.name for s in self.engine_specs
                               if s.name in self.engines)
            self.engine = self.engines[first_local]
        self.backend: Backend = as_backend(backend) \
            if backend is not None else self._default_backend()
        if reference is not None:
            self.reference = as_backend(reference)
        elif self.engines:
            from repro_torch.runtime.backend import ReferenceBackend
            gold_spec = self._specs_by_name[self.gold_engine_name]
            self.reference = ReferenceBackend(
                self.engines[gold_spec.name], lg=gold_spec.lg_model)
        else:
            # no engine: the backend's own gold operators (candidates
            # list, gold last) are the reference
            self.reference = self.backend

    @property
    def device(self):
        """Where the session plans (its gradient optimizer's loop): the
        first engine's device, else the configured one."""
        if self.engine is not None:
            return self.engine.device
        return resolve_device(self.config.device)

    # ---------------- lifecycle ----------------

    def _build_engines(self) -> Dict[str, Any]:
        from repro_torch.cache.store import CacheStore
        from repro_torch.data.synthetic import (make_planted_params,
                                                planted_config)
        from repro_torch.serving.engine import ServingEngine
        engines: Dict[str, Any] = {}
        for spec in self.engine_specs:
            if spec.address is not None:
                continue            # served by a remote worker process
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
        if self._affinity_disp is not None:
            self._affinity_disp.close()
            self._affinity_disp = None
        for member in self._remote_members.values():
            member.close()
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
        """Build KV-cache profiles for this corpus (offline phase), per
        engine at each engine's own ladder (`ratios` overrides every
        ladder), plus its int8 rungs. Safe to call repeatedly — and from
        concurrent scheduler queries — each (engine, corpus, ladder) is
        built once."""
        if not self.engines and not self._remote_members:
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
        # remote members: corpus sync (the worker builds its own ladder
        # lazily on first sync; a hash-matched re-sync is one round trip)
        for name, member in self._remote_members.items():
            key = ("remote", name, self._corpus_key(items))
            if key in self._prepared:
                continue
            member.sync(items)
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
        """A KVCacheBackend over one session engine (default: the first
        declared) with an alternative candidate ladder (defaults: that
        engine's declared ladder). Single-engine view — the session
        default for pool configs is `_default_backend()`."""
        if not self.engines:
            raise RuntimeError("session has no engine: it wraps an "
                               "externally supplied backend")
        name = engine if engine is not None else self.engine_specs[0].name
        spec = self._specs_by_name.get(name)
        if spec is not None and spec.address is not None:
            raise ValueError(
                f"engine {name!r} is remote (address={spec.address!r}) — "
                f"it has no local KVCacheBackend; its candidate ladder "
                f"lives on the worker and is reached through the pool")
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

    def _default_backend(self) -> Backend:
        """The session's runtime backend: the bare KVCacheBackend for a
        single-engine config (operator names stay unprefixed), a
        PoolBackend routing across every declared engine otherwise."""
        if len(self.engine_specs) == 1:
            return self.backend_for()
        from repro_torch.runtime.backend import PoolBackend
        members = []
        for spec in self.engine_specs:
            if spec.address is not None:
                from repro_torch.remote.client import RemoteEngineMember
                member = RemoteEngineMember(
                    spec.name, spec.address, timeout_s=spec.timeout_s,
                    retries=spec.remote_retries,
                    on_unavailable=spec.on_unavailable)
                self._remote_members[spec.name] = member
            else:
                member = self.backend_for(engine=spec.name)
            members.append((spec.name, member))
        pool = PoolBackend(
            members, gold=self.gold_engine_name,
            cost_scales={s.name: s.cost_scale for s in self.engine_specs})
        # a remote member's on_unavailable='fallback' re-routes failed
        # flushes to the gold/local member — always safe: gold scores
        # never degrade decisions (gold is the quality reference)
        for member in self._remote_members.values():
            member.set_fallback(pool.members[self.gold_engine_name])
        return pool

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

    def _default_dispatcher(self):
        """The session-default dispatcher argument, honoring per-engine
        thread affinity: when any EngineSpec declares a `dispatcher`
        worker hint and the session default resolves to a "threads" spec,
        a session-owned ThreadPoolDispatcher with dedicated per-engine
        pools is used (completions still apply in global submission
        order, so decisions are unchanged)."""
        spec = self.config.dispatcher
        if not self._engine_workers:
            return spec
        if spec is not None and not isinstance(spec, str):
            return spec                 # caller-supplied instance wins
        from repro_torch.runtime.dispatch import (ThreadPoolDispatcher,
                                                  effective_spec)
        eff = effective_spec(spec)
        if not eff.startswith("threads"):
            return spec
        if self._affinity_disp is None:
            _, _, arg = eff.partition(":")
            kwargs: Dict[str, Any] = {
                "engine_workers": dict(self._engine_workers)}
            if arg:
                n = int(arg)
                if n <= 0:
                    # same contract as resolve_dispatcher: a bad count
                    # must fail loudly, not silently clamp to 1 worker
                    raise ValueError(f"dispatcher spec {eff!r}: "
                                     f"worker/shard count must be "
                                     f"positive, got {n}")
                kwargs["n_workers"] = n
            self._affinity_disp = ThreadPoolDispatcher(**kwargs)
        return self._affinity_disp

    def _exec_kwargs(self, partition_size=_UNSET, coalesce=_UNSET,
                     dispatcher=_UNSET) -> Dict[str, Any]:
        cfg = self.config
        return {
            "partition_size": cfg.partition_size
            if partition_size is _UNSET else partition_size,
            "coalesce": cfg.coalesce if coalesce is _UNSET else coalesce,
            "dispatcher": self._default_dispatcher()
            if dispatcher is _UNSET else dispatcher,
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
                    measured=self.measured if len(self.measured) else None,
                    device=self.device)
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
        before = {n: m.snapshot()
                  for n, m in self._remote_members.items()} or None
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
        if before is not None:
            from repro_torch.remote.client import remote_run_info
            after = {n: m.snapshot()
                     for n, m in self._remote_members.items()}
            result.remote = remote_run_info(before, after)
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

    # ---------------- join trees ----------------

    def plan_tree(self, tree, left_items: Sequence[Any],
                  right_items: Sequence[Any], *,
                  target_recall: float = 0.9,
                  target_precision: float = 0.9):
        """Plan a logical join tree over two corpora with the session's
        planner settings, memoized like `plan` but keyed on *both*
        corpus fingerprints. Profiles are built for each side corpus
        only — the pair cascade's operators decompose to side-item
        engine calls, so the sides' KV-cache profiles serve the pair
        stages too."""
        from repro_torch.core.planner import plan_tree as _plan_tree
        with self._state_lock:
            self._ensure_prepared(left_items)
            self._ensure_prepared(right_items)
            key = ("tree", self._corpus_key(left_items),
                   self._corpus_key(right_items), tree,
                   target_recall, target_precision,
                   self.measured.version if len(self.measured) else 0)
            plan = self._plan_cache.get(key)
            if plan is None:
                cfg = self.config
                plan = _plan_tree(
                    tree, left_items, right_items, self.backend,
                    cfg.planner, target_recall=target_recall,
                    target_precision=target_precision,
                    sample_frac=cfg.sample_frac, seed=cfg.seed,
                    reorder=cfg.reorder,
                    coalesce=cfg.coalesce if cfg.coalesce is not None
                    else DEFAULT_COALESCE,
                    measured=self.measured if len(self.measured) else None,
                    device=self.device)
                self._plan_cache[key] = plan
            return plan

    def run_tree(self, plan, left_items: Sequence[Any],
                 right_items: Sequence[Any],
                 backend: Optional[Backend] = None, *,
                 partition_size=_UNSET, coalesce=_UNSET,
                 dispatcher=_UNSET):
        """Execute a planned join tree — left side, right side, then the
        pair cascade over the blocked survivor pairs — with the
        session's execution defaults. Returns a runtime TreeResult."""
        from repro_torch.runtime.tree import run_tree as _run_tree
        self._ensure_prepared(left_items)
        self._ensure_prepared(right_items)
        return _run_tree(plan, left_items, right_items,
                         backend or self.backend,
                         **self._exec_kwargs(partition_size, coalesce,
                                             dispatcher))

    def gold_tree(self, plan, left_items: Sequence[Any],
                  right_items: Sequence[Any]):
        """The gold reference execution of a join tree (every role run
        under its gold-only plan, gold survivors paired), memoized per
        (both corpora, tree queries)."""
        from repro_torch.runtime.tree import run_gold_tree
        with self._state_lock:
            self._ensure_prepared(left_items)
            self._ensure_prepared(right_items)
            key = ("gold-tree", self._corpus_key(left_items),
                   self._corpus_key(right_items), plan.join,
                   tuple(tuple(plan.queries[r].nodes)
                         for r in ("left", "right", "pair")))
            got = self._gold_cache.get(key)
            if got is None:
                got = run_gold_tree(plan, left_items, right_items,
                                    self.reference, **self._exec_kwargs())
                self._gold_cache[key] = got
            return got

    def scheduler(self, **kwargs):
        """Build a QueryScheduler admitting concurrent queries onto this
        session (see repro_torch.scheduler). Tenants default to the
        session config's `tenants` tuple; keyword arguments are forwarded
        to the QueryScheduler constructor."""
        from repro_torch.scheduler import QueryScheduler
        return QueryScheduler(self, **kwargs)
