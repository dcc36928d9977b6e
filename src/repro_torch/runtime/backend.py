"""Pluggable operator backends for the runtime (paper §5 execution layer).

The port of `repro.runtime.backend`. A Backend answers one question:
"score this batch of items under this physical implementation of a
semantic operator". It owns operator resolution (the physical candidates
of a logical op, gold last) and batched invocation.

  OracleBackend     — wraps any registry callable.
  KVCacheBackend    — operators over a ServingEngine's precomputed
                      (compressed) KV-cache profiles, with KV-bytes
                      telemetry.
  ReferenceBackend  — uncompressed gold only (largest model, ratio 0.0).
  PoolBackend       — a routing pool over *named* member backends
                      (heterogeneous engines): `candidates()` is the union
                      of every member's non-gold candidates, each tagged
                      with its owning engine (operator names become
                      ``engine/op``), sorted by (cost-scaled) static cost,
                      with exactly one gold — the designated gold engine's
                      — resolved last. score_filter / run_map and the
                      KV-bytes counter route to the owning member, so the
                      planner prices and the executor attributes every
                      stage per (engine, operator).

`as_backend` adapts registry callables.
"""
from __future__ import annotations

import threading
from typing import (Any, Callable, Dict, List, Optional, Protocol,
                    Sequence, Tuple, runtime_checkable)

import numpy as np

from repro_torch.core.logical import SemFilter, SemMap
from repro_torch.core.physical import PhysicalOperator


@runtime_checkable
class Backend(Protocol):
    """Batched execution surface for physical operators."""

    name: str

    def candidates(self, op) -> List[PhysicalOperator]:
        """Physical implementations of semantic op, cost order, gold LAST."""
        ...

    def resolve(self, op, op_name: str) -> PhysicalOperator:
        """The named physical implementation of a semantic operator."""
        ...

    def score_filter(self, op: SemFilter, op_name: str,
                     items: Sequence[Any]) -> np.ndarray:
        """Log-odds scores (len(items),) for a SemFilter batch."""
        ...

    def run_map(self, op: SemMap, op_name: str, items: Sequence[Any]
                ) -> Tuple[np.ndarray, np.ndarray]:
        """(values, confidences) each (len(items),) for a SemMap batch."""
        ...

    def kv_bytes_loaded(self) -> int:
        """Monotonic counter of KV-cache bytes materialized so far *by the
        calling thread* (0 for backends that never touch a cache store).
        Thread-scoped so `run_operator`'s before/after deltas stay exact
        when independent flushes overlap on a dispatcher's thread pool —
        a process-global counter would interleave concurrent loads into
        each other's deltas and double-count."""
        ...


class RegistryBackend:
    """Shared machinery: a Backend over a `registry(op) -> [PhysicalOperator]`
    callable. Operator instances are cached per semantic op so repeated
    stages hit the same jit/profile state."""

    name = "registry"

    def __init__(self, registry: Optional[Callable]):
        self._registry = registry
        self._cache: Dict[Any, List[PhysicalOperator]] = {}
        self._by_name: Dict[Any, PhysicalOperator] = {}
        # candidate/name resolution is memoized; the scheduler's query
        # drivers resolve concurrently, so the build-on-miss must be
        # serialized (RLock: a registry callable may itself resolve —
        # PoolBackend's union walks member candidates)
        self._resolve_lock = threading.RLock()

    def candidates(self, op) -> List[PhysicalOperator]:
        got = self._cache.get(op)
        if got is None:
            with self._resolve_lock:
                got = self._cache.get(op)
                if got is None:
                    got = list(self._build_candidates(op))
                    self._cache[op] = got
        return got

    def _build_candidates(self, op) -> List[PhysicalOperator]:
        """The candidates of `op`, built once per op (`candidates`
        memoizes them): the registry callable's. A subclass that builds
        them from its own state overrides this, so that it keeps no
        callable bound to itself (a reference cycle that would hold its
        engines until the cyclic collector ran)."""
        return self._registry(op)

    def resolve(self, op, op_name: str) -> PhysicalOperator:
        got = self._by_name.get((op, op_name))
        if got is not None:
            return got
        with self._resolve_lock:
            got = self._by_name.get((op, op_name))
            if got is not None:
                return got
            for phys in self.candidates(op):
                if phys.name == op_name:
                    self._by_name[(op, op_name)] = phys
                    return phys
        raise KeyError(f"backend {self.name!r} has no operator {op_name!r} "
                       f"for {op}")

    def score_filter(self, op: SemFilter, op_name: str,
                     items: Sequence[Any]) -> np.ndarray:
        phys = self.resolve(op, op_name)
        return np.asarray(phys.run_filter(items, op), np.float32)

    def run_map(self, op: SemMap, op_name: str, items: Sequence[Any]
                ) -> Tuple[np.ndarray, np.ndarray]:
        phys = self.resolve(op, op_name)
        vals, conf = phys.run_map(items, op)
        return np.asarray(vals), np.asarray(conf, np.float32)

    def kv_bytes_loaded(self) -> int:
        # Non-serving backends own no cache store, so they report a flat 0
        # — the StageStats kv_bytes field must not drift with whatever
        # engine-backed operators a registry callable happens to hand out.
        # Serving backends (KVCache / Reference) override this with their
        # engine's store counter.
        return 0

    def transfer_stats(self) -> Tuple[float, int]:
        """Monotonic (h2d_overlap_s, donated_bytes) counters for the
        calling thread — H2D transfer time the engine hid behind decode
        compute, and KV cache bytes released for reuse. Thread-scoped
        for the same reason as kv_bytes_loaded. Kept OFF the Backend
        protocol (it is optional — run_operator getattr-probes it), so
        custom backends that only implement the protocol surface keep
        satisfying the runtime_checkable isinstance check."""
        return (0.0, 0)


class OracleBackend(RegistryBackend):
    """Backend over the synthetic planted-signal registry (or any other
    registry callable): scores come from whatever operators the registry
    hands out."""

    name = "oracle"


class KVCacheBackend(RegistryBackend):
    """Backend over a ServingEngine's precomputed KV-cache profiles — the
    paper's prefill-skip operators as a first-class runtime backend."""

    name = "kvcache"

    def __init__(self, engine, *, sm: str = "sm", lg: str = "lg",
                 sm_ratios=(0.8, 0.5, 0.0), lg_ratios=(0.8, 0.5, 0.3),
                 sm_int8=(), lg_int8=(), include_cheap: bool = True):
        from repro_torch.serving.operators import make_registry
        self.engine = engine
        super().__init__(make_registry(
            engine, sm=sm, lg=lg, sm_ratios=sm_ratios, lg_ratios=lg_ratios,
            sm_int8=sm_int8, lg_int8=lg_int8,
            include_cheap=include_cheap))

    def kv_bytes_loaded(self) -> int:
        # thread-local counter: a flush runs entirely on one dispatcher
        # thread, so per-call deltas are exact under concurrent dispatch
        return self.engine.store.bytes_loaded_local

    def transfer_stats(self) -> Tuple[float, int]:
        return self.engine.transfer_stats_local()


class ReferenceBackend(RegistryBackend):
    """Uncompressed gold only: every semantic operator maps to the single
    largest-model, ratio-0.0 operator. Executing any plan through this
    backend reproduces the reference result set."""

    name = "reference"

    def __init__(self, engine, *, lg: str = "lg"):
        from repro_torch.core.logical import SemJoin
        from repro_torch.serving.operators import (KVCacheLLMOperator,
                                                   KVCachePairOperator)
        self.engine = engine

        def gold_registry(op):
            if isinstance(op, SemJoin):
                return [KVCachePairOperator(engine, lg, 0.0, is_gold=True)]
            return [KVCacheLLMOperator(engine, lg, 0.0, is_gold=True)]

        super().__init__(gold_registry)

    def kv_bytes_loaded(self) -> int:
        return self.engine.store.bytes_loaded_local

    def transfer_stats(self) -> Tuple[float, int]:
        return self.engine.transfer_stats_local()


class EngineTaggedOperator(PhysicalOperator):
    """A member engine's physical operator, as seen through a PoolBackend:
    the name gains an ``engine/`` prefix (so MeasuredBatchStore feedback
    and StageStats stay keyed per (engine, op) even when two engines serve
    the same model ladder), `.engine_name` names the owner (a dedicated
    attribute — serving operators already use `.engine` for the
    ServingEngine object itself), and the static cost-model estimate is
    scaled by the engine's declared `cost_scale` (candidate *ordering* —
    profiling still measures real wall time)."""

    def __init__(self, engine_name: str, inner: PhysicalOperator,
                 cost_scale: float = 1.0):
        self.engine_name = engine_name
        self.inner = inner
        self.cost_scale = float(cost_scale)
        self.name = f"{engine_name}/{inner.name}"
        self.is_gold = bool(getattr(inner, "is_gold", False))
        self.uses_llm = bool(getattr(inner, "uses_llm", True))

    def run_filter(self, items: Sequence[Any], op) -> np.ndarray:
        return self.inner.run_filter(items, op)

    def run_map(self, items: Sequence[Any], op):
        return self.inner.run_map(items, op)

    def cost_model(self) -> float:
        return self.inner.cost_model() * self.cost_scale

    def max_batch(self) -> Optional[int]:
        fn = getattr(self.inner, "max_batch", None)
        return fn() if callable(fn) else None


class PoolBackend(RegistryBackend):
    """Routing pool over named heterogeneous member backends.

    `members` is an ordered mapping (or sequence of pairs) ``name ->
    Backend``; `gold` names the member whose gold operator defines the
    reference (default: the first member — declaration order is the
    priority order). Candidates are the union of every member's non-gold
    candidates tagged ``name/op`` and sorted by cost-scaled static cost,
    plus the gold member's gold operator, last and unique — the Backend
    contract every planner/profiler path relies on. Execution and
    KV-bytes telemetry route to the owning member: a flush touches
    exactly one engine's cache store, so per-stage counters attribute to
    the right engine with no extra bookkeeping.
    """

    name = "pool"

    def __init__(self, members, *, gold: Optional[str] = None,
                 cost_scales: Optional[Dict[str, float]] = None):
        pairs = list(members.items()) if isinstance(members, dict) \
            else [(n, b) for n, b in members]
        if not pairs:
            raise ValueError("PoolBackend needs at least one member engine")
        names = [n for n, _ in pairs]
        dups = sorted({n for n in names if names.count(n) > 1})
        if dups:
            raise ValueError(f"duplicate engine name(s) in pool: {dups}")
        self.members: Dict[str, Backend] = {n: as_backend(b)
                                            for n, b in pairs}
        self.gold_engine = gold if gold is not None else names[0]
        if self.gold_engine not in self.members:
            raise ValueError(
                f"gold engine {self.gold_engine!r} is not a pool member "
                f"(engines: {sorted(self.members)})")
        self.cost_scales = {n: float((cost_scales or {}).get(n, 1.0))
                            for n in names}
        super().__init__(None)

    def _build_candidates(self, op) -> List[PhysicalOperator]:
        ops: List[PhysicalOperator] = []
        for name, member in self.members.items():
            for phys in member.candidates(op):
                if getattr(phys, "is_gold", False):
                    continue        # one gold only: the gold engine's
                ops.append(EngineTaggedOperator(name, phys,
                                                self.cost_scales[name]))
        # cost order (stable: declaration order breaks ties), gold LAST
        ops.sort(key=lambda t: t.cost_model())
        golds = [p for p in self.members[self.gold_engine].candidates(op)
                 if getattr(p, "is_gold", False)]
        if not golds:
            raise ValueError(f"gold engine {self.gold_engine!r} offers no "
                             f"gold operator for {op}")
        ops.append(EngineTaggedOperator(self.gold_engine, golds[-1],
                                        self.cost_scales[self.gold_engine]))
        return ops

    def resolve(self, op, op_name: str) -> PhysicalOperator:
        try:
            return super().resolve(op, op_name)
        except KeyError:
            engine, sep, _ = op_name.partition("/")
            if sep and engine not in self.members:
                # surfaced at resolve time, on the submitting thread —
                # never deep inside a dispatched flush
                raise ValueError(
                    f"operator {op_name!r} references unknown engine "
                    f"{engine!r}; pool engines: {sorted(self.members)}"
                ) from None
            raise

    def member(self, engine: str) -> Backend:
        """The named member backend."""
        try:
            return self.members[engine]
        except KeyError:
            raise ValueError(f"unknown engine {engine!r}; pool engines: "
                             f"{sorted(self.members)}") from None

    def kv_bytes_loaded(self) -> int:
        # per-thread sum over members: each member counts only its own
        # store's loads, so a flush (which touches exactly one engine)
        # contributes its delta to exactly one term
        return sum(m.kv_bytes_loaded() for m in self.members.values())

    def transfer_stats(self) -> Tuple[float, int]:
        h2d, donated = 0.0, 0
        for m in self.members.values():
            fn = getattr(m, "transfer_stats", None)
            if fn is not None:
                mh, md = fn()
                h2d += mh
                donated += md
        return (h2d, donated)


def as_backend(registry_or_backend) -> Backend:
    """Adapt a legacy registry callable to the Backend protocol; Backends
    pass through unchanged."""
    if isinstance(registry_or_backend, Backend):
        return registry_or_backend
    if callable(registry_or_backend):
        return OracleBackend(registry_or_backend)
    raise TypeError(f"cannot adapt {type(registry_or_backend)!r} "
                    "to a runtime Backend")
