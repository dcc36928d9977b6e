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

The routing pool over several engines (`PoolBackend`) is not ported yet.
`as_backend` adapts registry callables.
"""
from __future__ import annotations

import threading
from typing import (Any, Callable, Dict, List, Protocol, Sequence,
                    Tuple, runtime_checkable)

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

    def __init__(self, registry: Callable):
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
                    got = list(self._registry(op))
                    self._cache[op] = got
        return got

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


def as_backend(registry_or_backend) -> Backend:
    """Adapt a legacy registry callable to the Backend protocol; Backends
    pass through unchanged."""
    if isinstance(registry_or_backend, Backend):
        return registry_or_backend
    if callable(registry_or_backend):
        return OracleBackend(registry_or_backend)
    raise TypeError(f"cannot adapt {type(registry_or_backend)!r} "
                    "to a runtime Backend")
