"""Pluggable dispatch layer for the streaming executor's stage flushes.

The port of `repro.runtime.dispatch`'s flush dispatchers. A flush becomes
a `FlushTask` submitted to a `Dispatcher`:

  InlineDispatcher     — runs the operator on the calling thread and
                         completes it immediately: the parity baseline.
  ThreadPoolDispatcher — overlaps independent stage flushes on a thread
                         pool; the executor applies completions in strict
                         submission order, so decisions match inline
                         bit-for-bit whenever per-tuple scores do not
                         depend on batch grouping (the CUDA decode kernels
                         guarantee that for the attention).

The partition-scatter dispatchers (`sharded`, `mesh`) are not ported yet.

Selection: pass a Dispatcher (or spec string) to `run_plan(dispatcher=...)`
or set ``STRETTO_DISPATCHER`` (``inline`` | ``threads[:N]``).
"""
from __future__ import annotations

import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

DISPATCHER_ENV = "STRETTO_DISPATCHER"

# default coalesced flush width (tuples per stage batch), the same as the
# JAX package's (its planner prices flushes of this width)
DEFAULT_COALESCE = 64

_DEFAULT_THREADS = 4


@dataclass
class FlushTask:
    """One coalesced stage flush: a batch of tuples for one physical
    operator. `items` holds only the tuples the stage will actually score
    (the eligible subset of its cohort)."""
    stage_idx: int           # position in plan.stages
    sem_op: Any              # the logical (semantic) operator
    op_name: str             # physical operator name to resolve
    items: List[Any]         # batch payloads, eligible tuples only
    engine: str = ""         # owning engine of the stage's operator (""
    #                          for single-engine sessions): dispatchers
    #                          with per-engine affinity route on it, and
    #                          because the executor applies completions in
    #                          global submission (FIFO) order regardless
    #                          of which pool ran a task, per-engine
    #                          routing preserves submission-order parity


class _Immediate:
    """Resolved handle for synchronously executed tasks."""

    __slots__ = ("_value",)

    def __init__(self, value):
        self._value = value

    def result(self):
        return self._value


class InlineDispatcher:
    """Run every flush synchronously on the calling thread — the exact
    pre-dispatch execution schedule, and the parity baseline."""

    name = "inline"
    n_workers = 1
    max_pending = 0     # executor completes each flush right after submit

    def submit(self, task: FlushTask,
               runner: Callable[[FlushTask], Any]) -> _Immediate:
        return _Immediate(runner(task))

    def close(self):
        pass


class ThreadPoolDispatcher:
    """Overlap independent stage flushes on a thread pool.

    The executor bounds in-flight flushes at `max_pending` and applies
    completions in FIFO submission order, so scheduling decisions (cohort
    composition, flush points) depend only on deterministically ordered
    state — never on thread timing. Operator calls themselves are pure
    batch -> scores functions; PyTorch releases the GIL inside its
    operators and the card runs asynchronously, which is where the
    overlap comes from.
    """

    name = "threads"

    def __init__(self, n_workers: int = _DEFAULT_THREADS,
                 engine_workers: Optional[Dict[str, int]] = None):
        """`engine_workers` declares per-engine thread affinity: flushes
        whose FlushTask.engine appears in the mapping run on a dedicated
        pool of that size (engines stop contending for each other's
        workers); everything else shares the default pool. Completions
        are still applied by the executor in global submission order, so
        affinity never changes decisions — only where the overlap
        happens."""
        self.n_workers = max(int(n_workers), 1)
        self.engine_workers = {str(k): max(int(v), 1)
                               for k, v in (engine_workers or {}).items()}
        # in-flight window: enough tasks to keep every worker busy while
        # the main thread prepares the next cohort
        total = self.n_workers + sum(self.engine_workers.values())
        self.max_pending = 2 * total
        self._pools: Dict[str, ThreadPoolExecutor] = {}
        self._lock = threading.Lock()
        self._closed = False

    def _pool_for(self, engine: str) -> ThreadPoolExecutor:
        key = engine if engine in self.engine_workers else ""
        with self._lock:
            if self._closed:
                # without this check a submit racing close() would
                # silently respawn a fresh pool that nothing ever shuts
                # down (close already ran) — fail loudly instead
                raise RuntimeError(
                    "ThreadPoolDispatcher is closed; flushes can no "
                    "longer be submitted")
            pool = self._pools.get(key)
            if pool is None:
                workers = self.engine_workers.get(key, self.n_workers)
                pool = ThreadPoolExecutor(
                    max_workers=workers,
                    thread_name_prefix=f"stretto-flush-{key or 'shared'}")
                self._pools[key] = pool
            return pool

    def submit(self, task: FlushTask,
               runner: Callable[[FlushTask], Any]) -> Future:
        return self._pool_for(getattr(task, "engine", "") or "").submit(
            runner, task)

    def close(self):
        """Idempotent and safe under concurrent submitters: the first
        close wins (later calls return immediately), pools are shut down
        outside the lock (a shutdown waits for running flushes, which
        must not block new submitters from getting their clear
        submit-after-close error), and any submit that loses the race
        raises instead of leaking an orphan pool."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            pools, self._pools = dict(self._pools), {}
        for pool in pools.values():
            pool.shutdown(wait=True)


def effective_spec(spec=None) -> str:
    """The dispatcher spec a run with this argument will actually use:
    spec strings pass through, Dispatcher instances report their name,
    and None resolves the ``STRETTO_DISPATCHER`` environment default
    (``inline``). The single source of the env-default policy — EXPLAIN
    reports through this, so it cannot drift from resolve_dispatcher."""
    if spec is None:
        spec = os.environ.get(DISPATCHER_ENV, "") or "inline"
    if isinstance(spec, str):
        return spec
    return getattr(spec, "name", str(spec))


def backend_engines(backend) -> List[Any]:
    """Every ServingEngine a runtime backend routes flushes to: the
    engine of a KVCache/Reference backend, the union over a PoolBackend's
    members, [] for engineless (oracle/registry) backends."""
    eng = getattr(backend, "engine", None)
    if eng is not None:
        return [eng]
    members = getattr(backend, "members", None)
    if members:
        out: List[Any] = []
        for m in members.values():
            out.extend(backend_engines(m))
        return out
    return []


def resolve_dispatcher(spec=None) -> Tuple[Any, bool]:
    """Resolve a dispatcher argument to (dispatcher, owned).

    `spec` may be a Dispatcher instance (passed through, owned=False — the
    caller manages its lifetime), a spec string (``inline``, ``threads``,
    ``threads:N``), or None, which
    reads the ``STRETTO_DISPATCHER`` environment variable (default
    ``inline``). Owned dispatchers are closed by run_plan when the plan
    finishes.
    """
    if spec is None:
        spec = effective_spec()
    if hasattr(spec, "submit"):
        return spec, False
    if not isinstance(spec, str):
        raise TypeError(f"cannot resolve {type(spec)!r} to a Dispatcher")
    kind, _, arg = spec.partition(":")
    n = int(arg) if arg else None
    if n is not None and n <= 0:
        raise ValueError(f"dispatcher spec {spec!r}: worker/shard count "
                         f"must be positive, got {n}")
    if kind == "inline":
        return InlineDispatcher(), True
    if kind == "threads":
        return ThreadPoolDispatcher(
            n if n is not None else _DEFAULT_THREADS), True
    if kind in ("sharded", "mesh"):
        raise NotImplementedError(
            f"dispatcher {kind!r} is not ported yet (inline | threads[:N])")
    raise ValueError(f"unknown dispatcher spec {spec!r} "
                     "(expected inline | threads[:N])")
