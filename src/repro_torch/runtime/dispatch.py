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
  ShardedDispatcher    — scatters `run_plan`'s partition loop itself:
                         contiguous corpus shards each run the full
                         streaming cascade independently (per-tuple
                         decisions are partition-invariant), and only the
                         decision arrays are merged and the per-stage
                         StageStats summed. Here shards run on a thread
                         pool sharing one engine.
  MeshDispatcher       — the same scatter over the devices of a dispatch
                         mesh (launch/mesh.py): shard i runs with every
                         engine placed on device i % n (`place_on`: the
                         weights go whole onto that device) and that
                         device as the shard thread's current CUDA device.
                         Same shard tiling, same merge, so decisions stay
                         bit-identical to inline; only where the flushes
                         run changes. On one card every shard runs there.

Selection: pass a Dispatcher (or spec string) to `run_plan(dispatcher=...)`
or set ``STRETTO_DISPATCHER`` (``inline`` | ``threads[:N]`` |
``sharded[:N]`` | ``mesh[:N]``).
"""
from __future__ import annotations

import contextlib
import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

DISPATCHER_ENV = "STRETTO_DISPATCHER"

# default coalesced flush width (tuples per stage batch), the same as the
# JAX package's (its planner prices flushes of this width)
DEFAULT_COALESCE = 64

_DEFAULT_THREADS = 4
_DEFAULT_SHARDS = 2


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
    n_shards = 1
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
    n_shards = 1

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


class ShardedDispatcher:
    """Scatter the partition loop: each contiguous corpus shard streams
    through the full cascade independently; the executor merges only the
    per-shard decision arrays and sums StageStats."""

    name = "sharded"
    max_pending = 0

    def __init__(self, n_shards: int = _DEFAULT_SHARDS):
        self.n_shards = max(int(n_shards), 1)
        self._closed = False

    @property
    def n_workers(self) -> int:
        """The scatter's concurrency, which a run's result reports: one
        thread per shard."""
        return self.n_shards

    def shard_bounds(self, n_items: int) -> List[Tuple[int, int]]:
        """Contiguous [lo, hi) shard ranges covering the corpus."""
        k = min(self.n_shards, max(n_items, 1))
        step = (n_items + k - 1) // max(k, 1)
        return [(lo, min(lo + step, n_items))
                for lo in range(0, n_items, max(step, 1))]

    def map_shards(self, fn: Callable[[int, int, int], Any],
                   bounds: Sequence[Tuple[int, int]]) -> List[Any]:
        """Run ``fn(shard_idx, lo, hi)`` for every shard; the index lets
        dispatchers with per-shard placement (MeshDispatcher) route each
        shard onto its own device."""
        if self._closed:
            raise RuntimeError(
                f"{type(self).__name__} is closed; shards can no longer "
                f"be scattered")
        if len(bounds) <= 1:
            return [fn(i, lo, hi) for i, (lo, hi) in enumerate(bounds)]
        with ThreadPoolExecutor(max_workers=len(bounds),
                                thread_name_prefix="stretto-shard") as pool:
            futs = [pool.submit(fn, i, lo, hi)
                    for i, (lo, hi) in enumerate(bounds)]
            return [f.result() for f in futs]

    def close(self):
        # idempotent: per-scatter pools are context-managed inside
        # map_shards, so closing only has to fence future scatters
        self._closed = True


def backend_engines(backend) -> List[Any]:
    """Every ServingEngine a runtime backend routes flushes to: the
    engine of a KVCache/Reference backend, the union over a PoolBackend's
    members, [] for engineless (oracle/registry) backends. Used by
    dispatchers that place engine state per device."""
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


class MeshDispatcher(ShardedDispatcher):
    """ShardedDispatcher over a dispatch mesh: shard i of the scatter runs
    with its engines placed on data slice ``i % n_data`` of the mesh
    (`ServingEngine.place_on`: the weights go whole onto that device) and
    with that device as the shard
    thread's current CUDA device, so its cache loads and decodes land on
    that device. Shard tiling and the merge are inherited unchanged, so
    decisions and map values stay bit-identical to inline; with fewer
    devices than shards the shards cycle over the devices (one card runs
    every shard, as ShardedDispatcher does).

    The mesh's kind ("cuda" or "cpu", `device`) is that of the first
    engine the first scatter places (a CPU session's engines ask for the
    CPU); for a backend without engines, "cuda" where there is a card.
    """

    name = "mesh"

    def __init__(self, n_shards: Optional[int] = None):
        import torch
        super().__init__(int(n_shards) if n_shards else (
            torch.cuda.device_count() if torch.cuda.is_available() else 1))
        self.device: Optional[str] = None
        self._lock = threading.Lock()
        self._mesh = None
        self._data_slices: List[Tuple[Any, ...]] = []

    @property
    def mesh(self):
        """The dispatch mesh (built on first use): up to n_shards devices
        on the "data" axis (launch.mesh.make_dispatch_mesh)."""
        with self._lock:
            if self._mesh is None:
                from repro_torch.launch.mesh import make_dispatch_mesh
                self._mesh = make_dispatch_mesh(self.n_shards,
                                                self.device or "cuda")
                # row i holds the devices shard i runs on (the model
                # axis is one wide here)
                self._data_slices = [tuple(row)
                                     for row in self._mesh.devices]
            return self._mesh

    def shard_device(self, shard_idx: int):
        """The device owning shard `shard_idx` (shards cycle when the
        mesh has fewer data slices than shards)."""
        _ = self.mesh
        return self._data_slices[shard_idx % len(self._data_slices)][0]

    @contextlib.contextmanager
    def shard_context(self, shard_idx: int, backend):
        """Everything shard `shard_idx` executes runs on its own device:
        every engine of `backend` is placed there (`place_on`), and the
        device becomes the thread's current CUDA device."""
        import torch
        engines = backend_engines(backend)
        if self.device is None:
            with self._lock:
                if self.device is None and self._mesh is None:
                    dev = getattr(engines[0], "device", None) \
                        if engines else None
                    # an engineless backend places nothing: its shards
                    # run where its operators do
                    self.device = (torch.device(dev).type if dev is not None
                                   else "cuda" if torch.cuda.is_available()
                                   else "cpu")
        dev = self.shard_device(shard_idx)
        with contextlib.ExitStack() as stack:
            for eng in engines:
                stack.enter_context(eng.place_on(dev))
            if dev.type == "cuda":
                stack.enter_context(torch.cuda.device(dev))
            yield


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


def resolve_dispatcher(spec=None) -> Tuple[Any, bool]:
    """Resolve a dispatcher argument to (dispatcher, owned).

    `spec` may be a Dispatcher instance (passed through, owned=False — the
    caller manages its lifetime), a spec string (``inline``, ``threads``,
    ``threads:N``, ``sharded``, ``sharded:N``, ``mesh``, ``mesh:N`` — a
    bare ``mesh`` scatters over every local card), or None, which
    reads the ``STRETTO_DISPATCHER`` environment variable (default
    ``inline``). Owned dispatchers are closed by run_plan when the plan
    finishes.
    """
    if spec is None:
        spec = effective_spec()
    if hasattr(spec, "submit") or hasattr(spec, "map_shards"):
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
    if kind == "sharded":
        return ShardedDispatcher(
            n if n is not None else _DEFAULT_SHARDS), True
    if kind == "mesh":
        return MeshDispatcher(n), True
    raise ValueError(f"unknown dispatcher spec {spec!r} "
                     "(expected inline | threads[:N] | sharded[:N] "
                     "| mesh[:N])")
