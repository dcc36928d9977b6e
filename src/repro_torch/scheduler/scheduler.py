"""QueryScheduler: concurrent admission of SemFrame queries onto one
Session's engine pool.

The scheduler owns three concerns the single-query Session API does not:

  admission — a bounded run queue in front of `max_concurrent` query
      slots. submit() returns a QueryHandle immediately; when the queue
      is full it raises SchedulerSaturated instead of buffering
      unboundedly. Admission order is weighted-fair: each tenant carries
      a virtual time that advances at tuples/weight as its flushes fire,
      and the pending query belonging to the lowest-vtime tenant is
      admitted first (arrival order breaks ties), so a heavy premium
      tenant gets its weight share without starving cold tenants.

  coalescing — every admitted query executes the ordinary streaming
      cascade on its own query thread, but flushes route through the
      shared FlushHub (see hub.py): concurrent queries' flushes for the
      same (engine, operator) fire as ONE merged engine call, and the
      per-query decisions stay bit-identical to solo execution.

  tiers — premium tenants (`TenantSpec.warms`) get their profile ladder
      pre-staged into the engines' device-resident LRU on their first
      query per corpus; cold tenants (`TenantSpec.evicts`) have their
      rungs evicted when each query finishes.

Per-query telemetry (queue wait, slot occupancy, shared-batch counters)
is attached to the QueryResult as `.sched` and rendered by EXPLAIN
ANALYZE's "scheduler:" footer; per-tenant aggregates and the hub's
merge counters come back from `stats()`.
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.scheduler.hub import FlushHub
from repro_torch.scheduler.tenants import TenantSpec, validate_tenants


class SchedulerSaturated(RuntimeError):
    """submit() refused: the run queue is at max_queue."""


@dataclass
class QueryTelemetry:
    """Per-query scheduler telemetry, attached to QueryResult.sched."""
    query_id: int
    tenant: str
    tier: str
    weight: float
    queue_wait_s: float = 0.0     # submit -> admission
    run_wall_s: float = 0.0       # admission -> completion
    slots: int = 1                # concurrent flush slots the query held
    shared_batches: int = 0       # this query's flushes that rode a
    shared_width: int = 0         # merged call, and their summed width
    n_batches: int = 0            # total flushes this query executed

    @property
    def mean_shared_width(self) -> float:
        return self.shared_width / max(self.shared_batches, 1)

    def as_dict(self) -> Dict[str, Any]:
        return {"query_id": self.query_id, "tenant": self.tenant,
                "tier": self.tier, "weight": self.weight,
                "queue_wait_s": self.queue_wait_s,
                "run_wall_s": self.run_wall_s, "slots": self.slots,
                "shared_batches": self.shared_batches,
                "shared_width": self.shared_width,
                "n_batches": self.n_batches}


@dataclass
class _TenantState:
    """Scheduler-internal per-tenant accounting."""
    spec: TenantSpec
    vtime: float = 0.0            # virtual time, tuples/weight
    n_queries: int = 0
    n_tuples: int = 0
    queue_wait_s: float = 0.0
    run_wall_s: float = 0.0
    warmed: Set[Any] = field(default_factory=set)   # corpus keys staged
    warm_batches: int = 0
    evictions: int = 0


class QueryHandle:
    """Future-like handle for one submitted query."""

    def __init__(self, scheduler: "QueryScheduler", query_id: int,
                 tenant: str, query, items: Sequence[Any], plan):
        self._scheduler = scheduler
        self.query_id = query_id
        self.tenant = tenant
        self.query = query
        self.items = items
        self.plan = plan
        self.submit_t = time.monotonic()
        self.admit_t: Optional[float] = None
        self.queue_wait_s = 0.0
        self.run_wall_s = 0.0
        self._done = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None):
        """Block until the query completes; returns its QueryResult
        (with `.sched` telemetry attached) or re-raises its error."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"query {self.query_id} (tenant {self.tenant!r}) not done "
                f"within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result

    def _finish(self, result, error: Optional[BaseException]):
        self._result = result
        self._error = error
        self._done.set()

    def __repr__(self) -> str:
        state = "done" if self.done() else (
            "running" if self.admit_t is not None else "queued")
        return (f"QueryHandle(id={self.query_id}, tenant={self.tenant!r}, "
                f"{state})")


class QueryScheduler:
    """Admit many concurrent queries onto one Session.

      max_concurrent — query slots (queries executing at once)
      max_queue      — bound on queued-but-unadmitted queries; submit()
                       raises SchedulerSaturated beyond it
      slots_per_query — concurrent unfinished flushes each query may
                       hold in the hub (1 = inline lockstep schedule,
                       the bit-identical default)
      execute        — where merged engine calls run: "inline" or
                       "threads[:N]" (see FlushHub)
      patience_s / fire_width — hub firing policy knobs
      tenants        — TenantSpec declarations (default: the session
                       config's `tenants`; an implicit "default"
                       standard tenant always exists)
      paused         — start paused (queries queue but none admit);
                       useful for deterministic overlap in tests
    """

    def __init__(self, session, *, max_concurrent: int = 4,
                 max_queue: int = 64, slots_per_query: int = 1,
                 execute: str = "inline", patience_s: float = 0.05,
                 fire_width: Optional[int] = None,
                 tenants: Optional[Sequence[TenantSpec]] = None,
                 paused: bool = False):
        if max_concurrent < 1:
            raise ValueError("max_concurrent must be >= 1")
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        self.session = session
        self.max_concurrent = int(max_concurrent)
        self.max_queue = int(max_queue)
        self.slots_per_query = max(int(slots_per_query), 1)
        declared = tenants if tenants is not None else \
            (session.config.tenants or ())
        specs = list(validate_tenants(declared))
        if not any(t.name == "default" for t in specs):
            specs.append(TenantSpec("default"))
        self._lock = threading.Lock()
        self._tenants: Dict[str, _TenantState] = {
            t.name: _TenantState(t) for t in specs}
        self._queue: List[QueryHandle] = []
        self._running: Set[QueryHandle] = set()
        self._seq = itertools.count()
        self._paused = bool(paused)
        self._closed = False
        self._idle = threading.Condition(self._lock)
        self._hub = FlushHub(session.backend, execute=execute,
                             patience_s=patience_s, fire_width=fire_width,
                             charge=self._charge, priority=self._priority)

    # ---------------- submission ----------------

    def submit(self, frame=None, *, query=None, items=None,
               tenant: str = "default", plan=None) -> QueryHandle:
        """Enqueue one query. Pass a SemFrame, or (query=, items=)
        explicitly; `plan` short-circuits planning with a prebuilt
        PhysicalPlan. Returns a QueryHandle immediately."""
        if frame is not None:
            if getattr(frame, "_session", None) is not self.session:
                raise ValueError("frame belongs to a different Session "
                                 "than this scheduler")
            query = frame.to_query()
            items = frame.items
        if query is None or items is None:
            raise ValueError("submit() needs a SemFrame or query= and "
                             "items=")
        with self._lock:
            if self._closed:
                raise RuntimeError("QueryScheduler is closed")
            st = self._tenants.get(tenant)
            if st is None:
                raise ValueError(
                    f"unknown tenant {tenant!r}: declared tenants are "
                    f"{sorted(self._tenants)}")
            can_start = (not self._paused
                         and len(self._running) < self.max_concurrent)
            if not can_start and len(self._queue) >= self.max_queue:
                raise SchedulerSaturated(
                    f"run queue full ({self.max_queue} queries waiting); "
                    f"tenant {tenant!r} must back off")
            h = QueryHandle(self, next(self._seq), tenant, query, items,
                            plan)
            self._queue.append(h)
        self._maybe_admit()
        return h

    def _maybe_admit(self):
        while True:
            with self._lock:
                if (self._paused or self._closed or not self._queue
                        or len(self._running) >= self.max_concurrent):
                    return
                h = min(self._queue,
                        key=lambda q: (self._tenants[q.tenant].vtime,
                                       q.query_id))
                self._queue.remove(h)
                self._running.add(h)
                h.admit_t = time.monotonic()
                h.queue_wait_s = h.admit_t - h.submit_t
            # register with the hub HERE, before the query thread even
            # starts: the hub's quiescence count then covers every
            # admitted query, so an early query's first flush waits for
            # its co-admitted peers instead of firing solo (outside the
            # scheduler lock — the hub's cv may call back into
            # _priority, which takes it)
            self._hub.register()
            t = threading.Thread(target=self._drive, args=(h,),
                                 name=f"stretto-query-{h.query_id}",
                                 daemon=True)
            t.start()

    # ---------------- hub callbacks (fairness) ----------------

    # Lock ordering: the hub calls these while holding nothing (charge)
    # or its own cv (priority); this lock never calls back into the hub,
    # so hub-cv -> scheduler-lock is the only ordering and cannot cycle.

    def _charge(self, ticket: QueryHandle, n_tuples: int):
        with self._lock:
            st = self._tenants[ticket.tenant]
            st.vtime += n_tuples / st.spec.fair_weight
            st.n_tuples += n_tuples

    def _priority(self, ticket: QueryHandle) -> float:
        with self._lock:
            return self._tenants[ticket.tenant].vtime

    # ---------------- execution ----------------

    def _drive(self, h: QueryHandle):
        # NOTE: the matching hub.register() already ran in _maybe_admit
        from repro_torch.api.result import QueryResult
        try:
            spec = self._tenants[h.tenant].spec
            plan = h.plan if h.plan is not None \
                else self.session.plan(h.query, h.items)
            if spec.warms:
                self._warm(h, plan)
            t0 = time.monotonic()
            try:
                disp = self._hub.dispatcher(h, self.slots_per_query)
                gen = self.session.iter_run(plan, h.query, h.items,
                                            dispatcher=disp)
                while True:
                    try:
                        next(gen)
                    except StopIteration as stop:
                        raw = stop.value
                        break
            finally:
                h.run_wall_s = time.monotonic() - t0
            if spec.evicts:
                self._evict(plan, h)
            qr = QueryResult(self.session, h.query, h.items, raw)
            qr.sched = self._telemetry(h, raw)
            h._finish(qr, None)
        except BaseException as e:
            h._finish(None, e)
        finally:
            self._hub.unregister()
            with self._lock:
                self._running.discard(h)
                st = self._tenants[h.tenant]
                st.n_queries += 1
                st.queue_wait_s += h.queue_wait_s
                st.run_wall_s += h.run_wall_s
                self._idle.notify_all()
            self._maybe_admit()

    def _telemetry(self, h: QueryHandle, raw) -> QueryTelemetry:
        spec = self._tenants[h.tenant].spec
        return QueryTelemetry(
            query_id=h.query_id, tenant=h.tenant, tier=spec.tier,
            weight=spec.fair_weight, queue_wait_s=h.queue_wait_s,
            run_wall_s=h.run_wall_s, slots=self.slots_per_query,
            shared_batches=sum(getattr(sg, "shared_batches", 0)
                               for sg in raw.stage_stats),
            shared_width=sum(getattr(sg, "shared_width", 0)
                             for sg in raw.stage_stats),
            n_batches=sum(sg.n_batches for sg in raw.stage_stats))

    # ---------------- tier cache policy ----------------

    def _stage_engines(self, plan, query) -> List[Tuple[Any, str, float,
                                                        bool]]:
        """(engine, model_name, ratio, quant) per distinct KV-cache rung
        the plan touches — derived by resolving each stage to its
        physical operator and reading the serving attributes off it
        (pooled stages unwrap their EngineTaggedOperator)."""
        sem_ops = query.semantic_ops
        seen: Set[Tuple[int, str, float, bool]] = set()
        out: List[Tuple[Any, str, float, bool]] = []
        for st in plan.stages:
            try:
                phys = self.session.backend.resolve(
                    sem_ops[st.logical_idx], st.op_name)
            except Exception:
                continue
            inner = getattr(phys, "inner", phys)
            eng = getattr(inner, "engine", None)
            model = getattr(inner, "model_name", None)
            if eng is None or model is None or not hasattr(eng, "warm"):
                continue
            ratio = float(getattr(inner, "ratio", 1.0))
            quant = bool(getattr(inner, "quant", False))
            key = (id(eng), model, ratio, quant)
            if key in seen:
                continue
            seen.add(key)
            out.append((eng, model, ratio, quant))
        return out

    def _warm(self, h: QueryHandle, plan):
        """Premium pre-staging: push the plan's profile rungs into the
        engines' device LRU, once per (tenant, corpus)."""
        st = self._tenants[h.tenant]
        ckey = self.session.corpus_key(h.items)
        with self._lock:
            if ckey in st.warmed:
                return
            st.warmed.add(ckey)
        ids = [getattr(it, "item_id", None) for it in h.items]
        if any(i is None for i in ids):
            return
        batches = 0
        for eng, model, ratio, quant in self._stage_engines(plan, h.query):
            try:
                batches += eng.warm(model, ratio, ids, quant=quant)
            except Exception:
                continue      # warm is best-effort; the query still runs
        with self._lock:
            st.warm_batches += batches

    def _evict(self, plan, h: QueryHandle):
        """Cold-tier cleanup: drop this query's rungs from the device
        LRU so a rarely-seen workload cannot squat on HBM."""
        st = self._tenants[h.tenant]
        n = 0
        for eng, model, ratio, quant in self._stage_engines(plan, h.query):
            try:
                n += eng.evict(model, ratio, quant=quant)
            except Exception:
                continue
        with self._lock:
            st.evictions += n

    # ---------------- control / telemetry / lifecycle ----------------

    def pause(self):
        """Stop admitting queries (running ones finish; submits queue)."""
        with self._lock:
            self._paused = True

    def resume(self):
        with self._lock:
            self._paused = False
        self._maybe_admit()

    @property
    def n_running(self) -> int:
        with self._lock:
            return len(self._running)

    @property
    def n_queued(self) -> int:
        with self._lock:
            return len(self._queue)

    def stats(self) -> Dict[str, Any]:
        """Per-tenant aggregates plus the hub's merge counters."""
        with self._lock:
            tenants = {
                name: {"tier": st.spec.tier,
                       "weight": st.spec.fair_weight,
                       "vtime": st.vtime,
                       "n_queries": st.n_queries,
                       "n_tuples": st.n_tuples,
                       "queue_wait_s": st.queue_wait_s,
                       "run_wall_s": st.run_wall_s,
                       "warm_batches": st.warm_batches,
                       "evictions": st.evictions}
                for name, st in self._tenants.items()}
            queued, running = len(self._queue), len(self._running)
        out = {"tenants": tenants, "queued": queued, "running": running}
        out.update(self._hub.snapshot())
        return out

    def drain(self, timeout: Optional[float] = None):
        """Block until every submitted query has completed."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._idle:
            while self._queue or self._running:
                left = None if deadline is None \
                    else deadline - time.monotonic()
                if left is not None and left <= 0:
                    raise TimeoutError(
                        f"scheduler not drained: {len(self._queue)} "
                        f"queued, {len(self._running)} running")
                self._idle.wait(left)

    def close(self, timeout: Optional[float] = None):
        """Drain outstanding queries, then shut the hub down.
        Idempotent; submits after close raise RuntimeError."""
        with self._lock:
            if self._closed:
                self._hub.close()
                return
        self.drain(timeout)
        with self._lock:
            self._closed = True
        self._hub.close()

    def __enter__(self) -> "QueryScheduler":
        return self

    def __exit__(self, *exc):
        self.close()
        return False
