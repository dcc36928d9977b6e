"""FlushHub: the cross-query flush-coalescing seam.

Each admitted query runs the ordinary streaming executor on its own
query thread, but with a per-query proxy dispatcher (`QueryDispatcher`)
instead of inline/threads: every FlushTask the executor submits is parked
in the hub, grouped by ``(engine, op_name, semantic op)``, and the
query thread blocks on the task's handle exactly where an InlineDispatcher
would have executed it. When every live query thread is blocked on an
unfired flush (quiescence — nobody can contribute more work to the
current round), the hub fires all pending groups: each group becomes ONE
`run_operator` call over the concatenation of its members' batches, and
the scores/values are sliced back per member.

Why decisions stay bit-identical to solo execution: per-query *schedule*
is untouched (the proxy's default max_pending=0 reproduces the inline
lockstep flush order, and completions apply in the executor's FIFO
order), and per-tuple scores are independent of batch composition: the
decode attention kernels are batch-invariant, and the engine runs a
flush's dense layers at one pinned row count whatever the flush's batch
(serving/engine.py) — merging only regroups
batches, exactly like coalescing across partitions does. Telemetry
splits exactly: integer counters (kv_bytes, donated_bytes) are
apportioned by segment size with the remainder on the leading segments
so per-query stats tile the merged totals bit for bit even though a merged load cannot be re-measured per
query; wall_s is apportioned proportionally (each query reports its
share of the merged call's wall time).

Deadlock-freedom: quiescence is detected as ``blocked >= active`` with
no fired group still executing; a query thread doing long non-flush work
(planning, decision kernels) delays firing at most `patience_s`, after
which pending groups fire without it. The same patience window bounds
how long a fired-but-slow group (a remote member on a bad link) can
hold back unrelated parked groups. A pump-thread failure fails every
parked flush instead of hanging its query threads.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.runtime.backend import Backend
from repro_torch.runtime.dispatch import FlushTask
from repro_torch.runtime.executor import _OperatorOutcome, run_operator


def split_ints(total: int, sizes: List[int]) -> List[int]:
    """Apportion an integer total over segments proportionally to their
    sizes, remainder (< len(sizes)) on the leading segments — the splits
    always sum back to the total exactly."""
    n = sum(sizes)
    if n <= 0:
        return [0] * len(sizes)
    out = [total * s // n for s in sizes]
    rem = total - sum(out)
    for i in range(rem):
        out[i] += 1
    return out


class _PendingFlush:
    """One parked FlushTask awaiting a merged fire."""

    __slots__ = ("ticket", "task", "done", "outcome", "error", "fired")

    def __init__(self, ticket, task: FlushTask):
        self.ticket = ticket
        self.task = task
        self.done = threading.Event()
        self.outcome: Optional[_OperatorOutcome] = None
        self.error: Optional[BaseException] = None
        self.fired = False


class _HubHandle:
    """The handle the executor blocks on (its `.result()` is where an
    inline flush would have run)."""

    __slots__ = ("_hub", "_flush")

    def __init__(self, hub: "FlushHub", flush: _PendingFlush):
        self._hub = hub
        self._flush = flush

    def result(self):
        return self._hub._wait(self._flush)


class QueryDispatcher:
    """Per-query proxy dispatcher: satisfies the executor's dispatcher
    surface (submit/close/max_pending) but parks every flush in the
    shared FlushHub instead of executing it. With the default
    ``slots=1`` the executor completes each flush right after submitting
    it — the exact inline lockstep schedule, which is what keeps
    per-query decisions bit-identical to solo execution."""

    name = "scheduler"
    n_shards = 1

    def __init__(self, hub: "FlushHub", ticket, slots: int = 1):
        self._hub = hub
        self._ticket = ticket
        self.max_pending = max(int(slots), 1) - 1
        self.n_workers = hub.n_workers

    def submit(self, task: FlushTask,
               runner: Callable[[FlushTask], Any]) -> _HubHandle:
        # the runner is ignored on purpose: the hub executes merged
        # groups through run_operator itself, one call per group
        return self._hub.submit(self._ticket, task)

    def close(self):
        pass


class FlushHub:
    """Shared coalescing hub over one Session backend.

    execute — where merged calls run: "inline" (the pump thread,
        serially, in fair order) or "threads[:N]" (a pool; groups for
        different engines overlap, as ThreadPoolDispatcher would).
    patience_s — max time the pump waits for stragglers once at least
        one flush is parked and nothing is executing; bounds added
        latency when a query thread is busy with non-flush work.
    fire_width — fire a group immediately once its concatenated batch
        reaches this many tuples, without waiting for quiescence
        (None: always wait — maximal merging).
    charge / priority — scheduler callbacks: ``charge(ticket, n)``
        advances the ticket's tenant virtual time when its flush fires;
        ``priority(ticket)`` orders groups at fire time (lower first).
    """

    def __init__(self, backend: Backend, *, execute: str = "inline",
                 patience_s: float = 0.05,
                 fire_width: Optional[int] = None,
                 charge: Optional[Callable[[Any, int], None]] = None,
                 priority: Optional[Callable[[Any], float]] = None):
        self._backend = backend
        self._patience = max(float(patience_s), 1e-4)
        self._fire_width = fire_width
        self._charge = charge
        self._priority = priority
        kind, _, arg = str(execute).partition(":")
        if kind not in ("inline", "threads"):
            raise ValueError(f"FlushHub execute={execute!r}: expected "
                             f"'inline' or 'threads[:N]'")
        self.n_workers = int(arg) if (kind == "threads" and arg) else \
            (4 if kind == "threads" else 1)
        if self.n_workers <= 0:
            raise ValueError(f"FlushHub execute={execute!r}: worker count "
                             f"must be positive")
        self._pool = None
        if kind == "threads":
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                max_workers=self.n_workers,
                thread_name_prefix="stretto-hub")
        self._cv = threading.Condition()
        # key -> (arrival seq, [parked flushes]); keys are hashable by
        # construction (engine tag, op name, frozen-dataclass sem op)
        self._groups: "OrderedDict[Tuple, Tuple[int, List[_PendingFlush]]]" \
            = OrderedDict()
        self._seq = 0
        self._active = 0          # registered query threads
        self._blocked = 0         # query threads inside _wait
        self._in_service = 0      # fired groups still executing
        self._closed = False
        self._last_change = time.monotonic()
        # telemetry (read via snapshot())
        self.n_calls = 0          # merged engine calls made
        self.n_flushes = 0        # member flushes folded into them
        self.n_merged_calls = 0   # calls that merged >1 query
        self.merged_width = 0     # tuples in those merged calls
        self._thread = threading.Thread(target=self._pump_loop,
                                        name="stretto-hub-pump",
                                        daemon=True)
        self._thread.start()

    # ---------------- query-thread surface ----------------

    def register(self):
        with self._cv:
            if self._closed:
                raise RuntimeError("FlushHub is closed")
            self._active += 1
            self._touch()

    def unregister(self):
        with self._cv:
            self._active -= 1
            self._touch()
            self._cv.notify_all()

    def dispatcher(self, ticket, slots: int = 1) -> QueryDispatcher:
        return QueryDispatcher(self, ticket, slots)

    def submit(self, ticket, task: FlushTask) -> _HubHandle:
        f = _PendingFlush(ticket, task)
        key = (task.engine, task.op_name, task.sem_op)
        with self._cv:
            if self._closed:
                raise RuntimeError("FlushHub is closed")
            got = self._groups.get(key)
            if got is None:
                self._groups[key] = (self._seq, [f])
                self._seq += 1
            else:
                got[1].append(f)
            self._touch()
            self._cv.notify_all()
        return _HubHandle(self, f)

    def _wait(self, f: _PendingFlush) -> _OperatorOutcome:
        with self._cv:
            self._blocked += 1
            self._touch()
            self._cv.notify_all()
        try:
            f.done.wait()
        finally:
            with self._cv:
                self._blocked -= 1
                self._touch()
        if f.error is not None:
            raise f.error
        return f.outcome

    # ---------------- firing policy ----------------

    def _touch(self):
        self._last_change = time.monotonic()

    def _width(self, members: List[_PendingFlush]) -> int:
        return sum(len(f.task.items) for f in members)

    def _fire_ready(self) -> bool:
        """Under self._cv: should the pump fire the pending groups now?"""
        if not self._groups:
            return False
        if self._closed:
            return True
        if self._fire_width is not None and any(
                self._width(m) >= self._fire_width
                for _, m in self._groups.values()):
            return True
        if self._in_service:
            # a completing group normally wakes the next round (maximal
            # merging) — but a SLOW member (a remote engine on a bad
            # link, say) must not stall unrelated parked groups past the
            # patience window: after patience_s they fire anyway (under
            # "threads" execution they overlap the straggler; decisions
            # are unchanged — merging only regroups batches)
            return (time.monotonic() - self._last_change) >= self._patience
        # quiescence: every live query thread is blocked on an unfired
        # flush — nobody can add to this round, so merging is maximal
        if self._blocked >= self._active:
            return True
        return (time.monotonic() - self._last_change) >= self._patience

    def _wait_timeout(self) -> Optional[float]:
        # the patience timer is armed whenever anything is parked — also
        # while a fired group is still executing, else a straggling
        # member leaves parked groups waiting on its completion forever
        if self._groups:
            left = self._patience - (time.monotonic() - self._last_change)
            return max(left, 1e-3)
        return None

    def _take_all(self) -> List[Tuple[Tuple, List[_PendingFlush]]]:
        """Under self._cv: claim every pending group, fair order (lowest
        member priority first, arrival order breaking ties)."""
        taken = [(key, seq, members)
                 for key, (seq, members) in self._groups.items()]
        self._groups.clear()
        if self._priority is not None:
            taken.sort(key=lambda g: (min(self._priority(f.ticket)
                                          for f in g[2]), g[1]))
        else:
            taken.sort(key=lambda g: g[1])
        for _, _, members in taken:
            for f in members:
                f.fired = True
        return [(key, members) for key, _, members in taken]

    def _pump_loop(self):
        try:
            while True:
                with self._cv:
                    while not self._fire_ready():
                        if self._closed and not self._groups:
                            return
                        self._cv.wait(self._wait_timeout())
                    groups = self._take_all()
                    self._in_service += len(groups)
                    self._touch()
                for key, members in groups:
                    if self._charge is not None:
                        for f in members:
                            self._charge(f.ticket, len(f.task.items))
                    if self._pool is not None:
                        self._pool.submit(self._run_group, key, members)
                    else:
                        self._run_group(key, members)
        except BaseException as e:       # pump must never die silently:
            self._fail_all(e)            # fail parked flushes, not hang
            raise

    def _fail_all(self, err: BaseException):
        with self._cv:
            groups = [m for _, (_, m) in self._groups.items()]
            self._groups.clear()
            self._closed = True
            self._cv.notify_all()
        for members in groups:
            for f in members:
                f.error = err
                f.done.set()

    # ---------------- merged execution ----------------

    def _run_group(self, key: Tuple, members: List[_PendingFlush]):
        engine, op_name, sem_op = key
        try:
            items: List[Any] = []
            segs: List[Tuple[_PendingFlush, int, int]] = []
            for f in members:
                lo = len(items)
                items.extend(f.task.items)
                segs.append((f, lo, len(items)))
            out = run_operator(self._backend, sem_op, op_name, items)
            n_total = len(items)
            sizes = [hi - lo for _, lo, hi in segs]
            n_queries = len({id(f.ticket) for f in members})
            kv = split_ints(out.kv_bytes, sizes)
            donated = split_ints(out.donated_bytes, sizes)
            for i, (f, lo, hi) in enumerate(segs):
                frac = sizes[i] / max(n_total, 1)
                f.outcome = _OperatorOutcome(
                    scores=out.scores[lo:hi],
                    values=None if out.values is None
                    else out.values[lo:hi],
                    wall_s=out.wall_s * frac,
                    kv_bytes=kv[i],
                    uses_llm=out.uses_llm,
                    h2d_overlap_s=out.h2d_overlap_s * frac,
                    donated_bytes=donated[i],
                    merged_width=n_total if n_queries > 1 else 0,
                    merged_queries=n_queries)
        except BaseException as e:
            for f in members:
                f.error = e
        finally:
            with self._cv:
                self._in_service -= 1
                self.n_calls += 1
                self.n_flushes += len(members)
                if len({id(f.ticket) for f in members}) > 1:
                    self.n_merged_calls += 1
                    self.merged_width += sum(len(f.task.items)
                                             for f in members)
                self._touch()
                self._cv.notify_all()
            for f in members:
                f.done.set()

    # ---------------- lifecycle / telemetry ----------------

    def snapshot(self) -> Dict[str, Any]:
        with self._cv:
            return {"n_calls": self.n_calls,
                    "n_flushes": self.n_flushes,
                    "n_merged_calls": self.n_merged_calls,
                    "merged_width": self.merged_width,
                    "saved_calls": self.n_flushes - self.n_calls}

    def close(self):
        with self._cv:
            if self._closed and not self._thread.is_alive():
                return
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=30)
        if self._pool is not None:
            self._pool.shutdown(wait=True)
        if not self._thread.is_alive():
            # the callbacks are the scheduler's bound methods: dropped, the
            # scheduler (and the session and engines it holds) is freed by
            # reference counting once its last handle goes
            self._charge = self._priority = None
