"""RemoteEngineMember: a PoolBackend member whose operators go over the
wire (the port of `repro.remote.client`).

The member satisfies exactly the surface PoolBackend expects of a local
member backend — `candidates` (from the worker's catalog, cost numbers
included, so pool ordering matches the all-local pool bit for bit),
`score_filter` / `run_map` (one wire call per flush), thread-scoped
`kv_bytes_loaded` / `transfer_stats` counters (fed from the worker's
per-call stat deltas, so per-engine StageStats tile exactly) — plus
`warm` / `evict` via a `_RemoteEngineHandle` so scheduler keep-warm
tenants reach across the network too.

Failure handling, layered:

  timeout   — every call carries a deadline (`timeout_s`; corpus sync
              gets `sync_timeout_s`, profile builds are slow).
  retries   — transport-level failures (refused / reset / timeout /
              protocol error) on idempotent calls retry with exponential
              backoff. Scoring is idempotent: the worker holds no
              per-call state.
  breaker   — after `breaker_threshold` consecutive transport failures
              the circuit opens and calls fail fast (no connect attempt)
              until `breaker_reset_s` passes, then one probe call
              half-opens it.
  policy    — `on_unavailable="fallback"` re-routes a failed flush to
              the pool's gold/local member mid-run (gold scores are
              always semantically safe) and records it in telemetry;
              `"fail"` raises RemoteEngineError. Application-level
              errors from the worker (unknown operator, no synced
              corpus) are never retried or masked by fallback — a
              misconfiguration must surface, not degrade.
"""
from __future__ import annotations

import socket
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.logical import SemFilter, SemJoin, SemMap
from repro_torch.remote.protocol import (HAVE_MSGPACK, PROTOCOL_VERSION,
                                         ProtocolError, corpus_hash,
                                         items_to_wire, recv_msg, send_msg,
                                         sem_to_wire)
from repro_torch.runtime.backend import RegistryBackend

_TRANSPORT_ERRORS = (OSError, ProtocolError, socket.timeout)


class RemoteEngineError(RuntimeError):
    """A remote engine call failed. `transport` distinguishes network
    unavailability (eligible for fallback) from an application error the
    worker reported (never masked)."""

    def __init__(self, message: str, *, engine: str = "", verb: str = "",
                 transport: bool = False):
        super().__init__(message)
        self.engine = engine
        self.verb = verb
        self.transport = transport


class _RemoteOperator:
    """One catalog entry as a physical operator: runs through the owning
    member's wire calls. Carries the serving attributes (`model_name`,
    `ratio`, `quant`, `.engine`) the scheduler's keep-warm path reads."""

    def __init__(self, member: "RemoteEngineMember", desc: Dict[str, Any]):
        self._member = member
        self.name = desc["name"]
        self.is_gold = bool(desc["is_gold"])
        self.uses_llm = bool(desc["uses_llm"])
        self._cost = float(desc["cost"])
        self._max_batch = desc.get("max_batch")
        self.model_name = desc.get("model")
        self.engine = member.engine_handle
        if desc.get("ratio") is not None:
            self.ratio = float(desc["ratio"])
        self.quant = bool(desc.get("quant", False))

    def run_filter(self, items: Sequence[Any], op) -> np.ndarray:
        return self._member._wire_filter(op, self.name, items)

    def run_map(self, items: Sequence[Any], op):
        return self._member._wire_map(op, self.name, items)

    def cost_model(self) -> float:
        return self._cost

    def max_batch(self) -> Optional[int]:
        return self._max_batch


class _RemoteEngineHandle:
    """The `.engine` surface remote operators expose to the scheduler's
    keep-warm tenant path: warm/evict forwarded over the wire,
    best-effort (a dead worker warms nothing; the query still runs)."""

    def __init__(self, member: "RemoteEngineMember"):
        self._member = member

    def warm(self, model_name: str, ratio: float,
             item_ids: Sequence[int], query_len: int = 1,
             quant: bool = False) -> int:
        resp = self._member._call(
            {"verb": "warm", "model": model_name, "ratio": float(ratio),
             "item_ids": [int(i) for i in item_ids],
             "query_len": int(query_len), "quant": bool(quant)})
        return int(resp.get("batches", 0))

    def evict(self, model_name: Optional[str] = None,
              ratio: Optional[float] = None, quant: bool = False) -> int:
        resp = self._member._call(
            {"verb": "evict", "model": model_name,
             "ratio": float(ratio) if ratio is not None else None,
             "quant": bool(quant)})
        return int(resp.get("dropped", 0))


class RemoteEngineMember(RegistryBackend):
    """A pool member backend served by a RemoteWorker at `address`."""

    def __init__(self, engine_name: str, address: str, *,
                 timeout_s: float = 30.0, sync_timeout_s: float = 600.0,
                 retries: int = 2, backoff_s: float = 0.05,
                 breaker_threshold: int = 3, breaker_reset_s: float = 5.0,
                 on_unavailable: str = "fallback"):
        if on_unavailable not in ("fallback", "fail"):
            raise ValueError(
                f"on_unavailable must be 'fallback' or 'fail', "
                f"got {on_unavailable!r}")
        host, _, port = address.partition(":")
        if not host or not port.isdigit():
            raise ValueError(
                f"remote engine {engine_name!r}: address must be "
                f"'host:port', got {address!r}")
        self.engine_name = engine_name
        self.name = f"remote:{engine_name}"
        self.address = (host, int(port))
        self.timeout_s = float(timeout_s)
        self.sync_timeout_s = float(sync_timeout_s)
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.on_unavailable = on_unavailable
        self.engine_handle = _RemoteEngineHandle(self)
        self._fallback = None          # a local Backend (the gold member)
        self._synced_hash: Optional[str] = None

        self._sock_tl = threading.local()
        # per-flush telemetry, thread-scoped like a local engine's store
        # counters (run_operator deltas them before/after each flush)
        self._flush_tl = threading.local()

        # circuit breaker + global counters
        self._breaker_threshold = int(breaker_threshold)
        self._breaker_reset_s = float(breaker_reset_s)
        self._consecutive_failures = 0
        self._breaker_open_until = 0.0
        self._stats_lock = threading.Lock()
        self._calls = 0
        self._retries = 0
        self._fallbacks = 0
        self._errors = 0
        self._bytes_sent = 0
        self._bytes_recv = 0
        self._rtt_count = 0
        self._rtt_total_s = 0.0
        self._rtt_recent: "deque[float]" = deque(maxlen=8192)
        super().__init__(self._remote_registry)

    # ---------------- catalog -> candidates ----------------

    def _remote_registry(self, op) -> List[_RemoteOperator]:
        if isinstance(op, SemJoin):
            kind = "join"
        elif isinstance(op, SemMap):
            kind = "map"
        elif isinstance(op, SemFilter):
            kind = "filter"
        else:
            raise RemoteEngineError(
                f"remote engine {self.engine_name!r} cannot serve "
                f"{type(op).__name__}", engine=self.engine_name,
                verb="catalog")
        resp = self._call({"verb": "catalog", "kind": kind})
        return [_RemoteOperator(self, d) for d in resp["ops"]]

    # ---------------- transport ----------------

    def _socket(self):
        tl = self._sock_tl
        sock = getattr(tl, "sock", None)
        if sock is not None:
            return sock, tl.encoding
        sock = socket.create_connection(self.address,
                                        timeout=self.timeout_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            send_msg(sock, {"verb": "hello", "version": PROTOCOL_VERSION,
                            "msgpack": HAVE_MSGPACK})
            resp, _, _ = recv_msg(sock)
        except _TRANSPORT_ERRORS:
            sock.close()
            raise
        if resp is None:
            sock.close()
            raise ProtocolError("worker closed the connection during "
                                "the hello handshake")
        if not resp.get("ok"):
            sock.close()
            raise RemoteEngineError(
                f"remote engine {self.engine_name!r} rejected the "
                f"handshake: {resp.get('error')}",
                engine=self.engine_name, verb="hello")
        tl.sock = sock
        tl.encoding = "msgpack" if (HAVE_MSGPACK and resp.get("msgpack")) \
            else "json"
        return sock, tl.encoding

    def _drop_socket(self):
        tl = self._sock_tl
        sock = getattr(tl, "sock", None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
            tl.sock = None

    def _breaker_check(self):
        now = time.monotonic()
        if self._consecutive_failures >= self._breaker_threshold \
                and now < self._breaker_open_until:
            raise RemoteEngineError(
                f"remote engine {self.engine_name!r}: circuit open after "
                f"{self._consecutive_failures} consecutive failures "
                f"(retries in "
                f"{self._breaker_open_until - now:.1f}s)",
                engine=self.engine_name, verb="breaker", transport=True)

    def _breaker_record(self, ok: bool):
        with self._stats_lock:
            if ok:
                self._consecutive_failures = 0
            else:
                self._consecutive_failures += 1
                if self._consecutive_failures >= self._breaker_threshold:
                    self._breaker_open_until = \
                        time.monotonic() + self._breaker_reset_s

    def _call(self, msg: Dict[str, Any], *, timeout: Optional[float] = None,
              idempotent: bool = True) -> Dict[str, Any]:
        """One request/response round trip with retries + breaker.
        Transport failures raise RemoteEngineError(transport=True);
        worker-reported errors raise transport=False (never retried)."""
        self._breaker_check()
        attempts = (self.retries + 1) if idempotent else 1
        last: Optional[Exception] = None
        for attempt in range(attempts):
            if attempt:
                with self._stats_lock:
                    self._retries += 1
                time.sleep(self.backoff_s * (2 ** (attempt - 1)))
            try:
                sock, encoding = self._socket()
                if timeout is not None:
                    sock.settimeout(timeout)
                t0 = time.perf_counter()
                try:
                    sent = send_msg(sock, msg, encoding=encoding)
                    resp, _, recvd = recv_msg(sock)
                finally:
                    if timeout is not None:
                        sock.settimeout(self.timeout_s)
                if resp is None:
                    raise ProtocolError("worker closed the connection "
                                        "mid-call")
                wall = time.perf_counter() - t0
            except _TRANSPORT_ERRORS as exc:
                self._drop_socket()
                self._breaker_record(ok=False)
                last = exc
                continue
            self._breaker_record(ok=True)
            server_wall = float(
                (resp.get("stats") or {}).get("server_wall_s", 0.0))
            with self._stats_lock:
                self._calls += 1
                self._bytes_sent += sent
                self._bytes_recv += recvd
                self._rtt_count += 1
                rtt = max(wall - server_wall, 0.0)
                self._rtt_total_s += rtt
                self._rtt_recent.append(rtt)
            if not resp.get("ok"):
                with self._stats_lock:
                    self._errors += 1
                raise RemoteEngineError(
                    f"remote engine {self.engine_name!r} "
                    f"{msg.get('verb')} failed: "
                    f"[{resp.get('etype')}] {resp.get('error')}",
                    engine=self.engine_name, verb=str(msg.get("verb")),
                    transport=False)
            return resp
        with self._stats_lock:
            self._errors += 1
        raise RemoteEngineError(
            f"remote engine {self.engine_name!r} unreachable at "
            f"{self.address[0]}:{self.address[1]} "
            f"({attempts} attempt(s)): {last}",
            engine=self.engine_name, verb=str(msg.get("verb")),
            transport=True)

    def close(self):
        self._drop_socket()

    # ---------------- corpus sync ----------------

    def sync(self, items: Sequence[Any]) -> str:
        """Ship the corpus and (lazily, worker-side) build profiles.
        Idempotent by corpus hash — re-syncing the same corpus is one
        cheap round trip."""
        wire = items_to_wire(items)
        want = corpus_hash((i, t) for i, t in wire)
        resp = self._call({"verb": "sync", "items": wire, "hash": want},
                          timeout=self.sync_timeout_s)
        self._synced_hash = resp["hash"]
        return self._synced_hash

    # ---------------- fallback wiring ----------------

    def set_fallback(self, backend) -> None:
        """The local backend (the pool's gold member) that serves a flush
        when this member is unreachable under on_unavailable='fallback'."""
        self._fallback = backend

    def _fallback_scores(self, op, items, exc: RemoteEngineError,
                         mapper: bool):
        if self.on_unavailable != "fallback" or self._fallback is None:
            raise exc
        gold = self._fallback.candidates(op)[-1]
        with self._stats_lock:
            self._fallbacks += 1
        if mapper:
            vals, conf = gold.run_map(items, op)
            return np.asarray(vals), np.asarray(conf, np.float32)
        return np.asarray(gold.run_filter(items, op), np.float32)

    # ---------------- scoring (the member surface) ----------------

    def _batch_msg(self, verb: str, op, op_name: str,
                   items: Sequence[Any]) -> Dict[str, Any]:
        msg: Dict[str, Any] = {"verb": verb, "sem": sem_to_wire(op),
                               "op_name": op_name}
        if items and hasattr(items[0], "left"):     # join pairs
            msg["pair_ids"] = [[int(p.left.item_id), int(p.right.item_id)]
                               for p in items]
        else:
            msg["item_ids"] = [int(it.item_id) for it in items]
        return msg

    def _apply_stats(self, stats: Dict[str, Any]):
        tl = self._flush_tl
        tl.kv_bytes = getattr(tl, "kv_bytes", 0) \
            + int(stats.get("kv_bytes", 0))
        tl.h2d_s = getattr(tl, "h2d_s", 0.0) \
            + float(stats.get("h2d_overlap_s", 0.0))
        tl.donated = getattr(tl, "donated", 0) \
            + int(stats.get("donated_bytes", 0))

    def _wire_filter(self, op, op_name: str,
                     items: Sequence[Any]) -> np.ndarray:
        try:
            resp = self._call(self._batch_msg("score_filter", op, op_name,
                                              items))
        except RemoteEngineError as exc:
            if not exc.transport:
                raise
            return self._fallback_scores(op, items, exc, mapper=False)
        self._apply_stats(resp["stats"])
        return np.asarray(resp["scores"], np.float32)

    def _wire_map(self, op, op_name: str, items: Sequence[Any]):
        try:
            resp = self._call(self._batch_msg("run_map", op, op_name,
                                              items))
        except RemoteEngineError as exc:
            if not exc.transport:
                raise
            return self._fallback_scores(op, items, exc, mapper=True)
        self._apply_stats(resp["stats"])
        return (np.asarray(resp["values"], np.int64),
                np.asarray(resp["confs"], np.float32))

    # score_filter / run_map come from RegistryBackend: resolve the
    # catalog operator by name, which routes back through _wire_*.

    # ---------------- telemetry ----------------

    def kv_bytes_loaded(self) -> int:
        # thread-scoped, like a local engine's store counter: the
        # worker's per-call kv delta is applied on the calling thread,
        # so run_operator's before/after deltas stay exact
        return getattr(self._flush_tl, "kv_bytes", 0)

    def transfer_stats(self) -> Tuple[float, int]:
        tl = self._flush_tl
        return (getattr(tl, "h2d_s", 0.0), getattr(tl, "donated", 0))

    def snapshot(self) -> Dict[str, Any]:
        """Cumulative wire counters (monotonic; diff two snapshots for a
        per-run delta — see remote_run_info)."""
        with self._stats_lock:
            return {
                "engine": self.engine_name,
                "calls": self._calls,
                "retries": self._retries,
                "fallbacks": self._fallbacks,
                "errors": self._errors,
                "bytes_sent": self._bytes_sent,
                "bytes_recv": self._bytes_recv,
                "rtt_count": self._rtt_count,
                "rtt_total_s": self._rtt_total_s,
                "rtt_recent": list(self._rtt_recent),
            }

    def health(self) -> Dict[str, Any]:
        return self._call({"verb": "health"})

    def worker_stats(self) -> Dict[str, Any]:
        return self._call({"verb": "stats"})


# ---------------- module helpers (Session/EXPLAIN integration) --------

def remote_members(backend) -> List[RemoteEngineMember]:
    """Every RemoteEngineMember reachable from `backend` (itself, or a
    pool's members, recursively)."""
    out: List[RemoteEngineMember] = []
    seen = set()

    def walk(b):
        if id(b) in seen:
            return
        seen.add(id(b))
        if isinstance(b, RemoteEngineMember):
            out.append(b)
            return
        members = getattr(b, "members", None)
        if isinstance(members, dict):
            for m in members.values():
                walk(m)

    walk(backend)
    return out


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(int(round(q * (len(sorted_vals) - 1))),
              len(sorted_vals) - 1)
    return sorted_vals[idx]


def remote_run_info(before: Dict[str, Dict[str, Any]],
                    after: Dict[str, Dict[str, Any]]
                    ) -> Optional[Dict[str, Any]]:
    """Per-run remote telemetry from two snapshot maps (engine name ->
    RemoteEngineMember.snapshot()). None when no wire activity happened
    during the run."""
    engines: Dict[str, Dict[str, Any]] = {}
    rtts: List[float] = []
    totals = {"calls": 0, "retries": 0, "fallbacks": 0, "errors": 0,
              "bytes": 0}
    for name, a in after.items():
        b = before.get(name, {})
        calls = a["calls"] - b.get("calls", 0)
        retries = a["retries"] - b.get("retries", 0)
        fallbacks = a["fallbacks"] - b.get("fallbacks", 0)
        errors = a["errors"] - b.get("errors", 0)
        nbytes = (a["bytes_sent"] + a["bytes_recv"]
                  - b.get("bytes_sent", 0) - b.get("bytes_recv", 0))
        if not (calls or retries or fallbacks or errors):
            continue
        n_new = a["rtt_count"] - b.get("rtt_count", 0)
        new_rtts = a["rtt_recent"][-n_new:] if n_new > 0 else []
        rtts.extend(new_rtts)
        engines[name] = {"calls": calls, "retries": retries,
                         "fallbacks": fallbacks, "errors": errors,
                         "wire_kb": round(nbytes / 1024.0, 2)}
        totals["calls"] += calls
        totals["retries"] += retries
        totals["fallbacks"] += fallbacks
        totals["errors"] += errors
        totals["bytes"] += nbytes
    if not engines:
        return None
    rtts.sort()
    return {
        "calls": totals["calls"],
        "retries": totals["retries"],
        "fallbacks": totals["fallbacks"],
        "errors": totals["errors"],
        "wire_kb": round(totals["bytes"] / 1024.0, 2),
        "rtt_ms_p50": round(1e3 * _percentile(rtts, 0.50), 3),
        "rtt_ms_p95": round(1e3 * _percentile(rtts, 0.95), 3),
        "engines": engines,
    }
