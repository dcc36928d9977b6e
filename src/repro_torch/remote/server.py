"""Remote worker: one local ServingEngine behind the wire protocol (the
port of `repro.remote.server`).

A `RemoteWorker` owns exactly what a session-built engine slot owns — a
CacheStore, a ServingEngine on its device, planted models, and a
KVCacheBackend over them — but serves it to `RemoteEngineMember` clients
over a threaded socket server instead of in-process calls.

Profiles are built lazily on the first corpus `sync`: the client ships
(item_id, tokens) pairs plus a corpus hash, the worker builds its ladder
(exactly the rungs a local engine with the same spec would build, in the
same item order, so calibration and therefore scores match the local
engine bit for bit) and echoes the hash back. A re-sync with the same
hash is a no-op, so reconnects and multiple clients are cheap.

Scoring requests execute under one lock so the telemetry deltas
(thread-local kv-bytes / transfer counters on the handler thread, the
engine's attn-dispatch counter) attribute to exactly one request — the
client folds them into its own per-flush StageStats, keeping per-engine
telemetry exact across the network boundary. On the card a handler
thread launches its flushes as a dispatcher thread of a local Session
does: on its own current stream (the default one), with every tensor
placed on the engine's device. Scores and confidences are cast to
float32 before they are listed for the wire, so JSON carries them
exactly.
"""
from __future__ import annotations

import socketserver
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.remote.protocol import (HAVE_MSGPACK, PROTOCOL_VERSION,
                                         ProtocolError, corpus_hash,
                                         recv_msg, send_msg, sem_from_wire)


class _WirePair:
    """A join pair reconstructed from synced corpus items by id — the
    only surface pair operators touch (.left / .right with item_id and
    tokens)."""

    __slots__ = ("left", "right")

    def __init__(self, left, right):
        self.left = left
        self.right = right


class RemoteWorker:
    """One serving engine + backend, exposed verb by verb.

    The constructor mirrors the EngineSpec fields that define an engine's
    identity (model zoo, ladder, limits, seed, device) — a worker launched
    with the same values as a local spec serves bit-identical scores.
    `kernels` is one of kernels.ops.VALID_BACKENDS (None: the
    STRETTO_TORCH_KERNELS env var at flush time); `device` is where the
    engine runs ("cuda" unless the caller says otherwise).
    """

    def __init__(self, name: str = "remote", *,
                 models: Sequence[str] = ("sm", "lg"),
                 sm_ratios: Sequence[float] = (0.8, 0.5, 0.0),
                 lg_ratios: Sequence[float] = (0.8, 0.5, 0.3),
                 include_cheap: bool = True,
                 sm_int8: Sequence[float] = (),
                 lg_int8: Sequence[float] = (),
                 prefill_batch: int = 16,
                 memory_budget_bytes: float = 2e9,
                 max_batch: int = 128,
                 model_seed: int = 1,
                 cache_dir: Optional[str] = None,
                 kernels: Optional[str] = None,
                 verbose: bool = False,
                 device="cuda"):
        from repro_torch.cache.store import CacheStore
        from repro_torch.kernels.ops import VALID_BACKENDS
        from repro_torch.runtime.backend import KVCacheBackend
        from repro_torch.serving.engine import ServingEngine

        if kernels is not None and kernels not in VALID_BACKENDS:
            raise ValueError(f"worker {name!r}: kernels={kernels!r} is not "
                             f"one of {VALID_BACKENDS}")
        self.name = name
        self.models = tuple(models)
        self.sm_ratios = tuple(sm_ratios)
        self.lg_ratios = tuple(lg_ratios)
        self.include_cheap = bool(include_cheap)
        self.sm_int8 = tuple(sm_int8)
        self.lg_int8 = tuple(lg_int8)
        self.prefill_batch = int(prefill_batch)
        self.model_seed = int(model_seed)
        self.verbose = bool(verbose)
        self._t0 = time.monotonic()

        if cache_dir is None:
            cache_dir = tempfile.mkdtemp(prefix=f"stretto_remote_{name}_")
        self.engine = ServingEngine(
            CacheStore(cache_dir), memory_budget_bytes=memory_budget_bytes,
            max_batch=max_batch, kernels=kernels, device=device)
        self.register_models()
        self.backend = KVCacheBackend(
            self.engine, sm=self.models[0], lg=self.models[-1],
            sm_ratios=self.sm_ratios, lg_ratios=self.lg_ratios,
            sm_int8=self.sm_int8, lg_int8=self.lg_int8,
            include_cheap=self.include_cheap)

        # synced corpus state (guarded by _sync_lock)
        self._items: Dict[int, Any] = {}
        self._corpus_hash: Optional[str] = None
        self._sync_lock = threading.Lock()
        # scoring runs one request at a time so the engine's counters
        # delta cleanly per request
        self._exec_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self.n_requests = 0
        self.n_scores = 0
        self.n_syncs = 0

    def register_models(self) -> None:
        """Register every model of `models` with the engine: the planted
        zoo's weights from `model_seed`, on the engine's device."""
        from repro_torch.data.synthetic import (make_planted_params,
                                                planted_config)
        for m in self.models:
            mcfg = planted_config(m)
            self.engine.register_model(m, mcfg, make_planted_params(
                mcfg, seed=self.model_seed, device=self.engine.device))

    # ---------------- verb handlers ----------------

    def handle(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        verb = msg.get("verb")
        with self._stats_lock:
            self.n_requests += 1
        fn = getattr(self, f"_do_{verb}", None)
        if fn is None:
            return {"ok": False, "etype": "ProtocolError",
                    "error": f"unknown verb {verb!r}"}
        try:
            return fn(msg)
        except Exception as exc:                  # -> typed client error
            return {"ok": False, "etype": type(exc).__name__,
                    "error": str(exc)}

    def _do_hello(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        peer = int(msg.get("version", -1))
        if peer != PROTOCOL_VERSION:
            return {"ok": False, "etype": "ProtocolError",
                    "error": f"protocol version mismatch: client speaks "
                             f"{peer}, worker speaks {PROTOCOL_VERSION}"}
        return {"ok": True, "version": PROTOCOL_VERSION, "name": self.name,
                "models": list(self.models),
                "msgpack": HAVE_MSGPACK and bool(msg.get("msgpack")),
                "corpus_hash": self._corpus_hash}

    def _ladder(self) -> List[float]:
        return sorted({0.0, *self.sm_ratios, *self.lg_ratios})

    def _do_sync(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        from repro_torch.data.synthetic import Item
        pairs = msg["items"]
        want = msg.get("hash")
        with self._sync_lock:
            if want is not None and want == self._corpus_hash:
                return {"ok": True, "hash": self._corpus_hash,
                        "built": False, "n_items": len(self._items)}
            items = [Item(int(i), [int(t) for t in toks], {}, {}, {})
                     for i, toks in pairs]
            got = corpus_hash((it.item_id, it.tokens) for it in items)
            if want is not None and got != want:
                return {"ok": False, "etype": "ProtocolError",
                        "error": f"corpus hash mismatch after decode: "
                                 f"client {want}, worker {got}"}
            ladder = self._ladder()
            for m in self.models:
                quant: set = set()
                if m == self.models[0]:
                    quant |= set(self.sm_int8)
                if m == self.models[-1]:
                    quant |= set(self.lg_int8)
                self.engine.build_profiles(
                    m, items, ratios=ladder,
                    prefill_batch=self.prefill_batch,
                    quant_ratios=sorted(quant))
            self._items = {it.item_id: it for it in items}
            self._corpus_hash = got
            with self._stats_lock:
                self.n_syncs += 1
            if self.verbose:
                print(f"[{self.name}] synced {len(items)} items, "
                      f"ladder {ladder}", flush=True)
            return {"ok": True, "hash": got, "built": True,
                    "n_items": len(items)}

    def _do_catalog(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        from repro_torch.core.logical import SemFilter, SemJoin, SemMap
        kind = msg.get("kind")
        rep = {"filter": SemFilter("", 0), "map": SemMap("", 0),
               "join": SemJoin("", 0)}.get(kind)
        if rep is None:
            raise ProtocolError(f"unknown catalog kind {kind!r}")
        descs = []
        for phys in self.backend.candidates(rep):
            mb = getattr(phys, "max_batch", None)
            descs.append({
                "name": phys.name,
                "is_gold": bool(getattr(phys, "is_gold", False)),
                "uses_llm": bool(getattr(phys, "uses_llm", True)),
                "cost": float(phys.cost_model()),
                "max_batch": mb() if callable(mb) else None,
                "model": getattr(phys, "model_name", None),
                "ratio": getattr(phys, "ratio", None),
                "quant": bool(getattr(phys, "quant", False)),
            })
        return {"ok": True, "ops": descs}

    def _materialize(self, msg: Dict[str, Any]) -> List[Any]:
        """The request's item batch from the synced corpus (single ids or
        [left, right] pair ids)."""
        if not self._items:
            raise RuntimeError(
                f"worker {self.name!r} has no synced corpus — "
                f"send `sync` before scoring")
        if msg.get("pair_ids") is not None:
            return [_WirePair(self._items[int(li)], self._items[int(ri)])
                    for li, ri in msg["pair_ids"]]
        return [self._items[int(i)] for i in msg["item_ids"]]

    def _score(self, msg: Dict[str, Any], runner) -> Dict[str, Any]:
        sem = sem_from_wire(msg["sem"])
        items = self._materialize(msg)
        eng = self.engine
        with self._exec_lock:
            kv0 = eng.store.bytes_loaded_local
            h2d0, don0 = eng.transfer_stats_local()
            attn0 = eng.attn_dispatches
            t0 = time.perf_counter()
            payload = runner(sem, msg["op_name"], items)
            wall = time.perf_counter() - t0
            h2d1, don1 = eng.transfer_stats_local()
            stats = {"kv_bytes": eng.store.bytes_loaded_local - kv0,
                     "attn_dispatches": eng.attn_dispatches - attn0,
                     "h2d_overlap_s": h2d1 - h2d0,
                     "donated_bytes": don1 - don0,
                     "server_wall_s": wall}
        with self._stats_lock:
            self.n_scores += 1
        payload.update(ok=True, stats=stats)
        return payload

    def _do_score_filter(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        def run(sem, op_name, items):
            scores = self.backend.score_filter(sem, op_name, items)
            return {"scores": np.asarray(scores, np.float32).tolist()}
        return self._score(msg, run)

    def _do_run_map(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        def run(sem, op_name, items):
            vals, conf = self.backend.run_map(sem, op_name, items)
            return {"values": np.asarray(vals).tolist(),
                    "confs": np.asarray(conf, np.float32).tolist()}
        return self._score(msg, run)

    def _do_warm(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        ids = msg.get("item_ids")
        if ids is None:
            ids = sorted(self._items)
        with self._exec_lock:
            n = self.engine.warm(
                msg["model"], float(msg["ratio"]), [int(i) for i in ids],
                query_len=int(msg.get("query_len", 1)),
                quant=bool(msg.get("quant", False)))
        return {"ok": True, "batches": n}

    def _do_evict(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        ratio = msg.get("ratio")
        with self._exec_lock:
            n = self.engine.evict(
                msg.get("model"),
                float(ratio) if ratio is not None else None,
                quant=bool(msg.get("quant", False)))
        return {"ok": True, "dropped": n}

    def _do_health(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        return {"ok": True, "name": self.name,
                "uptime_s": time.monotonic() - self._t0,
                "corpus_hash": self._corpus_hash,
                "n_items": len(self._items)}

    def _do_stats(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        with self._stats_lock:
            return {"ok": True, "n_requests": self.n_requests,
                    "n_scores": self.n_scores, "n_syncs": self.n_syncs,
                    "attn_dispatches": self.engine.attn_dispatches}


class _Handler(socketserver.BaseRequestHandler):
    """Persistent per-connection frame loop: each request frame gets one
    response frame in the request's encoding; a clean EOF ends the
    connection."""

    def handle(self):
        worker: RemoteWorker = self.server.worker     # type: ignore
        while True:
            try:
                msg, encoding, _ = recv_msg(self.request)
            except (ProtocolError, OSError):
                return
            if msg is None:
                return
            reply = worker.handle(msg)
            try:
                send_msg(self.request, reply, encoding=encoding)
            except OSError:
                return


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


def start_server(worker: RemoteWorker, host: str = "127.0.0.1",
                 port: int = 0) -> Tuple[_Server, threading.Thread, str]:
    """Serve `worker` on (host, port) in a daemon thread; port 0 picks a
    free one. Returns (server, thread, "host:port") — call
    `server.shutdown()` to stop."""
    server = _Server((host, port), _Handler)
    server.worker = worker                            # type: ignore
    bound = server.server_address
    thread = threading.Thread(
        target=server.serve_forever, name=f"remote-{worker.name}",
        daemon=True)
    thread.start()
    return server, thread, f"{bound[0]}:{bound[1]}"
