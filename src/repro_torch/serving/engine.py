"""Prefill-skip batched serving engine (paper §5, Fig. 4), in PyTorch.

The port of `repro.serving.engine`. Offline, `build_profiles` prefills
every corpus item once per model, scores every position with Expected
Attention, keeps the top positions at each ladder ratio (optionally
quantizing rungs to int8) and persists the profiles in the CacheStore.
Online, `run_filter` / `run_map` load a profile's caches for a batch of
items, pad them to the longest, skip prefill, feed the operator's query
tokens through the decode path and read out answer-token log-odds or a
greedy value with its top-2 margin.

The offline prefill and calibration forwards pass the same `kernels`
choice to every layer's full-sequence attention: on the card that is the
hand-written prefill kernel (`kernels/prefill_attention.py`).

The decode path:
  - attention runs through kernels.ops (`kernels` ctor arg, else the
    STRETTO_TORCH_KERNELS env var: auto | cuda | ref): on the card, the
    hand-written CUDA kernels;
  - by default the query goes through ONE fused multi-token attention
    launch per layer (`decode_multi`); `fused=False` (or STRETTO_FUSED=0),
    and every model without fused decode (MLA), feeds the tokens one
    `decode_step` at a time (a scan flush);
  - repeated flushes of the same (profile, batch) skip the npz read, the
    padding and the H2D copy through a device-resident LRU bounded by
    `memory_budget_bytes` (`device_cache` ctor arg, else
    STRETTO_DEVICE_CACHE). A hit adds nothing to kv_bytes, which counts
    real loads only. Decode writes the query's k/v into the cache tensors
    in place, so flushes over one LRU entry enqueue their decodes one at a
    time, under the entry's lock.

Transfers overlap compute (`async_h2d`, else STRETTO_ASYNC_H2D): a
multi-batch run enqueues batch i's decode, then loads and copies batch
i+1's caches (pinned host memory, non-blocking copy) before it reads
batch i's logits back, so the load hides behind the decode; the hidden
time is counted into `h2d_overlap_s`. On the same flag, when the LRU is
off, a flush drops its cache tensors as soon as the decode is enqueued,
which hands their memory back to PyTorch's stream-ordered caching
allocator for the next batch; those bytes are counted into
`donated_bytes` (the JAX engine's buffer donation). Both counters are
kept globally and per thread (`transfer_stats_local`).

An item's scores do not depend on the flush it is decoded in: the decode
attention kernels are batch-invariant, and a flush runs its dense layers
(projections, SwiGLU, the head) at `max_batch` x Lq rows whatever its
batch, padding the activations, not the caches (`decode_multi(rows=)`).
Without that pin the matmul library picks its algorithm by row count
and rounds a row differently by batch (cuBLAS and PyTorch's CPU matmul
both do: `flush_invariance` below measures it), so a query's scores
under the scheduler's merged flushes would drift from its solo run's.

Batch size is memory-bounded: higher compression -> smaller caches ->
larger batches -> fewer calls (the paper's batching speedup mechanism).

Multi-device placement: `place_on(device)` pins the calling thread's
flushes (cache loads, the weights they decode with, the decode itself)
onto `device`. On the engine's own device the flushes use the engine's
own weight tensors; on another device a copy is made once per (model,
device) and kept. The runtime's MeshDispatcher enters `place_on` per
corpus shard. The offline build runs on the engine's device.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.cache.compression import (QueryStats, calibrate_query_stats,
                                           compress_item_cache, quantize_kv,
                                           score_chunk)
from repro_torch.cache.store import CacheStore, Profile
from repro_torch.configs.base import ModelConfig
from repro_torch.device import canonical, resolve_device
from repro_torch.kernels import ops as KOPS
from repro_torch.models import cache_keys, decode_multi, decode_step, \
    prefill, supports_fused_decode

# Loads pad the cache length to a multiple of the kernels' position chunk
# (the JAX engine pads to its Pallas block for the same reason). Padded
# positions are masked exactly and kv_bytes counts unpadded bytes.
KERNEL_BLOCK_S = 128
BUILD_STEPS = ("calibrate", "prefill", "compress", "store")


def _env_flag(name: str, default: bool = True) -> bool:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return v not in ("0", "false", "False", "no")


def _nbytes(cache: Dict[str, Any]) -> int:
    return sum(v.numel() * v.element_size() for v in cache.values()
               if isinstance(v, torch.Tensor))


@dataclass
class EngineModel:
    cfg: ModelConfig
    params: Any
    stats: Optional[QueryStats] = None
    host_embed: Optional[np.ndarray] = None


class ServingEngine:
    """Executes semantic operators over precomputed KV-cache profiles."""

    def __init__(self, store: CacheStore,
                 memory_budget_bytes: float = 2e9,
                 max_batch: int = 128,
                 kernels: Optional[str] = None,
                 fused: Optional[bool] = None,
                 device_cache: Optional[bool] = None,
                 async_h2d: Optional[bool] = None,
                 device="cuda"):
        self.store = store
        self.device = resolve_device(device)
        self.models: Dict[str, EngineModel] = {}
        self.memory_budget = memory_budget_bytes
        self.max_batch = max_batch
        # attention backend: explicit arg > STRETTO_TORCH_KERNELS > auto,
        # resolved at flush time so the env var can flip between flushes
        self.kernels = kernels
        self.fused = (_env_flag("STRETTO_FUSED") if fused is None
                      else bool(fused))
        self.device_cache = (_env_flag("STRETTO_DEVICE_CACHE")
                             if device_cache is None else bool(device_cache))
        self.async_h2d = (_env_flag("STRETTO_ASYNC_H2D")
                          if async_h2d is None else bool(async_h2d))
        # the dense layers' pinned row count is on; flush_invariance
        # switches it off only to measure what it prevents
        self.pin_rows = True
        # per-thread placement (place_on) and the weights copied to other
        # devices, once per (model, device)
        self._placement_tl = threading.local()
        self._placed_params: Dict[Tuple[str, Any], Any] = {}
        self._placed_lock = threading.Lock()
        self.h2d_overlap_s = 0.0
        self.donated_bytes = 0
        self._xfer_lock = threading.Lock()
        self._xfer_tl = threading.local()
        # device-resident profile cache: (profile.tag, ids, headroom,
        # device) -> (cache on device, nbytes, lock held while a flush
        # decodes over it); one lock serializes lookup-or-load so
        # concurrent flushes of one key load once
        self._dev_cache: "OrderedDict[Tuple, Tuple[Any, int, Any]]" = \
            OrderedDict()
        self._dev_bytes = 0
        self._dev_lock = threading.Lock()
        self.dev_cache_hits = 0
        self.dev_cache_misses = 0
        # attention launches per layer issued by flushes (1 per fused
        # flush, len(query) per scan flush)
        self.attn_dispatches = 0
        # seconds spent in each offline build step (BUILD_STEPS)
        self.build_seconds = {k: 0.0 for k in BUILD_STEPS}
        self.prefill_chunks = 0

    # ---------------- placement + transfer telemetry ----------------

    @contextlib.contextmanager
    def place_on(self, device):
        """Pin this thread's flushes onto `device`: the weights there (the
        engine's own tensors on its own device, else a copy made once per
        (model, device)), the cache loads and the decode. The weights go
        whole: no path of the port splits a tensor across devices. Nests
        and restores."""
        dev = canonical(device)
        if dev.type != self.device.type:
            raise ValueError(f"engine on {self.device} cannot be placed on "
                             f"{dev}")
        tl = self._placement_tl
        prev = getattr(tl, "device", None)
        tl.device = dev
        try:
            yield
        finally:
            tl.device = prev

    def _placement(self) -> Optional[torch.device]:
        """This thread's device under `place_on`, or None outside it."""
        return getattr(self._placement_tl, "device", None)

    def _flush_device(self) -> torch.device:
        placed = self._placement()
        return self.device if placed is None else placed

    def _params_for(self, em: EngineModel, model_name: str, device):
        """The model's weights on `device`: the engine's own tensors where
        they already lie (never a copy), else a copy made once per (model,
        device)."""
        home = em.params["embed"].device
        dev = canonical(device)
        if dev == canonical(home):
            return em.params
        key = (model_name, dev)
        with self._placed_lock:
            got = self._placed_params.get(key)
            if got is None:
                got = _tree_to(em.params, dev)
                self._placed_params[key] = got
            return got

    def _count_xfer(self, h2d_s: float = 0.0, donated: int = 0):
        tl = self._xfer_tl
        tl.h2d_s = getattr(tl, "h2d_s", 0.0) + h2d_s
        tl.donated = getattr(tl, "donated", 0) + donated
        with self._xfer_lock:
            self.h2d_overlap_s += h2d_s
            self.donated_bytes += donated

    def transfer_stats_local(self) -> Tuple[float, int]:
        """Monotonic (h2d_overlap_s, donated_bytes) for the calling
        thread."""
        tl = self._xfer_tl
        return (getattr(tl, "h2d_s", 0.0), getattr(tl, "donated", 0))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---------------- offline phase ----------------

    def register_model(self, name: str, cfg: ModelConfig, params):
        self.models[name] = EngineModel(cfg, params)

    def host_embed(self, model_name: str) -> np.ndarray:
        """The embedding table on the host, copied once per model."""
        em = self.models[model_name]
        if em.host_embed is None:
            em.host_embed = em.params["embed"].float().cpu().numpy()
        return em.host_embed

    def build_profiles(self, model_name: str, items: Sequence[Any],
                       ratios: Sequence[float], prefill_batch: int = 16,
                       quant_ratios: Sequence[float] = ()):
        """Prefill every item once, compress at every ratio, persist.

        Scores do not depend on the ratio, so each prefill chunk is scored
        once (`score_chunk`: one Expected-Attention launch over its layers
        and items) and every rung of an item keeps its top positions from
        its slice of those scores (the JAX engine rescores item by item and
        rung by rung; the kept sets are the same). Seconds per step
        accumulate in `build_seconds`; `prefill_chunks` counts the chunks
        prefilled. MLA models keep latent caches and rwkv6 keeps no
        positional cache, so neither has an int8 rung: `quant_ratios` on
        one raises, as in the JAX package. rwkv6 has no ladder either: it
        is not calibrated, ratios above 0 are skipped, and its ratio-0
        profile stores the prefill's states as they are."""
        em = self.models[model_name]
        cfg = em.cfg
        if quant_ratios and cfg.attn_kind not in ("gqa", "hymba"):
            raise ValueError(
                f"int8 KV profiles require a k/v cache; "
                f"attn_kind={cfg.attn_kind!r} has none")
        has_cache = cfg.attn_kind != "rwkv6"
        if not has_cache:
            ratios = [r for r in ratios if r <= 0]
        keys = cache_keys(cfg)
        secs = self.build_seconds
        if has_cache and em.stats is None:
            t0 = time.perf_counter()
            calib = _pad_tokens([it.tokens for it in items[:8]],
                                device=self.device)
            em.stats = calibrate_query_stats(em.params, cfg, tokens=calib,
                                             kernels=self.kernels)
            self._sync()
            secs["calibrate"] += time.perf_counter() - t0
        for start in range(0, len(items), prefill_batch):
            chunk = items[start:start + prefill_batch]
            t0 = time.perf_counter()
            toks = _pad_tokens([it.tokens for it in chunk],
                               device=self.device)
            lengths = torch.tensor([len(it.tokens) for it in chunk],
                                   dtype=torch.int32, device=self.device)
            _, cache = prefill(em.params, cfg, tokens=toks,
                               max_len=toks.shape[1], lengths=lengths,
                               kernels=self.kernels)
            self._sync()
            secs["prefill"] += time.perf_counter() - t0
            self.prefill_chunks += 1
            scores = None
            if any(r > 0 for r in ratios) or quant_ratios:
                t0 = time.perf_counter()
                scores = score_chunk(cfg, cache, em.stats,
                                     [len(it.tokens) for it in chunk],
                                     kernels=self.kernels)   # (L, B, S)
                secs["compress"] += time.perf_counter() - t0
            for bi, it in enumerate(chunk):
                item_cache = {k: cache[k][:, bi:bi + 1] for k in keys}
                n = len(it.tokens)
                t0 = time.perf_counter()
                item_scores = None if scores is None else scores[:, bi]
                rungs = []
                for ratio in ratios:
                    arrays, new_len = compress_item_cache(
                        cfg, item_cache, em.stats, ratio, n,
                        scores=item_scores)
                    rungs.append((Profile(model_name, ratio), arrays,
                                  new_len))
                for ratio in quant_ratios:
                    arrays, new_len = compress_item_cache(
                        cfg, item_cache, em.stats, ratio, n,
                        scores=item_scores)
                    rungs.append((Profile(model_name, ratio, quant=True),
                                  quantize_kv(arrays), new_len))
                t1 = time.perf_counter()
                secs["compress"] += t1 - t0
                for profile, arrays, new_len in rungs:
                    self.store.save(profile, it.item_id, arrays, new_len)
                secs["store"] += time.perf_counter() - t1

    # ---------------- online phase ----------------

    def max_batch_for(self, model_name: str, ratio: float,
                      item_id: Optional[int] = None,
                      quant: bool = False) -> int:
        """Memory-bounded max decode batch for a (model, ratio) profile,
        from the store's per-item metadata; never above `max_batch`."""
        profile = Profile(model_name, ratio, quant)
        per_item = self.store.item_nbytes(profile, item_id)
        if per_item is None:
            return self.max_batch
        b = max(1, int(self.memory_budget / max(per_item, 1)))
        return min(b, self.max_batch)

    def _batch_size(self, profile: Profile, item_ids) -> int:
        b = self.max_batch_for(profile.model_name, profile.ratio,
                               item_ids[0], quant=profile.quant)
        return min(b, len(item_ids))

    def _run_tokens(self, em: EngineModel, params, fused: bool,
                    backend: str, cache, tokens):
        """Final-token logits of the query `tokens` (B, Lq) over `cache`,
        the dense layers at `max_batch` rows when `pin_rows`."""
        rows = self.max_batch if self.pin_rows else None
        if fused:
            return decode_multi(params, em.cfg, cache, tokens=tokens,
                                kernels=backend, rows=rows)[0]
        logits = None
        for t in range(tokens.shape[1]):
            logits, cache = decode_step(params, em.cfg, cache,
                                        tokens=tokens[:, t:t + 1],
                                        kernels=backend, rows=rows)
        return logits

    def warm(self, model_name: str, ratio: float, item_ids: Sequence[int],
             query_len: int = 1, quant: bool = False) -> int:
        """Pre-stage a profile's flush batches in the device-resident LRU;
        returns the number of batches staged (0 when the device cache is
        off, the model unknown or the rung not built)."""
        if not self.device_cache or model_name not in self.models \
                or not item_ids:
            return 0
        em = self.models[model_name]
        profile = Profile(model_name, ratio, quant)
        ids = [int(i) for i in item_ids if self.store.has(profile, i)]
        if not ids:
            return 0
        bs = self._batch_size(profile, ids)
        query_tokens = [0] * max(int(query_len), 1)
        n = 0
        for s in range(0, len(ids), bs):
            self._load_for(em, profile, ids[s:s + bs], query_tokens, bs)
            n += 1
        return n

    def evict(self, model_name: Optional[str] = None,
              ratio: Optional[float] = None,
              quant: bool = False) -> int:
        """Drop device-LRU entries: everything (model_name=None), every
        rung of a model (ratio=None) or one profile. Returns entries
        dropped; the on-disk profiles stay."""
        with self._dev_lock:
            if model_name is None:
                n = len(self._dev_cache)
                self._dev_cache.clear()
                self._dev_bytes = 0
                return n
            if ratio is None:
                prefix = f"{model_name}__r"
                keys = [k for k in self._dev_cache
                        if k[0].startswith(prefix)]
            else:
                tag = Profile(model_name, ratio, quant).tag
                keys = [k for k in self._dev_cache if k[0] == tag]
            for k in keys:
                self._dev_bytes -= self._dev_cache.pop(k)[1]
            return len(keys)

    def _load_cached(self, em: EngineModel, profile: Profile,
                     ids: Sequence[int], headroom: int, n_real: int):
        """load_batch through the device-resident LRU, onto this thread's
        flush device. Returns (cache, lock): the lock of the LRU entry,
        None for a private load."""
        device = self._flush_device()

        def load():
            return self.store.load_batch(
                em.cfg, profile, ids, pad_to_multiple=KERNEL_BLOCK_S,
                headroom=headroom, n_real=n_real, device=device)[0]

        if not self.device_cache:
            return load(), None
        key = (profile.tag, tuple(ids), headroom, canonical(device))
        with self._dev_lock:
            hit = self._dev_cache.get(key)
            if hit is not None:
                self._dev_cache.move_to_end(key)
                self.dev_cache_hits += 1
                return hit[0], hit[2]
            self.dev_cache_misses += 1
            cache = load()
            nbytes = _nbytes(cache)
            lock = threading.Lock()
            self._dev_cache[key] = (cache, nbytes, lock)
            self._dev_bytes += nbytes
            while self._dev_bytes > self.memory_budget \
                    and len(self._dev_cache) > 1:
                self._dev_bytes -= self._dev_cache.popitem(last=False)[1][1]
            return cache, lock

    def _load_for(self, em: EngineModel, profile: Profile, ids: List[int],
                  query_tokens: Sequence[int], bs: int):
        """One flush batch's (caches, LRU lock), padded to the same shape
        `_flush` loads, so a prefetched cache slots in as `preloaded`."""
        pad = max(0, min(_bucket(len(ids)), bs) - len(ids))
        return self._load_cached(em, profile, ids + ids[:1] * pad,
                                 headroom=len(query_tokens) + 2,
                                 n_real=len(ids))

    def _flush(self, em: EngineModel, profile: Profile, ids: List[int],
               query_tokens: Sequence[int], bs: int, preloaded=None):
        """One decode flush: load (or hit, or take the prefetched) caches,
        run the query, return logits (len(ids) rows) still on the device;
        callers read them back when they consume them."""
        pad = max(0, min(_bucket(len(ids)), bs) - len(ids))
        fused = self.fused and supports_fused_decode(em.cfg)
        backend = KOPS.resolve_backend(self.kernels)
        # releasing the buffers needs exclusive ownership: the LRU would
        # hand the same tensors to the next hit
        donate = self.async_h2d and not self.device_cache
        cache, lock = preloaded if preloaded is not None else \
            self._load_for(em, profile, ids, query_tokens, bs)
        device = self._flush_device()
        params = self._params_for(em, profile.model_name, device)
        q = torch.tensor([list(query_tokens)] * (len(ids) + pad),
                         dtype=torch.long, device=device)
        # the decode writes this query's k/v into an LRU entry's shared
        # tensors: one flush at a time enqueues over it, and the stream
        # runs the decodes in that order
        with lock or contextlib.nullcontext():
            logits = self._run_tokens(em, params, fused, backend, cache, q)
        if donate:
            donated = _nbytes(cache)
            cache.clear()      # the allocator reuses them once the decode ends
            self._count_xfer(donated=donated)
        self.attn_dispatches += 1 if fused else len(query_tokens)
        return logits[:len(ids)]

    def _iter_flushes(self, em: EngineModel, profile: Profile,
                      item_ids: Sequence[int], query_tokens: Sequence[int],
                      bs: int):
        """Yield (start, ids, logits) per flush batch. With `async_h2d` and
        more than one batch, batch i+1's caches load right after batch i's
        decode is enqueued and before its logits are read back."""
        batches = [(s, list(item_ids[s:s + bs]))
                   for s in range(0, len(item_ids), bs)]
        prefetch = self.async_h2d and len(batches) > 1
        pre = None
        for bi, (s, ids) in enumerate(batches):
            logits = self._flush(em, profile, ids, query_tokens, bs,
                                 preloaded=pre)
            pre = None
            if prefetch and bi + 1 < len(batches):
                t0 = time.perf_counter()
                pre = self._load_for(em, profile, batches[bi + 1][1],
                                     query_tokens, bs)
                self._count_xfer(h2d_s=time.perf_counter() - t0)
            yield s, ids, logits

    def run_filter(self, model_name: str, profile_ratio: float,
                   item_ids: Sequence[int], query_tokens: Sequence[int],
                   yes_token: int, no_token: int,
                   quant: bool = False) -> np.ndarray:
        """Log-odds per item: logit(yes) - logit(no), prefill skipped."""
        em = self.models[model_name]
        profile = Profile(model_name, profile_ratio, quant)
        out = np.zeros(len(item_ids), np.float32)
        bs = self._batch_size(profile, item_ids)
        for s, ids, logits in self._iter_flushes(em, profile, item_ids,
                                                 query_tokens, bs):
            lo = (logits[:, yes_token] - logits[:, no_token]).float()
            out[s:s + len(ids)] = lo.cpu().numpy()
        return out

    def run_map(self, model_name: str, profile_ratio: float,
                item_ids: Sequence[int], query_tokens: Sequence[int],
                value_tokens: Sequence[int], quant: bool = False
                ) -> Tuple[np.ndarray, np.ndarray]:
        """Greedy value among `value_tokens` + confidence (top-2 margin)."""
        em = self.models[model_name]
        profile = Profile(model_name, profile_ratio, quant)
        vals = np.zeros(len(item_ids), np.int64)
        confs = np.zeros(len(item_ids), np.float32)
        bs = self._batch_size(profile, item_ids)
        vt = torch.tensor(list(value_tokens), dtype=torch.long,
                          device=self._flush_device())
        for s, ids, logits in self._iter_flushes(em, profile, item_ids,
                                                 query_tokens, bs):
            vlogits = logits[:, vt]                        # (B, n_vals)
            top2 = torch.topk(vlogits, 2, dim=-1).values
            vals[s:s + len(ids)] = vt[torch.argmax(vlogits, -1)].cpu().numpy()
            confs[s:s + len(ids)] = (top2[:, 0] - top2[:, 1]).float() \
                .cpu().numpy()
        return vals, confs


def flush_invariance(engine: ServingEngine, model_name: str, ratio: float,
                     probe: int, others: Sequence[int], *,
                     filter_args: Tuple[Sequence[int], int, int],
                     map_args: Tuple[Sequence[int], Sequence[int]],
                     quant: bool = False) -> Dict[int, bool]:
    """Whether item `probe`'s flush outputs depend on its batch: its
    `run_filter` log-odds (filter_args: query tokens, yes, no) and its
    `run_map` value and confidence (map_args: query tokens, value tokens)
    alone, against the same in one flush of n = 2, 4, ... up to the
    profile's memory-bounded batch with items of `others` (cycled) beside
    it, once with the probe first and once last. Returns {n: bit-equal}."""
    bs = engine.max_batch_for(model_name, ratio, probe, quant=quant)
    sizes, n = [], 2
    while n < bs:
        sizes.append(n)
        n *= 2
    sizes.append(bs)
    fq, yes, no = filter_args
    mq, vals = map_args

    def outputs(ids):
        lo = engine.run_filter(model_name, ratio, ids, fq, yes, no,
                               quant=quant)
        v, c = engine.run_map(model_name, ratio, ids, mq, vals, quant=quant)
        return lo, v, c

    alone = [o[0] for o in outputs([probe])]
    out = {}
    for n in sizes:
        fill = [others[i % len(others)] for i in range(n - 1)]
        first = [o[0] for o in outputs([probe] + fill)]
        last = [o[-1] for o in outputs(fill + [probe])]
        out[n] = all(np.array_equal(a, b) and np.array_equal(a, c)
                     for a, b, c in zip(alone, first, last))
    return out


def _tree_to(tree, device):
    """A nested dict of tensors copied to `device`."""
    return {k: (_tree_to(v, device) if isinstance(v, dict)
                else v.to(device)) for k, v in tree.items()}


def _bucket(n: int) -> int:
    """Round a batch size up to a power of two (callers cap it at the
    memory-bounded batch size)."""
    b = 1
    while b < n:
        b *= 2
    return b


def _pad_tokens(token_lists: Sequence[Sequence[int]], multiple: int = 16,
                device="cpu") -> torch.Tensor:
    n = max(len(t) for t in token_lists)
    n = (n + multiple - 1) // multiple * multiple
    out = np.zeros((len(token_lists), n), np.int64)
    for i, t in enumerate(token_lists):
        out[i, :len(t)] = t
    return torch.from_numpy(out).to(device)
