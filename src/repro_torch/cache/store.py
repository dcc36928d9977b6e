"""On-disk KV-cache repository (paper §5, Fig. 4).

The port of `repro.cache.store`. One *profile* = (model_name, compression
ratio, optional int8 quantization); the store holds one compressed cache
per (profile, item) as an .npz shard plus an append-only `_meta.jsonl`
of per-item byte sizes. `load_batch` right-pads a set of items to the
longest in the batch (plus headroom, rounded up to a multiple) and
returns a decode-ready cache on the requested device.

Shard format. float32 and int8 shards are byte-compatible with the JAX
package's store in both directions: keys `__length__`, `k`, `v` (and
`k_scale`, `v_scale`), or MLA's `c_kv`, `k_rope`. numpy has no bfloat16, so a bfloat16 array is
stored as its uint16 bit pattern, and the shard names those keys in a
string array `__bf16__`; `load_batch` reinterprets them as bfloat16.
Keys that start with `__` are metadata: they count toward no byte total.

Host copies: on CUDA a batch is assembled in pinned host memory and
copied with `non_blocking=True`, so the copy queues behind work already
on the stream and the caller's thread returns at once (the engine's
prefetch relies on that).
"""
from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device

META_FILE = "_meta.jsonl"
BF16_KEY = "__bf16__"
SEQ_KEYS = {"k", "v", "c_kv", "k_rope", "k_scale", "v_scale"}


@dataclass(frozen=True)
class Profile:
    model_name: str
    ratio: float
    quant: bool = False

    @property
    def tag(self) -> str:
        base = f"{self.model_name}__r{int(round(self.ratio * 100)):02d}"
        return base + ("__q8" if self.quant else "")


def _encode(arrays: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Tensors / arrays -> npz-ready numpy arrays (bfloat16 as uint16)."""
    out: Dict[str, np.ndarray] = {}
    bf16 = []
    for k, v in arrays.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            if v.dtype == torch.bfloat16:
                out[k] = v.contiguous().view(torch.int16).numpy().view(
                    np.uint16)
                bf16.append(k)
                continue
            v = v.numpy()
        out[k] = np.asarray(v)
    if bf16:
        out[BF16_KEY] = np.asarray(sorted(bf16))
    return out


def _nbytes(shard: Dict[str, np.ndarray]) -> int:
    return sum(a.nbytes for k, a in shard.items() if not k.startswith("__"))


def _as_tensor(a: np.ndarray, bf16: bool) -> torch.Tensor:
    if bf16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class CacheStore:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._mem: Dict[Tuple[str, int], Dict[str, np.ndarray]] = {}
        self._meta: Dict[str, Dict[int, int]] = {}
        # monotonic telemetry: bytes of cached KV arrays handed to decode
        # batches, store-wide and per calling thread (the runtime's
        # StageStats read deltas of the thread-local counter, exact when
        # flushes overlap on a dispatcher's threads)
        self.bytes_loaded = 0
        self._tl = threading.local()
        self._bytes_lock = threading.Lock()

    @property
    def bytes_loaded_local(self) -> int:
        """KV bytes materialized by the *calling thread* (monotonic)."""
        return getattr(self._tl, "bytes_loaded", 0)

    def _path(self, profile: Profile, item_id: int) -> str:
        return os.path.join(self.root, profile.tag, f"{item_id}.npz")

    def _meta_path(self, profile: Profile) -> str:
        return os.path.join(self.root, profile.tag, META_FILE)

    def save(self, profile: Profile, item_id: int, arrays: Dict[str, Any],
             length: int):
        path = self._path(profile, item_id)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        arrs = _encode(arrays)
        np.savez(path, __length__=np.int32(length), **arrs)
        self._mem[(profile.tag, item_id)] = {
            "__length__": np.int32(length), **arrs}
        nbytes = _nbytes(arrs)
        with open(self._meta_path(profile), "a") as f:
            f.write(json.dumps({"id": item_id, "nbytes": nbytes,
                                "length": int(length)}) + "\n")
        self._meta.setdefault(profile.tag, {})[item_id] = nbytes

    def _load_meta(self, profile: Profile) -> Dict[int, int]:
        """Per-item nbytes for a profile; last write wins (append-only)."""
        if profile.tag not in self._meta:
            meta: Dict[int, int] = {}
            p = self._meta_path(profile)
            if os.path.exists(p):
                with open(p) as f:
                    for line in f:
                        line = line.strip()
                        if line:
                            rec = json.loads(line)
                            meta[int(rec["id"])] = int(rec["nbytes"])
            self._meta[profile.tag] = meta
        return self._meta[profile.tag]

    def item_nbytes(self, profile: Profile,
                    item_id: Optional[int] = None) -> Optional[int]:
        """Cache bytes for one stored item (any item if id is None), from
        profile metadata; falls back to the shard for stores written
        without metadata."""
        meta = self._load_meta(profile)
        if item_id is None:
            if meta:
                return next(iter(meta.values()))
            item_id = self.any_item_id(profile)
            if item_id is None:
                return None
        if item_id in meta:
            return meta[item_id]
        if not self.has(profile, item_id):
            return None
        nbytes = _nbytes(self.load(profile, item_id))
        meta[item_id] = nbytes
        return nbytes

    def load(self, profile: Profile, item_id: int) -> Dict[str, np.ndarray]:
        key = (profile.tag, item_id)
        if key not in self._mem:
            with np.load(self._path(profile, item_id)) as z:
                self._mem[key] = {k: z[k] for k in z.files}
        return self._mem[key]

    def has(self, profile: Profile, item_id: int) -> bool:
        return ((profile.tag, item_id) in self._mem
                or os.path.exists(self._path(profile, item_id)))

    def any_item_id(self, profile: Profile) -> Optional[int]:
        for tag, item_id in self._mem:
            if tag == profile.tag:
                return item_id
        d = os.path.join(self.root, profile.tag)
        if os.path.isdir(d):
            for f in os.listdir(d):
                if f.endswith(".npz"):
                    return int(f[:-len(".npz")])
        return None

    def storage_bytes(self, profile: Profile) -> int:
        d = os.path.join(self.root, profile.tag)
        if not os.path.isdir(d):
            return 0
        return sum(os.path.getsize(os.path.join(d, f))
                   for f in os.listdir(d) if f.endswith(".npz"))

    def load_batch(self, cfg: ModelConfig, profile: Profile,
                   item_ids: Sequence[int], pad_to_multiple: int = 32,
                   headroom: int = 0, n_real: Optional[int] = None,
                   device="cuda") -> Tuple[Dict[str, Any], np.ndarray]:
        """Assemble a right-padded decode cache for a batch of items.

        Returns (cache with leaves (L, B, S_max, ...) + 'lengths' on
        `device`, lengths numpy array). S_max is the longest item plus
        `headroom`, rounded up to `pad_to_multiple`; padding is zeros.
        `n_real` bounds the bytes-loaded telemetry to the first n_real
        entries (callers replicating an item to round a batch up to a
        shape bucket pass the unpadded count)."""
        device = resolve_device(device)
        shards = [self.load(profile, i) for i in item_ids]
        n_count = len(shards) if n_real is None else min(n_real, len(shards))
        loaded = sum(_nbytes(s) for s in shards[:n_count])
        with self._bytes_lock:
            self.bytes_loaded += loaded
        self._tl.bytes_loaded = self.bytes_loaded_local + loaded
        lengths = np.array([int(s["__length__"]) for s in shards], np.int32)
        smax = int(lengths.max()) + headroom
        smax = ((smax + pad_to_multiple - 1) // pad_to_multiple
                * pad_to_multiple)
        pin = device.type == "cuda"
        bf16 = set(str(k) for k in shards[0].get(BF16_KEY, ()))
        cache: Dict[str, Any] = {}
        for key in shards[0]:
            if key.startswith("__"):
                continue
            first = _as_tensor(shards[0][key], key in bf16)
            shape = list(first.shape)
            shape.insert(1, len(shards))            # (L, B, ...)
            if key in SEQ_KEYS:
                shape[2] = smax
            buf = torch.empty(shape, dtype=first.dtype, pin_memory=pin)
            for b, s in enumerate(shards):
                a = _as_tensor(s[key], key in bf16)
                if key in SEQ_KEYS:
                    n = a.shape[1]
                    buf[:, b, :n] = a
                    buf[:, b, n:] = 0
                else:
                    buf[:, b] = a
            cache[key] = buf.to(device, non_blocking=pin)
        cache["lengths"] = torch.from_numpy(lengths).to(device,
                                                        non_blocking=pin)
        return cache, lengths
