"""Fault-tolerant, device-agnostic checkpointing.

The port of `repro.training.checkpoint`, with the same directory layout,
manifest and files, so each package restores the other's checkpoints:
- Atomic: write to a temp dir, fsync, rename. A crash mid-write never
  corrupts the latest checkpoint, and `latest_step` never lists a
  `.tmp_ckpt_*` dir.
- Device-agnostic: each leaf is saved as a whole numpy buffer, one `.npy`
  per leaf named by the SHA1 of its key, with a manifest (step, and per
  leaf key its file, shape, dtype name and a SHA1 prefix of its bytes).
  Leaf keys are the JAX package's tree paths (`0/embed`,
  `1/m/layers/attn/wq`, `1/step`). Restore places the leaves on any
  device (the counterpart of the reference's `shardings=`).
- Self-validating: restore checks each leaf's hash before handing the
  tree back.
bfloat16 has no numpy dtype: its leaves are stored as their raw bytes
(uint8, last axis doubled) under the dtype name "bfloat16", as the
reference stores its `ml_dtypes` arrays; `Tensor.view` reinterprets the
bytes both ways, so the hashes are the same.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.training.tree import leaves_with_paths, path_key, unflatten

PyTree = Any

# dtypes numpy lacks: stored as raw uint8 bytes
_RAW = {torch.bfloat16: "bfloat16"}


def _to_numpy_savable(t: torch.Tensor) -> Tuple[np.ndarray, str, bytes]:
    """(the array np.save writes, the leaf's dtype name, its bytes)."""
    t = t.detach().cpu().contiguous()
    if t.dtype in _RAW:
        raw = t.view(torch.uint8).numpy()
        return raw, _RAW[t.dtype], raw.tobytes()
    arr = t.numpy()
    return arr, arr.dtype.name, arr.tobytes()


def _from_numpy_savable(arr: np.ndarray, dtype_name: str,
                        shape) -> torch.Tensor:
    if arr.dtype == np.uint8 and dtype_name != "uint8":
        return torch.from_numpy(np.ascontiguousarray(arr)).view(
            getattr(torch, dtype_name)).reshape(shape)
    return torch.from_numpy(np.ascontiguousarray(arr)).reshape(shape)


def save_checkpoint(root: str, step: int, tree: PyTree,
                    keep_last: int = 3) -> str:
    """Atomically persist `tree` under root/step_<n>. Returns the path."""
    os.makedirs(root, exist_ok=True)
    final = os.path.join(root, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(dir=root, prefix=".tmp_ckpt_")
    manifest = {"step": step, "leaves": {}}
    for path, leaf in leaves_with_paths(tree):
        key = path_key(path)
        arr, dtype_name, data = _to_numpy_savable(leaf)
        fname = hashlib.sha1(key.encode()).hexdigest()[:16] + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = {
            "file": fname, "shape": list(leaf.shape),
            "dtype": dtype_name,
            "sha1": hashlib.sha1(data).hexdigest()[:16],
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic on POSIX
    _gc(root, keep_last)
    return final


def latest_step(root: str) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(root)
             if d.startswith("step_")]
    return max(steps) if steps else None


def restore_checkpoint(root: str, like: PyTree, step: Optional[int] = None,
                       device=None, validate: bool = True
                       ) -> Tuple[PyTree, int]:
    """Restore into the structure of `like` (the dtypes and shapes are the
    manifest's). Each leaf goes to `device`, or, with None, to the device
    of `like`'s leaf at its place (the CPU where that is no tensor)."""
    step = latest_step(root) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {root}")
    d = os.path.join(root, f"step_{step:010d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)

    out = []
    for path, leaf in leaves_with_paths(like):
        key = path_key(path)
        meta = manifest["leaves"][key]
        arr = np.load(os.path.join(d, meta["file"]))
        if validate:
            h = hashlib.sha1(arr.tobytes()).hexdigest()[:16]
            if h != meta["sha1"]:
                raise IOError(f"checkpoint leaf {key} failed hash check")
        t = _from_numpy_savable(arr, meta["dtype"], tuple(meta["shape"]))
        dev = device if device is not None else getattr(leaf, "device",
                                                        "cpu")
        out.append(t.to(dev))
    return unflatten(like, out), step


def _gc(root: str, keep_last: int):
    steps = sorted([d for d in os.listdir(root) if d.startswith("step_")])
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(root, d), ignore_errors=True)
