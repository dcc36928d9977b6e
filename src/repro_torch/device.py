"""Where the port runs: explicit devices, no silent CPU fallback.

Entry points take `device` (default "cuda"). Asking for CUDA on a machine
without it raises; only an explicit `device="cpu"` runs on the CPU (the
tests do). On CUDA the float32 matmul and cuDNN paths are pinned to full
float32 (TF32 off): the planted models' decisions sit near their
thresholds at float32 precision, and TF32 keeps about three digits.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but CUDA is not available; pass "
                f"device='cpu' to run the plain versions on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def canonical(device) -> torch.device:
    """`device` with its index filled in ("cuda" is the current card),
    so two names of one device compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def torch_dtype(name) -> torch.dtype:
    """A config's dtype string ('float32', 'bfloat16', ...) as torch."""
    if isinstance(name, torch.dtype):
        return name
    return getattr(torch, str(name))
