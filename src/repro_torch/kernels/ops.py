"""Backend-selectable public wrappers for the port's kernels.

Every wrapper takes `backend`, one of:

  auto  the hand-written CUDA kernel for CUDA tensors, the plain PyTorch
        version (kernels/ref.py) for CPU tensors (default)
  cuda  the CUDA kernel; a CPU tensor raises
  ref   the plain PyTorch version on whatever device the tensors are on

`backend=None` defers to the STRETTO_TORCH_KERNELS environment variable,
read at call time so tests and deployments can flip it without
reimporting. A CUDA tensor under `auto` or `cuda` always launches the
kernel: a failed build or launch raises, and nothing falls back to the
plain version.

int8 KV caches (with per-token scales) take the `ref` path's up-front
dequantization; their in-kernel dequantizing CUDA body is not ported yet,
so `auto`/`cuda` on CUDA int8 caches raise.
"""
from __future__ import annotations

import os

import torch

from repro_torch.kernels import ref
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import expected_attention as _ea
from repro_torch.kernels.ref import GLOBAL

VALID_BACKENDS = ("auto", "cuda", "ref")
ENV_VAR = "STRETTO_TORCH_KERNELS"
KERNELS = {
    "decode_query_attention": _da.decode_query_attention,
    "decode_attention": _da.decode_attention,
    "expected_attention_scores": _ea.expected_attention_scores,
}


def resolve_backend(backend=None) -> str:
    """Explicit arg wins, else STRETTO_TORCH_KERNELS (read now), else auto."""
    if backend is None or backend == "":
        backend = os.environ.get(ENV_VAR, "auto") or "auto"
    if backend not in VALID_BACKENDS:
        raise ValueError(f"unknown kernels backend {backend!r}; expected one "
                         f"of {VALID_BACKENDS}")
    return backend


def use_kernel(backend, x: torch.Tensor) -> bool:
    """True when the call must launch the CUDA kernel for tensor `x`."""
    backend = resolve_backend(backend)
    if backend == "ref":
        return False
    if backend == "cuda" and not x.is_cuda:
        raise ValueError(f"kernels backend 'cuda' needs CUDA tensors, got a "
                         f"tensor on {x.device}")
    return x.is_cuda


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def _dequant(x, scale):
    return x.float() * scale[..., None].float()


def _int8_kernel_missing(what):
    raise NotImplementedError(
        f"{what}: the int8 CUDA body is not ported yet; use backend='ref' "
        f"for int8 KV caches")


def decode_attention(q, k_cache, v_cache, lengths, *, window=GLOBAL,
                     backend=None, k_scale=None, v_scale=None):
    """Single-query flash-decode; (B, KV, G, dk) -> (B, KV, G, dv)."""
    if use_kernel(backend, q):
        if k_scale is not None:
            _int8_kernel_missing("decode_attention")
        return _da.decode_attention(q, k_cache, v_cache, lengths,
                                    window=window)
    if k_scale is not None:
        k_cache = _dequant(k_cache, k_scale)
        v_cache = _dequant(v_cache, v_scale)
    return ref.decode_attention_ref(q, k_cache, v_cache, lengths,
                                    window=min(int(window), GLOBAL))


def decode_query_attention(q, k_cache, v_cache, lengths, *, window=GLOBAL,
                           backend=None, k_scale=None, v_scale=None):
    """Fused multi-token query decode; (B, Lq, KV, G, dk) ->
    (B, Lq, KV, G, dv). `lengths` includes the Lq query tokens."""
    if use_kernel(backend, q):
        if k_scale is not None:
            _int8_kernel_missing("decode_query_attention")
        return _da.decode_query_attention(q, k_cache, v_cache, lengths,
                                          window=window)
    if k_scale is not None:
        k_cache = _dequant(k_cache, k_scale)
        v_cache = _dequant(v_cache, v_scale)
    return ref.decode_query_attention_ref(q, k_cache, v_cache, lengths,
                                          window=min(int(window), GLOBAL))


def expected_attention_scores(k_cache, mu, sig2, *, backend=None):
    if use_kernel(backend, k_cache):
        return _ea.expected_attention_scores(k_cache, mu, sig2)
    return ref.expected_attention_scores_ref(k_cache, mu, sig2)
