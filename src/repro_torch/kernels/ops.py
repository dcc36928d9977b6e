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

int8 KV caches (with per-token scales) launch the int8 CUDA kernels,
which dequantise in the kernel; the plain versions dequantise up front.
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
    "decode_query_attention_int8": _da.decode_query_attention_int8,
    "decode_attention": _da.decode_attention,
    "decode_attention_int8": _da.decode_attention_int8,
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


def decode_attention(q, k_cache, v_cache, lengths, *, window=GLOBAL,
                     backend=None, k_scale=None, v_scale=None):
    """Single-query flash-decode; (B, KV, G, dk) -> (B, KV, G, dv).
    With k_scale / v_scale (B, S, KV), k_cache / v_cache are int8."""
    quant = k_scale is not None
    if use_kernel(backend, q):
        if quant:
            return _da.decode_attention_int8(q, k_cache, v_cache, k_scale,
                                             v_scale, lengths, window=window)
        return _da.decode_attention(q, k_cache, v_cache, lengths,
                                    window=window)
    window = min(int(window), GLOBAL)
    if quant:
        return ref.decode_attention_int8_ref(q, k_cache, v_cache, k_scale,
                                             v_scale, lengths, window=window)
    return ref.decode_attention_ref(q, k_cache, v_cache, lengths,
                                    window=window)


def decode_query_attention(q, k_cache, v_cache, lengths, *, window=GLOBAL,
                           backend=None, k_scale=None, v_scale=None):
    """Fused multi-token query decode; (B, Lq, KV, G, dk) ->
    (B, Lq, KV, G, dv). `lengths` includes the Lq query tokens. With
    k_scale / v_scale (B, S, KV), k_cache / v_cache are int8."""
    quant = k_scale is not None
    if use_kernel(backend, q):
        if quant:
            return _da.decode_query_attention_int8(
                q, k_cache, v_cache, k_scale, v_scale, lengths,
                window=window)
        return _da.decode_query_attention(q, k_cache, v_cache, lengths,
                                          window=window)
    window = min(int(window), GLOBAL)
    if quant:
        return ref.decode_query_attention_int8_ref(
            q, k_cache, v_cache, k_scale, v_scale, lengths, window=window)
    return ref.decode_query_attention_ref(q, k_cache, v_cache, lengths,
                                          window=window)


def expected_attention_scores(k_cache, mu, sig2, *, backend=None):
    if use_kernel(backend, k_cache):
        return _ea.expected_attention_scores(k_cache, mu, sig2)
    return ref.expected_attention_scores_ref(k_cache, mu, sig2)
