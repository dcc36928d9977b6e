"""Hand-written CUDA kernel for Expected-Attention scores
(`csrc/expected_attention.cu`).

Replaces the Pallas `repro.kernels.expected_attention.
expected_attention_scores`, mapped over the layers as the JAX package's
`jax.vmap` does: for each layer and cached position,

    score = mean_g[(k . mu_g) / sqrt(dk) + 0.5 (k*k) . sig2_g / dk]

k_cache (L, B, S, KV, dk) float32 or bfloat16 (its (S, KV, dk) block
contiguous, the layer and item axes at any stride); mu, sig2 (L, KV, G,
dk), float32 or bfloat16, read in their own type -> (L, B, S, KV)
float32. Without the leading layer axis ((B, S, KV, dk) and (KV, G, dk))
the result is (B, S, KV). One call is one launch, whatever L and B are.
CUDA tensors only; the plain version in `kernels/ref.py` serves CPU
tensors (see `kernels/ops.py`); CUDA tensors without storage
(`FakeTensor`s) get their output and a report to `kernels/cost.py`, and
no launch. Launches are counted in
`expected_attention_scores.launches`.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build, cost
from repro_torch.kernels.ref import ea_factors

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
_count_lock = threading.Lock()
_bound = set()


def _lib():
    lib = build.load("expected_attention")
    if "sig" not in _bound:
        f = lib.stretto_expected_attention_scores
        f.argtypes = [_P] * 4 + [_I] * 6 + [_L] * 2 + [_F] * 2 + \
            [_I] * 2 + [_P]
        f.restype = _I
        _bound.add("sig")
    return lib


def _rows_contiguous(k: torch.Tensor) -> bool:
    """(S, KV, dk) of a (L, B, S, KV, dk) tensor lie as one block."""
    _, _, S, KV, dk = k.shape
    return (k.stride(4) == 1 or dk == 1) and (k.stride(3) == dk or KV == 1) \
        and (k.stride(2) == KV * dk or S == 1)


def expected_attention_scores(k_cache, mu, sig2) -> torch.Tensor:
    what = "expected_attention_scores"
    if not (k_cache.is_cuda and mu.is_cuda and sig2.is_cuda):
        raise ValueError(f"{what}: the CUDA kernel takes CUDA tensors only")
    if k_cache.dtype not in _DTYPES or mu.dtype not in _DTYPES \
            or sig2.dtype != mu.dtype:
        raise TypeError(f"{what}: k, and mu / sig2 (one type), must be "
                        f"float32 or bfloat16; got {k_cache.dtype}, "
                        f"{mu.dtype}, {sig2.dtype}")
    layered = k_cache.dim() == 5
    if k_cache.dim() not in (4, 5) or mu.dim() != k_cache.dim() - 1 \
            or mu.shape != sig2.shape:
        raise ValueError(f"{what}: k ([L,] B, S, KV, dk) and mu / sig2 "
                         f"([L,] KV, G, dk) expected; got k "
                         f"{tuple(k_cache.shape)}, stats {tuple(mu.shape)} / "
                         f"{tuple(sig2.shape)}")
    k = k_cache if layered else k_cache[None]
    mu, sig2 = (mu, sig2) if layered else (mu[None], sig2[None])
    L, B, S, KV, dk = k.shape
    G = mu.shape[2]
    if mu.shape[0] != L or mu.shape[1] != KV or mu.shape[3] != dk:
        raise ValueError(f"{what}: stats {tuple(mu.shape)} do not match k "
                         f"{tuple(k.shape)}")
    if mu.device != k.device or sig2.device != k.device:
        raise ValueError(f"{what}: k and the stats lie on different devices")
    if not _rows_contiguous(k):
        k = k.contiguous()
    mu, sig2 = mu.contiguous(), sig2.contiguous()
    out = torch.empty((L, B, S, KV), dtype=torch.float32, device=k.device)
    if cost.is_fake(k):
        flops, nbytes = cost.expected_attention_work(
            k.numel(), k.element_size(), mu.numel(), mu.element_size(),
            out.numel())
        cost.report(what, flops, nbytes)
        return out if layered else out[0]
    fa, fc = ea_factors(dk, G)
    err = _lib().stretto_expected_attention_scores(
        k.data_ptr(), mu.data_ptr(), sig2.data_ptr(), out.data_ptr(), L, B,
        S, KV, G, dk, k.stride(0) if L > 1 else 0,
        k.stride(1) if B > 1 else 0, fa, fc, _DTYPES[k.dtype],
        _DTYPES[mu.dtype], torch.cuda.current_stream(k.device).cuda_stream)
    build.check(err, what)
    with _count_lock:
        expected_attention_scores.launches += 1
    return out if layered else out[0]


expected_attention_scores.launches = 0
