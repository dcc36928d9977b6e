"""Hand-written CUDA kernel for Expected-Attention scores
(`csrc/expected_attention.cu`).

Replaces the Pallas `repro.kernels.expected_attention.
expected_attention_scores`: for each cached position,

    score = mean_g[(k . mu_g) / sqrt(dk) + 0.5 (k*k) . sig2_g / dk]

k_cache (B, S, KV, dk) float32 or bfloat16; mu, sig2 (KV, G, dk) ->
(B, S, KV) float32. CUDA tensors only; the plain version in
`kernels/ref.py` serves CPU tensors (see `kernels/ops.py`). Launches are
counted in `expected_attention_scores.launches`.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_count_lock = threading.Lock()
_bound = set()


def _lib():
    lib = build.load("expected_attention")
    if "sig" not in _bound:
        f = lib.stretto_expected_attention_scores
        f.argtypes = [_P] * 4 + [_I] * 4 + [_F, _I, _P]
        f.restype = _I
        _bound.add("sig")
    return lib


def expected_attention_scores(k_cache, mu, sig2) -> torch.Tensor:
    if not k_cache.is_cuda:
        raise ValueError("expected_attention_scores: the CUDA kernel takes "
                         "CUDA tensors only")
    if k_cache.dtype not in _DTYPES:
        raise TypeError(f"expected_attention_scores: k must be float32 or "
                        f"bfloat16, got {k_cache.dtype}")
    if k_cache.dim() != 4 or mu.dim() != 3 or mu.shape != sig2.shape:
        raise ValueError("expected_attention_scores: k (B,S,KV,dk) and "
                         "mu/sig2 (KV,G,dk) expected")
    B, S, KV, dk = k_cache.shape
    if mu.shape[0] != KV or mu.shape[2] != dk:
        raise ValueError(f"expected_attention_scores: stats {tuple(mu.shape)}"
                         f" do not match k {tuple(k_cache.shape)}")
    G = mu.shape[1]
    dev = k_cache.device
    k = k_cache.contiguous()
    mu = mu.to(device=dev, dtype=torch.float32).contiguous()
    sig2 = sig2.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty((B, S, KV), dtype=torch.float32, device=dev)
    err = _lib().stretto_expected_attention_scores(
        k.data_ptr(), mu.data_ptr(), sig2.data_ptr(), out.data_ptr(),
        B * S, KV, G, dk, dk ** -0.5, _DTYPES[k.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "expected_attention_scores")
    with _count_lock:
        expected_attention_scores.launches += 1
    return out


expected_attention_scores.launches = 0
