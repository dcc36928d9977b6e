"""Hand-written CUDA flash-decode kernels (`csrc/decode_attention.cu`).

  decode_attention        one query token per item: q (B, KV, G, dk) ->
                          (B, KV, G, dv). Replaces the Pallas
                          `repro.kernels.decode_attention.decode_attention`.
  decode_query_attention  Lq query tokens per item in one launch:
                          q (B, Lq, KV, G, dk) -> (B, Lq, KV, G, dv).
                          Replaces the Pallas `decode_query_attention`.

  k_cache  (B, S, KV, dk), v_cache (B, S, KV, dv): q's type, float32 or
           bfloat16
  lengths  (B,) valid tokens per item (query tokens included)
  window   int; GLOBAL (2^30) means full attention, larger values clamp

Both wrappers take CUDA tensors only and launch the kernel; the plain
versions in `kernels/ref.py` serve CPU tensors (see `kernels/ops.py`).
The source header says what bounds the kernels on the H100 and how the
design meets it. Each wrapper counts its launches in `.launches`.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import GLOBAL

CHUNK = 128                       # cache positions per split (the .cu's)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_count_lock = threading.Lock()
_bound = set()


def _lib():
    lib = build.load("decode_attention")
    if "sig" not in _bound:
        f = lib.stretto_decode_query_attention
        f.argtypes = [_P] * 8 + [_I] * 8 + [_F, _I, _P]
        f.restype = _I
        f = lib.stretto_decode_attention
        f.argtypes = [_P] * 8 + [_I] * 7 + [_F, _I, _P]
        f.restype = _I
        _bound.add("sig")
    return lib


def _count(fn) -> None:
    with _count_lock:
        fn.launches += 1


def _check(q, k_cache, v_cache, lengths, q_ndim: int, what: str):
    if not (q.is_cuda and k_cache.is_cuda and v_cache.is_cuda):
        raise ValueError(f"{what}: the CUDA kernel takes CUDA tensors only")
    if not (q.device == k_cache.device == v_cache.device):
        raise ValueError(f"{what}: q, k and v lie on different devices")
    if q.dim() != q_ndim or k_cache.dim() != 4 or v_cache.dim() != 4:
        raise ValueError(f"{what}: bad ranks q{tuple(q.shape)} "
                         f"k{tuple(k_cache.shape)} v{tuple(v_cache.shape)}")
    if q.dtype not in _DTYPES or not q.dtype == k_cache.dtype == \
            v_cache.dtype:
        raise TypeError(f"{what}: the kernel takes q, k and v of one type, "
                        f"float32 or bfloat16; got q {q.dtype}, k "
                        f"{k_cache.dtype}, v {v_cache.dtype}")
    B, KV, dk = q.shape[0], q.shape[-3], q.shape[-1]
    if k_cache.shape[0] != B or v_cache.shape[0] != B \
            or k_cache.shape[2] != KV or v_cache.shape[2] != KV \
            or k_cache.shape[3] != dk or k_cache.shape[1] != v_cache.shape[1]:
        raise ValueError(f"{what}: shapes disagree: q{tuple(q.shape)} "
                         f"k{tuple(k_cache.shape)} v{tuple(v_cache.shape)}")
    if lengths.shape != (B,):
        raise ValueError(f"{what}: lengths must be ({B},)")
    return (q.contiguous(), k_cache.contiguous(), v_cache.contiguous(),
            lengths.to(device=q.device, dtype=torch.int32).contiguous())


def _scratch(B, KV, S, R, dv, device):
    n_split = (S + CHUNK - 1) // CHUNK
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty((B, KV, n_split, R), **f32),
            torch.empty((B, KV, n_split, R), **f32),
            torch.empty((B, KV, n_split, R, dv), **f32))


def _window(window) -> int:
    return min(int(window), GLOBAL)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def decode_query_attention(q, k_cache, v_cache, lengths, *,
                           window=GLOBAL) -> torch.Tensor:
    """Fused multi-token query decode on the card; (B, Lq, KV, G, dk) ->
    (B, Lq, KV, G, dv) in q's dtype."""
    q, k, v, lens = _check(q, k_cache, v_cache, lengths, 5,
                           "decode_query_attention")
    B, Lq, KV, G, dk = q.shape
    S, dv = v.shape[1], v.shape[3]
    out = torch.empty((B, Lq, KV, G, dv), dtype=q.dtype, device=q.device)
    pm, pl, pacc = _scratch(B, KV, S, Lq * G, dv, q.device)
    err = _lib().stretto_decode_query_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        out.data_ptr(), pm.data_ptr(), pl.data_ptr(), pacc.data_ptr(),
        B, Lq, KV, G, dk, dv, S, _window(window), dk ** -0.5,
        _DTYPES[q.dtype], _stream(q.device))
    build.check(err, "decode_query_attention")
    _count(decode_query_attention)
    return out


def decode_attention(q, k_cache, v_cache, lengths, *,
                     window=GLOBAL) -> torch.Tensor:
    """Single-token flash-decode on the card; (B, KV, G, dk) ->
    (B, KV, G, dv) in q's dtype."""
    q, k, v, lens = _check(q, k_cache, v_cache, lengths, 4,
                           "decode_attention")
    B, KV, G, dk = q.shape
    S, dv = v.shape[1], v.shape[3]
    out = torch.empty((B, KV, G, dv), dtype=q.dtype, device=q.device)
    pm, pl, pacc = _scratch(B, KV, S, G, dv, q.device)
    err = _lib().stretto_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        out.data_ptr(), pm.data_ptr(), pl.data_ptr(), pacc.data_ptr(),
        B, KV, G, dk, dv, S, _window(window), dk ** -0.5,
        _DTYPES[q.dtype], _stream(q.device))
    build.check(err, "decode_attention")
    _count(decode_attention)
    return out


decode_query_attention.launches = 0
decode_attention.launches = 0
