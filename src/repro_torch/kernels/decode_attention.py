"""Hand-written CUDA flash-decode kernels (`csrc/decode_attention.cu`).

  decode_attention        one query token per item: q (B, KV, G, dk) ->
                          (B, KV, G, dv). Replaces the Pallas
                          `repro.kernels.decode_attention.decode_attention`.
  decode_query_attention  Lq query tokens per item in one launch:
                          q (B, Lq, KV, G, dk) -> (B, Lq, KV, G, dv).
                          Replaces the Pallas `decode_query_attention`.

  decode_query_attention_int8, decode_attention_int8
                          the same calls over int8 K/V with float32
                          per-(item, position, head) scales (B, S, KV),
                          dequantised in the kernel as int8 * scale.
                          Replace the Pallas `_query_kernel_int8` and
                          `_decode_kernel_int8` bodies.

  k_cache  (B, S, KV, dk), v_cache (B, S, KV, dv): q's type, float32 or
           bfloat16 (int8 for the *_int8 wrappers)
  lengths  (B,) valid tokens per item (query tokens included)
  window   int; GLOBAL (2^30) means full attention, larger values clamp

A query row that sees no cache position (lengths < Lq, or a window that
excludes every position) gets the mean of V over all S positions, as the
JAX package's kernels and oracles return it.

Every wrapper launches one kernel per call, one body for all four
(splits of SPLIT positions, merged by the last CTA of each (item, KV
head) to arrive); its blocked algorithm, over float32 / bfloat16 or int8
K/V, has a CPU twin, `kernels/ref.decode_query_attention_twin`. The
arrival counters live in an int buffer kept per (device, stream): each
launch leaves it at zero. dk and dv are at most 256.

Every wrapper takes CUDA tensors only and launches the kernel; the plain
versions in `kernels/ref.py` serve CPU tensors (see `kernels/ops.py`).
CUDA tensors without storage (`FakeTensor`s, a dry run's trace) get
their output and scratch allocated and the call reported to
`kernels/cost.py`, with every cache row priced as visible (a fake
`lengths` cannot be read); nothing is built or launched for them.
The source header says what bounds the kernels on the H100 and how the
design meets it. Each wrapper counts its launches in `.launches`.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build, cost
from repro_torch.kernels.ref import GLOBAL

SPLIT = 128           # cache positions per split
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_count_lock = threading.Lock()
_bound = set()
_arrivals = {}                    # (device, stream) -> int32 counters


def _lib():
    lib = build.load("decode_attention")
    if "sig" not in _bound:
        f = lib.stretto_decode_query_attention
        f.argtypes = [_P] * 9 + [_I] * 8 + [_F, _I, _P]
        f.restype = _I
        f = lib.stretto_decode_attention
        f.argtypes = [_P] * 9 + [_I] * 7 + [_F, _I, _P]
        f.restype = _I
        f = lib.stretto_decode_query_attention_int8
        f.argtypes = [_P] * 11 + [_I] * 8 + [_F, _I, _P]
        f.restype = _I
        f = lib.stretto_decode_attention_int8
        f.argtypes = [_P] * 11 + [_I] * 7 + [_F, _I, _P]
        f.restype = _I
        _bound.add("sig")
    return lib


def _count(fn) -> None:
    with _count_lock:
        fn.launches += 1


def _check(q, k_cache, v_cache, lengths, q_ndim: int, what: str,
           k_scale=None, v_scale=None):
    quant = k_scale is not None
    tensors = (q, k_cache, v_cache) + ((k_scale, v_scale) if quant else ())
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{what}: the CUDA kernel takes CUDA tensors only")
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{what}: q, k and v lie on different devices")
    if q.dim() != q_ndim or k_cache.dim() != 4 or v_cache.dim() != 4:
        raise ValueError(f"{what}: bad ranks q{tuple(q.shape)} "
                         f"k{tuple(k_cache.shape)} v{tuple(v_cache.shape)}")
    kv_dtype = torch.int8 if quant else q.dtype
    if q.dtype not in _DTYPES or not kv_dtype == k_cache.dtype == \
            v_cache.dtype:
        raise TypeError(f"{what}: the kernel takes q in float32 or bfloat16 "
                        f"and k, v of type {kv_dtype}; got q {q.dtype}, k "
                        f"{k_cache.dtype}, v {v_cache.dtype}")
    B, KV, dk = q.shape[0], q.shape[-3], q.shape[-1]
    if max(dk, v_cache.shape[-1]) > MAX_HEAD_DIM:
        raise ValueError(f"{what}: the kernel takes dk, dv <= {MAX_HEAD_DIM}"
                         f"; got {dk}, {v_cache.shape[-1]}")
    if k_cache.shape[0] != B or v_cache.shape[0] != B \
            or k_cache.shape[2] != KV or v_cache.shape[2] != KV \
            or k_cache.shape[3] != dk or k_cache.shape[1] != v_cache.shape[1]:
        raise ValueError(f"{what}: shapes disagree: q{tuple(q.shape)} "
                         f"k{tuple(k_cache.shape)} v{tuple(v_cache.shape)}")
    if lengths.shape != (B,):
        raise ValueError(f"{what}: lengths must be ({B},)")
    out = [q.contiguous(), k_cache.contiguous(), v_cache.contiguous(),
           lengths.to(device=q.device, dtype=torch.int32).contiguous()]
    if quant:
        if k_scale.shape != k_cache.shape[:3] \
                or v_scale.shape != v_cache.shape[:3]:
            raise ValueError(f"{what}: scales must be {tuple(k_cache.shape[:3])}"
                             f", got {tuple(k_scale.shape)} and "
                             f"{tuple(v_scale.shape)}")
        out += [k_scale.to(torch.float32).contiguous(),
                v_scale.to(torch.float32).contiguous()]
    return out


def _scratch(B, KV, S, R, dv, device):
    n_split = (S + SPLIT - 1) // SPLIT
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty((B, KV, n_split, R), **f32),
            torch.empty((B, KV, n_split, R), **f32),
            torch.empty((B, KV, n_split, R, dv), **f32))


def _arrival_counters(n: int, device) -> torch.Tensor:
    """At least n int32 counters, all zero, for launches on the current
    stream of `device`. Every launch leaves the counters it used at zero,
    so the buffer is reused; a new one is made only when it must grow."""
    key = (device, _stream(device))
    with _count_lock:
        buf = _arrivals.get(key)
        if buf is None or buf.numel() < n:
            buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
            _arrivals[key] = buf
        return buf


def _window(window) -> int:
    return min(int(window), GLOBAL)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _shape_only(fn, out, q, k, v, window, scale_bytes=0):
    """The call on fake tensors: report its work (every cache row
    visible) and return the allocated output."""
    B, KV, G, dk = q.shape[0], q.shape[-3], q.shape[-2], q.shape[-1]
    Lq = q.shape[1] if q.dim() == 5 else 1
    S, dv = v.shape[1], v.shape[3]
    flops, nbytes = cost.decode_work(B, Lq, KV, G, dk, dv, S, [S] * B,
                                     _window(window), q.element_size(),
                                     k.element_size(), scale_bytes)
    cost.report(fn.__name__, flops, nbytes)
    return out


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
    if cost.is_fake(q):
        return _shape_only(decode_query_attention, out, q, k, v, window)
    arrivals = _arrival_counters(B * KV, q.device)
    err = _lib().stretto_decode_query_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        out.data_ptr(), pm.data_ptr(), pl.data_ptr(), pacc.data_ptr(),
        arrivals.data_ptr(), B, Lq, KV, G, dk, dv, S, _window(window),
        dk ** -0.5,
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
    if cost.is_fake(q):
        return _shape_only(decode_attention, out, q, k, v, window)
    arrivals = _arrival_counters(B * KV, q.device)
    err = _lib().stretto_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        out.data_ptr(), pm.data_ptr(), pl.data_ptr(), pacc.data_ptr(),
        arrivals.data_ptr(), B, KV, G, dk, dv, S, _window(window),
        dk ** -0.5,
        _DTYPES[q.dtype], _stream(q.device))
    build.check(err, "decode_attention")
    _count(decode_attention)
    return out


def decode_query_attention_int8(q, k_cache, v_cache, k_scale, v_scale,
                                lengths, *, window=GLOBAL) -> torch.Tensor:
    """Fused multi-token query decode over int8 K/V with (B, S, KV)
    float32 scales; (B, Lq, KV, G, dk) -> (B, Lq, KV, G, dv) in q's
    dtype."""
    q, k, v, lens, ks, vs = _check(q, k_cache, v_cache, lengths, 5,
                                   "decode_query_attention_int8",
                                   k_scale, v_scale)
    B, Lq, KV, G, dk = q.shape
    S, dv = v.shape[1], v.shape[3]
    out = torch.empty((B, Lq, KV, G, dv), dtype=q.dtype, device=q.device)
    pm, pl, pacc = _scratch(B, KV, S, Lq * G, dv, q.device)
    if cost.is_fake(q):
        return _shape_only(decode_query_attention_int8, out, q, k, v,
                           window, 8)
    arrivals = _arrival_counters(B * KV, q.device)
    err = _lib().stretto_decode_query_attention_int8(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ks.data_ptr(),
        vs.data_ptr(), lens.data_ptr(), out.data_ptr(), pm.data_ptr(),
        pl.data_ptr(), pacc.data_ptr(), arrivals.data_ptr(), B, Lq, KV, G,
        dk, dv, S, _window(window), dk ** -0.5, _DTYPES[q.dtype],
        _stream(q.device))
    build.check(err, "decode_query_attention_int8")
    _count(decode_query_attention_int8)
    return out


def decode_attention_int8(q, k_cache, v_cache, k_scale, v_scale, lengths, *,
                          window=GLOBAL) -> torch.Tensor:
    """Single-token flash-decode over int8 K/V with (B, S, KV) float32
    scales; (B, KV, G, dk) -> (B, KV, G, dv) in q's dtype."""
    q, k, v, lens, ks, vs = _check(q, k_cache, v_cache, lengths, 4,
                                   "decode_attention_int8", k_scale, v_scale)
    B, KV, G, dk = q.shape
    S, dv = v.shape[1], v.shape[3]
    out = torch.empty((B, KV, G, dv), dtype=q.dtype, device=q.device)
    pm, pl, pacc = _scratch(B, KV, S, G, dv, q.device)
    if cost.is_fake(q):
        return _shape_only(decode_attention_int8, out, q, k, v,
                           window, 8)
    arrivals = _arrival_counters(B * KV, q.device)
    err = _lib().stretto_decode_attention_int8(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ks.data_ptr(),
        vs.data_ptr(), lens.data_ptr(), out.data_ptr(), pm.data_ptr(),
        pl.data_ptr(), pacc.data_ptr(), arrivals.data_ptr(), B, KV, G, dk,
        dv, S, _window(window), dk ** -0.5, _DTYPES[q.dtype],
        _stream(q.device))
    build.check(err, "decode_attention_int8")
    _count(decode_attention_int8)
    return out


decode_query_attention.launches = 0
decode_attention.launches = 0
decode_query_attention_int8.launches = 0
decode_attention_int8.launches = 0
