"""Hand-written CUDA kernel for causal / windowed prefill attention
(`csrc/prefill_attention.cu`).

Replaces the Pallas `repro.kernels.prefill_attention.prefill_attention`:

  q (B, S, KV, G, dk), k (B, S, KV, dk), v (B, S, KV, dv)
    -> (B, S, KV, G, dv) in q's dtype (float32 or bfloat16)

Query position i sees key position j iff i - j < window and, when
causal, j <= i; the softmax runs online in float32 with the finite mask
-1e30. `window` is an int >= 1 (GLOBAL = 2^30 means full attention;
larger values clamp); 1 <= G <= 64, dk <= 256, dv <= 128.

CUDA tensors only; the plain version `kernels/ref.prefill_attention_ref`
serves CPU tensors (see `kernels/ops.py`). Launches are counted in
`prefill_attention.launches`. The source header says what bounds the
kernel on the H100 and how its design meets it.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import GLOBAL

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_count_lock = threading.Lock()
_bound = set()


def _lib():
    lib = build.load("prefill_attention")
    if "sig" not in _bound:
        f = lib.stretto_prefill_attention
        f.argtypes = [_P] * 4 + [_I] * 8 + [_F, _I, _P]
        f.restype = _I
        _bound.add("sig")
    return lib


def check_window(window) -> int:
    """The window as the kernels take it: an int in [1, GLOBAL]. Below 1
    no key is visible and the Pallas result depends on its block size, so
    it is refused."""
    window = int(window)
    if window < 1:
        raise ValueError(f"prefill_attention: window must be >= 1, got "
                         f"{window}")
    return min(window, GLOBAL)


def prefill_attention(q, k, v, *, window=GLOBAL,
                      causal: bool = True) -> torch.Tensor:
    """Flash attention over whole sequences on the card;
    (B, S, KV, G, dk) -> (B, S, KV, G, dv) in q's dtype."""
    what = "prefill_attention"
    window = check_window(window)
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(f"{what}: the CUDA kernel takes CUDA tensors only")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{what}: q, k and v lie on different devices")
    if q.dim() != 5 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{what}: bad ranks q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if q.dtype not in _DTYPES or not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"{what}: q, k and v must share float32 or "
                        f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    B, S, KV, G, dk = q.shape
    dv = v.shape[3]
    if tuple(k.shape) != (B, S, KV, dk) or tuple(v.shape[:3]) != (B, S, KV):
        raise ValueError(f"{what}: shapes disagree: q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if not (1 <= G <= 64 and dk <= 256 and dv <= 128):
        raise ValueError(f"{what}: the kernel takes 1 <= G <= 64, dk <= 256 "
                         f"and dv <= 128; got G {G}, dk {dk}, dv {dv}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty((B, S, KV, G, dv), dtype=q.dtype, device=q.device)
    err = _lib().stretto_prefill_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, KV,
        G, dk, dv, window, int(bool(causal)), dk ** -0.5, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, what)
    with _count_lock:
        prefill_attention.launches += 1
    return out


prefill_attention.launches = 0
