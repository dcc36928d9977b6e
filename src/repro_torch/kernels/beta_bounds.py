"""Hand-written CUDA kernel for the planner's Beta credible bounds
(`csrc/beta_bounds.cu`, kernel E).

No Pallas kernel stands behind it: the JAX package's `repro.core.bounds`
(betaincinv by bisection on betainc's continued fraction) is compiled by
XLA into fused while-loops inside the optimizer's jit. E is the port's
counterpart of that compiled code, so that an Adam step can be one CUDA
graph with no host sync (`core/optimizer.py`):

  beta_incinv(a, b, q)            x with I(x; a, b) = q, elementwise over
                                  the broadcast shape, float32
  beta_incinv_grad_terms(a, b, x) (fd, pdf): betainc at (a + ha, b),
                                  (a - ha, b), (a, b + hb), (a, b - hb)
                                  stacked on a leading axis of 4, and the
                                  Beta pdf, at x clamped to [1e-12, 1]

CUDA tensors only; the plain versions in `kernels/ref.py` serve CPU
tensors (see `kernels/ops.py`). Launches are counted in each function's
`launches`. A launch recorded into a CUDA graph under capture is counted
apart, per stream it was recorded on (`captured_counts`: the backward of
a captured step launches from autograd's thread, on the step's stream);
`ops.capture_graph` returns a replay that adds the launches its graph
holds.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build

_P, _L = ctypes.c_void_p, ctypes.c_longlong
_count_lock = threading.Lock()
_bound = set()
_captured = {}      # stream handle -> {function name: launches captured}


def _lib():
    lib = build.load("beta_bounds")
    if "sig" not in _bound:
        lib.stretto_beta_incinv.argtypes = [_P] * 4 + [_L, _P]
        lib.stretto_beta_incinv.restype = ctypes.c_int
        lib.stretto_beta_incinv_grad.argtypes = [_P] * 5 + [_L, _P]
        lib.stretto_beta_incinv_grad.restype = ctypes.c_int
        _bound.add("sig")
    return lib


def _operands(what, *ts):
    if not all(t.is_cuda for t in ts):
        raise ValueError(f"{what}: the CUDA kernel takes CUDA tensors only")
    if any(t.device != ts[0].device for t in ts):
        raise ValueError(f"{what}: the operands lie on different devices")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"{what}: float32 operands expected, got "
                        f"{[t.dtype for t in ts]}")
    return [t.contiguous() for t in torch.broadcast_tensors(*ts)]


def _count(fn, stream: int) -> None:
    with _count_lock:
        if torch.cuda.is_current_stream_capturing():
            counts = _captured.setdefault(stream, {})
            counts[fn.__name__] = counts.get(fn.__name__, 0) + 1
        else:
            fn.launches += 1


def beta_incinv(a, b, q) -> torch.Tensor:
    what = "beta_incinv"
    a, b, q = _operands(what, a, b, q)
    x = torch.empty_like(a)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _lib().stretto_beta_incinv(
        a.data_ptr(), b.data_ptr(), q.data_ptr(), x.data_ptr(), a.numel(),
        stream)
    build.check(err, what)
    _count(beta_incinv, stream)
    return x


def beta_incinv_grad_terms(a, b, x):
    what = "beta_incinv_grad_terms"
    a, b, x = _operands(what, a, b, x)
    fd = torch.empty((4,) + tuple(a.shape), dtype=torch.float32,
                     device=a.device)
    pdf = torch.empty_like(a)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _lib().stretto_beta_incinv_grad(
        a.data_ptr(), b.data_ptr(), x.data_ptr(), fd.data_ptr(),
        pdf.data_ptr(), a.numel(), stream)
    build.check(err, what)
    _count(beta_incinv_grad_terms, stream)
    return fd, pdf


def count_replays(captured: dict, replays: int) -> None:
    """Add the launches of `replays` replays of a graph that captured
    `captured[fn_name]` launches of each function."""
    with _count_lock:
        for fn in KERNELS:
            fn.launches += captured.get(fn.__name__, 0) * replays


def captured_counts(stream: int) -> dict:
    """Launches of each function recorded under capture on `stream` (a
    `cuda_stream` handle)."""
    with _count_lock:
        return dict(_captured.get(stream, {}))


KERNELS = (beta_incinv, beta_incinv_grad_terms)
for _fn in KERNELS:
    _fn.launches = 0
