"""Hand-written CUDA kernel D for causal / windowed prefill attention, in
two bodies (`csrc/prefill_attention_tc.cu`, `csrc/prefill_attention.cu`).

Replaces the Pallas `repro.kernels.prefill_attention.prefill_attention`:

  q (B, S, KV, G, dk), k (B, S, KV, dk), v (B, S, KV, dv)
    -> (B, S, KV, G, dv) in q's dtype (float32 or bfloat16)

Query position i sees key position j iff i - j < window and, when
causal, j <= i; the softmax runs online in float32 with the finite mask
-1e30. `window` is an int >= 1 (GLOBAL = 2^30 means full attention;
larger values clamp); 1 <= G <= 64, dk <= 256, dv <= 128.

The body, by one rule (`body()`), from the dtype and head dims alone:

  tc   bfloat16 with dk % 16 == 0 and dv % 16 == 0: wgmma on the tensor
       cores, K / V tiles by TMA (`prefill_attention_tc.cu`; sm_90a)
  fma  everything else (float32, or bf16 head dims the tensor-core tiles
       do not take): float32 FMAs through shared memory
       (`prefill_attention.cu`)

A body is never picked because another failed to build or launch. The
float32 body keeps float32 operands (the planted models' decisions sit at
the float32 tolerance); the tc body feeds P to the tensor cores as two
bf16 parts (high and low), so P V keeps about 16 bits of P. The tc
body's blocked algorithm has a CPU twin,
`kernels/ref.prefill_attention_tc_twin`, for the tests.

CUDA tensors only; the plain version `kernels/ref.prefill_attention_ref`
serves CPU tensors (see `kernels/ops.py`). CUDA tensors without storage
(`FakeTensor`s, a dry run's trace) get their output allocated and the
call reported to `kernels/cost.py`; nothing is built or launched. Launches are counted in
`prefill_attention.launches`, and per body in
`prefill_attention.launches_by_body`. Each source header says what bounds
its body on the H100 and how its design meets it.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build, cost
from repro_torch.kernels.ref import GLOBAL

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_count_lock = threading.Lock()
_bound = set()
BODIES = ("tc", "fma")
# body -> (source, C entry point, argtypes after the 4 pointers and 8 ints)
_ENTRY = {"tc": ("prefill_attention_tc", "stretto_prefill_attention_tc",
                 [_F, _P]),
          "fma": ("prefill_attention", "stretto_prefill_attention",
                  [_F, _I, _P])}


def body(dtype, dk: int, dv: int) -> str:
    """The body that runs these inputs: `tc` for bfloat16 with dk and dv
    multiples of 16 (the wgmma depth and TMA's 16-byte rows), else
    `fma`."""
    if dtype == torch.bfloat16 and dk % 16 == 0 and dv % 16 == 0:
        return "tc"
    return "fma"


def _entry(which: str):
    source, name, tail = _ENTRY[which]
    lib = build.load(source)
    f = getattr(lib, name)
    if which not in _bound:
        f.argtypes = [_P] * 4 + [_I] * 8 + tail
        f.restype = _I
        _bound.add(which)
    return f


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
    which = body(q.dtype, dk, dv)
    if cost.is_fake(q):
        flops, nbytes = cost.prefill_work(B, S, KV, G, dk, dv,
                                          q.element_size(), window, causal)
        cost.report(what, flops, nbytes)
        return out
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            KV, G, dk, dv, window, int(bool(causal)), dk ** -0.5]
    if which == "tc":
        # the tensor maps and the 16-byte loads need 16-byte aligned bases
        # (the strides, multiples of dk or dv elements, are then aligned)
        bad = [n for n, t in (("q", q), ("k", k), ("v", v))
               if t.data_ptr() % 16]
        if bad:
            raise ValueError(f"{what}: the tensor-core body needs 16-byte "
                             f"aligned tensors; {bad} are not")
    else:
        args.append(_DTYPES[q.dtype])
    args.append(torch.cuda.current_stream(q.device).cuda_stream)
    build.check(_entry(which)(*args), what)
    with _count_lock:
        prefill_attention.launches += 1
        prefill_attention.launches_by_body[which] += 1
    return out


def reset_launch_counts() -> None:
    prefill_attention.launches = 0
    prefill_attention.launches_by_body = dict.fromkeys(BODIES, 0)


reset_launch_counts()
