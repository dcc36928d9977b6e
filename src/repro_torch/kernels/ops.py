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
plain version. A fake CUDA tensor (shape and dtype, no storage: a dry
run's trace, `launch/op_count.fake_cuda`) takes the same route to the
kernel's wrapper, which allocates the output, reports the call's work
to `kernels/cost.py` and builds and launches nothing.

int8 KV caches (with per-token scales) launch the int8 CUDA kernels,
which dequantise in the kernel; the plain versions dequantise up front.

The planner's Beta bounds (`beta_incinv`, `beta_incinv_grad_terms`)
launch kernel E on CUDA tensors; their plain versions are the float32
recipe `core/bounds.py` has always run. `capture_graph` captures a step
that launches E as a CUDA graph whose replays count E's launches.
"""
from __future__ import annotations

import os
from typing import Callable

import torch

from repro_torch.kernels import ref
from repro_torch.kernels import beta_bounds as _bb
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import expected_attention as _ea
from repro_torch.kernels import prefill_attention as _pa
from repro_torch.kernels.ref import GLOBAL

VALID_BACKENDS = ("auto", "cuda", "ref")
ENV_VAR = "STRETTO_TORCH_KERNELS"
KERNELS = {
    "decode_query_attention": _da.decode_query_attention,
    "decode_query_attention_int8": _da.decode_query_attention_int8,
    "decode_attention": _da.decode_attention,
    "decode_attention_int8": _da.decode_attention_int8,
    "expected_attention_scores": _ea.expected_attention_scores,
    "prefill_attention": _pa.prefill_attention,
    "beta_incinv": _bb.beta_incinv,
    "beta_incinv_grad_terms": _bb.beta_incinv_grad_terms,
}


def resolve_backend(backend=None) -> str:
    """Explicit arg wins, else STRETTO_TORCH_KERNELS (read now), else auto."""
    if backend is None or backend == "":
        backend = os.environ.get(ENV_VAR, "auto") or "auto"
    if backend not in VALID_BACKENDS:
        raise ValueError(f"unknown kernels backend {backend!r}; expected one "
                         f"of {VALID_BACKENDS}")
    return backend


def use_kernel(backend, x: torch.Tensor, *inputs) -> bool:
    """True when the call must launch the CUDA kernel for tensor `x`.
    `inputs` are the call's other tensor inputs (None is skipped). The
    kernels have no backward: a launch under grad mode with an input that
    requires grad raises, where it would silently cut the graph."""
    backend = resolve_backend(backend)
    if backend == "ref":
        return False
    if backend == "cuda" and not x.is_cuda:
        raise ValueError(f"kernels backend 'cuda' needs CUDA tensors, got a "
                         f"tensor on {x.device}")
    if x.is_cuda and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x,) + inputs):
        raise RuntimeError(
            "a CUDA kernel of kernels.ops was reached under autograd with "
            "an input that requires grad; the kernels have no backward. "
            "Take the differentiable route (models.forward(..., "
            "differentiable=True)) or run under torch.no_grad()")
    return x.is_cuda


def launch_counts() -> dict:
    """Launches per kernel, plus D's per body under
    `prefill_attention_by_body` ({"tc": n, "fma": n})."""
    counts = {name: fn.launches for name, fn in KERNELS.items()}
    counts["prefill_attention_by_body"] = dict(
        _pa.prefill_attention.launches_by_body)
    return counts


GRAPH_WARMUP = 2        # eager steps on the side stream before a capture


def capture_graph(step: Callable[[], None], reset: Callable[[], None],
                  device) -> Callable[[], None]:
    """Capture `step` (no host sync inside) as one CUDA graph on `device`:
    it runs GRAPH_WARMUP times on a side stream first (as PyTorch's graph
    notes ask), then `reset()` puts its state back, then one `step` is
    captured. Returns `replay()`, which replays the graph and adds the
    kernel launches it holds to their counts (those recorded on the side
    stream, from any thread: autograd runs a backward on its own thread).
    The capture is thread-local: other threads may keep using the card
    meanwhile, on their own streams."""
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        for _ in range(GRAPH_WARMUP):
            step()
        reset()
        before = _bb.captured_counts(side.cuda_stream)
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            step()
        finally:
            graph.capture_end()
    cur.wait_stream(side)
    held = {k: n - before.get(k, 0)
            for k, n in _bb.captured_counts(side.cuda_stream).items()}

    def replay() -> None:
        graph.replay()
        _bb.count_replays(held, 1)
    return replay


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    _pa.reset_launch_counts()


def decode_attention(q, k_cache, v_cache, lengths, *, window=GLOBAL,
                     backend=None, k_scale=None, v_scale=None):
    """Single-query flash-decode; (B, KV, G, dk) -> (B, KV, G, dv).
    With k_scale / v_scale (B, S, KV), k_cache / v_cache are int8."""
    quant = k_scale is not None
    if use_kernel(backend, q, k_cache, v_cache, k_scale, v_scale):
        if quant:
            return _da.decode_attention_int8(q, k_cache, v_cache, k_scale,
                                             v_scale, lengths, window=window)
        if q.dtype == torch.float32 and k_cache.dtype != q.dtype:
            # a float32 hymba's int8 rung dequantises K/V to bfloat16; the
            # plain version computes over them in float32, so widen them
            # (exactly) to q's type for the float32 body
            k_cache, v_cache = k_cache.float(), v_cache.float()
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
    if use_kernel(backend, q, k_cache, v_cache, k_scale, v_scale):
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


def prefill_attention(q, k, v, *, window=GLOBAL, causal: bool = True,
                      backend=None):
    """Causal / windowed flash attention over whole sequences;
    q (B, S, KV, G, dk), k (B, S, KV, dk), v (B, S, KV, dv) ->
    (B, S, KV, G, dv). `window` must be >= 1."""
    window = _pa.check_window(window)
    if use_kernel(backend, q, k, v):
        return _pa.prefill_attention(q, k, v, window=window, causal=causal)
    return ref.prefill_attention_ref(q, k, v, window=window, causal=causal)


def expected_attention_scores(k_cache, mu, sig2, *, backend=None):
    """Expected-Attention keep-scores; k ([L,] B, S, KV, dk) with stats
    ([L,] KV, G, dk) -> ([L,] B, S, KV) float32, one launch on the card."""
    if use_kernel(backend, k_cache, mu, sig2):
        return _ea.expected_attention_scores(k_cache, mu, sig2)
    return ref.expected_attention_scores_ref(k_cache, mu, sig2)


def beta_incinv(a, b, q, *, backend=None):
    """x with I(x; a, b) = q (the regularized incomplete beta), float32,
    elementwise over the broadcast shape: a 60-step bisection."""
    if use_kernel(backend, a, b, q):
        return _bb.beta_incinv(a, b, q)
    return ref.betaincinv_ref(a, b, q)


def beta_incinv_grad_terms(a, b, x, *, backend=None):
    """The terms of betaincinv's gradient at its root x: (fd, pdf), fd
    the betainc values at (a + ha, b), (a - ha, b), (a, b + hb),
    (a, b - hb) stacked on a leading axis of 4, pdf the Beta(a, b)
    density (x clamped to [1e-12, 1], pdf floored at 1e-30)."""
    if use_kernel(backend, a, b, x):
        return _bb.beta_incinv_grad_terms(a, b, x)
    return ref.betaincinv_grad_terms_ref(a, b, x)
