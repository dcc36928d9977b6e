"""Bayesian credible lower bounds on precision/recall (paper §3.1, Eq. 8-9).

The port of `repro.core.bounds`, in float32 as the JAX package runs it.

Recall_D | sample  ~  Beta(1 + TP, 1 + FN)      (uninformative Beta(1,1) prior)
lower bound  l_a   =  quantile(1 - a)  of that posterior
                   =  betaincinv(1 + TP, 1 + FN, 1 - a)

The planner optimizes *against* these bounds with gradient descent, so the
inverse regularized incomplete beta function must be differentiable in
(a, b) = (1+TP, 1+FN). `torch.special` has neither `betainc` nor `betaln`,
and scipy is not used (the reference avoids it too), so:

  betainc     the regularized incomplete beta I(x; a, b), by the modified
              Lentz continued fraction (DLMF 8.17.22), with the symmetry
              I(x; a, b) = 1 - I(1-x; b, a) where the fraction converges
              slowly; the same recipe, iteration cap and tolerance as
              XLA's float32 implementation behind `jax.scipy.special.
              betainc`, and XLA's Lanczos log-gamma
  betaln      log B(a, b) from `torch.lgamma`, taken in float64
  betaincinv  a `torch.autograd.Function`: the forward is the 60-step
              bisection on betainc, the backward the implicit function
              theorem, I(x; a, b) = q with q fixed:
                  dx/da = -(dI/da) / pdf(x; a, b)   dI/da by central
                  dx/db = -(dI/db) / pdf(x; a, b)   differences
                  dx/dq = 1 / pdf(x; a, b)

The bisection and the backward's betainc terms go through
`kernels.ops`: on CUDA tensors kernel E (`csrc/beta_bounds.cu`, one
launch each, no host sync, so an Adam step can be captured in a CUDA
graph), on CPU tensors the plain versions in `kernels/ref.py`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import (_betaincinv_bisect, _f32,  # noqa: F401
                                     betainc, betaln, fd_grads)


class _BetaIncInv(torch.autograd.Function):

    @staticmethod
    def forward(ctx, a, b, q):
        with torch.no_grad():
            x = ops.beta_incinv(a, b, q)
        ctx.save_for_backward(a, b, q, x)
        return x

    @staticmethod
    def backward(ctx, g):
        a, b, q, x = ctx.saved_tensors
        with torch.no_grad():
            fd, pdf = ops.beta_incinv_grad_terms(a, b, x)
            dIda, dIdb = fd_grads(fd, a, b)
            grads = (g * -dIda / pdf, g * -dIdb / pdf, g / pdf)
        return tuple(
            _sum_to(gr, t.shape) if need else None
            for gr, t, need in zip(grads, (a, b, q), ctx.needs_input_grad))


def _sum_to(grad, shape):
    """Reduce a broadcast gradient back to an input's shape."""
    while grad.dim() > len(shape):
        grad = grad.sum(0)
    for i, n in enumerate(shape):
        if n == 1 and grad.shape[i] != 1:
            grad = grad.sum(i, keepdim=True)
    return grad


def betaincinv(a, b, q) -> torch.Tensor:
    """x such that I(x; a, b) = q. Differentiable in a, b (and q). b and
    q join a's device."""
    a = _f32(a)
    b, q = (_f32(t).to(a.device) for t in (b, q))
    return _BetaIncInv.apply(a, b, q)


def beta_lower_bound(successes, failures, credibility: float = 0.95):
    """l such that P(rate >= l | successes, failures) = credibility.

    Differentiable in (successes, failures): soft counts welcome."""
    a = 1.0 + _f32(successes)
    b = 1.0 + _f32(failures)
    # filled on a's device: no host copy inside a captured step
    q = a.new_full((), 1.0 - credibility)
    return betaincinv(a, b, q)


def recall_lower_bound(tp, fn, credibility: float = 0.95):
    return beta_lower_bound(tp, fn, credibility)


def precision_lower_bound(tp, fp, credibility: float = 0.95):
    return beta_lower_bound(tp, fp, credibility)
