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
"""
from __future__ import annotations

import math

import torch

_F32 = torch.float32
_EPS = torch.finfo(_F32).eps / 2          # Lentz "small" and tolerance
_TINY = torch.finfo(_F32).tiny * 2
_CF_ITERS = 200                           # XLA's cap for float32
_LEVELS = 6                               # bisection levels per betainc call
# Lanczos approximation (g = 7, n = 9), as XLA evaluates lgamma
_LANCZOS_G = 7.0
_LANCZOS_BASE = 0.99999999999980993227684700473478
_LANCZOS = (676.520368121885098567009190444019,
            -1259.13921672240287047156078755283,
            771.3234287776530788486528258894,
            -176.61502916214059906584551354,
            12.507343278686904814458936853,
            -0.13857109526572011689554707,
            9.984369578019570859563e-6,
            1.50563273514931155834e-7)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_F32)


def _lgamma(x: torch.Tensor) -> torch.Tensor:
    """log Gamma(x) in float32 by XLA's Lanczos recipe for x >= 0.5 (all
    the betainc calls here have a, b >= 0.5), `torch.lgamma` below."""
    z = x - 1.0
    s = torch.full_like(x, _LANCZOS_BASE)
    for i, c in enumerate(_LANCZOS):
        s = s + c / (z + float(i) + 1.0)
    t = (_LANCZOS_G + 0.5) + z
    log_t = math.log(_LANCZOS_G + 0.5) + torch.log1p(z / (_LANCZOS_G + 0.5))
    out = (0.5 * (math.log(2.0) + math.log(math.pi))
           + (z + 0.5 - t / log_t) * log_t + torch.log(s))
    return torch.where(x >= 0.5, out, torch.lgamma(x))


def betaln(a, b) -> torch.Tensor:
    """log B(a, b) = lgamma(a) + lgamma(b) - lgamma(a + b), evaluated in
    float64 (the float32 difference of three large lgammas cancels)."""
    a64 = _f32(a).double()
    b64 = _f32(b).double()
    return (torch.lgamma(a64) + torch.lgamma(b64)
            - torch.lgamma(a64 + b64)).to(_F32)


def _continued_fraction(a, b, x):
    """Modified Lentz evaluation of the incomplete beta fraction. Each
    element stops at its own convergence (as under the JAX package's vmap
    over restarts), so its value does not depend on the other elements of
    the call."""
    one = torch.ones_like(a)
    small = torch.full_like(a, _EPS)
    h = small.clone()                     # partial denominator 0 is 0
    c = h.clone()
    d = torch.zeros_like(a)
    active = torch.ones_like(a, dtype=torch.bool)
    for it in range(1, _CF_ITERS):
        if it == 1:
            num = one
        elif it % 2 == 0:
            m = float((it - 1) // 2)
            if m == 0:
                num = -(a + b) * x / (a + one)
            else:
                num = -(a + m) * (a + b + m) * x / (
                    (a + 2 * m) * (a + 2 * m + one))
        else:
            m = float((it - 1) // 2)
            num = m * (b - m) * x / ((a + 2 * m - one) * (a + 2 * m))
        c_new = one + num / c
        c_new = torch.where(c_new.abs() < small, small, c_new)
        d_new = one + num * d
        d_new = torch.where(d_new.abs() < small, small, d_new)
        d_new = 1.0 / d_new
        delta = c_new * d_new
        h = torch.where(active, h * delta, h)
        c = torch.where(active, c_new, c)
        d = torch.where(active, d_new, d)
        active = active & ((delta - 1.0).abs() >= _EPS)
        if not bool(active.any()):
            break
    return h


def betainc(a, b, x) -> torch.Tensor:
    """Regularized incomplete beta I(x; a, b), elementwise, float32, for
    a, b > 0 and 0 <= x <= 1. Not differentiable (betaincinv supplies its
    own gradient)."""
    a, b, x = torch.broadcast_tensors(_f32(a), _f32(b), _f32(x))
    with torch.no_grad():
        rapid = x < (a + 1.0) / (a + b + 2.0)
        a2 = torch.where(rapid, a, b)
        b2 = torch.where(rapid, b, a)
        x2 = torch.where(rapid, x, 1.0 - x)
        cf = _continued_fraction(a2, b2, x2)
        lbeta_small_a = _lgamma(b2) - _lgamma(a2 + b2)
        lbeta = _lgamma(a2) + lbeta_small_a
        factor = torch.where(
            a2 < _TINY, torch.exp(torch.log1p(-x2) * b2 - lbeta_small_a),
            torch.exp(torch.log(x2) * a2 + torch.log1p(-x2) * b2 - lbeta)
            / a2)
        out = cf * factor
        return torch.where(rapid, out, 1.0 - out)


def _beta_logpdf(x, a, b):
    return ((a - 1.0) * torch.log(x) + (b - 1.0) * torch.log1p(-x)
            - betaln(a, b))


def _betaincinv_bisect(a, b, q, iters: int = 60):
    """The 60-step bisection of the JAX package, `_LEVELS` steps per
    betainc call: the 2^L - 1 midpoints the next L steps could visit are
    computed as the sequential steps compute them (0.5 * (lo + hi) in
    float32) and scored in one vectorised call, then the L steps walk that
    tree, so lo and hi follow exactly the sequential path. Once every
    midpoint equals lo or hi the path is fixed (lo only ever holds points
    below q, hi points at or above it) and the remaining steps are
    skipped."""
    a, b, q = torch.broadcast_tensors(a, b, q)
    lo = torch.zeros_like(q).reshape(-1, 1)
    hi = torch.ones_like(q).reshape(-1, 1)
    af, bf, qf = (t.reshape(-1, 1) for t in (a, b, q))
    done = 0
    while done < iters:
        levels = min(_LEVELS, iters - done)
        # level k holds the 2^k intervals the first k steps can reach;
        # node j's children are 2j (not below: hi = mid) and 2j + 1
        # (below: lo = mid)
        mids, l_k, h_k = [], lo, hi
        for _ in range(levels):
            m_k = 0.5 * (l_k + h_k)
            mids.append(m_k)
            l_k = torch.stack([l_k, m_k], -1).flatten(-2)
            h_k = torch.stack([m_k, h_k], -1).flatten(-2)
        if bool(((mids[0] == lo) | (mids[0] == hi)).all()):
            break
        pts = torch.cat(mids, -1)                    # (n, 2^L - 1)
        below = betainc(af, bf, pts) < qf
        node = torch.zeros_like(lo, dtype=torch.long)
        for k in range(levels):
            idx = node + ((1 << k) - 1)              # offset of level k
            mid = pts.gather(1, idx)
            bel = below.gather(1, idx)
            lo = torch.where(bel, mid, lo)
            hi = torch.where(bel, hi, mid)
            node = 2 * node + bel.long()
        done += levels
    return (0.5 * (lo + hi)).reshape(q.shape)


class _BetaIncInv(torch.autograd.Function):

    @staticmethod
    def forward(ctx, a, b, q):
        with torch.no_grad():
            x = _betaincinv_bisect(a, b, q)
        ctx.save_for_backward(a, b, q, x)
        return x

    @staticmethod
    def backward(ctx, g):
        a, b, q, x = ctx.saved_tensors
        with torch.no_grad():
            x = torch.clamp(x, 1e-12, 1.0 - 1e-12)
            pdf = torch.clamp(torch.exp(_beta_logpdf(x, a, b)), min=1e-30)
            ha = 1e-4 * torch.clamp(a, min=1.0)
            hb = 1e-4 * torch.clamp(b, min=1.0)
            # the four central-difference evaluations in one call
            fd = betainc(torch.stack([a + ha, a - ha, a, a]),
                         torch.stack([b, b, b + hb, b - hb]), x)
            dIda = (fd[0] - fd[1]) / (2 * ha)
            dIdb = (fd[2] - fd[3]) / (2 * hb)
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
    """x such that I(x; a, b) = q. Differentiable in a, b (and q)."""
    return _BetaIncInv.apply(_f32(a), _f32(b), _f32(q))


def beta_lower_bound(successes, failures, credibility: float = 0.95):
    """l such that P(rate >= l | successes, failures) = credibility.

    Differentiable in (successes, failures): soft counts welcome."""
    a = 1.0 + _f32(successes)
    b = 1.0 + _f32(failures)
    q = _f32(1.0 - credibility)
    return betaincinv(a, b, q)


def recall_lower_bound(tp, fn, credibility: float = 0.95):
    return beta_lower_bound(tp, fn, credibility)


def precision_lower_bound(tp, fp, credibility: float = 0.95):
    return beta_lower_bound(tp, fp, credibility)
