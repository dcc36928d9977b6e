"""The port's Beta credible bounds against the JAX package's.

The same numpy inputs go through `jax.scipy.special.betainc` / `betaln`,
`repro.core.bounds` (with `jax.grad`) and `repro_torch.core.bounds`, over
the range the planner produces: soft counts from 0 to a few hundred, so
a, b = 1 + count in [1, 400].

Tolerances, all float32 as the JAX package runs it:
  betainc      atol 1e-4. Both follow XLA's continued fraction; their
               log-gamma and exp/log round differently, and at a, b of a
               few hundred the prefactor exp(a log x + b log1p(-x) - lbeta)
               carries ~1e-5 of that rounding (each is within 4e-5 of a
               float64 reference there).
  betaln       atol 5e-4 absolute on values up to ~300: the port takes it in
               float64, the reference in float32.
  betaincinv   atol 2e-5: the bisection lands on the float where the two
               betaincs cross q, and their difference moves it by < 1e-5.
  gradients    rtol 5e-2 + atol 2e-4: both are central differences of a
               float32 betainc with step 1e-4 * a, whose rounding noise
               (~1e-6) is divided by the step; near counts of a few hundred
               that noise is a few percent of the gradient on either side.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.scipy.special import betainc as jbetainc
from jax.scipy.special import betaln as jbetaln

from repro.core import bounds as JB
from repro_torch.core import bounds as TB


def _grid(seed, n=64, hi=400.0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(1.0, hi, n).astype(np.float32)
    b = rng.uniform(1.0, hi, n).astype(np.float32)
    x = rng.uniform(0.0, 1.0, n).astype(np.float32)
    return a, b, x


@pytest.mark.parametrize("seed,hi", [(0, 400.0), (1, 30.0), (2, 3.0)])
def test_betainc_matches_jax(seed, hi):
    a, b, x = _grid(seed, hi=hi)
    want = np.asarray(jbetainc(a, b, x))
    got = TB.betainc(torch.from_numpy(a), torch.from_numpy(b),
                     torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_betainc_edges_and_batch_independence():
    a = torch.tensor([2.0, 5.0, 300.0])
    b = torch.tensor([3.0, 1.0, 40.0])
    assert TB.betainc(a, b, torch.zeros(3)).tolist() == [0.0, 0.0, 0.0]
    assert TB.betainc(a, b, torch.ones(3)).tolist() == [1.0, 1.0, 1.0]
    # an element's value does not depend on the other elements of the call
    x = torch.tensor([0.3, 0.9, 0.88])
    whole = TB.betainc(a, b, x)
    for i in range(3):
        assert torch.equal(TB.betainc(a[i:i + 1], b[i:i + 1], x[i:i + 1]),
                           whole[i:i + 1])


def test_betaln_matches_jax():
    a, b, _ = _grid(3, hi=300.0)
    want = np.asarray(jbetaln(a, b))
    got = TB.betaln(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)


@pytest.mark.parametrize("q", [0.05, 0.5, 0.95])
def test_betaincinv_matches_jax(q):
    a, b, _ = _grid(4, n=40, hi=300.0)
    want = np.asarray(JB.betaincinv(jnp.asarray(a), jnp.asarray(b),
                                    jnp.full(a.shape, q, jnp.float32)))
    got = TB.betaincinv(torch.from_numpy(a), torch.from_numpy(b),
                        torch.tensor(q)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_tree_bisection_is_the_sequential_bisection():
    """The port scores six bisection levels per betainc call; lo and hi
    must follow the 60 sequential steps exactly."""
    a, b, _ = _grid(5, n=24, hi=200.0)
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    for q in (0.05, 0.5, 0.999):
        q = torch.tensor(q)
        lo, hi = torch.zeros_like(a), torch.ones_like(a)
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            below = TB.betainc(a, b, mid) < q
            lo = torch.where(below, mid, lo)
            hi = torch.where(below, hi, mid)
        assert torch.equal(TB._betaincinv_bisect(a, b, q), 0.5 * (lo + hi))


COUNTS = [(10.3, 2.2, 0.95), (150.0, 30.5, 0.95), (3.1, 0.4, 0.95),
          (42.0, 7.5, 0.9), (0.0, 0.0, 0.95), (250.0, 1.0, 0.99)]


@pytest.mark.parametrize("which", ["recall", "precision"])
@pytest.mark.parametrize("tp,miss,cred", COUNTS)
def test_bound_values_and_gradients_match_jax(which, tp, miss, cred):
    jfn = JB.recall_lower_bound if which == "recall" \
        else JB.precision_lower_bound
    tfn = TB.recall_lower_bound if which == "recall" \
        else TB.precision_lower_bound
    jval, jgrad = jax.value_and_grad(
        lambda t, m: jfn(t, m, cred), argnums=(0, 1))(
            jnp.float32(tp), jnp.float32(miss))
    t = torch.tensor(tp, requires_grad=True)
    m = torch.tensor(miss, requires_grad=True)
    val = tfn(t, m, cred)
    val.backward()
    assert abs(float(val.detach()) - float(jval)) < 2e-5
    for got, want in ((t.grad, jgrad[0]), (m.grad, jgrad[1])):
        np.testing.assert_allclose(float(got), float(want), rtol=5e-2,
                                   atol=2e-4)


def test_batched_bounds_match_scalar_calls():
    """The optimizer asks for every restart's bounds in one call; each
    element equals its own scalar call, gradient included."""
    tp = torch.tensor([10.3, 150.0, 3.1], requires_grad=True)
    fn = torch.tensor([2.2, 30.5, 0.4], requires_grad=True)
    TB.recall_lower_bound(tp, fn).sum().backward()
    for i in range(3):
        t = tp[i].detach().clone().requires_grad_(True)
        f = fn[i].detach().clone().requires_grad_(True)
        TB.recall_lower_bound(t, f).backward()
        assert torch.equal(t.grad, tp.grad[i])
        assert torch.equal(f.grad, fn.grad[i])


# ---------------------------------------------------------------------------
# kernel E's twin (kernels/ref.py): the per-element loops of
# csrc/beta_bounds.cu, exits as masks, no host sync
# ---------------------------------------------------------------------------

def _wide_grid(seed, n=48):
    """a, b log-uniform in [0.5, 1e4]: past the planner's counts at both
    ends (a, b = 1 + a soft count)."""
    rng = np.random.default_rng(seed)
    lo, hi = np.log(0.5), np.log(1e4)
    return (np.exp(rng.uniform(lo, hi, n)).astype(np.float32),
            np.exp(rng.uniform(lo, hi, n)).astype(np.float32))


@pytest.mark.parametrize("q", [1e-6, 0.05, 0.5, 0.95, 1 - 1e-6])
def test_e_twin_is_the_plain_bisection_bit_for_bit(q):
    from repro_torch.kernels import ref
    a, b = map(torch.from_numpy, _wide_grid(6))
    qt = torch.tensor(q, dtype=torch.float32)
    plain = ref.betaincinv_ref(a, b, qt)
    twin = ref.betaincinv_twin(a, b, qt)
    assert torch.equal(twin, plain)
    assert torch.equal(TB.betaincinv(a, b, qt).detach(), plain)
    fd, pdf = ref.betaincinv_grad_terms_ref(a, b, plain)
    fd_t, pdf_t = ref.betaincinv_grad_terms_twin(a, b, plain)
    assert torch.equal(fd_t, fd) and torch.equal(pdf_t, pdf)
    # both held to the JAX package's bounds at this file's tolerance, on
    # the range it was stated for (a, b <= 400; the float32 prefactor's
    # rounding grows with a and b past it)
    want = np.asarray(JB.betaincinv(jnp.asarray(a.numpy()),
                                    jnp.asarray(b.numpy()),
                                    jnp.full(a.shape, q, jnp.float32)))
    planner = ((a <= 400) & (b <= 400)).numpy()
    assert planner.sum() >= 10
    np.testing.assert_allclose(twin.numpy()[planner], want[planner], rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("which", ["recall", "precision"])
def test_bound_gradients_through_the_twin_terms_match_jax(which):
    """beta_lower_bound's backward, rebuilt from the twin's terms,
    equals the port's autograd bit for bit and the JAX package's gradient
    at this file's tolerance."""
    from repro_torch.kernels import ref
    tp = torch.tensor([c[0] for c in COUNTS], requires_grad=True)
    miss = torch.tensor([c[1] for c in COUNTS], requires_grad=True)
    fn = TB.recall_lower_bound if which == "recall" \
        else TB.precision_lower_bound
    val = fn(tp, miss, 0.95)
    val.sum().backward()
    a, b = 1.0 + tp.detach(), 1.0 + miss.detach()
    fd, pdf = ref.betaincinv_grad_terms_twin(a, b, val.detach())
    ha, hb = ref.grad_steps(a, b)
    assert torch.equal(tp.grad, 1.0 * -((fd[0] - fd[1]) / (2 * ha)) / pdf)
    assert torch.equal(miss.grad, 1.0 * -((fd[2] - fd[3]) / (2 * hb)) / pdf)
    jfn = JB.recall_lower_bound if which == "recall" \
        else JB.precision_lower_bound
    for i, (t, m, _) in enumerate(COUNTS):
        jgrad = jax.grad(lambda x, y: jfn(x, y, 0.95), argnums=(0, 1))(
            jnp.float32(t), jnp.float32(m))
        np.testing.assert_allclose(float(tp.grad[i]), float(jgrad[0]),
                                   rtol=5e-2, atol=2e-4)
        np.testing.assert_allclose(float(miss.grad[i]), float(jgrad[1]),
                                   rtol=5e-2, atol=2e-4)
