"""The port's planner against the JAX package's: the relaxation, the
gradient optimizer and `plan_query`.

The relaxation and optimizer tests run both packages on one fixed
`PipelineData` (a filter and a map pipeline of three operators each,
scores made with numpy from a seed). `plan_query` runs on a planted world
with both packages' profiling clocks pinned: the wall time that
`run_operator` reports is replaced by the same deterministic cost model
in both packages (monkeypatched inside the test; the planner's cost
inputs are otherwise measured and load-dependent).

Tolerances (float32):
  relaxation   atol 1e-5 on probabilities, counts and costs (sums over 48
               sample tuples, reassociated).
  optimizer    loss history rtol 5e-3 over the first 10 Adam steps: the
               bounds' gradients are central differences of a float32
               betainc in both packages, whose rounding differs by up to a
               few percent (tests/test_torch_bounds.py), and Adam carries
               that into the trajectory; selected operators and
               feasibility equal; thresholds atol 0.02; bounds atol 1e-4.
  plan_query   the same stage ops in the same order; thresholds atol 0.05
               (the same trajectory difference, over a profiled sample).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import optimizer as JO
from repro.core import relaxation as JR
from repro.runtime import kernel as jkernel
from repro_torch.core import optimizer as TO
from repro_torch.core import relaxation as TR
from repro_torch.runtime import kernel as tkernel

N = 48


def _world(seed=0):
    rng = np.random.default_rng(seed)
    gold = rng.normal(size=N) * 2
    f = np.stack([gold + rng.normal(scale=0.8, size=N),
                  gold + rng.normal(scale=0.3, size=N),
                  gold]).astype(np.float32)
    conf = (np.abs(rng.normal(size=(3, N)))
            * np.array([[2.0], [3.0], [4.0]])).astype(np.float32)
    corr = np.stack([rng.uniform(size=N) < 0.8, rng.uniform(size=N) < 0.95,
                     np.ones(N, bool)]).astype(np.float32)
    costs = np.array([1e-4, 4e-4, 2e-3], np.float32)
    fixed = np.array([2e-3, 3e-3, 6e-3], np.float32)
    cap = np.array([128, 64, 32], np.float32)
    meas = np.array([np.nan, 40.0, np.nan], np.float32)
    pipes = [dict(scores=f, costs=costs, is_map=False, correct=None,
                  fixed=fixed, batch_cap=cap, meas_width=meas),
             dict(scores=conf, costs=costs * 1.5, is_map=True, correct=corr,
                  fixed=fixed, batch_cap=cap, meas_width=None)]
    return pipes, (gold > 0).astype(np.float32)


def _lift(pipes, mod, asarray):
    return [mod.PipelineData(**{k: (asarray(v) if isinstance(v, np.ndarray)
                                    else v) for k, v in p.items()})
            for p in pipes]


def _params(seed, sizes):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=n).astype(np.float32),
             rng.normal(size=n).astype(np.float32) + 0.5,
             rng.normal(size=n).astype(np.float32) - 0.5) for n in sizes]


@pytest.fixture(scope="module")
def world():
    pipes, g = _world()
    jp = _lift(pipes, JR, jnp.asarray)
    tp = _lift(pipes, TR, torch.from_numpy)
    return pipes, g, jp, tp


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def test_decide_traced_matches_jax():
    rng = np.random.default_rng(0)
    s = rng.normal(scale=3, size=(4, 37)).astype(np.float32)
    hi = rng.normal(size=(4, 1)).astype(np.float32)
    lo = hi - rng.uniform(-1, 2, size=(4, 1)).astype(np.float32)
    for is_map in (False, True):
        for a, b in zip(tkernel.decide_traced(torch.from_numpy(s),
                                              torch.from_numpy(hi),
                                              torch.from_numpy(lo), is_map),
                        jkernel.decide_traced(jnp.asarray(s), hi, lo,
                                              is_map)):
            np.testing.assert_array_equal(_np(a), _np(b))


@pytest.mark.parametrize("tau", [1.0, 0.3, 0.02])
def test_soft_and_hard_decisions_match_jax(world, tau):
    pipes, _, _, _ = world
    for p, (pick, hi, lo) in zip(pipes, _params(1, [3, 3])):
        s = p["scores"]
        for a, b in zip(TR.soft_decisions(torch.from_numpy(s),
                                          torch.from_numpy(hi),
                                          torch.from_numpy(lo), tau,
                                          p["is_map"]),
                        JR.soft_decisions(jnp.asarray(s), jnp.asarray(hi),
                                          jnp.asarray(lo), tau,
                                          p["is_map"])):
            np.testing.assert_allclose(_np(a), _np(b), atol=1e-5, rtol=0)
        for a, b in zip(TR.hard_decisions(torch.from_numpy(s),
                                          torch.from_numpy(hi),
                                          torch.from_numpy(lo), p["is_map"]),
                        JR.hard_decisions(jnp.asarray(s), jnp.asarray(hi),
                                          jnp.asarray(lo), p["is_map"])):
            np.testing.assert_array_equal(_np(a), _np(b))


@pytest.mark.parametrize("hard,tau", [(False, 1.0), (False, 0.1),
                                      (True, 0.0)])
@pytest.mark.parametrize("no_accept", [False, True])
def test_simulate_pipeline_matches_jax(world, hard, tau, no_accept):
    pipes, _, jp, tp = world
    hint = (64.0, 4.0)
    weight = np.random.default_rng(2).uniform(size=N).astype(np.float32)
    for jd, td, (pick, hi, lo) in zip(jp, tp, _params(3, [3, 3])):
        jd, td = jd._replace(no_accept=no_accept), td._replace(
            no_accept=no_accept)
        j = JR.simulate_pipeline(
            JR.PipelineParams(*map(jnp.asarray, (pick, hi, lo))), jd, tau,
            hard=hard, pick_tau=None if hard else 0.7,
            batch_hint=JR.BatchHint(*hint), reach_weight=jnp.asarray(weight))
        t = TR.simulate_pipeline(
            TR.PipelineParams(*map(torch.from_numpy, (pick, hi, lo))), td,
            tau, hard=hard, pick_tau=None if hard else 0.7,
            batch_hint=TR.BatchHint(*hint),
            reach_weight=torch.from_numpy(weight))
        for a, b in zip(t, j):
            np.testing.assert_allclose(_np(a), _np(b), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("hard,tau", [(False, 0.5), (True, 0.0)])
def test_query_counts_match_jax(world, hard, tau):
    _, g, jp, tp = world
    params = _params(4, [3, 3])
    j = JR.query_counts(jp, [JR.PipelineParams(*map(jnp.asarray, p))
                             for p in params], jnp.asarray(g), tau,
                        hard=hard, batch_hint=JR.BatchHint(64.0, 4.0))
    t = TR.query_counts(tp, [TR.PipelineParams(*map(torch.from_numpy, p))
                             for p in params], g, tau, hard=hard,
                        batch_hint=TR.BatchHint(64.0, 4.0))
    for a, b in zip(t, j):
        np.testing.assert_allclose(float(a), float(b), atol=1e-5, rtol=1e-5)


def test_query_counts_gradient_matches_jax(world):
    """The relaxation's gradient, ties included: jnp.maximum / jnp.clip
    split it in half where their arguments meet, and so must the port."""
    import jax
    _, g, jp, tp = world
    params = _params(5, [3, 3])
    flat = np.concatenate([np.concatenate(p) for p in params])

    def jloss(x):
        ps = JO.unflatten_params(x, [3, 3])
        c = JR.query_counts(jp, ps, jnp.asarray(g), 0.3, pick_tau=1.0,
                            batch_hint=JR.BatchHint(64.0, 4.0))
        return c.tp - 0.5 * c.fp - 0.3 * c.fn + 10.0 * c.cost

    x = torch.from_numpy(flat).requires_grad_(True)
    c = TR.query_counts(tp, TO.unflatten_params(x, [3, 3]), g, 0.3,
                        pick_tau=1.0, batch_hint=TR.BatchHint(64.0, 4.0))
    (c.tp - 0.5 * c.fp - 0.3 * c.fn + 10.0 * c.cost).backward()
    np.testing.assert_allclose(x.grad.numpy(),
                               np.asarray(jax.grad(jloss)(jnp.asarray(flat))),
                               atol=1e-4, rtol=1e-4)


def test_batched_params_equal_per_restart_calls(world):
    """A leading restart dimension gives each restart what its own call
    gives (the optimizer relies on it)."""
    _, g, _, tp = world
    per = [_params(s, [3, 3]) for s in (6, 7, 8)]
    stacked = [TR.PipelineParams(*(torch.from_numpy(np.stack(
        [per[k][i][f] for k in range(3)])) for f in range(3)))
        for i in range(2)]
    batched = TR.query_counts(tp, stacked, g, 0.4, pick_tau=1.0)
    for k in range(3):
        one = TR.query_counts(tp, [TR.PipelineParams(*map(torch.from_numpy,
                                                          p))
                                   for p in per[k]], g, 0.4, pick_tau=1.0)
        for a, b in zip(batched, one):
            torch.testing.assert_close(a[k], b, atol=1e-6, rtol=1e-6)


def test_init_params_match_jax(world):
    pipes, _, jp, tp = world
    for jd, td in zip(jp, tp):
        for pick0, width in ((2.0, 0.3), (0.5, 1.5)):
            j = JO.init_pipeline_params(jd, pick0, width)
            t = TO.init_pipeline_params(td, pick0, width)
            for a, b in zip(t, j):
                np.testing.assert_allclose(_np(a), _np(b), atol=1e-6,
                                           rtol=1e-6)


def test_optimize_query_matches_jax(world):
    _, g, jp, tp = world
    j = JO.optimize_query(jp, g, 0.7, 0.7,
                          JO.PlannerConfig(steps=60, restarts=3),
                          batch_hint=JR.BatchHint(64.0, 4.0))
    t = TO.optimize_query(tp, g, 0.7, 0.7,
                          TO.PlannerConfig(steps=60, restarts=3),
                          batch_hint=TR.BatchHint(64.0, 4.0))
    assert t.loss_history.shape == j.loss_history.shape == (60,)
    np.testing.assert_allclose(t.loss_history[:10], j.loss_history[:10],
                               rtol=5e-3, atol=0)
    assert t.feasible == j.feasible
    for a, b in zip(t.selected, j.selected):
        np.testing.assert_array_equal(a, b)
    # a cascade, not the gold-only fallback: the test exercises extraction
    assert any(s[:-1].any() for s in t.selected)
    for a, b in zip(t.params, j.params):
        np.testing.assert_allclose(_np(a.thr_hi), _np(b.thr_hi), atol=0.02)
        np.testing.assert_allclose(_np(a.thr_lo), _np(b.thr_lo), atol=0.02)
    assert abs(t.recall_bound - j.recall_bound) < 1e-4
    assert abs(t.precision_bound - j.precision_bound) < 1e-4
    assert t.est_cost == pytest.approx(j.est_cost, rel=1e-4)


def test_optimize_query_groups_not_ported(world):
    """Grouped (join-tree) optimization is ported: the plan the port picks
    under `groups`, re-counted by the JAX package's `tree_counts` at
    tau 0, has the port's sample counts and cost (atol 1e-4 on counts,
    rtol 1e-5 on cost)."""
    _, g, jp, tp = world
    groups = [(1, "side", 0.5), (1, "pair", 2.0)]
    tgroups = [TR.TreeGroup(c, k, w, TR.BatchHint(64.0, w))
               for c, k, w in groups]
    jgroups = [JR.TreeGroup(c, k, w, JR.BatchHint(64.0, w))
               for c, k, w in groups]
    plan = TO.optimize_query(tp, g, 0.7, 0.7,
                             TO.PlannerConfig(steps=30, restarts=2),
                             groups=tgroups)
    jparams = [JR.PipelineParams(*(jnp.asarray(_np(x)) for x in p))
               for p in plan.params]
    c = JR.tree_counts(jp, jparams, jnp.asarray(g), jgroups, 0.0,
                       hard=True)
    assert plan.sample_tp == pytest.approx(float(c.tp), abs=1e-4)
    assert plan.sample_fp == pytest.approx(float(c.fp), abs=1e-4)
    assert plan.sample_fn == pytest.approx(float(c.fn), abs=1e-4)
    assert plan.est_cost == pytest.approx(float(c.cost), rel=1e-5)
    assert all(sel[-1] for sel in plan.selected)


# ---------------------------------------------------------------------------
# plan_query on the planted world, both packages' clocks pinned
# ---------------------------------------------------------------------------

def pinned_wall(op_name: str, n: int) -> float:
    """Deterministic seconds for one operator call of n tuples: larger
    models and lighter compression cost more, int8 rungs half as much per
    tuple, plus a fixed cost per call."""
    m = re.match(r"(sm|lg)-kv(\d\d)(i8)?$", op_name)
    if m is None:                              # embedding / python ops
        return 1e-4 + 1e-5 * n
    size = {"sm": 1.0, "lg": 3.0}[m.group(1)]
    keep = 1.0 - int(m.group(2)) / 100.0
    per = 1e-4 * size * (0.2 + keep) * (0.5 if m.group(3) else 1.0)
    return 2e-3 * size + per * n


def pin_clock(monkeypatch, executor_module):
    real = executor_module.run_operator

    def run_operator(backend, op, op_name, items):
        out = real(backend, op, op_name, items)
        out.wall_s = pinned_wall(op_name, len(items))
        return out

    monkeypatch.setattr(executor_module, "run_operator", run_operator)


def test_plan_query_matches_jax_under_pinned_clock(monkeypatch, tmp_path):
    import repro.runtime.executor as jex
    import repro_torch.runtime.executor as tex
    from repro.cache.store import CacheStore as JStore
    from repro.core.logical import Query as JQuery
    from repro.core.logical import SemFilter as JSemFilter
    from repro.core.logical import SemMap as JSemMap
    from repro.core.planner import plan_query as jplan_query
    from repro.data import synthetic as jsyn
    from repro.runtime.backend import KVCacheBackend as JBackend
    from repro.serving.engine import ServingEngine as JEngine
    from repro_torch.cache.store import CacheStore
    from repro_torch.core.logical import Query, SemFilter, SemMap
    from repro_torch.core.planner import plan_query
    from repro_torch.data import synthetic as tsyn
    from repro_torch.runtime.backend import KVCacheBackend
    from repro_torch.serving.engine import ServingEngine
    pin_clock(monkeypatch, jex)
    pin_clock(monkeypatch, tex)

    ds = jsyn.make_dataset("plan", 80, seed=5)
    jeng = JEngine(JStore(str(tmp_path / "j")), device_cache=False)
    teng = ServingEngine(CacheStore(str(tmp_path / "t")), device_cache=False,
                         device="cpu")
    for size, ratios, quant in (("sm", (0.5,), ()), ("lg", (0.0,), (0.3,))):
        jcfg = jsyn.planted_config(size)
        jeng.register_model(size, jcfg, jsyn.make_planted_params(jcfg))
        jeng.build_profiles(size, ds.items, ratios=ratios, prefill_batch=40,
                            quant_ratios=quant)
        tcfg = tsyn.planted_config(size)
        teng.register_model(size, tcfg, tsyn.make_planted_params(
            tcfg, device="cpu"))
        teng.build_profiles(size, ds.items, ratios=ratios, prefill_batch=40,
                            quant_ratios=quant)
    kw = dict(sm_ratios=(0.5,), lg_ratios=(), lg_int8=(0.3,),
              include_cheap=True)
    args = dict(sample_frac=0.25, seed=0)
    jp = jplan_query(JQuery([JSemFilter("mentions topic 1", 1),
                             JSemMap("extract field 2", 2)], 0.75, 0.75),
                     ds.items, JBackend(jeng, **kw),
                     JO.PlannerConfig(steps=60, restarts=2), **args)
    tp = plan_query(Query([SemFilter("mentions topic 1", 1),
                           SemMap("extract field 2", 2)], 0.75, 0.75),
                    ds.items, KVCacheBackend(teng, **kw),
                    TO.PlannerConfig(steps=60, restarts=2), **args)
    assert [(s.logical_idx, s.stage, s.op_name, s.is_gold)
            for s in tp.stages] == [(s.logical_idx, s.stage, s.op_name,
                                     s.is_gold) for s in jp.stages]
    assert any(s.op_name == "lg-kv30i8" for s in tp.stages)
    for a, b in zip(tp.stages, jp.stages):
        for x, y in ((a.thr_hi, b.thr_hi), (a.thr_lo, b.thr_lo)):
            assert x == y or abs(x - y) < 0.05, (a, b)
        assert a.exp_batch == pytest.approx(b.exp_batch, rel=1e-6)
        assert a.cost == pytest.approx(b.cost, rel=1e-5)
    assert tp.feasible == jp.feasible
    assert tp.est_cost == pytest.approx(jp.est_cost, rel=1e-4)


# ---------------------------------------------------------------------------
# the step the card captures as a CUDA graph, eagerly on the CPU
# ---------------------------------------------------------------------------

def _eager_loop(loss_fn, flat, cfg, snap_steps):
    """The CPU's Adam loop as `optimize_query` ran it before the step was
    written for capture: eager steps on fresh tensors, step and tau made
    on the host each step."""
    decay = torch.tensor(TO.tau_decay(cfg), dtype=torch.float32)
    m, v = torch.zeros_like(flat), torch.zeros_like(flat)
    b1 = torch.tensor(0.9, dtype=torch.float32)
    b2 = torch.tensor(0.999, dtype=torch.float32)
    losses, traj = [], {}
    for i in range(cfg.steps):
        step = torch.tensor(float(i), dtype=torch.float32)
        tau = cfg.tau_start * decay ** step
        x = flat.detach().requires_grad_(True)
        loss = loss_fn(x, tau)
        grad, = torch.autograd.grad(loss.sum(), x)
        with torch.no_grad():
            m = 0.9 * m + 0.1 * grad
            v = 0.999 * v + 0.001 * torch.square(grad)
            t = step + 1.0
            mhat = m / (1 - b1 ** t)
            vhat = v / (1 - b2 ** t)
            flat = flat - cfg.lr * mhat / (torch.sqrt(vhat) + 1e-8)
        losses.append(loss.detach())
        if i in snap_steps:
            traj[i] = flat
    return flat, torch.stack(losses), traj


@pytest.mark.parametrize("counts", ["query_counts", "tree_counts"])
def test_captured_adam_step_is_the_eager_loop_bit_for_bit(world, counts):
    """`adam_loop` on the CPU runs `adam_step`, the step a CUDA device
    captures (step and tau as tensors, state updated in place, losses
    and snapshots copied into buffers); over a full 200-step run it
    gives the eager loop the CPU ran before (`_eager_loop`) bit for bit:
    every restart's parameters, every loss and every snapshot
    (`test_optimize_query_matches_jax` holds the loop to the JAX
    package)."""
    _, g, _, tp = world
    cfg = TO.PlannerConfig(steps=200, restarts=2)
    if counts == "tree_counts":
        groups = [TR.TreeGroup(1, "side", 0.5, TR.BatchHint(64.0, 0.5)),
                  TR.TreeGroup(1, "pair", 2.0, TR.BatchHint(64.0, 2.0))]
        prob = TO.setup_problem(tp, g, 0.7, 0.7, cfg, groups=groups)
    else:
        prob = TO.setup_problem(tp, g, 0.7, 0.7, cfg,
                                batch_hint=TR.BatchHint(64.0, 4.0))
    flat, losses, traj = _eager_loop(prob.loss_fn, prob.flat0, cfg,
                                     prob.snap_steps)
    step = TO.adam_loop(prob.loss_fn, prob.flat0, cfg, prob.snap_steps)
    assert step.replays == 0 and losses.shape == (200, 2)
    assert torch.equal(step.flat, flat)
    assert torch.equal(step.losses, losses)
    assert sorted(step.snaps) == sorted(traj) == prob.snap_steps
    for i in prob.snap_steps:
        assert torch.equal(step.snaps[i], traj[i])


def test_optimize_query_places_its_problem_on_the_device(world):
    """The problem lies where the pipelines lie; a `device` other than
    theirs raises, and so does a graph off CUDA. On the CPU
    `optimize_query` runs the eager loop and returns host tensors."""
    _, g, _, tp = world
    cfg = TO.PlannerConfig(steps=5, restarts=2)
    prob = TO.setup_problem(tp, g, 0.7, 0.7, cfg, device="cpu")
    assert prob.flat0.shape == (2, 18) and prob.flat0.device.type == "cpu"
    assert all(p.scores.device.type == "cpu" for p in prob.pipelines)
    with pytest.raises(ValueError, match="pipelines lie on"):
        TO.setup_problem(tp, g, 0.7, 0.7, cfg, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        TO.adam_loop(prob.loss_fn, prob.flat0, cfg, [], graph=True)
    plan = TO.optimize_query(tp, g, 0.7, 0.7, cfg, device="cpu")
    assert all(p.thr_hi.device.type == "cpu" for p in plan.params)
