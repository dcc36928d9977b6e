"""The port's comparison planners (`repro_torch.core.baselines`) against
the JAX package's (`repro.core.baselines`).

Twins of `tests/test_planner_e2e.py`'s baseline tests: one planted world
(corpus, models and KV-cache profiles built by each package from the same
seeds), each planner run by both packages on the CPU with both profiling
clocks pinned to one deterministic cost model (the planner's cost inputs
are otherwise measured wall times), the plans then executed by each
package.

Held to:
  plan_lotus, plan_pareto_cascades   the same stages (ops, order, gold
      flags) and bounds; thresholds within 1e-4 (both pick them from the
      profiled scores, which the two packages compute to ~1e-5);
  plan_stretto_local, plan_stretto_independent   the same stages except
      at a pick whose final probability is within TIE of 0.5 in both
      packages (the bounds' finite-difference gradients round differently
      in float32, and Adam turns a vanishing gradient into a full step);
      bounds within 0.02; thresholds of stages both keep within 0.05 for
      the local ablation (the planner tests' tolerance) and 0.1 for the
      independent one, whose single start has no restart or snapshot to
      choose between, so the same rounding carries through its whole
      trajectory (0.067 seen on this world, an sm-kv50 reject threshold).
      `scripts/independent_gap.py` shows that it is rounding: over six
      worlds (dataset seeds 5, 7, 11 at 100 and 120 items) the gap
      between the packages was 0.003-0.067, and moving one package's
      start by one float32 ulp moved its own thresholds by 0.0005-0.069
      (the port) and 0.003-0.058 (the JAX package), 0.069 on this world.
"""
import numpy as np
import pytest
import torch

import repro.core.baselines as JBL
import repro.runtime.executor as jex
import repro_torch.core.baselines as TBL
import repro_torch.runtime.executor as tex
from repro.cache.store import CacheStore as JStore
from repro.core import PlannerConfig as JConfig
from repro.core import Query as JQuery
from repro.core import SemFilter as JSemFilter
from repro.core import SemMap as JSemMap
from repro.core import evaluate_vs_gold as jevaluate
from repro.core import execute_plan as jexecute
from repro.data import synthetic as jsyn
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.operators import make_registry as jmake_registry
from repro_torch.cache.store import CacheStore
from repro_torch.core import PlannerConfig, Query, SemFilter, SemMap
from repro_torch.core import evaluate_vs_gold, execute_plan
from repro_torch.data import synthetic as tsyn
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.operators import make_registry
from test_torch_planner import pin_clock

TIE = 5e-3
N_ITEMS = 100
LADDER = dict(sm_ratios=(0.5, 0.0), lg_ratios=(0.5,))
FAST = dict(steps=150, restarts=2, snapshots=3)
QUERIES = {
    "lotus": ([("f", "f1", 1), ("f", "f2", 2)], 0.7),
    "pareto": ([("f", "f5", 5)], 0.6),
    "local": ([("f", "f1", 1), ("f", "f6", 6)], 0.6),
    "independent": ([("f", "f1", 1), ("m", "extract v3", 3)], 0.6),
}


def _query(pkg_q, pkg_f, pkg_m, name):
    ops, target = QUERIES[name]
    return pkg_q([pkg_f(t, k) if kind == "f" else pkg_m(t, k)
                  for kind, t, k in ops], target_recall=target,
                 target_precision=target)


def _gold_plan(query, registry, pkg):
    """Every semantic op on its gold operator."""
    from importlib import import_module
    phys = import_module(f"{pkg}.core.physical")
    stages = [phys.PhysicalPlanStage(
        li, 0, registry(op)[-1].name, 0.0, 0.0,
        op.__class__.__name__ == "SemMap", True, 1.0)
        for li, op in enumerate(query.semantic_ops)]
    return phys.PhysicalPlan(stages, [], 0.0, 1.0, 1.0, True)


def _recorder(mp, module, name, into):
    """Keep the last result (optimize_query) or argument
    (unflatten_params) a baseline passes through `module.name`."""
    real = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = real(*args, **kwargs)
        into.append(out if name == "optimize_query" else args[0])
        return out
    mp.setattr(module, name, wrapped)


@pytest.fixture(scope="module")
def plans(tmp_path_factory):
    ds = jsyn.make_dataset("baselines", N_ITEMS, seed=5)
    root = tmp_path_factory.mktemp("baselines")
    jeng = JEngine(JStore(str(root / "j")), device_cache=False)
    teng = ServingEngine(CacheStore(str(root / "t")), device_cache=False,
                         device="cpu")
    for size in ("sm", "lg"):
        jcfg = jsyn.planted_config(size)
        jeng.register_model(size, jcfg, jsyn.make_planted_params(jcfg,
                                                                 seed=1))
        jeng.build_profiles(size, ds.items, ratios=(0.0, 0.5),
                            prefill_batch=40)
        tcfg = tsyn.planted_config(size)
        teng.register_model(size, tcfg, tsyn.make_planted_params(
            tcfg, seed=1, device="cpu"))
        teng.build_profiles(size, ds.items, ratios=(0.0, 0.5),
                            prefill_batch=40)
    jreg, treg = jmake_registry(jeng, **LADDER), make_registry(teng, **LADDER)
    args = dict(sample_frac=0.3, seed=0)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        pin_clock(mp, jex)
        pin_clock(mp, tex)
        for name, jfn, tfn, cfg in (
                ("lotus", JBL.plan_lotus, TBL.plan_lotus, None),
                ("pareto", JBL.plan_pareto_cascades,
                 TBL.plan_pareto_cascades, None),
                ("local", JBL.plan_stretto_local, TBL.plan_stretto_local,
                 "optimize_query"),
                ("independent", JBL.plan_stretto_independent,
                 TBL.plan_stretto_independent, "unflatten_params")):
            jq = _query(JQuery, JSemFilter, JSemMap, name)
            tq = _query(Query, SemFilter, SemMap, name)
            rec = {"jax": [], "torch": []}
            extra = ({}, {})
            if cfg is not None:
                _recorder(mp, JBL, cfg, rec["jax"])
                _recorder(mp, TBL, cfg, rec["torch"])
                extra = (dict(cfg=JConfig(**FAST)),
                         dict(cfg=PlannerConfig(**FAST)))
            jp = jfn(jq, ds.items, jreg, **args, **extra[0])
            tp = tfn(tq, ds.items, treg, **args, **extra[1], device="cpu")
            out[name] = dict(jax=jp, torch=tp, rec=rec, jq=jq, tq=tq,
                             treg=treg)
    for name, r in out.items():
        r["jres"] = jexecute(r["jax"], r["jq"], ds.items, jreg)
        r["tres"] = execute_plan(r["torch"], r["tq"], ds.items, treg)
        r["jgold"] = jexecute(_gold_plan(r["jq"], jreg, "repro"), r["jq"],
                              ds.items, jreg)
        r["tgold"] = execute_plan(_gold_plan(r["tq"], treg, "repro_torch"),
                                  r["tq"], ds.items, treg)
    return out


def _stages(plan):
    return [(s.logical_idx, s.op_name, s.is_gold, s.is_map)
            for s in plan.stages]


@pytest.mark.parametrize("name", ["lotus", "pareto"])
def test_fixed_rule_baselines_match_jax(plans, name):
    r = plans[name]
    jp, tp = r["jax"], r["torch"]
    assert _stages(tp) == _stages(jp)
    if name == "lotus":       # 2 logical ops x (small + gold)
        assert len(tp.stages) == 4 and sum(s.is_gold for s in tp.stages) == 2
    for a, b in zip(tp.stages, jp.stages):
        for x, y in ((a.thr_hi, b.thr_hi), (a.thr_lo, b.thr_lo)):
            assert x == y or abs(x - y) < 1e-4, (a, b)
        assert a.cost == pytest.approx(b.cost, rel=1e-5)
    assert tp.recall_bound == pytest.approx(jp.recall_bound, abs=1e-6)
    assert tp.precision_bound == pytest.approx(jp.precision_bound, abs=1e-6)
    assert tp.feasible == jp.feasible
    assert tp.est_cost == pytest.approx(jp.est_cost, rel=1e-4)


def _pick_probs(rec, name, sizes):
    """Per pipeline, the final pick probabilities a baseline selected
    from: the optimizer's plan per logical op (local), the last flat
    vector (independent)."""
    if name == "local":
        return [1 / (1 + np.exp(-np.asarray(p.params[0].pick_logits,
                                            np.float64))) for p in rec]
    flat = np.asarray(rec[-1], np.float64).reshape(-1)
    out, off = [], 0
    for n in sizes:
        out.append(1 / (1 + np.exp(-flat[off:off + n])))
        off += 3 * n
    return out


@pytest.mark.parametrize("name", ["local", "independent"])
def test_gradient_baselines_match_jax_outside_ties(plans, name):
    r = plans[name]
    jp, tp = r["jax"], r["torch"]
    cands = [r["treg"](op) for op in r["tq"].semantic_ops]
    sizes = [len(c) for c in cands]
    jprob = _pick_probs(r["rec"]["jax"], name, sizes)
    tprob = _pick_probs(r["rec"]["torch"], name, sizes)
    tied = set()
    for li, (a, b) in enumerate(zip(tprob, jprob)):
        sa, sb = a > 0.5, b > 0.5
        sa[-1] = sb[-1] = True
        for i in np.flatnonzero(sa != sb):
            assert abs(a[i] - 0.5) < TIE and abs(b[i] - 0.5) < TIE, \
                (li, i, a, b)
            tied.add((li, cands[li][i].name))
    j_ops = {(s.logical_idx, s.op_name): s for s in jp.stages}
    t_ops = {(s.logical_idx, s.op_name): s for s in tp.stages}
    assert set(j_ops) ^ set(t_ops) <= tied
    thr_tol = 0.05 if name == "local" else 0.1
    for key in set(j_ops) & set(t_ops):
        s, o = t_ops[key], j_ops[key]
        assert s.is_gold == o.is_gold
        if not s.is_gold:
            for x, y in ((s.thr_hi, o.thr_hi), (s.thr_lo, o.thr_lo)):
                assert abs(x - y) < thr_tol, (key, x, y)
    assert tp.recall_bound == pytest.approx(jp.recall_bound, abs=0.02)
    assert tp.precision_bound == pytest.approx(jp.precision_bound, abs=0.02)
    if not tied:
        assert tp.feasible == jp.feasible


@pytest.mark.parametrize("name", ["lotus", "pareto", "local", "independent"])
def test_baseline_plans_execute_like_jax(plans, name):
    """Each package executes its own plan; where the plans agree, so do
    the results (quality against each package's gold within 0.02)."""
    r = plans[name]
    tm = evaluate_vs_gold(r["tres"], r["tgold"], r["tq"].semantic_ops)
    jm = jevaluate(r["jres"], r["jgold"], r["jq"].semantic_ops)
    np.testing.assert_array_equal(r["tgold"].accepted, r["jgold"].accepted)
    assert r["tres"].accepted.dtype == bool
    assert r["tres"].runtime_s > 0
    if _stages(r["torch"]) == _stages(r["jax"]):
        assert tm["recall"] == pytest.approx(jm["recall"], abs=0.02)
        assert tm["precision"] == pytest.approx(jm["precision"], abs=0.02)
