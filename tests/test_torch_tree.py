"""Join trees in the port against the JAX package: the grouped
relaxation, the tree runtime and `sem_join` through both Sessions.

The join is `tests/test_algebra.py`'s pair predicate "same v3" (task 3)
blocked on `category`, over two planted corpora of 40 items
(`make_join_corpora`), with recall and precision 0.7. Its sides are bare
(no side filter): with side filters the planner's sample holds too few
gold pairs for a feasible plan at this size, and both packages plan
gold-only; bare sides leave about 100 sample pairs, 13 of them gold.
The cheap operators (embedding, generated-code pair matcher) are left
out of the ladder: the code matcher alone decides every planted pair,
and then no LLM pair stage would run. The plan is a compressed pair
stage ahead of gold. Side pipelines are held by the relaxation test and
by `chip_smoke.py`'s join phases. Both Sessions (the port's with
device="cpu", the plain kernel versions) profile, plan and execute it
with both packages' profiling clocks pinned to one deterministic cost
model (monkeypatched in the test, as in `tests/test_torch_api.py`).

Held to:
  - `tree_counts` equal to the JAX package's on fixed `PipelineData`
    and groups: atol 1e-5 on probabilities summed into counts, rtol 1e-5
    on costs (float32 sums over 60 pair coordinates, reassociated);
  - the JAX package's TreePlan (its role stages and thresholds) run
    through the port's `run_tree`, inline and threads:4: the JAX
    package's accepted pair ids and integer StageStats (n_tuples,
    n_llm_calls, kv_bytes) exactly;
  - both Sessions' planned trees: the same role cascades (ops, order,
    kinds, gold flags) apart from a stage whose pick probability sits
    within TIE of the 0.5 selection boundary in either package's
    optimizer output (where the float32 rounding of the bounds'
    gradients decides), thresholds within 0.05, joint bounds within
    1e-3; both meet the targets against gold and the two gold joins are
    equal.
"""
import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.runtime.executor as jex
import repro_torch
import repro_torch.runtime.executor as tex
from repro.core import relaxation as JR
from repro.data import synthetic as jsyn
from repro_torch.core import relaxation as TR
from repro_torch.core.logical import (JoinNode, PipelineLeaf, SemFilter,
                                      SemJoin)
from repro_torch.core.optimizer import PlannerConfig
from repro_torch.core.physical import PhysicalPlan, PhysicalPlanStage
from repro_torch.core.planner import plan_tree
from repro_torch.runtime import tree as T

TIE = 5e-3
N_SIDE = 40
TARGET = 0.7


def pinned_wall(op_name: str, n: int) -> float:
    """Deterministic seconds for one operator call of n tuples: larger
    models and lighter compression cost more, a pair call (two side
    decodes) twice a filter call, plus a fixed cost per call."""
    m = re.match(r"(sm|lg)-(kv|pair)(\d\d)(i8)?$", op_name)
    if m is None:                              # embedding / python ops
        return 1e-4 + 1e-5 * n
    size = {"sm": 1.0, "lg": 3.0}[m.group(1)]
    keep = 1.0 - int(m.group(3)) / 100.0
    per = 1e-4 * size * (0.2 + keep) * (2.0 if m.group(2) == "pair" else 1.0)
    return 2e-3 * size + per * n


def pin_clock(mp, executor_module):
    real = executor_module.run_operator

    def run_operator(backend, op, op_name, items):
        out = real(backend, op, op_name, items)
        out.wall_s = pinned_wall(op_name, len(items))
        return out

    mp.setattr(executor_module, "run_operator", run_operator)


def capture_optimizer(mp, planner_module, into: dict):
    real = planner_module.optimize_query

    def optimize_query(*args, **kwargs):
        into["opt"] = real(*args, **kwargs)
        return into["opt"]

    mp.setattr(planner_module, "optimize_query", optimize_query)


def _config(pkg, **kw):
    return pkg.SessionConfig(
        profile_ratios=(0.0, 0.5, 0.8), sm_ratios=(0.8, 0.5),
        lg_ratios=(0.5,), planner=pkg.PlannerConfig(steps=60, restarts=2),
        sample_frac=0.5, include_cheap=False, partition_size=32,
        device_cache=False, **kw)


def _join(sess, left, right):
    return (sess.frame(left.items)
            .sem_join(sess.frame(right.items), "same v3", 3, on="category")
            .with_guarantees(recall=TARGET, precision=TARGET))


STAGE_FIELDS = ("logical_idx", "stage", "op_name", "thr_hi", "thr_lo",
                "is_map", "is_gold", "cost", "sel_inter", "sel_intra",
                "exp_batch", "engine")


def port_tree_plan(jplan, tplan):
    """The JAX package's TreePlan as the port's: its role stages and
    thresholds, over the port's role queries (built from equal frames)."""
    roles = {}
    for role, jp in jplan.roles.items():
        tp = tplan.roles[role]
        roles[role] = PhysicalPlan(
            [PhysicalPlanStage(**{f: getattr(s, f) for f in STAGE_FIELDS})
             for s in jp.stages], tp.relational, jp.est_cost,
            jp.recall_bound, jp.precision_bound, jp.feasible,
            post_relational=tp.post_relational)
    return dataclasses.replace(tplan, roles=roles)


@pytest.fixture(scope="module")
def world():
    import repro.core.planner as jplanner
    import repro_torch.core.planner as tplanner
    left, right = jsyn.make_join_corpora(n_left=N_SIDE, n_right=N_SIDE,
                                         seed=3)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        pin_clock(mp, jex)
        pin_clock(mp, tex)
        for name, pkg, planner, kw in (
                ("jax", repro, jplanner, {}),
                ("torch", repro_torch, tplanner, {"device": "cpu"})):
            sess = pkg.Session(_config(pkg, **kw))
            frame = _join(sess, left, right)
            got: dict = {}
            capture_optimizer(mp, planner, got)
            report = frame.explain()
            result = frame.execute()
            out[name] = dict(sess=sess, frame=frame, report=report,
                             result=result, metrics=result.metrics(),
                             opt=got["opt"])
        tsess = out["torch"]["sess"]
        plan = port_tree_plan(out["jax"]["result"].raw.plan,
                              out["torch"]["result"].raw.plan)
        out["jax_plan_on_torch"] = {
            spec: T.run_tree(plan, left.items, right.items, tsess.backend,
                             dispatcher=spec)
            for spec in ("inline", "threads:4")}
    yield left, right, out
    for r in out.values():
        if "sess" in r:
            r["sess"].close()


def _ints(stats):
    return [(s.op_name, s.logical_idx, s.stage, s.n_tuples, s.n_llm_calls,
             s.kv_bytes) for s in stats]


# ---------------------------------------------------------------------------
# the runtime's pair corpus
# ---------------------------------------------------------------------------

def test_survivor_pairs_blocking_and_order():
    class It:
        def __init__(self, i, cat):
            self.item_id = i
            self.row = {"category": cat}
            self.tokens = []
    L = [It(0, "a"), It(1, "b"), It(2, None)]
    R = [It(10, "b"), It(11, "a"), It(12, "a")]
    pairs = T.survivor_pairs(L, R, "category")
    assert [p.item_id for p in pairs] == [(0, 11), (0, 12), (1, 10)]
    assert all(p.row["category"] is not None for p in pairs)
    assert pairs[0].row["left_category"] == "a"
    full = T.survivor_pairs(L, R, None)
    assert [p.item_id for p in full] == [(i, j) for i in (0, 1, 2)
                                         for j in (10, 11, 12)]
    with pytest.raises(ValueError, match="equal-length"):
        T.make_pairs(L, R[:2])


# ---------------------------------------------------------------------------
# the grouped relaxation
# ---------------------------------------------------------------------------

def _tree_world(seed=0, n=60):
    """Two left ops, three right ops, two pair ops (one map) over n pair
    coordinates; groups as plan_tree builds them."""
    rng = np.random.default_rng(seed)
    gold = rng.normal(size=n) * 2
    pipes = []
    for n_ops, is_map in ((2, False), (3, False), (2, False), (2, True)):
        scores = np.stack([gold + rng.normal(scale=s, size=n)
                           for s in np.linspace(1.0, 0.0, n_ops)]
                          ).astype(np.float32)
        if is_map:
            scores = np.abs(scores)
        pipes.append(dict(
            scores=scores,
            costs=np.linspace(1e-4, 2e-3, n_ops).astype(np.float32),
            is_map=is_map,
            correct=(rng.uniform(size=(n_ops, n)) < 0.9).astype(np.float32)
            if is_map else None,
            fixed=np.full(n_ops, 2e-3, np.float32),
            batch_cap=np.full(n_ops, 64.0, np.float32),
            meas_width=None))
    params = [(rng.normal(size=p["scores"].shape[0]).astype(np.float32),
               rng.normal(size=p["scores"].shape[0]).astype(np.float32) + .5,
               rng.normal(size=p["scores"].shape[0]).astype(np.float32) - .5)
              for p in pipes]
    g = (gold > 0).astype(np.float32)
    groups = [(1, "side", 0.4), (1, "side", 0.6), (2, "pair", 3.0)]
    return pipes, params, g, groups


@pytest.mark.parametrize("hard,tau", [(False, 1.0), (False, 0.1),
                                      (True, 0.0)])
def test_tree_counts_match_jax(hard, tau):
    pipes, params, g, groups = _tree_world()

    def lift(mod, asarray):
        data = [mod.PipelineData(**{k: asarray(v) if isinstance(
            v, np.ndarray) else v for k, v in p.items()}) for p in pipes]
        prm = [mod.PipelineParams(*map(asarray, p)) for p in params]
        grp = [mod.TreeGroup(c, kind, w, mod.BatchHint(32.0, w))
               for c, kind, w in groups]
        return data, prm, grp

    jd, jp, jg = lift(JR, jnp.asarray)
    td, tp, tg = lift(TR, torch.from_numpy)
    pick_tau = None if hard else 0.7
    j = JR.tree_counts(jd, jp, jnp.asarray(g), jg, tau, hard=hard,
                       pick_tau=pick_tau)
    t = TR.tree_counts(td, tp, torch.from_numpy(g), tg, tau, hard=hard,
                       pick_tau=pick_tau)
    for name in ("tp", "fp", "fn"):
        np.testing.assert_allclose(float(getattr(t, name)),
                                   float(getattr(j, name)), atol=1e-4,
                                   rtol=1e-5)
    np.testing.assert_allclose(float(t.cost), float(j.cost), rtol=1e-5)
    # a leading restart dimension gives each restart its own counts
    stacked = [TR.PipelineParams(*(torch.stack([x, x + 0.3]) for x in p))
               for p in tp]
    both = TR.tree_counts(td, stacked, torch.from_numpy(g), tg, tau,
                          hard=hard, pick_tau=pick_tau)
    assert both.tp.shape == (2,)
    assert float(both.tp[0]) == pytest.approx(float(t.tp), abs=1e-5)


def test_grouped_optimizer_prices_the_tree():
    """optimize_query(groups=...) runs the tree relaxation: its hard
    re-evaluation of the chosen parameters equals tree_counts'."""
    pipes, _, g, groups = _tree_world(seed=1)
    data = [TR.PipelineData(**{k: torch.from_numpy(v) if isinstance(
        v, np.ndarray) else v for k, v in p.items()}) for p in pipes]
    grp = [TR.TreeGroup(c, kind, w, TR.BatchHint(32.0, w))
           for c, kind, w in groups]
    from repro_torch.core.optimizer import optimize_query
    plan = optimize_query(data, g, 0.6, 0.6,
                          PlannerConfig(steps=20, restarts=2), groups=grp)
    c = TR.tree_counts(data, plan.params, torch.from_numpy(g), grp, 0.0,
                       hard=True)
    assert plan.est_cost == pytest.approx(float(c.cost), rel=1e-6)
    assert plan.sample_tp == pytest.approx(float(c.tp))
    assert len(plan.selected) == len(pipes)
    assert all(s[-1] for s in plan.selected)


# ---------------------------------------------------------------------------
# the JAX package's tree plan executed by the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["inline", "threads:4"])
def test_jax_tree_plan_on_the_port_matches_jax_execution(world, spec):
    _, _, out = world
    j = out["jax"]["result"].raw
    t = out["jax_plan_on_torch"][spec]
    assert t.pair_ids == j.pair_ids
    assert [p.item_id for p in t.pair_items] == \
        [p.item_id for p in j.pair_items]
    assert _ints(t.stage_stats) == _ints(j.stage_stats)
    for role in ("left", "right", "pair"):
        np.testing.assert_array_equal(t.roles[role].accepted,
                                      j.roles[role].accepted)
    assert sum(s.n_llm_calls > 0 for s in t.stage_stats) >= 2


def test_join_blocking_mismatch_raises(world):
    left, right, out = world
    tree = JoinNode(PipelineLeaf(()), PipelineLeaf(()),
                    SemJoin("j", 3, on="no_such_column"))
    with pytest.raises(ValueError, match="eliminated every sample pair"):
        plan_tree(tree, left.items, right.items,
                  out["torch"]["sess"].backend,
                  PlannerConfig(steps=10, restarts=1), sample_frac=0.35)
    with pytest.raises(ValueError, match="join tree"):
        plan_tree(PipelineLeaf((SemFilter("f", 1),)), left.items,
                  right.items, out["torch"]["sess"].backend)


# ---------------------------------------------------------------------------
# sem_join through both Sessions
# ---------------------------------------------------------------------------

def _tied(opt, flat_idx: int, op_name: str, names) -> bool:
    """The stage's pick probability sits within TIE of 0.5 (flat_idx:
    the pipeline's index in the tree's group-major concatenation)."""
    i = names.index(op_name)
    p = 1.0 / (1.0 + np.exp(-float(opt.params[flat_idx].pick_logits[i])))
    return abs(p - 0.5) < TIE


def test_planned_trees_match_jax(world):
    _, _, out = world
    j, t = out["jax"]["report"], out["torch"]["report"]
    sess = out["torch"]["sess"]
    plan = out["torch"]["result"].raw.plan
    flat = 0
    for (role, js), (trole, ts) in zip(j.sections, t.sections):
        assert role == trole
        ops = plan.queries[role].semantic_ops
        names = [[p.name for p in sess.backend.candidates(op)]
                 for op in ops]

        def kept(report, others):
            other = {(s.logical_idx, s.op_name) for s in others.stages}
            rows = []
            for s in report.stages:
                if (s.logical_idx, s.op_name) not in other:
                    li = flat + s.logical_idx
                    assert _tied(out["jax"]["opt"], li, s.op_name,
                                 names[s.logical_idx]) or _tied(
                        out["torch"]["opt"], li, s.op_name,
                        names[s.logical_idx]), (role, s)
                    continue
                rows.append(s)
            return rows

        a, b = kept(ts, js), kept(js, ts)
        assert [(s.op_name, s.logical_idx, s.kind, s.is_gold) for s in a] \
            == [(s.op_name, s.logical_idx, s.kind, s.is_gold) for s in b]
        for x, y in zip(a, b):
            if not x.is_gold:
                assert abs(x.thr_lo - y.thr_lo) < 0.05, (role, x, y)
                assert abs(x.thr_hi - y.thr_hi) < 0.05, (role, x, y)
        flat += len(ops)
    assert t.feasible and j.feasible
    assert len(t.sections[-1][1].stages) >= 2      # a real pair cascade
    assert t.recall_bound == pytest.approx(j.recall_bound, abs=1e-3)
    assert t.precision_bound == pytest.approx(j.precision_bound, abs=1e-3)
    assert [r for r, _, _ in t.split] == ["left", "right", "pair"]
    text = str(t)
    assert text.startswith(f"EXPLAIN — semantic join tree over {N_SIDE} x "
                           f"{N_SIDE} items")


def test_join_guarantees_met_against_gold(world):
    _, _, out = world
    for name in ("torch", "jax"):
        m = out[name]["metrics"]
        assert m["n_gold"] > 0
        assert m["recall"] >= TARGET and m["precision"] >= TARGET, (name, m)
    tg = out["torch"]["result"].gold()
    jg = out["jax"]["result"].gold()
    assert tg.pair_ids == jg.pair_ids
    assert _ints(tg.stage_stats) == _ints(jg.stage_stats)


def test_join_result_and_explain_analyze(world):
    _, _, out = world
    res = out["torch"]["result"]
    assert len(res) == len(res.pair_ids)
    assert [(p.left.item_id, p.right.item_id) for p in res.matches()] == \
        res.pair_ids
    assert res.role("pair").accepted.shape == (len(res.pair_items),)
    report = res.explain_analyze()
    assert report.analyzed and str(report).startswith("EXPLAIN ANALYZE")
    assert report.measured_pairs == len(res.pair_items)
    assert sum(r.get("meas_tuples") or 0 for r in report.rows()) == \
        sum(s.n_tuples for s in res.stage_stats)
    keys = [(s.logical_idx, s.stage, s.op_name) for s in res.stage_stats]
    assert len(keys) == len(set(keys))
