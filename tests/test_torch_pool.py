"""Engine pools in the port, held to the JAX package's (twins of
`tests/test_pool.py`, without the `sharded` dispatcher, which is not
ported).

One world: 60 planted items (dataset seed 7) under the reference's
two-tier pool, a fast engine serving "sm" (kv80, kv50) and an accurate
engine serving "lg" (kv50 and the gold, which defines the reference).
Both packages build the same pool (the port with device="cpu", the plain
kernel versions), with both profiling clocks pinned to one deterministic
cost model (`test_torch_api.pin_clock`, on the operator name past its
``engine/`` prefix), and plan the quickstart-style query (sem_filter
task 1, sem_map task 2, recall and precision 0.7).

Held to:
  - the same candidate lists (``engine/op`` names and order) and the
    same plan stages as the JAX pool, engines included;
  - the JAX package's plan, run through the port's pool: the same
    decisions and the same integer StageStats per stage (n_tuples,
    n_llm_calls, kv_bytes, engine), tuples whose scores sit within
    MARGIN of a threshold excepted (none does on this corpus);
  - per-engine totals that partition the run exactly, each engine's
    kv_bytes equal to its own CacheStore's counter;
  - decisions bit-identical across inline, threads:2 and per-engine
    affinity dispatch; a one-engine pool bit-identical to the bare
    backend; the flat config planning as the explicit single spec.
"""
import numpy as np
import pytest

import repro
import repro.runtime.executor as jex
import repro_torch
import repro_torch.runtime.executor as tex
from repro.data import synthetic as jsyn
from repro_torch.api import EngineSpec, Session, SessionConfig
from repro_torch.runtime import (DEFAULT_COALESCE, InlineDispatcher,
                                 PoolBackend, ThreadPoolDispatcher, run_plan,
                                 stage_stats_by_engine)

from test_torch_api import MARGIN, pinned_wall

N_ITEMS = 60
DISPATCHERS = ("inline", "threads:2")
# the single-engine tests pin invariants of the port, not plan quality
TINY = repro_torch.PlannerConfig(steps=40, restarts=1, snapshots=2)


def pool_wall(op_name: str, n: int) -> float:
    """test_torch_api's pinned cost of the operator past its engine."""
    return pinned_wall(op_name.rpartition("/")[2], n)


def pin_pool_clock(mp, executor_module):
    real = executor_module.run_operator

    def run_operator(backend, op, op_name, items):
        out = real(backend, op, op_name, items)
        out.wall_s = pool_wall(op_name, len(items))
        return out

    mp.setattr(executor_module, "run_operator", run_operator)


def _pool_config(pkg, root, **kw):
    return pkg.SessionConfig(
        engines=(
            pkg.EngineSpec("fast", models=("sm",), sm_ratios=(0.8, 0.5),
                           lg_ratios=(), cache_dir=str(root / "fast"),
                           device_cache=False, **kw),
            pkg.EngineSpec("accurate", models=("lg",), sm_ratios=(),
                           lg_ratios=(0.5,), include_cheap=False,
                           cache_dir=str(root / "accurate"),
                           device_cache=False, **kw)),
        gold_engine="accurate",
        planner=pkg.PlannerConfig(steps=120, restarts=2, snapshots=2),
        sample_frac=0.35, partition_size=40)


def _frame(sess, items):
    return (sess.frame(items)
            .sem_filter("f1", 1)
            .sem_map("extract v2", 2)
            .with_guarantees(recall=0.7, precision=0.7))


def _stages(plan):
    return [(s.logical_idx, s.stage, s.op_name, s.is_gold, s.engine)
            for s in plan.stages]


def _ints(r):
    return [(s.op_name, s.engine, s.logical_idx, s.stage, s.n_tuples,
             s.n_llm_calls, s.kv_bytes) for s in r.stage_stats]


def _to_port_plan(jplan):
    from repro_torch.core.physical import PhysicalPlan, PhysicalPlanStage
    fields = ("logical_idx", "stage", "op_name", "thr_hi", "thr_lo",
              "is_map", "is_gold", "cost", "sel_inter", "sel_intra",
              "exp_batch", "engine")
    return PhysicalPlan(
        [PhysicalPlanStage(**{f: getattr(s, f) for f in fields})
         for s in jplan.stages], [], jplan.est_cost, jplan.recall_bound,
        jplan.precision_bound, jplan.feasible)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both packages' pools over one corpus, planned under the pinned
    clock, and a flat single-engine port Session over the same corpus."""
    ds = jsyn.make_dataset("pool", N_ITEMS, seed=7)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        pin_pool_clock(mp, jex)
        pin_pool_clock(mp, tex)
        for name, pkg, kw in (("jax", repro, {}),
                              ("torch", repro_torch, {"device": "cpu"})):
            sess = pkg.Session(_pool_config(
                pkg, tmp_path_factory.mktemp(name), **kw))
            sess.prepare(ds.items)
            frame = _frame(sess, ds.items)
            out[name] = dict(sess=sess, frame=frame, plan=frame.plan(),
                             result=frame.execute(dispatcher="inline"))
        tsess = out["torch"]["sess"]
        out["jax_plan_on_torch"] = tsess.run(
            _to_port_plan(out["jax"]["plan"]),
            out["torch"]["frame"].to_query(), ds.items,
            dispatcher="inline")
    flat = Session(SessionConfig(
        cache_dir=str(tmp_path_factory.mktemp("flat")),
        profile_ratios=(0.0, 0.8), sm_ratios=(0.8, 0.0), lg_ratios=(0.8,),
        planner=TINY, sample_frac=0.4, partition_size=30, device="cpu"))
    flat.prepare(ds.items)
    out["flat"] = flat
    yield ds, out
    for sess in (out["jax"]["sess"], out["torch"]["sess"], flat):
        sess.close()


def test_pool_candidates_contract(world):
    """Union candidates: engine-tagged, unique names, cost-ordered,
    exactly one gold (the gold engine's), last — and the JAX pool's
    names in the JAX pool's order."""
    _, out = world
    tsess, jsess = out["torch"]["sess"], out["jax"]["sess"]
    jops = out["jax"]["frame"].to_query().semantic_ops
    for op, jop in zip(out["torch"]["frame"].to_query().semantic_ops, jops):
        cands = tsess.backend.candidates(op)
        names = [c.name for c in cands]
        assert names == [c.name for c in jsess.backend.candidates(jop)]
        assert len(set(names)) == len(names)
        assert all("/" in n for n in names)
        assert all(c.engine_name in ("fast", "accurate") for c in cands)
        golds = [c for c in cands if c.is_gold]
        assert golds == [cands[-1]]
        assert cands[-1].engine_name == "accurate"
        costs = [c.cost_model() for c in cands[:-1]]
        assert costs == sorted(costs)


def test_pool_resolve_and_member_errors(world):
    _, out = world
    sess = out["torch"]["sess"]
    op = out["torch"]["frame"].to_query().semantic_ops[0]
    with pytest.raises(ValueError, match="unknown engine 'slow'"):
        sess.backend.resolve(op, "slow/sm-kv80")
    with pytest.raises(KeyError):
        sess.backend.resolve(op, "fast/lg-kv00")
    assert sess.backend.member("fast").engine is sess.engines["fast"]
    with pytest.raises(ValueError, match="unknown engine"):
        sess.backend.member("slow")
    with pytest.raises(ValueError, match="duplicate"):
        PoolBackend([("a", sess.backend.member("fast")),
                     ("a", sess.backend.member("accurate"))])
    with pytest.raises(ValueError, match="not a pool member"):
        PoolBackend([("a", sess.backend.member("fast"))], gold="b")
    with pytest.raises(ValueError, match="per-engine ladders"):
        sess.config.ladder()
    with pytest.raises(ValueError, match="adopts exactly one engine"):
        Session(sess.config, engine=sess.engines["fast"])


def test_plan_mixes_engines_and_explain_column(world):
    """The port plans the JAX pool's stages (engines included) under the
    pinned clock; the plan mixes both engines; EXPLAIN has the engine
    column."""
    _, out = world
    plan = out["torch"]["plan"]
    assert _stages(plan) == _stages(out["jax"]["plan"])
    assert {st.engine for st in plan.stages} == {"fast", "accurate"}
    for st in plan.stages:
        assert st.op_name.startswith(st.engine + "/")
        if st.is_gold:
            assert st.engine == "accurate"
    frame = out["torch"]["frame"]
    rep = frame.explain()
    assert [s.engine for s in rep.stages] == [st.engine
                                              for st in plan.stages]
    text = rep.render()
    assert "engine" in text and "fast" in text and "accurate" in text
    assert all("engine" in row for row in rep.rows())


def _near_margin(sess, items, query, plan):
    from repro_torch.runtime.executor import run_operator
    near = np.zeros(len(items), bool)
    for st in plan.stages:
        sc = np.asarray(run_operator(sess.backend,
                                     query.semantic_ops[st.logical_idx],
                                     st.op_name, items).scores)
        thrs = [0.0] if st.is_gold else [
            x for x in ((st.thr_hi,) if st.is_map else (st.thr_hi, st.thr_lo))
            if np.isfinite(x)]
        for x in thrs:
            near |= np.abs(sc - x) < MARGIN
    return near


def test_jax_plan_on_the_port_pool_matches_jax(world):
    """The JAX pool's plan through the port's pool: the same decisions
    and the same integer StageStats, stage by stage and engine by
    engine."""
    ds, out = world
    j, t = out["jax"]["result"], out["jax_plan_on_torch"]
    query = out["torch"]["frame"].to_query()
    far = ~_near_margin(out["torch"]["sess"], ds.items, query, t.plan)
    assert far.all()          # on this corpus no score sits within MARGIN
    np.testing.assert_array_equal(t.accepted, j.accepted)
    for li in j.map_values:
        np.testing.assert_array_equal(
            np.asarray(t.map_values[li]).astype(np.int64),
            np.asarray(j.map_values[li]).astype(np.int64))
    assert _ints(t) == _ints(j.raw)
    assert set(stage_stats_by_engine(t.stage_stats)) == {"fast", "accurate"}


def test_per_engine_attribution_sums_exactly(world):
    """Per-stage engine tags partition the run's telemetry exactly: the
    per-engine groups sum to the session totals, and each engine's KV
    bytes match its own cache store's counter delta."""
    ds, out = world
    sess, frame = out["torch"]["sess"], out["torch"]["frame"]
    stores = {name: eng.store for name, eng in sess.engines.items()}
    before = {name: st.bytes_loaded for name, st in stores.items()}
    res = frame.execute(dispatcher="inline")
    deltas = {name: st.bytes_loaded - before[name]
              for name, st in stores.items()}
    per_engine = res.engine_totals()
    assert set(per_engine) <= {"fast", "accurate"}
    assert sum(d["kv_bytes"] for d in per_engine.values()) \
        == sum(s.kv_bytes for s in res.stage_stats)
    assert sum(d["n_llm_calls"] for d in per_engine.values()) \
        == res.n_llm_tuples
    assert sum(d["n_tuples"] for d in per_engine.values()) \
        == sum(s.n_tuples for s in res.stage_stats)
    for name, delta in deltas.items():
        assert per_engine.get(name, {"kv_bytes": 0})["kv_bytes"] == delta
    assert per_engine["accurate"]["kv_bytes"] > 0
    for s in res.stage_stats:
        assert s.op_name.startswith(s.engine + "/")
    # the JAX pool's per-engine integer totals
    jtot = out["jax"]["result"].engine_totals()
    assert {e: (d["n_tuples"], d["n_llm_calls"], d["kv_bytes"])
            for e, d in per_engine.items()} == \
        {e: (d["n_tuples"], d["n_llm_calls"], d["kv_bytes"])
         for e, d in jtot.items()}
    rep = res.explain_analyze()
    assert {e: (t, k) for e, _, t, _, k in rep.measured_engines} \
        == {e: (d["n_tuples"], d["kv_bytes"])
            for e, d in per_engine.items()}
    text = rep.render()
    assert "engine accurate:" in text and "engine fast:" in text


@pytest.mark.parametrize("dispatcher", DISPATCHERS)
def test_pool_execution_parity_across_dispatchers(world, dispatcher):
    _, out = world
    frame = out["torch"]["frame"]
    ref = frame.execute(dispatcher="inline")
    res = frame.execute(dispatcher=dispatcher, partition_size=23)
    np.testing.assert_array_equal(res.accepted, ref.accepted)
    for li in ref.map_values:
        np.testing.assert_array_equal(res.map_values[li],
                                      ref.map_values[li])
    key = lambda s: (s.engine, s.logical_idx, s.stage, s.op_name)
    assert {key(s): (s.kv_bytes, s.n_tuples, s.n_llm_calls)
            for s in res.stage_stats} == \
        {key(s): (s.kv_bytes, s.n_tuples, s.n_llm_calls)
         for s in ref.stage_stats}


def test_engine_affinity_dispatcher_parity(world):
    """Per-engine thread affinity routes flushes to dedicated pools
    without changing a single decision."""
    _, out = world
    frame = out["torch"]["frame"]
    ref = frame.execute(dispatcher="inline")
    disp = ThreadPoolDispatcher(2, engine_workers={"fast": 1,
                                                   "accurate": 2})
    res = frame.execute(dispatcher=disp)
    disp.close()
    np.testing.assert_array_equal(res.accepted, ref.accepted)
    for li in ref.map_values:
        np.testing.assert_array_equal(res.map_values[li],
                                      ref.map_values[li])


def test_session_builds_affinity_dispatcher():
    """A 'threads' session default + EngineSpec.dispatcher hints resolve
    to one session-owned ThreadPoolDispatcher with per-engine pools."""
    cfg = SessionConfig(
        engines=(EngineSpec("a", dispatcher=2, device="cpu"),
                 EngineSpec("b", dispatcher="threads:3", device="cpu")),
        dispatcher="threads:2", device="cpu")
    sess = Session(cfg, backend=lambda op: [])   # no engine build needed
    disp = sess._default_dispatcher()
    assert isinstance(disp, ThreadPoolDispatcher)
    assert disp.engine_workers == {"a": 2, "b": 3}
    assert disp.n_workers == 2
    assert sess._default_dispatcher() is disp    # built once, reused
    sess.close()                                  # closes the dispatcher
    sess2 = Session(SessionConfig(dispatcher="threads:2", device="cpu"),
                    backend=lambda op: [])
    assert sess2._default_dispatcher() == "threads:2"
    sess2.close()
    for bad in (0, "inline", 1.5):
        with pytest.raises(ValueError):
            EngineSpec("x", dispatcher=bad)
    with pytest.raises(ValueError, match="cost_scale"):
        EngineSpec("x", cost_scale=0.0)
    with pytest.raises(ValueError, match="gold_engine"):
        SessionConfig(engines=(EngineSpec("a"),), gold_engine="b")


def test_flush_tasks_carry_engine_tag(world):
    """Every FlushTask the executor submits is tagged with the stage's
    owning engine — the hook per-engine dispatch affinity routes on."""
    _, out = world
    seen = []

    class Recording(InlineDispatcher):
        def submit(self, task, runner):
            seen.append((task.op_name, task.engine))
            return super().submit(task, runner)

    out["torch"]["frame"].execute(dispatcher=Recording())
    assert seen
    for op_name, engine in seen:
        assert engine in ("fast", "accurate")
        assert op_name.startswith(engine + "/")


def test_one_engine_pool_bit_identical_to_bare_backend(world, monkeypatch):
    """A PoolBackend wrapping one engine plans the same cascade (modulo
    the ``default/`` name prefix) and decides bit-identically to the
    bare KVCacheBackend, under every ported dispatcher."""
    from repro_torch.core import plan_query
    ds, out = world
    sess = out["flat"]
    pin_pool_clock(monkeypatch, tex)
    q = _frame(sess, ds.items).to_query()
    pool = PoolBackend([("default", sess.backend)])
    cfg = sess.config.planner
    bare_plan = plan_query(q, ds.items, sess.backend, cfg, sample_frac=0.4,
                           seed=0, coalesce=DEFAULT_COALESCE, device="cpu")
    pool_plan = plan_query(q, ds.items, pool, cfg, sample_frac=0.4, seed=0,
                           coalesce=DEFAULT_COALESCE, device="cpu")
    assert [("default/" + st.op_name, st.thr_hi, st.thr_lo, st.is_gold)
            for st in bare_plan.stages] \
        == [(st.op_name, st.thr_hi, st.thr_lo, st.is_gold)
            for st in pool_plan.stages]
    assert all(st.engine == "default" for st in pool_plan.stages)
    assert all(st.engine == "" for st in bare_plan.stages)
    for disp in DISPATCHERS:
        ref = run_plan(bare_plan, q, ds.items, sess.backend,
                       partition_size=30, dispatcher=disp)
        got = run_plan(pool_plan, q, ds.items, pool, partition_size=30,
                       dispatcher=disp)
        np.testing.assert_array_equal(got.accepted, ref.accepted,
                                      err_msg=disp)
        for li in ref.map_values:
            np.testing.assert_array_equal(got.map_values[li],
                                          ref.map_values[li], err_msg=disp)
        assert got.n_llm_tuples == ref.n_llm_tuples, disp
        assert [(s.n_tuples, s.n_llm_calls, s.kv_bytes)
                for s in got.stage_stats] \
            == [(s.n_tuples, s.n_llm_calls, s.kv_bytes)
                for s in ref.stage_stats], disp


def test_flat_config_plans_identically_to_explicit_spec(world,
                                                        tmp_path_factory,
                                                        monkeypatch):
    """The flat -> EngineSpec shim is a pure compilation step: an explicit
    single-spec SessionConfig plans the same stages and decides
    bit-identically to the flat form."""
    ds, out = world
    flat_sess = out["flat"]
    pin_pool_clock(monkeypatch, tex)
    spec = flat_sess.config.resolved_engines()[0]
    explicit_sess = Session(SessionConfig(
        engines=(EngineSpec(
            "default", models=spec.models, sm_ratios=spec.sm_ratios,
            lg_ratios=spec.lg_ratios, include_cheap=spec.include_cheap,
            profile_ratios=spec.profile_ratios,
            prefill_batch=spec.prefill_batch,
            memory_budget_bytes=spec.memory_budget_bytes,
            max_batch=spec.max_batch, model_seed=spec.model_seed,
            cache_dir=str(tmp_path_factory.mktemp("explicit")),
            device="cpu"),),
        planner=flat_sess.config.planner, sample_frac=0.4,
        partition_size=30))
    try:
        flat = _frame(flat_sess, ds.items)
        explicit = _frame(explicit_sess, ds.items)
        fp, ep = flat.plan(), explicit.plan()
        assert [(st.op_name, st.thr_hi, st.thr_lo, st.is_gold, st.engine)
                for st in fp.stages] \
            == [(st.op_name, st.thr_hi, st.thr_lo, st.is_gold, st.engine)
                for st in ep.stages]
        fr, er = flat.execute(), explicit.execute()
        np.testing.assert_array_equal(er.accepted, fr.accepted)
        for li in fr.map_values:
            np.testing.assert_array_equal(er.map_values[li],
                                          fr.map_values[li])
        assert set(stage_stats_by_engine(fr.stage_stats)) == {""}
    finally:
        explicit_sess.close()
