"""The port's streaming runtime against the JAX package's: one hand-made
cascade plan (the quickstart query: sem_filter task 1, then sem_map task
2) over a 64-item planted world, run through `run_plan` in both packages.

Accepted sets and map values must be equal for every tuple whose scores
sit more than MARGIN from every threshold the plan applies to them (the
scores agree to ~1e-6 in float32), and the integer StageStats exactly.
Inside the port, inline and thread-pool dispatch must be bit-identical.
"""
import numpy as np
import pytest

from repro.cache.store import CacheStore as JStore
from repro.core.logical import Query as JQuery
from repro.core.logical import SemFilter as JSemFilter
from repro.core.logical import SemMap as JSemMap
from repro.core.physical import PhysicalPlan as JPlan
from repro.core.physical import PhysicalPlanStage as JStage
from repro.data import synthetic as jsyn
from repro.runtime.backend import KVCacheBackend as JBackend
from repro.runtime.executor import run_plan as jrun_plan
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.cache.store import CacheStore
from repro_torch.core.logical import Query, SemFilter, SemMap
from repro_torch.core.physical import PhysicalPlan, PhysicalPlanStage
from repro_torch.data import synthetic as tsyn
from repro_torch.runtime import kernel as tkernel
from repro_torch.runtime.backend import KVCacheBackend
from repro_torch.runtime.executor import iter_plan, run_plan
from repro_torch.serving.engine import ServingEngine

MARGIN = 1e-4
# (logical_idx, stage, op, thr_hi, thr_lo, is_map, is_gold)
STAGES = [(0, 0, "sm-kv80", 2.0, -2.0, False, False),
          (1, 0, "sm-kv50", 1.5, -np.inf, True, False),
          (0, 1, "lg-kv50", 1.0, -1.0, False, False),
          (0, 2, "lg-kv00", 0.0, 0.0, False, True),
          (1, 1, "lg-kv00", 0.0, 0.0, True, True)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    ds = jsyn.make_dataset("rt", 64, seed=7)
    jeng = JEngine(JStore(str(tmp_path_factory.mktemp("jax"))),
                   device_cache=False)
    teng = ServingEngine(CacheStore(str(tmp_path_factory.mktemp("torch"))),
                         device_cache=False, device="cpu")
    for size, ratios in (("sm", (0.8, 0.5)), ("lg", (0.5, 0.0))):
        jcfg = jsyn.planted_config(size)
        jeng.register_model(size, jcfg, jsyn.make_planted_params(jcfg, seed=0))
        jeng.build_profiles(size, ds.items, ratios=ratios, prefill_batch=32)
        tcfg = tsyn.planted_config(size)
        teng.register_model(size, tcfg, tsyn.make_planted_params(
            tcfg, seed=0, device="cpu"))
        teng.build_profiles(size, ds.items, ratios=ratios, prefill_batch=32)
    kw = dict(sm_ratios=(0.8, 0.5), lg_ratios=(0.5,), include_cheap=False)
    jq = JQuery([JSemFilter("mentions topic 1", 1),
                 JSemMap("extract field 2", 2)])
    tq = Query([SemFilter("mentions topic 1", 1),
                SemMap("extract field 2", 2)])
    jplan = JPlan([JStage(*s, cost=0.1) for s in STAGES], [], 0.0, 1.0, 1.0,
                  True)
    tplan = PhysicalPlan([PhysicalPlanStage(*s, cost=0.1) for s in STAGES],
                         [], 0.0, 1.0, 1.0, True)
    return (ds, jeng, JBackend(jeng, **kw), jq, jplan,
            teng, KVCacheBackend(teng, **kw), tq, tplan)


def _near_threshold(ds, teng):
    """Tuples with some plan score within MARGIN of a threshold it meets."""
    ids = [it.item_id for it in ds.items]
    near = np.zeros(len(ids), bool)
    for li, _, op, hi, lo, is_map, is_gold in STAGES:
        model, ratio = op.split("-kv")[0], int(op.split("-kv")[1]) / 100
        if is_map:
            _, s = teng.run_map(model, ratio, ids, [tsyn.map_query_token(2)],
                                [tsyn.value_token(v) for v in range(8)])
        else:
            s = teng.run_filter(model, ratio, ids,
                                [tsyn.filter_query_token(1)], tsyn.TOK_YES,
                                tsyn.TOK_NO)
        thr = [0.0] if is_gold else [t for t in (hi, lo) if np.isfinite(t)]
        for t in thr:
            near |= np.abs(s - t) < MARGIN
    return near


def test_plan_decisions_and_telemetry_match_jax(worlds):
    ds, jeng, jbe, jq, jplan, teng, tbe, tq, tplan = worlds
    jr = jrun_plan(jplan, jq, ds.items, jbe, partition_size=16)
    tr = run_plan(tplan, tq, ds.items, tbe, partition_size=16)
    near = _near_threshold(ds, teng)
    assert not near.any(), "the seeded world puts no tuple near a threshold"
    np.testing.assert_array_equal(tr.accepted, jr.accepted)
    assert set(tr.map_values) == set(jr.map_values)
    for li in jr.map_values:
        np.testing.assert_array_equal(tr.map_values[li].astype(np.int64),
                                      jr.map_values[li].astype(np.int64))
    ints = ("op_name", "logical_idx", "stage", "n_tuples", "n_llm_calls",
            "kv_bytes", "n_batches")
    assert [[s.as_dict()[k] for k in ints] for s in tr.stage_stats] == \
        [[s.as_dict()[k] for k in ints] for s in jr.stage_stats]
    assert tr.n_llm_tuples == jr.n_llm_tuples
    assert 0 < tr.accepted.sum() < len(ds.items)


def test_inline_and_threads_are_bit_identical(worlds):
    ds, *_, teng, tbe, tq, tplan = worlds
    a = run_plan(tplan, tq, ds.items, tbe, partition_size=16,
                 dispatcher="inline")
    b = run_plan(tplan, tq, ds.items, tbe, partition_size=16,
                 dispatcher="threads:2")
    assert b.dispatcher == "threads" and b.n_workers == 2
    np.testing.assert_array_equal(a.accepted, b.accepted)
    for li in a.map_values:
        np.testing.assert_array_equal(a.map_values[li], b.map_values[li])
    assert [(s.n_tuples, s.kv_bytes) for s in a.stage_stats] == \
        [(s.n_tuples, s.kv_bytes) for s in b.stage_stats]


def test_iter_plan_partitions_tile_the_result(worlds):
    ds, *_, teng, tbe, tq, tplan = worlds
    gen = iter_plan(tplan, tq, ds.items, tbe, partition_size=16)
    parts = []
    while True:
        try:
            parts.append(next(gen))
        except StopIteration as stop:
            final = stop.value
            break
    assert [p.lo for p in parts] == [0, 16, 32, 48]
    np.testing.assert_array_equal(
        np.concatenate([p.accepted for p in parts]), final.accepted)
    total = sum(s.n_tuples for p in parts for s in p.stage_stats)
    assert total == sum(s.n_tuples for s in final.stage_stats)


def test_decide_rule_matches_jax():
    from repro.runtime import kernel as jkernel
    rng = np.random.default_rng(0)
    s = rng.normal(scale=3, size=37).astype(np.float32)
    for hi, lo, is_map in ((1.0, -1.0, False), (-0.5, 0.5, False),
                           (1.5, -np.inf, True), (np.inf, -np.inf, False)):
        for a, b in zip(tkernel.decide(s, hi, lo, is_map),
                        jkernel.decide(s, hi, lo, is_map)):
            np.testing.assert_array_equal(a, b)
    for is_map in (False, True):
        for a, b in zip(tkernel.gold_decide(s, is_map),
                        jkernel.gold_decide(s, is_map)):
            np.testing.assert_array_equal(a, b)


def test_unported_dispatchers_raise():
    """The partition-scatter dispatchers are ported now: their specs
    resolve; an unknown spec still raises."""
    from repro_torch.runtime.dispatch import (MeshDispatcher,
                                              ShardedDispatcher,
                                              resolve_dispatcher)
    d, owned = resolve_dispatcher("sharded:2")
    assert isinstance(d, ShardedDispatcher) and owned and d.n_shards == 2
    d, owned = resolve_dispatcher("mesh:2")
    assert isinstance(d, MeshDispatcher) and owned and d.n_shards == 2
    with pytest.raises(ValueError):
        resolve_dispatcher("bogus")
