"""The port's partition-scatter dispatchers, placement and sharding rules.

Twins of the sharded / mesh tests in tests/test_dispatch.py and
tests/test_mesh_dispatch.py, on the CPU: spec resolution, shard bounds
that tile any corpus (a Hypothesis property), every tuple flushed exactly
once under a scatter, close() fencing later scatters, `backend_engines`,
`shard_context` routing shard i to device i % n (the port's device list
patched to two CPU entries), and the core guarantee: decisions, map
values, SemTopK picks and integer StageStats of sharded / mesh runs
bit-identical to inline, with the wall clock reported beside the summed
operator time. Then `place_on` (the engine's own weights on its own
device, one copy per (model, device) elsewhere), the logical-axis rules
against the JAX package's, and one hand plan under sharded:2 in both
packages giving the same decisions.
"""
import threading

import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st

from repro_torch.core.logical import Query, RelFilter, SemFilter, SemMap
from repro_torch.core.physical import (PhysicalOperator, PhysicalPlan,
                                       PhysicalPlanStage)
from repro_torch.launch import mesh as tmesh
from repro_torch.runtime import (MeshDispatcher, ShardedDispatcher,
                                 as_backend, backend_engines,
                                 resolve_dispatcher, run_plan)
from repro_torch.runtime.executor import merge_stage_stats


# ---------------------------------------------------------------------------
# resolution and bounds
# ---------------------------------------------------------------------------

def test_resolve_specs(monkeypatch):
    d, owned = resolve_dispatcher("sharded:5")
    assert isinstance(d, ShardedDispatcher) and owned
    assert d.n_shards == 5 and d.n_workers == 5 and d.max_pending == 0
    d, _ = resolve_dispatcher("sharded")
    assert d.n_shards == 2
    d, owned = resolve_dispatcher("mesh:8")
    assert isinstance(d, MeshDispatcher) and owned and d.name == "mesh"
    assert d.n_shards == 8 and d.n_workers == 8
    d, _ = resolve_dispatcher("mesh")          # bare: every local card
    assert d.n_shards == (torch.cuda.device_count()
                          if torch.cuda.is_available() else 1)
    inst = ShardedDispatcher(3)
    assert resolve_dispatcher(inst) == (inst, False)
    monkeypatch.setenv("STRETTO_DISPATCHER", "sharded:3")
    d, owned = resolve_dispatcher(None)
    assert isinstance(d, ShardedDispatcher) and d.n_shards == 3 and owned
    with pytest.raises(ValueError, match="sharded"):
        resolve_dispatcher("gpu-farm")


@pytest.mark.parametrize("spec", ["sharded:0", "sharded:-1", "mesh:0",
                                  "mesh:-3"])
def test_resolve_rejects_nonpositive_counts(spec):
    with pytest.raises(ValueError, match="must be positive"):
        resolve_dispatcher(spec)


def _check_bounds_tile(disp, n):
    bounds = disp.shard_bounds(n)
    covered = [i for lo, hi in bounds for i in range(lo, hi)]
    assert covered == list(range(n)), \
        f"{disp.name}:{disp.n_shards} bounds {bounds} do not tile {n}"
    assert all(lo < hi for lo, hi in bounds)          # no empty shards
    assert len(bounds) <= max(disp.n_shards, 1)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 7, 8, 9, 64, 100])
@pytest.mark.parametrize("shards", [1, 2, 3, 8])
def test_shard_bounds_tile_exactly(n, shards):
    _check_bounds_tile(ShardedDispatcher(shards), n)
    _check_bounds_tile(MeshDispatcher(shards), n)


@given(n=st.integers(0, 200), shards=st.integers(1, 16))
@settings(max_examples=60, deadline=None)
def test_shard_bounds_tile_property(n, shards):
    _check_bounds_tile(ShardedDispatcher(shards), n)
    _check_bounds_tile(MeshDispatcher(shards), n)


@pytest.mark.parametrize("kind", [ShardedDispatcher, MeshDispatcher])
def test_close_idempotent_and_rejects_after(kind):
    d = kind(2)
    bounds = d.shard_bounds(4)
    assert d.map_shards(lambda i, lo, hi: (i, hi - lo), bounds) == \
        [(0, 2), (1, 2)]
    d.close()
    d.close()
    with pytest.raises(RuntimeError, match="closed"):
        d.map_shards(lambda i, lo, hi: hi - lo, bounds)


# ---------------------------------------------------------------------------
# the recording world: every tuple flushed exactly once under a scatter
# ---------------------------------------------------------------------------

class _Item:
    __slots__ = ("idx", "row")

    def __init__(self, idx: int):
        self.idx = idx
        self.row = {"grp": idx % 3}


def _score(idx, task_id):
    return np.float32(3.0 * np.sin(np.asarray(idx, np.float64) * 12.9898
                                   + task_id * 78.233))


class _Recording(PhysicalOperator):
    uses_llm = False

    def __init__(self, name, task_id, log, lock, is_gold=False):
        self.name, self.task_id, self.log, self.lock = name, task_id, log, \
            lock
        self.is_gold = is_gold

    def _record(self, items):
        idx = [it.idx for it in items]
        with self.lock:
            self.log.setdefault(self.name, []).extend(idx)
        return idx

    def run_filter(self, items, op):
        return _score(self._record(items), self.task_id)

    def run_map(self, items, op):
        idx = self._record(items)
        return np.asarray(idx, np.int64) % 5, _score(idx, self.task_id)


def _world():
    log, lock = {}, threading.Lock()
    ops = {n: _Recording(n, t, log, lock, is_gold=g)
           for n, t, g in (("f-cheap", 1, False), ("f-gold", 2, True),
                           ("m-cheap", 3, False), ("m-gold", 4, True))}
    sf, sm = SemFilter("f", 1), SemMap("m", 3)
    rel = RelFilter("grp", "!=", 0)

    def registry(op):
        return [ops["f-cheap"], ops["f-gold"]] if isinstance(op, SemFilter) \
            else [ops["m-cheap"], ops["m-gold"]]

    q = Query([sf, rel, sm], target_recall=0.8, target_precision=0.8)
    stages = [
        PhysicalPlanStage(0, 0, "f-cheap", 1.0, -1.0, False, False, 0.1),
        PhysicalPlanStage(1, 0, "m-cheap", 1.5, -np.inf, True, False, 0.1),
        PhysicalPlanStage(0, 1, "f-gold", 0.0, 0.0, False, True, 1.0),
        PhysicalPlanStage(1, 1, "m-gold", 0.0, 0.0, True, True, 1.0),
    ]
    return q, PhysicalPlan(stages, [rel], 0.0, 1.0, 1.0, True), registry, log


DISPATCHERS = ["sharded:3", "sharded:1", "mesh:2"]


def _check_flush_invariants(n, part, coalesce, dispatcher):
    items = [_Item(i) for i in range(n)]
    q, plan, registry, log = _world()
    rr = run_plan(plan, q, items, as_backend(registry), partition_size=part,
                  coalesce=coalesce, dispatcher=dispatcher)
    q2, plan2, registry2, log2 = _world()
    ref = run_plan(plan2, q2, items, as_backend(registry2),
                   dispatcher="inline")
    assert set(log) == set(log2)
    for name, idx in log.items():
        assert len(idx) == len(set(idx)), f"{name} scored a tuple twice"
        assert sorted(idx) == sorted(log2[name])
    np.testing.assert_array_equal(rr.accepted, ref.accepted)
    for li in ref.map_values:
        np.testing.assert_array_equal(rr.map_values[li], ref.map_values[li])
    dead = {it.idx for it in items if it.row["grp"] == 0}
    assert not any(dead & set(idx) for idx in log.values())
    assert rr.dispatcher == dispatcher.split(":")[0]


@pytest.mark.parametrize("dispatcher", DISPATCHERS)
def test_flushed_exactly_once_smoke(dispatcher):
    _check_flush_invariants(n=41, part=7, coalesce=13, dispatcher=dispatcher)


@given(n=st.integers(0, 60), part=st.integers(1, 23),
       coalesce=st.integers(1, 50), dispatcher=st.sampled_from(DISPATCHERS))
@settings(max_examples=30, deadline=None)
def test_flushed_exactly_once_property(n, part, coalesce, dispatcher):
    _check_flush_invariants(n, part, coalesce, dispatcher)


def test_merge_stage_stats_sums_in_plan_order():
    q, plan, registry, _ = _world()
    items = [_Item(i) for i in range(30)]
    halves = [run_plan(plan, q, items[lo:hi], as_backend(registry),
                       dispatcher="inline").stage_stats
              for lo, hi in ((0, 15), (15, 30))]
    merged = merge_stage_stats(halves, plan)
    names = [s.op_name for s in plan.stages]
    assert [s.op_name for s in merged] == \
        [n for n in names if n in {s.op_name for s in merged}]
    for m in merged:
        parts = [s for h in halves for s in h if s.op_name == m.op_name]
        assert m.n_tuples == sum(s.n_tuples for s in parts)
        assert m.n_llm_calls == sum(s.n_llm_calls for s in parts)


# ---------------------------------------------------------------------------
# shard_context placement, backend_engines
# ---------------------------------------------------------------------------

class _FakeEngine:
    device = torch.device("cpu")

    def __init__(self):
        self.placed = []

    def place_on(self, device):
        import contextlib

        @contextlib.contextmanager
        def ctx():
            self.placed.append(device)
            yield
        return ctx()


class _FakeBackend:
    def __init__(self, engine):
        self.engine = engine


def test_backend_engines_discovery():
    eng_a, eng_b = _FakeEngine(), _FakeEngine()

    class _Pool:
        members = {"a": _FakeBackend(eng_a), "b": _FakeBackend(eng_b)}

    assert backend_engines(_FakeBackend(eng_a)) == [eng_a]
    assert backend_engines(_Pool()) == [eng_a, eng_b]
    assert backend_engines(object()) == []


def test_shard_context_places_shard_i_on_device_i_mod_n(monkeypatch):
    two = [torch.device("cpu"), torch.device("cpu", 1)]
    monkeypatch.setattr(tmesh, "local_devices", lambda device="cuda": two)
    d = MeshDispatcher(5)
    assert d.mesh.axis_names == ("data", "model")
    assert d.mesh.shape == {"data": 2, "model": 1}
    eng = _FakeEngine()
    for i in range(5):
        with d.shard_context(i, _FakeBackend(eng)):
            pass
    assert eng.placed == [two[i % 2] for i in range(5)]


def test_mesh_of_a_cpu_session_is_the_cpu():
    assert [r for r in tmesh.make_dispatch_mesh(4, "cpu").devices] == \
        [[torch.device("cpu")]]
    d = MeshDispatcher(2)
    with d.shard_context(0, _FakeBackend(_FakeEngine())):
        pass
    assert d.shard_device(1) == torch.device("cpu")


# ---------------------------------------------------------------------------
# the serving engine: place_on and parity through a Session
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def session(tmp_path_factory):
    from repro_torch.api import Session, SessionConfig
    from repro_torch.core.optimizer import PlannerConfig
    from repro_torch.data.synthetic import make_dataset
    ds = make_dataset("mesh-parity", 60, seed=5)
    sess = Session(SessionConfig(
        cache_dir=str(tmp_path_factory.mktemp("cache")),
        profile_ratios=(0.0, 0.8), models=("sm",),
        sm_ratios=(0.8, 0.0), lg_ratios=(0.8,),
        planner=PlannerConfig(steps=120, restarts=2, snapshots=2),
        sample_frac=0.35, partition_size=20, device="cpu"))
    sess.prepare(ds.items)
    yield sess, ds
    sess.close()


def _int_stats(r):
    return {(s.logical_idx, s.stage, s.op_name):
            (s.n_tuples, s.n_llm_calls, s.kv_bytes) for s in r.stage_stats}


@pytest.mark.parametrize("dispatcher", ["sharded:2", "sharded:3", "mesh",
                                        "mesh:2"])
def test_scatter_bit_identical_to_inline(session, dispatcher):
    """Decisions, map values and the integer per-stage counters of a
    scatter equal inline's bit for bit; so do a SemTopK query's picks
    (one global rank cut at the merge). n_batches is not compared:
    shards flush on their own."""
    sess, ds = session
    frame = (sess.frame(ds.items)
             .sem_filter("about sports?", task_id=1)
             .sem_map("which group?", task_id=3)
             .with_guarantees(recall=0.7, precision=0.7))
    a = frame.execute(dispatcher="inline").raw
    b = frame.execute(dispatcher=dispatcher).raw
    np.testing.assert_array_equal(a.accepted, b.accepted)
    assert set(a.map_values) == set(b.map_values)
    for li in a.map_values:
        np.testing.assert_array_equal(a.map_values[li], b.map_values[li])
    assert _int_stats(a) == _int_stats(b)
    kind = dispatcher.split(":")[0]
    assert b.dispatcher == kind
    assert f"dispatcher={kind}" in str(frame.execute(
        dispatcher=dispatcher).explain_analyze())
    top = (sess.frame(ds.items).sem_topk("best sports?", task_id=1, k=7)
           .with_guarantees(recall=0.7, precision=0.7))
    ta = top.execute(dispatcher="inline").raw
    tb = top.execute(dispatcher=dispatcher).raw
    assert int(ta.accepted.sum()) == 7
    np.testing.assert_array_equal(ta.accepted, tb.accepted)
    assert tb.topk_scores is None and tb.topk_cand is None


def test_scatter_reports_wall_clock(session):
    sess, ds = session
    frame = sess.frame(ds.items).sem_filter("about sports?", task_id=1) \
        .with_guarantees(recall=0.7, precision=0.7)
    r = frame.execute(dispatcher="mesh:4").raw
    assert r.dispatcher == "mesh" and r.n_workers == 4
    assert r.wall_s > 0 and r.runtime_s > 0
    assert r.n_partitions >= 4


def test_place_on_shares_weights_on_their_own_device(session):
    sess, _ = session
    eng = sess.engine
    em = eng.models["sm"]
    with eng.place_on("cpu"):
        got = eng._params_for(em, "sm", eng._flush_device())
        assert got is em.params
        assert got["embed"].data_ptr() == em.params["embed"].data_ptr()
        with eng.place_on(torch.device("cpu", 1)):     # nests and restores
            assert eng._placement() == torch.device("cpu", 1)
        assert eng._placement() == torch.device("cpu")
    assert eng._placement() is None
    # another device: one copy per (model, device), kept
    meta = eng._params_for(em, "sm", "meta")
    assert meta["embed"].device.type == "meta"
    assert eng._params_for(em, "sm", "meta") is meta
    with pytest.raises(ValueError, match="cannot be placed"):
        with eng.place_on("meta"):
            pass


# ---------------------------------------------------------------------------
# the logical-axis rules against the JAX package's
# ---------------------------------------------------------------------------

class _Axes:
    def __init__(self, names):
        self.axis_names = names


@pytest.mark.parametrize("axes", [("data", "model"),
                                  ("pod", "data", "model")])
def test_rules_resolve_as_jax(axes):
    from repro.configs import REGISTRY as JREG
    from repro.distributed import sharding as js
    from repro.models import transformer as jT
    from repro_torch.configs import REGISTRY
    from repro_torch.distributed import sharding as ts
    from repro_torch.models import transformer as tT
    logical = sorted(ts.DEFAULT_RULES) + [None]
    assert ts.DEFAULT_RULES == js.DEFAULT_RULES
    with js.use_rules(js.make_rules(), _Axes(axes)), \
            ts.use_rules(ts.make_rules(), axes):
        for a in logical:
            for b in logical:
                assert ts.resolve((a, b)) == tuple(js.resolve((a, b)))
        for arch in ("deepseek-v2-lite-16b", "dbrx-132b", "gemma3-27b"):
            jt = js.pspec_tree(jT.param_axes(JREG[arch]))
            tt = ts.pspec_tree(tT.param_axes(REGISTRY[arch]))
            flat = {}

            def walk(t, j, path=()):
                for k in t:
                    if isinstance(t[k], dict):
                        walk(t[k], j[k], path + (k,))
                    else:
                        flat[path + (k,)] = (t[k], tuple(j[k]))
            walk(tt, jt)
            assert all(a == b for a, b in flat.values()), arch
    with pytest.raises(RuntimeError, match="use_rules"):
        ts.resolve(("batch",))


# ---------------------------------------------------------------------------
# one plan under sharded:2 in both packages
# ---------------------------------------------------------------------------

def test_sharded_plan_matches_jax(tmp_path):
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
    from repro_torch.data import synthetic as tsyn
    from repro_torch.runtime.backend import KVCacheBackend
    from repro_torch.serving.engine import ServingEngine

    stages = [(0, 0, "sm-kv80", 2.0, -2.0, False, False),
              (1, 0, "sm-kv80", 1.5, -np.inf, True, False),
              (0, 1, "lg-kv00", 0.0, 0.0, False, True),
              (1, 1, "lg-kv00", 0.0, 0.0, True, True)]
    ds = jsyn.make_dataset("sh", 40, seed=3)
    jeng = JEngine(JStore(str(tmp_path / "j")), device_cache=False)
    teng = ServingEngine(CacheStore(str(tmp_path / "t")), device_cache=False,
                         device="cpu")
    for size, ratios in (("sm", (0.8,)), ("lg", (0.0,))):
        jcfg, tcfg = jsyn.planted_config(size), tsyn.planted_config(size)
        jeng.register_model(size, jcfg, jsyn.make_planted_params(jcfg,
                                                                 seed=0))
        teng.register_model(size, tcfg, tsyn.make_planted_params(
            tcfg, seed=0, device="cpu"))
        for eng in (jeng, teng):
            eng.build_profiles(size, ds.items, ratios=ratios,
                               prefill_batch=40)
    kw = dict(sm_ratios=(0.8,), lg_ratios=(), include_cheap=False)
    jr = jrun_plan(JPlan([JStage(*s, cost=0.1) for s in stages], [], 0.0,
                         1.0, 1.0, True),
                   JQuery([JSemFilter("t1", 1), JSemMap("f2", 2)]),
                   ds.items, JBackend(jeng, **kw), dispatcher="sharded:2")
    tr = run_plan(PhysicalPlan([PhysicalPlanStage(*s, cost=0.1)
                                for s in stages], [], 0.0, 1.0, 1.0, True),
                  Query([SemFilter("t1", 1), SemMap("f2", 2)]),
                  ds.items, KVCacheBackend(teng, **kw),
                  dispatcher="sharded:2")
    ids = [it.item_id for it in ds.items]
    s = teng.run_filter("sm", 0.8, ids, [tsyn.filter_query_token(1)],
                        tsyn.TOK_YES, tsyn.TOK_NO)
    far = np.abs(np.abs(s) - 2.0) > 1e-4
    np.testing.assert_array_equal(tr.accepted[far], jr.accepted[far])
    assert tr.dispatcher == jr.dispatcher == "sharded"
    assert _int_stats(tr) == _int_stats(jr)
