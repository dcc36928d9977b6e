"""The port's concurrent query scheduler (twins of `tests/test_scheduler.py`)
and the batch invariance of an engine flush it rests on.

Parity — N concurrent queries admitted through the port's QueryScheduler
decide bit-identically to each query's solo run, with per-query
StageStats tiling exactly, under "inline" and "threads:2" hub execution,
on the oracle world and on a two-engine planted pool (device="cpu", the
plain kernel versions).

Held to the JAX package — on the oracle world (recording operators, no
engine), both packages' schedulers get the same paused submissions with
the same prebuilt plan, so what they do can be compared: the same
decisions, the same admission order under weighted-fair tenants, the
same member-flush counts and the same per-tenant tuple counts and
virtual times in `stats()`.

Batch invariance — one item's `run_filter` log-odds and `run_map` (value,
confidence) are bit-equal alone and in flushes of 2, 4, ... up to the
profile's batch beside other items, first and last, on every rung of the
world (float32 sm and lg, int8, gold): the dense layers run at the
engine's pinned row count and the plain attention is batch-invariant.
Without that, the merged flushes of the scheduler would round an item
differently from its solo run.

One engine-backed world: 48 planted items (dataset seed 5) under a
two-engine pool ("fast" sm, "accurate" lg with an int8 rung and the
gold), device-resident LRU on, a premium and a cold tenant declared.
"""
import threading
import time

import numpy as np
import pytest

import repro
import repro.core.physical as jphys
import repro_torch
import repro_torch.core.physical as tphys
from repro.data import synthetic as jsyn
from repro.runtime import OracleBackend as JOracle
from repro.scheduler import QueryScheduler as JScheduler
from repro.scheduler import TIERS as JTIERS
from repro.scheduler import split_ints as jsplit_ints
from repro_torch.api import EngineSpec, Session, SessionConfig
from repro_torch.data import synthetic as tsyn
from repro_torch.runtime import OracleBackend, backend_engines
from repro_torch.scheduler import (TIERS, QueryScheduler, SchedulerSaturated,
                                   TenantSpec, split_ints, validate_tenants)
from repro_torch.serving.engine import flush_invariance

TINY = repro_torch.PlannerConfig(steps=40, restarts=1, snapshots=2)
JTINY = repro.PlannerConfig(steps=40, restarts=1, snapshots=2)


# ---------------------------------------------------------------------------
# TenantSpec / split_ints units
# ---------------------------------------------------------------------------

def test_tenant_spec_validation():
    assert TIERS == JTIERS
    t = TenantSpec("acme", tier="premium")
    assert t.fair_weight == 4.0 and t.warms and not t.evicts
    assert TenantSpec("x", tier="cold").evicts
    assert TenantSpec("x", weight=2.5).fair_weight == 2.5
    assert TenantSpec("x", tier="cold", keep_warm=True).warms
    with pytest.raises(ValueError, match="tier"):
        TenantSpec("x", tier="platinum")
    with pytest.raises(ValueError, match="weight"):
        TenantSpec("x", weight=0.0)
    with pytest.raises(ValueError, match="non-empty"):
        TenantSpec("")
    with pytest.raises(ValueError, match="duplicate"):
        validate_tenants((TenantSpec("a"), TenantSpec("a")))
    with pytest.raises(TypeError):
        validate_tenants(("a",))


def test_split_ints_tiles_exactly():
    for total, sizes in ((10, [3, 3, 4]), (7, [5, 5, 5]), (0, [1, 2]),
                         (13, [1]), (5, [0, 5]), (3, [])):
        out = split_ints(total, sizes)
        assert out == jsplit_ints(total, sizes)
        assert sum(out) == (total if sizes and sum(sizes) else 0)
        assert len(out) == len(sizes)
        assert all(v >= 0 for v in out)


def test_session_config_validates_tenants():
    cfg = SessionConfig(tenants=(TenantSpec("a"), TenantSpec("b")))
    assert [t.name for t in cfg.tenants] == ["a", "b"]
    with pytest.raises(ValueError, match="duplicate"):
        SessionConfig(tenants=(TenantSpec("a"), TenantSpec("a")))


def test_split_ints_remainder_on_leading_segments():
    assert split_ints(10, [3, 3, 3]) == [4, 3, 3]
    assert split_ints(11, [3, 3, 3]) == [4, 4, 3]
    assert split_ints(1003, [37, 1, 0, 256]) == [127, 3, 0, 873]
    for total, sizes in ((1003, [37, 1, 0, 256]), (97, [64, 1, 64]),
                         (5, [1, 1, 1, 1, 1, 1, 1])):
        out = split_ints(total, sizes)
        assert out == jsplit_ints(total, sizes)
        assert sum(out) == total
        n = sum(sizes)
        bumps = [o - total * s // n for o, s in zip(out, sizes)]
        assert set(bumps) <= {0, 1}
        assert bumps == sorted(bumps, reverse=True)


# ---------------------------------------------------------------------------
# recording-operator world (no engine), in both packages
# ---------------------------------------------------------------------------

def _log_filter(base):
    class LogFilter(base):
        uses_llm = True

        def __init__(self, name, task_id, log, lock, is_gold=False):
            self.name = name
            self.task_id = task_id
            self.log = log
            self.lock = lock
            self.is_gold = is_gold

        def run_filter(self, items, op):
            idx = np.asarray([it.item_id for it in items], np.float64)
            with self.lock:
                self.log.append(len(items))
            return np.asarray(
                3.0 * np.sin(idx * 12.9898 + op.task_id * 78.233),
                np.float32)
    return LogFilter


_LogFilter = _log_filter(tphys.PhysicalOperator)
_JLogFilter = _log_filter(jphys.PhysicalOperator)


def _oracle_session():
    log, lock = [], threading.Lock()
    cheap = _LogFilter("cheap", 1, log, lock)
    gold = _LogFilter("gold", 2, log, lock, is_gold=True)
    sess = Session(backend=OracleBackend(lambda op: [cheap, gold]),
                   planner=TINY, sample_frac=0.5, device="cpu")
    return sess, log


def _jax_oracle_session():
    log, lock = [], threading.Lock()
    cheap = _JLogFilter("cheap", 1, log, lock)
    gold = _JLogFilter("gold", 2, log, lock, is_gold=True)
    return repro.Session(backend=JOracle(lambda op: [cheap, gold]),
                         planner=JTINY, sample_frac=0.5)


def _frames(sess, items, tasks=(1, 1, 2, 1)):
    return [(sess.frame(items)
             .sem_filter(f"f{t}", task_id=t)
             .with_guarantees(recall=0.7, precision=0.7))
            for t in tasks]


def _jax_plan(plan):
    fields = ("logical_idx", "stage", "op_name", "thr_hi", "thr_lo",
              "is_map", "is_gold", "cost", "sel_inter", "sel_intra",
              "exp_batch", "engine")
    return jphys.PhysicalPlan(
        [jphys.PhysicalPlanStage(**{f: getattr(s, f) for f in fields})
         for s in plan.stages], [], plan.est_cost, plan.recall_bound,
        plan.precision_bound, plan.feasible)


def _jax_run(submissions, items, **kw):
    """The JAX package's scheduler over the same (query nodes, plan,
    tenant) submissions, paused, then resumed: its results, handles and
    stats()."""
    jsess = _jax_oracle_session()
    with JScheduler(jsess, paused=True, **kw) as sched:
        hs = []
        for frame, plan, tenant in submissions:
            q = frame.to_query()
            jq = repro.Query(
                [repro.SemFilter(n.text, n.task_id) for n in q.nodes],
                q.target_recall, q.target_precision)
            hs.append(sched.submit(query=jq, items=items,
                                   plan=_jax_plan(plan), tenant=tenant))
        sched.resume()
        results = [h.result(timeout=120) for h in hs]
        stats = sched.stats()
    jsess.close()
    return results, hs, stats


def _tiles(r, s):
    key = lambda sg: (sg.logical_idx, sg.stage, sg.op_name)
    mine = {key(sg): sg for sg in r.stage_stats}
    ref = {key(sg): sg for sg in s.stage_stats}
    assert set(mine) == set(ref)
    for k, sg in mine.items():
        assert (sg.n_tuples, sg.n_llm_calls, sg.n_batches) == \
            (ref[k].n_tuples, ref[k].n_llm_calls, ref[k].n_batches)


@pytest.mark.parametrize("execute", ["inline", "threads:2"])
def test_concurrent_parity_oracle(execute):
    """N concurrent queries == their solo runs, bit for bit, with exactly
    tiling per-query stats; the JAX scheduler, given the same plans,
    decides the same and folds as many member flushes."""
    sess, log = _oracle_session()
    ds = tsyn.make_dataset("sched-par", 90, seed=3)
    frames = _frames(sess, ds.items)
    solo = [f.execute() for f in frames]
    plans = [f.plan() for f in frames]
    with QueryScheduler(sess, max_concurrent=4, paused=True,
                        execute=execute) as sched:
        handles = [sched.submit(f) for f in frames]
        sched.resume()
        results = [h.result(timeout=120) for h in handles]
        stats = sched.stats()
    for r, s in zip(results, solo):
        np.testing.assert_array_equal(r.accepted, s.accepted)
        assert set(r.map_values) == set(s.map_values)
        _tiles(r, s)
    assert stats["n_flushes"] >= stats["n_calls"] > 0
    jres, _, jstats = _jax_run([(f, p, "default")
                                for f, p in zip(frames, plans)],
                               ds.items, max_concurrent=4, execute=execute)
    for r, j in zip(results, jres):
        np.testing.assert_array_equal(r.accepted, j.accepted)
    assert jstats["n_flushes"] == stats["n_flushes"]
    assert jstats["tenants"]["default"]["n_tuples"] == \
        stats["tenants"]["default"]["n_tuples"]
    sess.close()


def test_concurrent_copies_merge_flushes():
    """K concurrent copies of one query coalesce: fewer merged calls than
    member flushes, and every query's flushes ride shared batches."""
    sess, log = _oracle_session()
    ds = tsyn.make_dataset("sched-merge", 60, seed=5)
    frame = _frames(sess, ds.items, tasks=(1,))[0]
    solo = frame.execute()
    plan = frame.plan()
    log.clear()
    K = 4
    with QueryScheduler(sess, max_concurrent=K, paused=True) as sched:
        handles = [sched.submit(frame) for _ in range(K)]
        sched.resume()
        results = [h.result(timeout=120) for h in handles]
        stats = sched.stats()
    for r in results:
        np.testing.assert_array_equal(r.accepted, solo.accepted)
    assert stats["n_merged_calls"] >= 1
    assert stats["n_calls"] < stats["n_flushes"]
    assert stats["saved_calls"] == stats["n_flushes"] - stats["n_calls"]
    assert any(r.sched.shared_batches > 0 for r in results)
    for r in (r for r in results if r.sched.shared_batches):
        assert r.sched.shared_width > r.sched.n_batches
    _, _, jstats = _jax_run([(frame, plan, "default")] * K, ds.items,
                            max_concurrent=K)
    assert jstats["n_flushes"] == stats["n_flushes"]
    assert jstats["n_merged_calls"] >= 1
    sess.close()


def test_weighted_fair_admission_order():
    """With one query slot, admission replays weighted-fair virtual
    time, in the JAX scheduler's order: q0 (heavy, tie at 0 broken by
    arrival), q1 (light, vtime 0), then heavy=n/4 < light=n, so q2 before
    q3."""
    sess, _ = _oracle_session()
    ds = tsyn.make_dataset("sched-fair", 40, seed=7)
    frame = _frames(sess, ds.items, tasks=(1,))[0]
    plan = frame.plan()
    tenants = (TenantSpec("heavy", weight=4.0),
               TenantSpec("light", weight=1.0))
    who = ("heavy", "light", "heavy", "light")
    with QueryScheduler(sess, max_concurrent=1, paused=True,
                        tenants=tenants) as sched:
        hs = [sched.submit(frame, tenant=t) for t in who]
        sched.resume()
        sched.drain(timeout=120)
        stats = sched.stats()
    order = sorted(range(4), key=lambda i: hs[i].admit_t)
    assert order == [0, 1, 2, 3]
    n = stats["tenants"]["heavy"]["n_tuples"]
    assert stats["tenants"]["heavy"]["vtime"] == pytest.approx(n / 4.0)
    assert stats["tenants"]["light"]["vtime"] == pytest.approx(
        stats["tenants"]["light"]["n_tuples"] / 1.0)
    jtenants = tuple(repro.scheduler.TenantSpec(t.name, weight=t.weight)
                     for t in tenants)
    _, jhs, jstats = _jax_run([(frame, plan, t) for t in who], ds.items,
                              max_concurrent=1, tenants=jtenants)
    assert sorted(range(4), key=lambda i: jhs[i].admit_t) == order
    for name in ("heavy", "light"):
        for k in ("n_queries", "n_tuples", "vtime"):
            assert jstats["tenants"][name][k] == stats["tenants"][name][k]


def test_admission_bounds_and_errors():
    sess, _ = _oracle_session()
    ds = tsyn.make_dataset("sched-adm", 30, seed=2)
    frame = _frames(sess, ds.items, tasks=(1,))[0]
    frame.plan()
    with QueryScheduler(sess, max_concurrent=1, max_queue=2,
                        paused=True) as sched:
        h1 = sched.submit(frame)
        h2 = sched.submit(frame)
        with pytest.raises(SchedulerSaturated):
            sched.submit(frame)
        with pytest.raises(ValueError, match="unknown tenant"):
            sched.submit(frame, tenant="nobody")
        other = Session(backend=OracleBackend(
            lambda op: [_LogFilter("c", 1, [], threading.Lock()),
                        _LogFilter("g", 2, [], threading.Lock(),
                                   is_gold=True)]), device="cpu")
        with pytest.raises(ValueError, match="different Session"):
            sched.submit(other.frame(ds.items).sem_filter("f1", 1))
        other.close()
        sched.resume()
        assert h1.result(timeout=120).accepted is not None
        assert h2.result(timeout=120).accepted is not None
    with pytest.raises(RuntimeError, match="closed"):
        sched.submit(frame)
    with pytest.raises(ValueError):
        QueryScheduler(sess, max_concurrent=0)
    sess.close()


def test_handle_timeout_and_repr():
    sess, _ = _oracle_session()
    ds = tsyn.make_dataset("sched-to", 30, seed=9)
    frame = _frames(sess, ds.items, tasks=(1,))[0]
    frame.plan()
    sched = QueryScheduler(sess, paused=True)
    h = sched.submit(frame)
    assert not h.done() and "queued" in repr(h)
    with pytest.raises(TimeoutError):
        h.result(timeout=0.01)
    sched.resume()
    assert h.result(timeout=120) is not None
    assert h.done() and "done" in repr(h)
    sched.close()
    sess.close()


def test_query_error_propagates():
    """A failing operator fails that query's handle; it neither hangs the
    hub nor poisons co-admitted queries."""
    boom = {"on": False}

    class _Bomb(_LogFilter):
        def run_filter(self, items, op):
            if boom["on"]:
                raise RuntimeError("operator exploded")
            return super().run_filter(items, op)

    log, lock = [], threading.Lock()
    cheap = _Bomb("cheap", 1, log, lock)
    gold = _Bomb("gold", 2, log, lock, is_gold=True)
    sess = Session(backend=OracleBackend(lambda op: [cheap, gold]),
                   planner=TINY, sample_frac=0.5, device="cpu")
    ds = tsyn.make_dataset("sched-err", 40, seed=4)
    frame = _frames(sess, ds.items, tasks=(1,))[0]
    frame.plan()
    boom["on"] = True
    with QueryScheduler(sess, max_concurrent=2) as sched:
        h = sched.submit(frame)
        with pytest.raises(RuntimeError, match="exploded"):
            h.result(timeout=120)
    boom["on"] = False
    sess.close()


def test_explain_analyze_scheduler_footer():
    sess, _ = _oracle_session()
    ds = tsyn.make_dataset("sched-exp", 40, seed=6)
    frame = _frames(sess, ds.items, tasks=(1,))[0]
    frame.plan()
    with QueryScheduler(sess, paused=True,
                        tenants=(TenantSpec("acme", tier="premium"),)) \
            as sched:
        hs = [sched.submit(frame, tenant="acme") for _ in range(2)]
        sched.resume()
        results = [h.result(timeout=120) for h in hs]
    text = results[0].explain_analyze().render()
    assert "scheduler: tenant=acme (premium)" in text
    assert "queue_wait_s=" in text and "shared_batches=" in text
    assert results[0].sched.as_dict()["tenant"] == "acme"
    sess.close()


def test_scheduler_stress_many_small_queries():
    """Many overlapping small queries under the threads hub: all finish
    within the deadline (no deadlock), all bit-identical to solo."""
    sess, _ = _oracle_session()
    ds = tsyn.make_dataset("sched-stress", 50, seed=11)
    frames = _frames(sess, ds.items,
                     tasks=(1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 3))
    solo = [f.execute() for f in frames]
    for f in frames:
        f.plan()
    t0 = time.monotonic()
    with QueryScheduler(sess, max_concurrent=6, execute="threads:3",
                        paused=True) as sched:
        handles = [sched.submit(f) for f in frames]
        sched.resume()
        results = [h.result(timeout=180) for h in handles]
    assert time.monotonic() - t0 < 180
    for r, s in zip(results, solo):
        np.testing.assert_array_equal(r.accepted, s.accepted)
    sess.close()


def test_hub_patience_bounds_slow_member_stall():
    """While a fired group still executes, a group parked after the fire
    waits at most the patience window, not the straggler's service time;
    under "threads" execution the late group overlaps the slow one."""
    from repro_torch.core.logical import SemFilter
    from repro_torch.runtime.dispatch import FlushTask
    from repro_torch.scheduler import FlushHub

    log, lock = [], threading.Lock()

    class _SleepFilter(_LogFilter):
        def __init__(self, name, task_id, delay):
            super().__init__(name, task_id, log, lock)
            self.delay = delay

        def run_filter(self, items, op):
            time.sleep(self.delay)
            return super().run_filter(items, op)

    slow = _SleepFilter("slow", 1, 1.2)
    fast = _SleepFilter("fast", 2, 0.0)
    backend = OracleBackend(lambda op: [slow, fast])
    ds = tsyn.make_dataset("hub-slow", 20, seed=1)
    hub = FlushHub(backend, execute="threads:2", patience_s=0.05)
    elapsed, errors = {}, []

    def query(name, op_name, sem, start_delay):
        hub.register()
        try:
            time.sleep(start_delay)
            task = FlushTask(0, sem, op_name, list(ds.items), "")
            t0 = time.monotonic()
            out = hub.submit(name, task).result()
            elapsed[name] = time.monotonic() - t0
            assert len(out.scores) == len(ds.items)
        except BaseException as e:            # surface into the test
            errors.append(e)
        finally:
            hub.unregister()

    ta = threading.Thread(target=query,
                          args=("a", "slow", SemFilter("s", 1), 0.0))
    tb = threading.Thread(target=query,
                          args=("b", "fast", SemFilter("f", 2), 0.3))
    ta.start(), tb.start()
    ta.join(timeout=30), tb.join(timeout=30)
    hub.close()
    assert not errors
    assert elapsed["b"] < 0.6
    assert elapsed["a"] >= 1.0
    snap = hub.snapshot()
    assert snap["n_calls"] == 2 and snap["n_flushes"] == 2


# ---------------------------------------------------------------------------
# engine-backed world: a two-engine planted pool on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pool_world(tmp_path_factory):
    ds = tsyn.make_dataset("sched-pool", 48, seed=5)
    session = Session(SessionConfig(
        engines=(
            EngineSpec("fast", models=("sm",), sm_ratios=(0.8, 0.0),
                       lg_ratios=(), device_cache=True, device="cpu",
                       cache_dir=str(tmp_path_factory.mktemp("fast"))),
            EngineSpec("accurate", models=("lg",), sm_ratios=(),
                       lg_ratios=(0.8,), lg_int8=(0.5,),
                       include_cheap=False, device_cache=True, device="cpu",
                       cache_dir=str(tmp_path_factory.mktemp("accurate"))),
        ),
        gold_engine="accurate",
        tenants=(TenantSpec("vip", tier="premium"),
                 TenantSpec("drifter", tier="cold")),
        planner=TINY, sample_frac=0.35))
    session.prepare(ds.items)
    yield ds, session
    session.close()


def _pool_frame(sess, ds):
    return (sess.frame(ds.items)
            .sem_filter("f1", 1)
            .sem_map("extract v2", 2)
            .with_guarantees(recall=0.7, precision=0.7))


def _total_dispatches(sess):
    return sum(e.attn_dispatches for e in backend_engines(sess.backend))


def _evict_all(sess):
    for e in backend_engines(sess.backend):
        e.evict()


def test_engine_coalescing_reduces_dispatches(pool_world):
    """K concurrent copies of one query drive strictly fewer engine
    attention dispatches than K solo runs, every copy bit-identical to
    solo, and the K queries' kv_bytes sum to K x solo's. The device LRU
    is off here: with it on, a copy whose flush the hub fired unmerged
    hits the entry another copy loaded and counts no bytes, so the sum
    would depend on how the rounds merged."""
    ds, sess = pool_world
    frame = (sess.frame(ds.items).sem_filter("f1", 1)
             .with_guarantees(recall=0.7, precision=0.7))
    frame.plan()
    engines = backend_engines(sess.backend)
    for e in engines:
        e.device_cache = False
    try:
        base = _total_dispatches(sess)
        solo = frame.execute()
        solo_dispatches = _total_dispatches(sess) - base
        assert solo_dispatches > 0
        K = 3
        base = _total_dispatches(sess)
        with QueryScheduler(sess, max_concurrent=K, paused=True) as sched:
            handles = [sched.submit(frame) for _ in range(K)]
            sched.resume()
            results = [h.result(timeout=600) for h in handles]
            stats = sched.stats()
        merged_dispatches = _total_dispatches(sess) - base
    finally:
        for e in engines:
            e.device_cache = True
    for r in results:
        np.testing.assert_array_equal(r.accepted, solo.accepted)
    assert merged_dispatches < K * solo_dispatches
    assert stats["n_merged_calls"] >= 1
    solo_kv = sum(sg.kv_bytes for sg in solo.stage_stats)
    assert sum(sg.kv_bytes for r in results
               for sg in r.stage_stats) == K * solo_kv


def test_premium_warm_and_cold_evict(pool_world):
    """A premium tenant's first query pre-stages its rungs (device-cache
    hits during the run); a cold tenant's query evicts its rungs."""
    ds, sess = pool_world
    engines = backend_engines(sess.backend)
    assert all(e.device_cache for e in engines)
    frame = (sess.frame(ds.items).sem_filter("f1", 1)
             .with_guarantees(recall=0.7, precision=0.7))
    frame.plan()
    _evict_all(sess)
    hits0 = sum(e.dev_cache_hits for e in engines)
    with sess.scheduler(max_concurrent=1) as sched:
        r0 = sched.submit(frame, tenant="vip").result(timeout=600)
        stats = sched.stats()
        assert stats["tenants"]["vip"]["warm_batches"] > 0
        assert sum(e.dev_cache_hits for e in engines) > hits0
        assert sum(len(e._dev_cache) for e in engines) > 0
        r1 = sched.submit(frame, tenant="drifter").result(timeout=600)
        assert sched.stats()["tenants"]["drifter"]["evictions"] > 0
    np.testing.assert_array_equal(r0.accepted, r1.accepted)


@pytest.mark.parametrize("execute", ["inline", "threads:2"])
def test_concurrent_parity_two_engine_pool(pool_world, execute):
    """On a two-engine pool, concurrent queries decide bit-identically to
    their solo runs, stats tile, and flushes merge per engine."""
    ds, sess = pool_world
    frame = _pool_frame(sess, ds)
    solo = frame.execute()
    frame.plan()
    with QueryScheduler(sess, max_concurrent=3, paused=True,
                        execute=execute) as sched:
        handles = [sched.submit(frame) for _ in range(3)]
        sched.resume()
        results = [h.result(timeout=600) for h in handles]
        stats = sched.stats()
    for r in results:
        np.testing.assert_array_equal(r.accepted, solo.accepted)
        for li in solo.map_values:
            np.testing.assert_array_equal(r.map_values[li],
                                          solo.map_values[li])
        _tiles(r, solo)
    assert stats["n_calls"] <= stats["n_flushes"]
    engs = {sg.engine for r in results for sg in r.stage_stats}
    assert engs <= {"fast", "accurate"} and engs


@pytest.mark.parametrize("engine,model,ratio,quant", [
    ("fast", "sm", 0.8, False), ("accurate", "lg", 0.8, False),
    ("accurate", "lg", 0.5, True), ("accurate", "lg", 0.0, False)])
def test_flush_outputs_do_not_depend_on_the_batch(pool_world, engine, model,
                                                  ratio, quant):
    """An item's log-odds and (value, confidence) are bit-equal alone and
    in every flush size up to the profile's batch, first and last."""
    ds, sess = pool_world
    ids = [it.item_id for it in ds.items]
    eng = sess.engines[engine]
    got = flush_invariance(
        eng, model, ratio, ids[0], ids[1:],
        filter_args=([tsyn.filter_query_token(1)], tsyn.TOK_YES,
                     tsyn.TOK_NO),
        map_args=([tsyn.map_query_token(2)],
                  [tsyn.value_token(v) for v in range(8)]), quant=quant)
    assert max(got) == eng.max_batch_for(model, ratio, ids[0], quant=quant)
    assert all(got.values()), got
