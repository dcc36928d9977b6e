"""The port's compression, cache store and serving engine against the JAX
package's, on the planted sm / lg world (float32).

Both engines build profiles of the same corpus from the same planted
weights; scores must agree at atol 1e-4 (log-odds and margins are sums
over a vocabulary row; float32), kv_bytes exactly. Kept-position sets
must match exactly, apart from positions whose score lies within 1e-5
(relative) of the cut, where float reassociation may swap a tie.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import compression as jcomp
from repro.cache.store import CacheStore as JStore
from repro.cache.store import Profile as JProfile
from repro.data import synthetic as jsyn
from repro.models import transformer as jT
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.cache import compression as tcomp
from repro_torch.cache.store import CacheStore, Profile
from repro_torch.data import synthetic as tsyn
from repro_torch.serving.engine import ServingEngine

RATIOS = (0.0, 0.5, 0.8)
TASK_F, TASK_M = 1, 2


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    ds = jsyn.make_dataset("t", 40, seed=11)
    jeng = JEngine(JStore(str(tmp_path_factory.mktemp("jax"))),
                   device_cache=False)
    teng = ServingEngine(CacheStore(str(tmp_path_factory.mktemp("torch"))),
                         device_cache=False, device="cpu")
    for size in ("sm", "lg"):
        jcfg = jsyn.planted_config(size)
        jeng.register_model(size, jcfg, jsyn.make_planted_params(jcfg, seed=1))
        jeng.build_profiles(size, ds.items, ratios=RATIOS, prefill_batch=20)
        tcfg = tsyn.planted_config(size)
        teng.register_model(size, tcfg, tsyn.make_planted_params(
            tcfg, seed=1, device="cpu"))
        teng.build_profiles(size, ds.items, ratios=RATIOS, prefill_batch=20)
    return jeng, teng, ds


def test_query_stats_match(engines):
    jeng, teng, _ = engines
    for size in ("sm", "lg"):
        js, ts = jeng.models[size].stats, teng.models[size].stats
        np.testing.assert_allclose(ts.mu.numpy(), np.asarray(js.mu),
                                   atol=2e-5, rtol=1e-5)
        np.testing.assert_allclose(ts.sig2.numpy(), np.asarray(js.sig2),
                                   atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("ratio", [0.5, 0.8])
def test_kept_sets_match(engines, ratio):
    """Same cache and stats into both packages' scoring + top-k."""
    jeng, _, ds = engines
    jcfg = jsyn.planted_config("lg")
    em = jeng.models["lg"]
    tcfg = tsyn.planted_config("lg")
    toks = np.zeros((1, 160), np.int32)
    it = ds.items[3]
    toks[0, :len(it.tokens)] = it.tokens
    _, jcache = jT.prefill(em.params, jcfg, tokens=jnp.asarray(toks))
    n = len(it.tokens)
    item = {k: jcache[k] for k in ("k", "v")}
    jscores = np.asarray(jcomp.score_positions(jcfg, item, em.stats, n))
    keep = max(4, int(round((1.0 - ratio) * n)))
    _, jidx = jax.lax.top_k(jnp.asarray(jscores), keep)
    titem = {k: torch.from_numpy(np.array(v)) for k, v in item.items()}
    tstats = tcomp.QueryStats(torch.from_numpy(np.asarray(em.stats.mu)),
                              torch.from_numpy(np.asarray(em.stats.sig2)))
    tscores = tcomp.score_positions(tcfg, titem, tstats, n)
    np.testing.assert_allclose(tscores.numpy(), jscores, rtol=1e-5,
                               atol=1e-6)
    tidx = tcomp.top_k_positions(tscores, keep).numpy()
    for layer in range(jscores.shape[0]):
        row = jscores[layer]
        cut = np.sort(row)[::-1][keep - 1]
        near = np.abs(row - cut) <= 1e-5 * max(1.0, abs(cut))
        jset = np.zeros(row.shape, bool)
        jset[np.asarray(jidx[layer])] = True
        tset = np.zeros(row.shape, bool)
        tset[tidx[layer]] = True
        assert np.array_equal(jset[~near], tset[~near])
    arrays, new_len = tcomp.compress_item_cache(tcfg, titem, tstats, ratio,
                                                n)
    jarrays, jlen = jcomp.compress_item_cache(jcfg, item, em.stats, ratio, n)
    assert new_len == jlen
    assert arrays["k"].shape == jarrays["k"].shape


def test_top_k_ties_prefer_lower_position():
    scores = torch.tensor([[1.0, 3.0, 3.0, 0.5, 3.0, 2.0]])
    assert tcomp.top_k_positions(scores, 2).tolist() == [[1, 2]]
    _, jidx = jax.lax.top_k(jnp.asarray(scores.numpy()), 2)
    assert sorted(np.asarray(jidx)[0].tolist()) == [1, 2]


def test_quantize_kv_matches(engines):
    _, teng, _ = engines
    shard = teng.store.load(Profile("lg", 0.5), 0)
    arrays = {"k": shard["k"], "v": shard["v"]}
    want = jcomp.quantize_kv(arrays)
    got = tcomp.quantize_kv({k: torch.from_numpy(v) for k, v in
                             arrays.items()})
    for key in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(got[key].numpy(), want[key])


def test_stores_read_each_others_shards(engines):
    jeng, teng, ds = engines
    ids = [0, 5, 9]
    jcfg, tcfg = jsyn.planted_config("lg"), tsyn.planted_config("lg")
    for ratio in RATIOS:
        # a shard written by either package loads in the other
        for root in (jeng.store.root, teng.store.root):
            jc, jl = JStore(root).load_batch(jcfg, JProfile("lg", ratio), ids,
                                             pad_to_multiple=128, headroom=3)
            tc, tl = CacheStore(root).load_batch(tcfg, Profile("lg", ratio),
                                                 ids, pad_to_multiple=128,
                                                 headroom=3, device="cpu")
            np.testing.assert_array_equal(tl, jl)
            for key in ("k", "v"):
                np.testing.assert_array_equal(tc[key].numpy(),
                                              np.asarray(jc[key]))
        assert teng.store.item_nbytes(Profile("lg", ratio), 5) == \
            jeng.store.item_nbytes(JProfile("lg", ratio), 5)


def test_bf16_shards_round_trip(tmp_path):
    store = CacheStore(str(tmp_path))
    k = torch.randn(2, 7, 3, 8).bfloat16()
    v = torch.randn(2, 7, 3, 8).bfloat16()
    store.save(Profile("m", 0.5), 1, {"k": k, "v": v}, 7)
    fresh = CacheStore(str(tmp_path))
    cache, lengths = fresh.load_batch(None, Profile("m", 0.5), [1],
                                      pad_to_multiple=16, device="cpu")
    assert cache["k"].dtype == torch.bfloat16
    assert torch.equal(cache["k"][:, 0, :7], k)
    assert torch.equal(cache["v"][:, 0, 7:], torch.zeros(2, 9, 3, 8,
                                                         dtype=torch.bfloat16))
    assert fresh.item_nbytes(Profile("m", 0.5), 1) == 2 * k.numel() * 2
    assert fresh.bytes_loaded == 2 * k.numel() * 2


@pytest.mark.parametrize("size,ratio", [(s, r) for s in ("sm", "lg")
                                        for r in RATIOS])
def test_engine_scores_match_jax(engines, size, ratio):
    jeng, teng, ds = engines
    ids = [it.item_id for it in ds.items]
    qf = [jsyn.filter_query_token(TASK_F)]
    jb0, tb0 = jeng.store.bytes_loaded, teng.store.bytes_loaded
    jlo = jeng.run_filter(size, ratio, ids, qf, jsyn.TOK_YES, jsyn.TOK_NO)
    tlo = teng.run_filter(size, ratio, ids, qf, jsyn.TOK_YES, jsyn.TOK_NO)
    np.testing.assert_allclose(tlo, jlo, atol=1e-4)
    qm = [jsyn.map_query_token(TASK_M)]
    vt = [jsyn.value_token(v) for v in range(jsyn.N_VALUES)]
    jv, jc = jeng.run_map(size, ratio, ids, qm, vt)
    tv, tc = teng.run_map(size, ratio, ids, qm, vt)
    sure = jc > 1e-3           # an exact top-2 tie may pick either value
    np.testing.assert_array_equal(tv[sure], jv[sure])
    np.testing.assert_allclose(tc, jc, atol=1e-4)
    assert teng.store.bytes_loaded - tb0 == jeng.store.bytes_loaded - jb0


def test_fused_equals_scan(engines):
    _, teng, ds = engines
    scan = ServingEngine(teng.store, fused=False, device_cache=False,
                         device="cpu")
    scan.models = teng.models
    ids = [it.item_id for it in ds.items]
    q = [jsyn.filter_query_token(TASK_F), jsyn.map_query_token(TASK_M)]
    a = teng.run_filter("lg", 0.5, ids, q, jsyn.TOK_YES, jsyn.TOK_NO)
    b = scan.run_filter("lg", 0.5, ids, q, jsyn.TOK_YES, jsyn.TOK_NO)
    np.testing.assert_allclose(a, b, atol=1e-4)
    assert scan.attn_dispatches == len(q) and teng.attn_dispatches > 0


def test_device_cache_hit_matches_cold_load(engines):
    """A device-LRU hit reuses the cache tensors the previous flush wrote
    its query into: scores equal a cold load's, and no kv_bytes count."""
    _, teng, ds = engines
    warm = ServingEngine(teng.store, device_cache=True, device="cpu")
    warm.models = teng.models
    ids = [it.item_id for it in ds.items[:16]]
    qf = [jsyn.filter_query_token(TASK_F)]
    cold = teng.run_filter("lg", 0.0, ids, qf, jsyn.TOK_YES, jsyn.TOK_NO)
    first = warm.run_filter("lg", 0.0, ids, qf, jsyn.TOK_YES, jsyn.TOK_NO)
    b0 = warm.store.bytes_loaded_local
    # a different query over the same batch, then the first query again
    warm.run_filter("lg", 0.0, ids, [jsyn.map_query_token(TASK_M)],
                    jsyn.TOK_YES, jsyn.TOK_NO)
    again = warm.run_filter("lg", 0.0, ids, qf, jsyn.TOK_YES, jsyn.TOK_NO)
    assert warm.dev_cache_hits >= 2
    assert warm.store.bytes_loaded_local == b0
    np.testing.assert_array_equal(first, cold)
    np.testing.assert_array_equal(again, cold)


def test_device_cache_entry_shared_by_concurrent_flushes(engines):
    """Flushes of two queries over one LRU entry, on four threads at once:
    each writes its query into the shared tensors, and each still scores
    as a cold load does."""
    from concurrent.futures import ThreadPoolExecutor
    _, teng, ds = engines
    warm = ServingEngine(teng.store, device_cache=True, device="cpu")
    warm.models = teng.models
    ids = [it.item_id for it in ds.items[:16]]
    queries = [[jsyn.filter_query_token(TASK_F)],
               [jsyn.map_query_token(TASK_M)]]
    cold = [teng.run_filter("lg", 0.0, ids, q, jsyn.TOK_YES, jsyn.TOK_NO)
            for q in queries]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(4) as pool:
            got = list(pool.map(lambda i: warm.run_filter(
                "lg", 0.0, ids, queries[i % 2], jsyn.TOK_YES, jsyn.TOK_NO),
                range(8), timeout=300))
    finally:
        sys.setswitchinterval(switch)
    assert warm.dev_cache_misses == 1 and warm.dev_cache_hits == 7
    for i, scores in enumerate(got):
        np.testing.assert_array_equal(scores, cold[i % 2])


def test_batch_sizing_and_donation(engines):
    _, teng, ds = engines
    eng = ServingEngine(teng.store, memory_budget_bytes=3 * 160 * 2 * 96 * 4,
                        device_cache=False, async_h2d=True, device="cpu")
    eng.models = teng.models
    per_item = teng.store.item_nbytes(Profile("lg", 0.0), 0)
    assert eng.max_batch_for("lg", 0.0) == int(eng.memory_budget // per_item)
    ids = [it.item_id for it in ds.items[:10]]
    ref = teng.run_filter("lg", 0.0, ids, [jsyn.filter_query_token(1)],
                          jsyn.TOK_YES, jsyn.TOK_NO)
    got = eng.run_filter("lg", 0.0, ids, [jsyn.filter_query_token(1)],
                         jsyn.TOK_YES, jsyn.TOK_NO)
    # smaller batches: the projections see other matrix shapes
    np.testing.assert_allclose(got, ref, atol=1e-5)
    h2d, donated = eng.transfer_stats_local()
    assert donated > 0 and h2d > 0


def test_prune_dominated_matches():
    profs = [{"ratio": 0.0, "quality": 0.9, "cost": 3.0},
             {"ratio": 0.5, "quality": 0.8, "cost": 2.0},
             {"ratio": 0.8, "quality": 0.7, "cost": 2.5}]
    assert tcomp.prune_dominated(profs) == jcomp.prune_dominated(profs)


def test_query_stats_in_bfloat16_match_jax():
    """A bfloat16 GQA model: both packages project the calibration
    queries in bfloat16 and return mu / sig2 in bfloat16. Tolerance: one
    bfloat16 step (2^-8 relative) plus atol 1e-3 for values near 0 (the
    two packages' float32 reductions can round either side of a bfloat16
    boundary). The kept-position sets of the same cache, compressed with
    each package's own stats, are equal."""
    from repro.configs.base import ModelConfig as JModelConfig
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import transformer as tT
    fields = dict(name="rand-gqa-bf16", family="dense", n_layers=2,
                  d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
                  vocab_size=200, attn_kind="gqa", rope_theta=10_000.0,
                  dtype="bfloat16")
    jcfg, tcfg = JModelConfig(**fields), ModelConfig(**fields)
    jparams = jT.init_params(jcfg, jax.random.PRNGKey(7))
    tparams = tT.params_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                                 device="cpu")
    toks = np.random.default_rng(2).integers(3, 200, size=(3, 48))
    js = jcomp.calibrate_query_stats(jparams, jcfg,
                                     tokens=jnp.asarray(toks, jnp.int32))
    ts = tcomp.calibrate_query_stats(tparams, tcfg,
                                     torch.from_numpy(toks).long())
    for j, t in ((js.mu, ts.mu), (js.sig2, ts.sig2)):
        assert j.dtype == jnp.bfloat16 and t.dtype == torch.bfloat16
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j, np.float32),
                                   rtol=2 ** -8, atol=1e-3)
    _, jcache = jT.prefill(jparams, jcfg, tokens=jnp.asarray(toks[:1],
                                                             jnp.int32))
    item = {k: jcache[k] for k in ("k", "v")}
    titem = {k: torch.from_numpy(np.asarray(v, np.float32)).to(
        torch.bfloat16) for k, v in item.items()}
    for ratio in (0.5, 0.8):
        jarr, jn = jcomp.compress_item_cache(jcfg, item, js, ratio, 48)
        tarr, tn = tcomp.compress_item_cache(tcfg, titem, ts, ratio, 48)
        assert tn == jn
        np.testing.assert_array_equal(
            tarr["k"].float().numpy(), np.asarray(jarr["k"], np.float32))
