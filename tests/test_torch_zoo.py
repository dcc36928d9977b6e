"""The port's model zoo against the JAX package's, on the CPU.

Every registered config: the reduced same-family config's forward shapes
and decode-vs-forward consistency (twins of tests/test_models_smoke.py),
and, with the JAX weights carried across by `params_from_jax` (float32),
forward / prefill / decode logits within atol 1e-5, hymba-1.5b and
rwkv6-1.6b (their recurrent states) included; tests/test_torch_ssm.py
holds their mixers and engines.

Then the new layers and the cache-keeping path at reduced widths:
`mla_attn_decode`, `moe_mlp` (dense and scatter, at a capacity that drops
tokens, with every router top-k margin above 1e-5 so no tie decides),
MLA query statistics and compressed keep-sets, a reduced deepseek
engine's build and `run_filter` (scores, kv_bytes, attention dispatches),
and the MoE router seeing the cache's batch, never the row pin's pad
rows. The train step waits with the training slice.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import compression as jcomp
from repro.cache.store import CacheStore as JStore
from repro.configs import REGISTRY as JREGISTRY
from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import layers as jL
from repro.models import transformer as jT
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.cache import compression as tcomp
from repro_torch.cache.store import CacheStore
from repro_torch.configs import ASSIGNED, REGISTRY, get_config
from repro_torch.configs.base import MoEConfig
from repro_torch.models import layers as tL
from repro_torch.models import transformer as tT
from repro_torch.serving.engine import ServingEngine

KEY = jax.random.PRNGKey(0)
ALL_ARCHS = sorted(REGISTRY)
ATOL = 1e-5          # float32 logits of the reduced configs (|x| < 1)


def _np(t):
    return t.detach().float().cpu().numpy()


def _pair(arch, **overrides):
    """(JAX config, JAX params, port config, port params) of the reduced
    float32 config, the JAX weights carried across."""
    jcfg = JREGISTRY[arch].reduced(dtype="float32", **overrides)
    cfg = REGISTRY[arch].reduced(dtype="float32", **overrides)
    jp = jT.init_params(jcfg, KEY)
    tp = tT.params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, cfg, tp


def _inputs(cfg, B, S, seed=0):
    """{"tokens": (B, S) int} or, for a frontend, {"embeds": (B, S, d)}."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "none":
        return {"tokens": rng.integers(0, cfg.vocab_size, (B, S))}
    return {"embeds": rng.normal(size=(B, S, cfg.d_model)).astype(
        np.float32)}


def _t(batch, sl=slice(None)):
    return {k: (torch.from_numpy(np.ascontiguousarray(v[:, sl])).long()
                if k == "tokens" else torch.from_numpy(
                    np.ascontiguousarray(v[:, sl])))
            for k, v in batch.items()}


def _j(batch, sl=slice(None)):
    return {k: jnp.asarray(v[:, sl], jnp.int32 if k == "tokens" else None)
            for k, v in batch.items()}


def test_registry_matches_jax():
    assert sorted(REGISTRY) == sorted(JREGISTRY)
    assert set(ASSIGNED) == set(REGISTRY) - {"stretto-llama-8b"}
    for name, cfg in REGISTRY.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            JREGISTRY[name]), name
        assert cfg.n_params == JREGISTRY[name].n_params
    with pytest.raises(KeyError):
        get_config("gpt-5")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_forward_shapes_no_nans(arch):
    cfg = get_config(arch).reduced()
    params = tT.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    logits, _ = tT.forward(params, cfg, **_t(_inputs(cfg, 2, 16)))
    assert tuple(logits.shape) == (2, 16, cfg.vocab_padded)
    assert not bool(torch.isnan(logits.float()).any())


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_decode_matches_forward(arch):
    cfg = get_config(arch).reduced(dtype="float32")
    params = tT.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    B, S = 2, 12
    batch = _inputs(cfg, B, S + 1)
    full, _ = tT.forward(params, cfg, **_t(batch))
    _, cache = tT.prefill(params, cfg, max_len=S + 4,
                          **_t(batch, slice(0, S)))
    dec, cache = tT.decode_step(params, cfg, cache,
                                **_t(batch, slice(S, S + 1)))
    ref = full[:, S]
    err = float((ref - dec).abs().max() / (ref.abs().max() + 1e-9))
    assert err < 5e-3, f"{arch}: decode/forward mismatch {err}"
    assert int(cache["lengths"][0]) == S + 1


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_logits_and_caches_match_jax(arch):
    """forward, prefill (its caches) and a pinned-row decode step (scan;
    and decode_multi where fused decode applies) against the JAX
    package's on the same weights and inputs."""
    jcfg, jp, cfg, tp = _pair(arch)
    B, S = 2, 13
    batch = _inputs(cfg, B, S + 2, seed=1)
    jl, _ = jT.forward(jp, jcfg, **_j(batch))
    tl, _ = tT.forward(tp, cfg, **_t(batch))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL, rtol=0)
    pre = slice(0, S)
    jlast, jc = jT.prefill(jp, jcfg, max_len=S + 4, **_j(batch, pre))
    tlast, tc = tT.prefill(tp, cfg, max_len=S + 4, **_t(batch, pre))
    np.testing.assert_allclose(_np(tlast), np.asarray(jlast), atol=ATOL,
                               rtol=0)
    for k in tT.cache_keys(cfg):
        np.testing.assert_allclose(_np(tc[k]), np.asarray(jc[k]),
                                   atol=ATOL, rtol=0)
    jd, _ = jT.decode_step(jp, jcfg, jc, **_j(batch, slice(S, S + 1)))
    tcache = {k: v.clone() for k, v in tc.items()}
    td, _ = tT.decode_step(tp, cfg, tcache, rows=5,
                           **_t(batch, slice(S, S + 1)))
    np.testing.assert_allclose(_np(td), np.asarray(jd), atol=ATOL, rtol=0)
    if tT.supports_fused_decode(cfg):
        two = slice(S, S + 2)
        jm, _ = jT.decode_multi(jp, jcfg, jc, **_j(batch, two))
        tm, _ = tT.decode_multi(tp, cfg, {k: v.clone()
                                          for k, v in tc.items()},
                                rows=4, **_t(batch, two))
        np.testing.assert_allclose(_np(tm), np.asarray(jm), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_axes_and_windows_match_jax(arch):
    jcfg, cfg = JREGISTRY[arch], REGISTRY[arch]
    assert tT.param_axes(cfg) == jT.param_axes(jcfg)
    assert tT.cache_axes(cfg) == jT.cache_axes(jcfg)
    np.testing.assert_array_equal(tT.build_window_array(cfg),
                                  jT.build_window_array(jcfg))


@pytest.mark.parametrize("arch", ["minicpm3-4b", "deepseek-v2-lite-16b"])
def test_mla_attn_decode_matches_jax(arch):
    """The absorbed MQA over the latent cache (float32), windowed and
    not, with right-padded items of different lengths."""
    jcfg, jp, cfg, tp = _pair(arch)
    jattn = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    tattn = {k: v[0] for k, v in tp["layers"]["attn"].items()}
    rng = np.random.default_rng(3)
    B, S, m = 3, 24, cfg.mla
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    ckv = rng.normal(size=(B, S, m.kv_lora_rank)).astype(np.float32)
    kr = rng.normal(size=(B, S, m.qk_rope_dim)).astype(np.float32)
    lengths = np.array([24, 9, 17], np.int32)
    for window in (1 << 30, 6):
        jo = jL.mla_attn_decode(jattn, jnp.asarray(x), jcfg, window,
                                jnp.asarray(ckv), jnp.asarray(kr),
                                jnp.asarray(lengths))
        to = tL.mla_attn_decode(tattn, torch.from_numpy(x), cfg, window,
                                torch.from_numpy(ckv), torch.from_numpy(kr),
                                torch.from_numpy(lengths))
        np.testing.assert_allclose(_np(to), np.asarray(jo), atol=1e-5,
                                   rtol=0)
    # pinned rows: the pad rows change nothing of the real ones
    xp = np.concatenate([x, x[:1], x[:1]])
    tp5 = tL.mla_attn_decode(tattn, torch.from_numpy(xp), cfg, 6,
                             torch.from_numpy(ckv), torch.from_numpy(kr),
                             torch.from_numpy(lengths))
    assert tuple(tp5.shape) == (5, 1, cfg.d_model)
    np.testing.assert_allclose(_np(tp5[:3]), _np(to), atol=1e-6, rtol=0)


def _moe_world(seed=5):
    """A MoE layer whose router crowds some experts: capacity drops
    tokens in both dispatch forms. Returns (JAX cfg, port cfg, JAX mlp
    params, port mlp params, x (B, S, d))."""
    moe = dict(n_experts=8, n_shared_experts=1, top_k=2, d_ff_expert=16,
               capacity_factor=1.0)
    jcfg = JREGISTRY["dbrx-132b"].reduced(dtype="float32",
                                          moe=JMoEConfig(**moe))
    cfg = REGISTRY["dbrx-132b"].reduced(dtype="float32",
                                        moe=MoEConfig(**moe))
    jp = jT.init_params(jcfg, jax.random.PRNGKey(seed))
    jmlp = jax.tree.map(lambda a: np.asarray(a[0]), jp["layers"]["mlp"])
    rng = np.random.default_rng(seed)
    # a skewed router: experts 0-2 take most of the traffic
    jmlp["router"] = (rng.normal(size=jmlp["router"].shape) * 0.5
                      + np.array([2.0, 1.5, 1.0, 0, 0, 0, 0, 0])
                      / 8).astype(np.float32)
    tmlp = jax.tree.map(torch.from_numpy, jmlp)
    x = rng.normal(size=(4, 16, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jmlp, tmlp, x


def _drops(probs, k, cap):
    """Tokens a capacity of `cap` per expert drops, in top-k order."""
    idx = np.argsort(-probs, axis=-1, kind="stable")[:, :k]
    load = np.zeros(probs.shape[-1], int)
    dropped = 0
    for t in range(idx.shape[0]):
        for e in idx[t]:
            dropped += load[e] >= cap
            load[e] += 1
    return dropped


@pytest.mark.parametrize("impl", ["dense", "scatter"])
def test_moe_mlp_matches_jax(impl):
    jcfg, cfg, jmlp, tmlp, x = _moe_world()
    e = cfg.moe
    B, S, d = x.shape
    logits = x.reshape(-1, d) @ jmlp["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    top = -np.sort(-probs, axis=-1)[:, :e.top_k + 1]
    assert np.diff(-top, axis=-1).min() > 1e-5      # no tie decides
    if impl == "dense":
        cap = int(max(4, e.capacity_factor * e.top_k * B * S
                      / e.n_experts))
        assert _drops(probs, e.top_k, cap) > 0
    else:
        cap = int(max(4, e.capacity_factor * e.top_k * S / e.n_experts))
        assert sum(_drops(probs.reshape(B, S, -1)[b], e.top_k, cap)
                   for b in range(B)) > 0
    jy = jL.moe_mlp(jax.tree.map(jnp.asarray, jmlp), jnp.asarray(x), jcfg,
                    impl=impl)
    ty = tL.moe_mlp(tmlp, torch.from_numpy(x), cfg, impl=impl)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=1e-6, rtol=0)
    # auto is dense at this size
    np.testing.assert_array_equal(
        _np(tL.moe_mlp(tmlp, torch.from_numpy(x), cfg)),
        _np(tL.moe_mlp(tmlp, torch.from_numpy(x), cfg, impl="dense")))


def test_moe_router_ignores_row_pin_padding(monkeypatch):
    """decode_step / decode_multi at pinned rows R > B: every MoE layer
    routes exactly the B cache rows (T = B Lq, as in the JAX package),
    and the logits equal the unpinned call's."""
    _, _, cfg, tp = _pair("dbrx-132b")
    seen = []
    real = tL.moe_mlp

    def spy(p, x, c, impl=None):
        seen.append(tuple(x.shape))
        return real(p, x, c, impl)

    monkeypatch.setattr(tL, "moe_mlp", spy)
    B, S = 3, 10
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S + 2)))
    _, cache = tT.prefill(tp, cfg, tokens=toks[:, :S], max_len=S + 4)
    seen.clear()
    pinned, _ = tT.decode_multi(tp, cfg, {k: v.clone()
                                          for k, v in cache.items()},
                                tokens=toks[:, S:], rows=16)
    assert seen == [(B, 2, cfg.d_model)] * cfg.n_layers
    free, _ = tT.decode_multi(tp, cfg, {k: v.clone()
                                        for k, v in cache.items()},
                              tokens=toks[:, S:])
    np.testing.assert_allclose(_np(pinned), _np(free), atol=1e-6, rtol=0)
    seen.clear()
    tT.decode_step(tp, cfg, {k: v.clone() for k, v in cache.items()},
                   tokens=toks[:, S:S + 1], rows=16)
    assert seen == [(B, 1, cfg.d_model)] * cfg.n_layers


@pytest.mark.parametrize("arch", ["minicpm3-4b", "deepseek-v2-lite-16b"])
def test_mla_query_stats_and_keep_sets_match_jax(arch):
    """The absorbed query's statistics (L, 1, H, r + rope), the latent
    rows' scores, and the kept positions at 0.5 / 0.8."""
    jcfg, jp, cfg, tp = _pair(arch)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (3, 32))
    js = jcomp.calibrate_query_stats(jp, jcfg, tokens=jnp.asarray(
        toks, jnp.int32))
    ts = tcomp.calibrate_query_stats(tp, cfg, tokens=torch.from_numpy(toks))
    m = cfg.mla
    assert tuple(ts.mu.shape) == (cfg.n_layers, 1, cfg.n_heads,
                                  m.kv_lora_rank + m.qk_rope_dim)
    for a, b in ((ts.mu, js.mu), (ts.sig2, js.sig2)):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=2e-5,
                                   rtol=1e-5)
    n = 29
    _, jc = jT.prefill(jp, jcfg, tokens=jnp.asarray(toks[:1], jnp.int32))
    _, tc = tT.prefill(tp, cfg, tokens=torch.from_numpy(toks[:1]))
    jsc = np.asarray(jcomp.score_positions(jcfg, jc, js, n))
    tsc = _np(tcomp.score_positions(cfg, tc, ts, n))
    live = np.isfinite(jsc)
    np.testing.assert_array_equal(np.isfinite(tsc), live)
    np.testing.assert_allclose(tsc[live], jsc[live], atol=1e-4, rtol=1e-4)
    for ratio in (0.5, 0.8):
        jout, jn = jcomp.compress_item_cache(jcfg, jc, js, ratio, n)
        tout, tn = tcomp.compress_item_cache(cfg, tc, ts, ratio, n)
        assert tn == jn and set(tout) == {"c_kv", "k_rope"}
        for key in tout:
            np.testing.assert_allclose(_np(tout[key]), jout[key],
                                       atol=1e-5, rtol=0)


def _corpus(cfg, n=6, seed=8):
    rng = np.random.default_rng(seed)
    lens = rng.integers(20, 40, n)
    return [SimpleNamespace(item_id=i, tokens=[int(t) for t in rng.integers(
        3, cfg.vocab_size, lens[i])]) for i in range(n)]


def test_deepseek_engine_build_and_filter_match_jax(tmp_path):
    """A reduced deepseek (MLA + MoE) in both engines: build (calibration,
    prefill, latent scoring, keep-sets), then run_filter on every rung,
    scan decode (no fused MLA path): log-odds within 1e-4, the same
    decisions away from the threshold, kv_bytes and attention dispatches
    equal. int8 rungs on MLA raise, as in the JAX package."""
    jcfg, jp, cfg, tp = _pair("deepseek-v2-lite-16b")
    items = _corpus(cfg)
    ratios = (0.0, 0.5, 0.8)
    jeng = JEngine(JStore(str(tmp_path / "jax")), device_cache=False)
    teng = ServingEngine(CacheStore(str(tmp_path / "torch")),
                         device_cache=False, device="cpu", max_batch=8)
    jeng.register_model("ds", jcfg, jp)
    teng.register_model("ds", cfg, tp)
    jeng.build_profiles("ds", items, ratios=ratios, prefill_batch=4)
    teng.build_profiles("ds", items, ratios=ratios, prefill_batch=4)
    assert teng.prefill_chunks == 2
    ids = [it.item_id for it in items]
    query, yes, no = [5, 9], 1, 2
    for ratio in ratios:
        jb0, tb0 = jeng.store.bytes_loaded, teng.store.bytes_loaded
        ja0, ta0 = jeng.attn_dispatches, teng.attn_dispatches
        js = jeng.run_filter("ds", ratio, ids, query, yes, no)
        ts = teng.run_filter("ds", ratio, ids, query, yes, no)
        np.testing.assert_allclose(ts, js, atol=1e-4, rtol=0)
        far = np.abs(js) > 1e-3
        np.testing.assert_array_equal((ts > 0)[far], (js > 0)[far])
        assert teng.store.bytes_loaded - tb0 == jeng.store.bytes_loaded - jb0
        assert teng.attn_dispatches - ta0 == jeng.attn_dispatches - ja0 \
            == len(query)
    with pytest.raises(ValueError, match="int8"):
        teng.build_profiles("ds", items[:2], ratios=(), quant_ratios=(0.5,))
