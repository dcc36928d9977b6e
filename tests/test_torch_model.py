"""The port's GQA model against the JAX package's, on the same weights.

JAX parameters (planted or `init_params` from a PRNG key) go to the port
through `params_from_jax`; the same token ids (numpy, from a seed) go
through both. Logits and caches must agree in float32: atol 2e-5 on the
planted models (unit-scale activations) and 1e-4 on the random configs,
whose logits sum hundreds of products.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.stretto_llama_8b import CONFIG as JLLAMA
from repro.data import synthetic as jsyn
from repro.models import layers as jL
from repro.models import transformer as jT
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.stretto_llama_8b import CONFIG as LLAMA
from repro_torch.data import synthetic as tsyn
from repro_torch.models import layers as tL
from repro_torch.models import transformer as tT


def _port_cfg(jcfg):
    """The port's ModelConfig with the same fields as a JAX config."""
    f = {k: getattr(jcfg, k) for k in ("name", "family", "n_layers",
                                       "d_model", "n_heads", "n_kv_heads",
                                       "d_head", "d_ff", "vocab_size",
                                       "attn_kind", "window", "global_every",
                                       "global_layers", "rope_theta",
                                       "norm_eps", "tie_embeddings", "dtype")}
    return ModelConfig(**f)


RANDOM_GQA = JModelConfig(
    name="rand-gqa-window", family="dense", n_layers=3, d_model=48,
    n_heads=4, n_kv_heads=2, d_head=24, d_ff=96, vocab_size=200,
    attn_kind="gqa", window=8, global_every=3, rope_theta=10_000.0,
    dtype="float32")


def _world(name):
    if name in ("sm", "lg"):
        jcfg = jsyn.planted_config(name)
        jparams = jsyn.make_planted_params(jcfg, seed=1)
        return jcfg, jparams, 2e-5
    jcfg = {"llama-reduced": JLLAMA.reduced(dtype="float32"),
            "rand-gqa": RANDOM_GQA}[name]
    jparams = jT.init_params(jcfg, jax.random.PRNGKey(3))
    return jcfg, jparams, 1e-4


WORLDS = ("sm", "lg", "llama-reduced", "rand-gqa")


@pytest.fixture(scope="module", params=WORLDS)
def world(request):
    jcfg, jparams, tol = _world(request.param)
    cfg = _port_cfg(jcfg)
    np_tree = jax.tree.map(np.asarray, jparams)
    params = tT.params_from_jax(cfg, np_tree, device="cpu")
    rng = np.random.default_rng(len(request.param))
    toks = rng.integers(3, min(cfg.vocab_size, 256), size=(2, 24))
    return jcfg, jparams, cfg, params, toks.astype(np.int32), tol


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def test_config_copy_matches():
    assert _port_cfg(JLLAMA) == LLAMA
    assert LLAMA.vocab_padded == JLLAMA.vocab_padded
    for size in ("sm", "lg"):
        assert _port_cfg(jsyn.planted_config(size)) == tsyn.planted_config(size)
    assert _port_cfg(JLLAMA.reduced()) == LLAMA.reduced()


def test_window_arrays_match():
    for jcfg in (RANDOM_GQA, JLLAMA, jsyn.planted_config("sm")):
        np.testing.assert_array_equal(jT.build_window_array(jcfg),
                                      tT.build_window_array(_port_cfg(jcfg)))


def test_forward_logits_and_caches(world):
    jcfg, jparams, cfg, params, toks, tol = world
    jl, jc = jT.forward(jparams, jcfg, tokens=jnp.asarray(toks),
                        collect_cache=True, collect_hidden=True)
    tl, tc = tT.forward(params, cfg, tokens=torch.from_numpy(toks).long(),
                        collect_cache=True, collect_hidden=True)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=tol, rtol=1e-5)
    for key in ("k", "v", "h"):
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), atol=tol,
                                   rtol=1e-5)


def test_prefill_then_decode(world):
    jcfg, jparams, cfg, params, toks, tol = world
    lengths = np.array([24, 17], np.int32)
    jlast, jcache = jT.prefill(jparams, jcfg, tokens=jnp.asarray(toks),
                               max_len=32, lengths=jnp.asarray(lengths))
    tlast, tcache = tT.prefill(params, cfg, tokens=torch.from_numpy(toks).long(),
                               max_len=32, lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(_np(tlast), _np(jlast), atol=tol, rtol=1e-5)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tcache[key]), _np(jcache[key]),
                                   atol=tol, rtol=1e-5)
    np.testing.assert_array_equal(_np(tcache["lengths"]),
                                  _np(jcache["lengths"]))

    # one decode step, then a fused 3-token decode on top of it
    step = np.array([[5], [9]], np.int32)
    jlog, jcache = jT.decode_step(jparams, jcfg, jcache,
                                  tokens=jnp.asarray(step), kernels="ref")
    tlog, tcache = tT.decode_step(params, cfg, tcache,
                                  tokens=torch.from_numpy(step).long())
    np.testing.assert_allclose(_np(tlog), _np(jlog), atol=tol, rtol=1e-5)
    multi = np.array([[16, 4, 7], [33, 3, 3]], np.int32)
    jlog, jcache = jT.decode_multi(jparams, jcfg, jcache,
                                   tokens=jnp.asarray(multi), kernels="ref")
    tlog, tcache = tT.decode_multi(params, cfg, tcache,
                                   tokens=torch.from_numpy(multi).long())
    np.testing.assert_allclose(_np(tlog), _np(jlog), atol=tol, rtol=1e-5)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tcache[key]), _np(jcache[key]),
                                   atol=tol, rtol=1e-5)
    np.testing.assert_array_equal(_np(tcache["lengths"]),
                                  _np(jcache["lengths"]))


def test_fused_decode_equals_scan(world):
    """decode_multi over Lq tokens equals Lq decode_steps (the port's own
    invariant, as in the JAX package)."""
    _, _, cfg, params, toks, tol = world
    t = torch.from_numpy(toks).long()
    _, c1 = tT.prefill(params, cfg, tokens=t, max_len=32)
    _, c2 = tT.prefill(params, cfg, tokens=t, max_len=32)
    multi = torch.tensor([[16, 4, 7], [33, 3, 3]])
    fused, _ = tT.decode_multi(params, cfg, c1, tokens=multi)
    logits = None
    for i in range(3):
        logits, c2 = tT.decode_step(params, cfg, c2, tokens=multi[:, i:i + 1])
    np.testing.assert_allclose(_np(fused), _np(logits), atol=tol, rtol=1e-5)


def test_int8_cache_decode_matches_jax():
    jcfg = jsyn.planted_config("sm")
    jparams = jsyn.make_planted_params(jcfg, seed=2)
    cfg = _port_cfg(jcfg)
    params = tT.params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                device="cpu")
    jc = jT.init_cache(jcfg, 2, 16, quant=True)
    tc = tT.init_cache(cfg, 2, 16, quant=True, device="cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: tuple(v.shape) for k, v in jc.items()}
    toks = np.array([[16, 64, 65], [17, 70, 3]], np.int32)
    jlog, jc = jT.decode_multi(jparams, jcfg, jc, tokens=jnp.asarray(toks),
                               kernels="ref")
    tlog, tc = tT.decode_multi(params, cfg, tc,
                               tokens=torch.from_numpy(toks).long())
    np.testing.assert_allclose(_np(tlog), _np(jlog), atol=2e-5, rtol=1e-5)
    for key in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), atol=1e-6)


def test_flash_attention_blocks_match_jax():
    """The blocked prefill attention with one query block and several key
    blocks (causal skipping, a window) against the JAX one."""
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 40, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 40, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 40, 2, 16)).astype(np.float32)
    for window, causal in ((7, True), (1 << 30, True), (1 << 30, False)):
        want = jL.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), window, block_q=40,
                                  block_k=8, causal=causal)
        got = tL.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), window, block_q=40,
                                 block_k=8, causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("window", [7, 1 << 30])
def test_flash_attention_query_blocks_match_oracle(window):
    """Several query blocks: the port against the attention oracle. (The
    JAX `flash_attention` reorders its output rows when Sq spans more
    than one query block, so it is not the reference here.)"""
    from repro.kernels import ref as jref
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 40, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 40, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 40, 2, 16)).astype(np.float32)
    want = jref.prefill_attention_ref(
        jnp.asarray(q).reshape(2, 40, 2, 2, 16), jnp.asarray(k),
        jnp.asarray(v), window=window)
    got = tL.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), window, block_q=8,
                             block_k=8)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).reshape(2, 40, 4, 16),
                               atol=2e-5)


def test_layer_primitives_match_jax():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 5, 3, 24)).astype(np.float32)
    pos = rng.integers(0, 1000, size=(2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        tL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e8).numpy(),
        np.asarray(jL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e8)),
        atol=2e-5)
    h = rng.normal(size=(2, 5, 24)).astype(np.float32)
    sc = rng.normal(size=(24,)).astype(np.float32)
    np.testing.assert_allclose(
        tL.rms_norm(torch.from_numpy(h), torch.from_numpy(sc)).numpy(),
        np.asarray(jL.rms_norm(jnp.asarray(h), jnp.asarray(sc))), atol=2e-5)


def test_planted_weights_are_identical():
    for size in ("sm", "lg"):
        jcfg = jsyn.planted_config(size)
        jp = jax.tree.map(np.asarray, jsyn.make_planted_params(jcfg, seed=1))
        tp = tsyn.make_planted_params(tsyn.planted_config(size), seed=1,
                                      device="cpu")
        jl = jax.tree_util.tree_flatten_with_path(jp)[0]
        for path, leaf in jl:
            node = tp
            for k in path:
                node = node[k.key]
            np.testing.assert_array_equal(node.numpy(), leaf)


def test_datasets_are_identical():
    for args in (("a", 20), ("b", 7)):
        jd = jsyn.make_dataset(*args, seed=4)
        td = tsyn.make_dataset(*args, seed=4)
        assert [(i.item_id, i.tokens, i.row, i.labels, i.map_vals)
                for i in jd.items] == \
            [(i.item_id, i.tokens, i.row, i.labels, i.map_vals)
             for i in td.items]
    jl, jr = jsyn.make_join_corpora(5, 6, seed=2)
    tl_, tr = tsyn.make_join_corpora(5, 6, seed=2)
    assert [i.item_id for i in jr.items] == [i.item_id for i in tr.items]
    assert [i.tokens for i in jl.items] == [i.tokens for i in tl_.items]


def test_init_params_shapes_and_scale():
    cfg = LLAMA.reduced(dtype="float32")
    g = torch.Generator().manual_seed(0)
    p = tT.init_params(cfg, g, device="cpu")
    jshapes = jax.tree.map(lambda s: s.shape,
                           jT.model_template(JLLAMA.reduced(dtype="float32")),
                           is_leaf=jT.is_spec)
    assert p["layers"]["attn"]["wq"].shape == \
        tuple(jshapes["layers"]["attn"]["wq"])
    assert p["embed"].shape == tuple(jshapes["embed"])
    assert float(p["layers"]["norm_mlp"].abs().max()) == 0.0
    assert 0.015 < float(p["embed"].std()) < 0.025
    again = tT.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    assert torch.equal(again["head"], p["head"])


def test_cuda_default_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        tT.init_cache(LLAMA.reduced(), 1, 8)


@pytest.mark.parametrize("S,window", [(64, 1 << 30), (200, 16),
                                      (512, 1 << 30)])
def test_gqa_attn_full_ref_route_matches_jax(S, window):
    """The prefill layer under kernels="ref" (and "auto" on the CPU) keeps
    the blocked `flash_attention`, the JAX package's route: its output and
    k/v equal the JAX layer's (one query block up to S 512, where the JAX
    blocked attention is right), atol 1e-4 as on the random configs."""
    cfg = _port_cfg(RANDOM_GQA)
    jp = jT.init_params(RANDOM_GQA, jax.random.PRNGKey(4))
    jattn = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    tattn = {k: torch.from_numpy(np.array(v)) for k, v in jattn.items()}
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    jout, (jk, jv) = jL.gqa_attn_full(jattn, jnp.asarray(x), RANDOM_GQA,
                                      window, jnp.asarray(pos))
    for kernels in ("ref", "auto", None):
        out, (k, v) = tL.gqa_attn_full(tattn, torch.from_numpy(x), cfg,
                                       window, torch.from_numpy(pos.copy()),
                                       kernels=kernels)
        for a, b in ((out, jout), (k, jk), (v, jv)):
            np.testing.assert_allclose(_np(a), _np(b), atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="CUDA"):
        tL.gqa_attn_full(tattn, torch.from_numpy(x), cfg, window,
                         torch.from_numpy(pos.copy()), kernels="cuda")
