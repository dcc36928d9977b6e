"""The port's training against the JAX package's, on the CPU.

Inputs come from numpy seeds; weights cross through `params_from_jax`.
Tolerances:
  - `lm_loss` and its grads, every registered arch's reduced config in
    float32 (B 2, S 16): loss within 1e-5 relative, each grad leaf within
    1e-4 of that leaf's max |grad| (float32 sums in another order);
  - the bf16 train step (a twin of tests/test_models_smoke.py::
    test_train_step_runs): loss within 1e-3 relative of JAX's bf16 loss
    (bf16 products rounded in another order; the largest seen is 5e-5);
  - remat none / dots / off: logits within atol 1e-5 (as
    test_remat_matches_no_remat) and grads equal within 1e-6 of the max
    (the recompute runs the same ops);
  - AdamW over 3 steps, float32 and bfloat16 params: params and moments
    within 1e-6 of the max (the port runs the reference's op order);
  - microbatching: loss within 1e-5 relative and the moments (0.1 g and
    0.05 g^2 after one step) within 1e-4 of the max of JAX's; the port at
    2 microbatches against itself at 1 within 1e-5;
  - gradient compression: int8 equal, scales and residuals within 1e-7;
  - `lm_batches`: equal byte for byte;
  - the launch specs: bytes per tree equal to the reference's
    ShapeDtypeStructs, shardings equal entry for entry.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import REGISTRY as JREGISTRY
from repro.configs import SHAPES as JSHAPES
from repro.data import pipeline as jpipe
from repro.distributed import sharding as jsh
from repro.launch import mesh as jmesh
from repro.launch import specs as jspecs
from repro.models import transformer as jT
from repro.training import optimizer as jopt
from repro.training import train_step as jts
from repro_torch.configs import REGISTRY, SHAPES
from repro_torch.data import pipeline as tpipe
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as tspecs
from repro_torch.launch import train as tlaunch
from repro_torch.models import transformer as tT
from repro_torch.training import optimizer as topt
from repro_torch.training import train_step as tts
from repro_torch.training.tree import leaves_with_paths, path_key

KEY = jax.random.PRNGKey(0)
ALL_ARCHS = sorted(REGISTRY)
B, S = 2, 16


def _np(t):
    return t.detach().float().cpu().numpy()


def _by_key(tree, conv):
    return {path_key(p): conv(x) for p, x in leaves_with_paths(tree)}


def _jax_key(path):
    """A JAX tree path as the checkpoints name it (`1/m/layers/attn/wq`)."""
    return "/".join(str(getattr(k, "key", getattr(k, "idx",
                                                  getattr(k, "name", k))))
                    for k in path)


def _jax_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_jax_key(path): np.asarray(x, np.float32) for path, x in flat}


def _batch(cfg, seed=0, b=B, s=S):
    """(JAX batch, port batch) from one numpy draw."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "none":
        toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
        return ({"tokens": jnp.asarray(toks)},
                {"tokens": torch.from_numpy(toks).long()})
    emb = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    lab = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return ({"embeds": jnp.asarray(emb), "labels": jnp.asarray(lab)},
            {"embeds": torch.from_numpy(emb),
             "labels": torch.from_numpy(lab).long()})


def _pair(arch, dtype="float32"):
    """(JAX config, JAX params, port config, port params) of the reduced
    config (dtype None: the config's own), the JAX weights carried
    across."""
    kw = {"dtype": dtype} if dtype else {}
    jcfg = JREGISTRY[arch].reduced(**kw)
    cfg = REGISTRY[arch].reduced(**kw)
    jp = jT.init_params(jcfg, KEY)
    tp = tT.params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, cfg, tp


def _jax_loss_fn(jcfg):
    def loss(p, b):
        return jts.lm_loss(p, jcfg, tokens=b.get("tokens"),
                           embeds=b.get("embeds"), labels=b.get("labels"),
                           remat=False)
    return loss


@pytest.fixture(scope="module")
def jax_value_and_grad():
    """arch -> the JAX loss and grads (one jit per arch, on first use)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg, jp, cfg, tp = _pair(arch)
            jb, tb = _batch(cfg)
            loss, grads = jax.jit(jax.value_and_grad(_jax_loss_fn(jcfg)))(
                jp, jb)
            cache[arch] = (cfg, tp, tb, float(loss), _jax_leaves(grads))
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_lm_loss_and_grads_match_jax(jax_value_and_grad, arch):
    cfg, tp, tb, jloss, jgrads = jax_value_and_grad(arch)
    loss, grads, missing = tts.value_and_grad(tp, tb, cfg, remat=False)
    assert abs(float(loss) - jloss) <= 1e-5 * abs(jloss)
    got = _by_key(grads, _np)
    assert sorted(got) == sorted(jgrads)
    for k, want in jgrads.items():
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got[k] - want).max()) <= 1e-4 * scale, k
    # the token table is unused only where the frontend's embeds replace it
    assert missing == (["embed"] if cfg.frontend != "none" else [])


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_train_step_runs_bf16(arch):
    """Twin of test_models_smoke.py::test_train_step_runs (bf16)."""
    jcfg, jp, cfg, tp = _pair(arch, dtype=None)
    assert cfg.dtype == "bfloat16"
    jb, tb = _batch(cfg)
    opt = topt.adamw_init(tp)
    before = {k: v.clone() for k, v in _by_key(tp, lambda t: t).items()}
    new_params, new_opt, loss = tts.train_step(tp, opt, tb, cfg,
                                               remat=False)
    assert np.isfinite(float(loss))
    assert int(new_opt.step) == 1 and int(opt.step) == 0
    d = [float((a.float() - before[k].float()).abs().max())
         for k, a in _by_key(new_params, lambda t: t).items()]
    assert max(d) > 0
    # the step leaves its inputs untouched
    for k, t in _by_key(tp, lambda t: t).items():
        assert torch.equal(t, before[k]), k
    jloss = float(jax.jit(_jax_loss_fn(jcfg))(jp, jb))
    assert abs(float(loss) - jloss) <= 1e-3 * abs(jloss)


@pytest.mark.parametrize("arch", ["granite-8b", "deepseek-v2-lite-16b",
                                  "hymba-1.5b"])
def test_remat_matches_no_remat(arch):
    _, _, cfg, tp = _pair(arch)
    _, tb = _batch(cfg)
    ref, _ = tT.forward(tp, cfg, tokens=tb["tokens"], differentiable=True)
    _, gref, _ = tts.value_and_grad(tp, tb, cfg, remat=False)
    gref = _by_key(gref, _np)
    for policy in ("none", "dots"):
        with torch.no_grad():
            got, _ = tT.forward(tp, cfg, tokens=tb["tokens"], remat=True,
                                remat_policy=policy, differentiable=True)
        np.testing.assert_allclose(_np(got), _np(ref), atol=1e-5)
        _, g, _ = tts.value_and_grad(tp, tb, cfg, remat=True,
                                     remat_policy=policy)
        for k, v in _by_key(g, _np).items():
            scale = max(float(np.abs(gref[k]).max()), 1e-30)
            assert float(np.abs(v - gref[k]).max()) <= 1e-6 * scale, \
                (policy, k)
    with pytest.raises(ValueError):
        tT.forward(tp, cfg, tokens=tb["tokens"], remat=True,
                   remat_policy="everything")


def test_forward_serving_route_unchanged():
    """Serving calls keep their route: without `differentiable`, the
    logits on the CPU are bit for bit those of the blocked route."""
    _, _, cfg, tp = _pair("hymba-1.5b")
    _, tb = _batch(cfg)
    with torch.no_grad():
        a, ca = tT.forward(tp, cfg, tokens=tb["tokens"], collect_cache=True)
        b, _ = tT.forward(tp, cfg, tokens=tb["tokens"], differentiable=True)
    assert torch.equal(a, b)
    assert set(ca) == set(tT.cache_keys(cfg))


def _adam_trees(dtype, rng):
    def mk(f):
        return {"a": f((64, 33)), "b": {"c": f((7,)), "d": f((3, 5, 4))}}
    p0 = mk(lambda s: rng.normal(size=s).astype(np.float32))
    gs = [mk(lambda s: (rng.normal(size=s) * 10.0 ** rng.uniform(-4, 1)
                        ).astype(np.float32)) for _ in range(3)]
    return p0, gs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax_over_three_steps(dtype):
    p0, gs = _adam_trees(dtype, np.random.default_rng(1))
    tdt = getattr(torch, dtype)
    jp = jax.tree.map(lambda x: jnp.asarray(x).astype(dtype), p0)
    tp = jax.tree.map(lambda x: torch.from_numpy(x).to(tdt), p0)
    js, ts = jopt.adamw_init(jp), topt.adamw_init(tp)
    for g in gs:
        jp, js = jopt.adamw_update(
            jax.tree.map(lambda x: jnp.asarray(x).astype(dtype), g), js, jp)
        tp, ts = topt.adamw_update(
            jax.tree.map(lambda x: torch.from_numpy(x).to(tdt), g), ts, tp)
    assert int(ts.step) == int(js.step) == 3 and ts.step.dtype == torch.int32
    for jt, tt, want_dtype in ((jp, tp, tdt), (js.m, ts.m, torch.float32),
                               (js.v, ts.v, torch.float32)):
        for a, b in zip(jax.tree.leaves(jt), jax.tree.leaves(tt)):
            assert b.dtype == want_dtype
            a = np.asarray(a, np.float32)
            assert float(np.abs(_np(b) - a).max()) <= \
                1e-6 * float(np.abs(a).max())


def test_adamw_state_from_jax_carries_the_state():
    """A JAX AdamWState of numpy leaves (the reference's layout: a nested
    dict per moment) crosses bit for bit."""
    cfg = REGISTRY["granite-8b"].reduced(dtype="bfloat16")
    rng = np.random.default_rng(4)
    like = tT.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")

    def moments():
        return jax.tree.map(lambda t: rng.normal(size=tuple(t.shape)).astype(
            np.float32), like)
    js = jopt.AdamWState(step=np.int32(3), m=moments(), v=moments())
    ts = topt.adamw_state_from_jax(cfg, js, device="cpu")
    assert int(ts.step) == 3 and ts.step.dtype == torch.int32
    for jt, tt in ((js.m, ts.m), (js.v, ts.v)):
        want = _by_key(jt, lambda x: x)
        for k, v in _by_key(tt, lambda t: t).items():
            assert v.dtype == torch.float32
            np.testing.assert_array_equal(v.numpy(), want[k])


def test_microbatches_match_jax_and_one_batch():
    jcfg, jp, cfg, tp = _pair("granite-8b")
    jb, tb = _batch(cfg, seed=3, b=4)
    jstep = jax.jit(jts.make_train_step(jcfg, remat=False, microbatches=2))
    _, jopt_s, jloss = jstep(jp, jopt.adamw_init(jp), jb)
    _, o2, l2 = tts.train_step(tp, topt.adamw_init(tp), tb, cfg,
                               remat=False, microbatches=2)
    _, o1, l1 = tts.train_step(tp, topt.adamw_init(tp), tb, cfg,
                               remat=False, microbatches=1)
    assert abs(float(l2) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert abs(float(l2) - float(l1)) <= 1e-5 * abs(float(l1))
    for jm, m2, m1 in ((jopt_s.m, o2.m, o1.m), (jopt_s.v, o2.v, o1.v)):
        want = _jax_leaves(jm)
        one = _by_key(m1, _np)
        for k, v in _by_key(m2, _np).items():
            scale = max(float(np.abs(want[k]).max()), 1e-30)
            assert float(np.abs(v - want[k]).max()) <= 1e-4 * scale, k
            assert float(np.abs(v - one[k]).max()) <= 1e-5 * scale, k


def test_compress_grads_matches_jax():
    rng = np.random.default_rng(2)
    g = {"w": rng.normal(size=(64,)).astype(np.float32),
         "b": {"x": (rng.normal(size=(5, 7)) * 1e-3).astype(np.float32)}}
    jg = jax.tree.map(jnp.asarray, g)
    tg = jax.tree.map(torch.from_numpy, g)
    jq, js, jr = jopt.compress_grads(jg, None)
    tq, ts, tr = topt.compress_grads(tg, None)
    # a second step carries the residuals
    jq, js, jr = jopt.compress_grads(jg, jr)
    tq, ts, tr = topt.compress_grads(tg, tr)
    for a, b in zip(jax.tree.leaves(jq), jax.tree.leaves(tq)):
        assert b.dtype == torch.int8
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for ja, ta in ((js, ts), (jr, tr),
                   (jopt.decompress_grads(jq, js),
                    topt.decompress_grads(tq, ts))):
        for a, b in zip(jax.tree.leaves(ja), jax.tree.leaves(ta)):
            np.testing.assert_allclose(_np(b), np.asarray(a), rtol=0,
                                       atol=1e-7)


@pytest.mark.parametrize("embeds_dim", [None, 8])
def test_lm_batches_equal_byte_for_byte(embeds_dim):
    for host in range(2):
        a = jpipe.lm_batches(97, 6, 5, host_id=host, n_hosts=2, seed=7,
                             embeds_dim=embeds_dim)
        b = tpipe.lm_batches(97, 6, 5, host_id=host, n_hosts=2, seed=7,
                             embeds_dim=embeds_dim)
        for _ in range(3):
            x, y = next(a), next(b)
            assert sorted(x) == sorted(y)
            for k in x:
                assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape
                assert x[k].tobytes() == y[k].tobytes()


def test_launch_train_main_runs_on_the_cpu(tmp_path, capsys):
    rep = tlaunch.main(["--steps", "3", "--batch", "2", "--seq", "16",
                        "--device", "cpu", "--ckpt-dir", str(tmp_path),
                        "--ckpt-every", "2"])
    assert rep.steps_run == 3 and len(rep.losses) == 3
    assert all(np.isfinite(rep.losses))
    assert len(rep.ckpts) == 1
    out = capsys.readouterr().out
    assert "[train] granite-8b" in out and "on cpu" in out
    # a rerun resumes from the checkpoint at step 2
    rep = tlaunch.main(["--steps", "3", "--batch", "2", "--seq", "16",
                        "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert rep.resumed_from == 2 and rep.steps_run == 1


def _jax_bytes(tree):
    return sum(int(np.prod(x.shape)) * jnp.dtype(x.dtype).itemsize
               for x in jax.tree.leaves(tree))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_specs_bytes_match_the_reference(arch):
    jcfg, cfg = JREGISTRY[arch], REGISTRY[arch]
    pairs = [(jspecs.params_sds(jcfg), tspecs.params_sds(cfg)),
             (jspecs.opt_state_sds(jcfg), tspecs.opt_state_sds(cfg)),
             (jspecs.cache_sds(jcfg, 2, 64), tspecs.cache_sds(cfg, 2, 64))]
    if cfg.attn_kind in ("gqa", "hymba"):
        pairs.append((jspecs.cache_sds(jcfg, 2, 64, quant=True),
                      tspecs.cache_sds(cfg, 2, 64, quant=True)))
    for name in SHAPES:
        pairs.append((jspecs.batch_sds(jcfg, JSHAPES[name]),
                      tspecs.batch_sds(cfg, SHAPES[name])))
    for j, t in pairs:
        assert all(x.device.type == "meta"
                   for _, x in leaves_with_paths(t))
        assert tspecs.tree_bytes(t) == _jax_bytes(j)
        assert sorted(_jax_leaves_shapes(j)) == sorted(
            (path_key(p), tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for p, x in leaves_with_paths(t))


def _jax_leaves_shapes(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(_jax_key(path), tuple(x.shape), jnp.dtype(x.dtype).name)
            for path, x in flat]


@pytest.mark.parametrize("arch", ["granite-8b", "deepseek-v2-lite-16b",
                                  "rwkv6-1.6b"])
def test_specs_shardings_match_the_reference(arch):
    """On a 1-device mesh with the production axis names: the rules of
    each shape cell, the params' and the optimizer state's shardings."""
    jcfg, cfg = JREGISTRY[arch], REGISTRY[arch]
    jm = jmesh.make_local_mesh()
    tm = tmesh.make_local_mesh("cpu")
    for name in SHAPES:
        jr = jspecs.rules_for(jcfg, JSHAPES[name], jm)
        tr = tspecs.rules_for(cfg, SHAPES[name], tm)
        assert jr == tr, name
        axes = [(jT.param_axes(jcfg), tT.param_axes(cfg)),
                (jopt.opt_state_axes(jT.param_axes(jcfg)),
                 topt.opt_state_axes(tT.param_axes(cfg))),
                (jspecs.batch_axes(jcfg, JSHAPES[name]),
                 tspecs.batch_axes(cfg, SHAPES[name]))]
        with jsh.use_rules(jr, jm), tsh.use_rules(tr, tm):
            for ja, ta in axes:
                assert _jax_specs(jspecs.shardings_for(ja, jm)) == \
                    _torch_specs(tspecs.shardings_for(ta, tm))


def _jax_specs(tree):
    from jax.sharding import NamedSharding
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, NamedSharding))
    return sorted((_jax_key(path), tuple(s.spec)) for path, s in flat)


def _torch_specs(tree, path=()):
    if isinstance(tree, tspecs.NamedSharding):
        return [("/".join(str(p) for p in path), tuple(tree.spec))]
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        items = enumerate(tree)
    return sorted(x for k, v in items for x in _torch_specs(v, path + (k,)))
