"""The port's kernel wrappers against the JAX package's kernels.

The same numpy inputs (from a seed) go through the JAX oracle (and, on a
subset, the Pallas kernel in interpret mode) and through the port's
wrapper on CPU tensors, which takes the plain PyTorch version. Tolerance:
atol 2e-5 in float32 (the JAX package's own kernel tolerance), and one
bfloat16 step (2^-7 relative, atol 2e-2 at these magnitudes) where the
outputs are rounded to bfloat16. The hand-written CUDA kernels are held
against the same plain versions on the card by tests/test_torch_gpu.py
and chip_smoke.py.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref

GLOBAL = 1 << 30
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(seed, B, S, KV, G, dk, dv, lq):
    rng = np.random.default_rng(seed)
    qshape = (B, KV, G, dk) if lq is None else (B, lq, KV, G, dk)
    q = rng.normal(size=qshape).astype(np.float32)
    k = rng.normal(size=(B, S, KV, dk)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, dv)).astype(np.float32)
    lengths = rng.integers(lq or 1, S + 1, B).astype(np.int32)
    lengths[0] = S                      # one item fills the cache
    return q, k, v, lengths


def _both(arrs, dt):
    jdt, tdt, _ = DTYPES[dt]
    j = [jnp.asarray(a, jdt) for a in arrs[:3]] + [jnp.asarray(arrs[3])]
    t = [torch.from_numpy(a).to(tdt) for a in arrs[:3]] + \
        [torch.from_numpy(arrs[3])]
    return j, t


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


GRID = list(itertools.product((1, 3), (1, 3), (1, 4), (16, 24, 128),
                              (8, GLOBAL), ("f32", "bf16")))


@pytest.mark.parametrize("B,lq,G,dk,window,dt", GRID)
def test_query_attention_matches_jax_oracle(B, lq, G, dk, window, dt):
    S, KV = 256, 2
    arrs = _inputs(hash((B, lq, G, dk, window)) % 1000, B, S, KV, G, dk, dk,
                   lq)
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _both(arrs, dt)
    want = jops.decode_query_attention(jq, jk, jv, jl, window=window,
                                       backend="ref")
    got = ops.decode_query_attention(tq, tk, tv, tl, window=window)
    assert got.dtype == tq.dtype and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_f32(got), _f32(want), atol=DTYPES[dt][2],
                               rtol=0)


@pytest.mark.parametrize("G,dk,window,dt",
                         list(itertools.product((1, 4), (16, 24, 128),
                                                (8, GLOBAL), ("f32", "bf16"))))
def test_decode_attention_matches_jax_oracle(G, dk, window, dt):
    B, S, KV = 3, 256, 2
    arrs = _inputs(hash((G, dk, window)) % 1000, B, S, KV, G, dk, dk, None)
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _both(arrs, dt)
    want = jops.decode_attention(jq, jk, jv, jl, window=window,
                                 backend="ref")
    got = ops.decode_attention(tq, tk, tv, tl, window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=DTYPES[dt][2],
                               rtol=0)


@pytest.mark.parametrize("lq,G,dk,window", [(1, 1, 16, GLOBAL),
                                            (3, 1, 24, 8),
                                            (3, 4, 128, GLOBAL),
                                            (1, 4, 24, 8)])
def test_query_attention_matches_pallas_interpret(lq, G, dk, window):
    """The Pallas kernel itself (interpret mode) against the port."""
    arrs = _inputs(7 + dk, 2, 256, 2, G, dk, dk, lq)
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _both(arrs, "f32")
    want = jops.decode_query_attention(jq, jk, jv, jl, window=window,
                                       backend="interpret")
    got = ops.decode_query_attention(tq, tk, tv, tl, window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("G,dk,window", [(1, 16, GLOBAL), (4, 24, 8)])
def test_decode_attention_matches_pallas_interpret(G, dk, window):
    arrs = _inputs(11 + dk, 2, 256, 2, G, dk, dk, None)
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _both(arrs, "f32")
    want = jops.decode_attention(jq, jk, jv, jl, window=window,
                                 backend="interpret")
    got = ops.decode_attention(tq, tk, tv, tl, window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5, rtol=0)


def test_dv_differs_from_dk():
    arrs = _inputs(3, 2, 128, 2, 2, 32, 48, 2)
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _both(arrs, "f32")
    want = jops.decode_query_attention(jq, jk, jv, jl, backend="ref")
    got = ops.decode_query_attention(tq, tk, tv, tl)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("B,S,KV,G,dk,dt", [
    (1, 256, 2, 1, 16, "f32"), (2, 256, 4, 1, 24, "f32"),
    (1, 256, 8, 4, 128, "f32"), (1, 256, 8, 4, 128, "bf16"),
    (2, 128, 2, 2, 24, "bf16")])
def test_expected_attention_matches_jax(B, S, KV, G, dk, dt):
    rng = np.random.default_rng(dk + G)
    k = rng.normal(size=(B, S, KV, dk)).astype(np.float32)
    mu = rng.normal(size=(KV, G, dk)).astype(np.float32)
    sig2 = rng.random(size=(KV, G, dk)).astype(np.float32)
    jdt, tdt, _ = DTYPES[dt]
    want = jops.expected_attention_scores(jnp.asarray(k, jdt),
                                          jnp.asarray(mu), jnp.asarray(sig2),
                                          backend="ref")
    got = ops.expected_attention_scores(torch.from_numpy(k).to(tdt),
                                        torch.from_numpy(mu),
                                        torch.from_numpy(sig2))
    assert got.dtype == torch.float32
    # scores are float32 either way: hold both types at the f32 tolerance,
    # relative to their magnitude (dk terms of size ~1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    if dt == "f32":
        interp = jops.expected_attention_scores(
            jnp.asarray(k), jnp.asarray(mu), jnp.asarray(sig2),
            backend="interpret")
        np.testing.assert_allclose(got.numpy(), np.asarray(interp),
                                   rtol=2e-5, atol=2e-5)


def test_int8_ref_path_matches_jax():
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 3, 2, 2, 16)).astype(np.float32)
    kf = rng.normal(size=(2, 128, 2, 16)).astype(np.float32)
    vf = rng.normal(size=(2, 128, 2, 16)).astype(np.float32)
    lengths = np.array([128, 40], np.int32)

    def quant(x):
        s = np.max(np.abs(x), -1) / 127.0
        return np.round(x / np.maximum(s, 1e-9)[..., None]).astype(np.int8), \
            s.astype(np.float32)

    (k8, ks), (v8, vs) = quant(kf), quant(vf)
    want = jops.decode_query_attention(
        jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8),
        jnp.asarray(lengths), backend="ref", k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs))
    t = torch.from_numpy
    got = ops.decode_query_attention(t(q), t(k8), t(v8), t(lengths),
                                     k_scale=t(ks), v_scale=t(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_prefill_oracle_matches_jax():
    rng = np.random.default_rng(9)
    q = rng.normal(size=(1, 64, 2, 2, 16)).astype(np.float32)
    k = rng.normal(size=(1, 64, 2, 16)).astype(np.float32)
    v = rng.normal(size=(1, 64, 2, 16)).astype(np.float32)
    from repro.kernels import ref as jref
    want = jref.prefill_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), window=8)
    got = ref.prefill_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), window=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_window_beyond_global_clamps():
    """A window past 2^30 means full attention (the JAX wrapper's int32
    window overflows there; the port clamps)."""
    arrs = _inputs(1, 2, 128, 2, 1, 16, 16, 1)
    t = [torch.from_numpy(a) for a in arrs]
    full = ops.decode_query_attention(*t, window=GLOBAL)
    huge = ops.decode_query_attention(*t, window=1 << 33)
    assert torch.equal(full, huge)


def test_backend_selection(monkeypatch):
    monkeypatch.delenv(ops.ENV_VAR, raising=False)
    assert ops.resolve_backend(None) == "auto"
    monkeypatch.setenv(ops.ENV_VAR, "ref")
    assert ops.resolve_backend(None) == "ref"
    assert ops.resolve_backend("cuda") == "cuda"
    with pytest.raises(ValueError, match="backend"):
        ops.resolve_backend("pallas")
    x = torch.zeros(2)
    assert ops.use_kernel("auto", x) is False      # CPU tensor: plain path
    assert ops.use_kernel("ref", x) is False


def test_cuda_backend_on_cpu_tensor_raises():
    arrs = _inputs(0, 1, 128, 1, 1, 16, 16, 1)
    t = [torch.from_numpy(a) for a in arrs]
    with pytest.raises(ValueError, match="CUDA"):
        ops.decode_query_attention(*t, backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.decode_attention(t[0][:, 0], *t[1:], backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.expected_attention_scores(t[1], torch.zeros(1, 1, 16),
                                      torch.zeros(1, 1, 16), backend="cuda")


def test_kernel_wrappers_refuse_cpu_tensors_and_count_nothing():
    """The CUDA wrappers never run a CPU tensor: they raise before any
    build or launch, and the launch counters stay put."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import expected_attention as ea
    before = ops.launch_counts()
    arrs = _inputs(0, 1, 128, 1, 1, 16, 16, 1)
    t = [torch.from_numpy(a) for a in arrs]
    with pytest.raises(ValueError):
        da.decode_query_attention(*t)
    with pytest.raises(ValueError):
        ea.expected_attention_scores(t[1], torch.zeros(1, 1, 16),
                                     torch.zeros(1, 1, 16))
    ops.decode_query_attention(*t)                 # plain path on the CPU
    assert ops.launch_counts() == before



def _quant(x):
    s = np.max(np.abs(x), -1) / 127.0
    return np.round(x / np.maximum(s, 1e-9)[..., None]).astype(np.int8), \
        s.astype(np.float32)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [GLOBAL, 0])
def test_rows_that_see_no_position_match_pallas(quant, window):
    """Query rows before position 0 (lengths < Lq), an empty item, and a
    window of 0 see no cache position. The Pallas kernels (interpret
    mode) mask with a finite -1e30 and return the mean of V over all S
    positions for such rows; the port's plain versions, which the CPU
    path runs and the CUDA kernels are held to, return the same."""
    rng = np.random.default_rng(13)
    B, Lq, S, KV, G, dk = 4, 3, 256, 2, 2, 16
    q = rng.normal(size=(B, Lq, KV, G, dk)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, dk)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, dk)).astype(np.float32)
    lengths = np.array([S, 1, 2, 0], np.int32)
    kw_j, kw_t = {}, {}
    if quant:
        (k, ks), (v, vs) = _quant(k), _quant(v)
        kw_j = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        kw_t = dict(k_scale=torch.from_numpy(ks),
                    v_scale=torch.from_numpy(vs))
    jargs = [jnp.asarray(a) for a in (q, k, v, lengths)]
    targs = [torch.from_numpy(a) for a in (q, k, v, lengths)]
    want = jops.decode_query_attention(*jargs, window=window,
                                       backend="interpret", **kw_j)
    got = ops.decode_query_attention(*targs, window=window, **kw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    want1 = jops.decode_attention(jargs[0][:, 0], *jargs[1:], window=window,
                                  backend="interpret", **kw_j)
    got1 = ops.decode_attention(targs[0][:, 0], *targs[1:], window=window,
                                **kw_t)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), atol=2e-5)
    # item 3 (length 0) gets exactly the mean of its V rows
    vf = v.astype(np.float32) * (vs[..., None] if quant else 1.0)
    np.testing.assert_allclose(got.numpy()[3, 0], np.broadcast_to(
        vf[3].mean(0)[:, None, :], (KV, G, dk)), atol=2e-5)


def test_int8_kernel_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels import decode_attention as da
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.normal(size=(1, 1, 2, 1, 16)).astype(np.float32))
    k8, ks = (torch.from_numpy(a) for a in _quant(
        rng.normal(size=(1, 128, 2, 16)).astype(np.float32)))
    lengths = torch.tensor([100], dtype=torch.int32)
    before = ops.launch_counts()
    with pytest.raises(ValueError):
        da.decode_query_attention_int8(q, k8, k8, ks, ks, lengths)
    with pytest.raises(ValueError):
        da.decode_attention_int8(q[:, 0], k8, k8, ks, ks, lengths)
    with pytest.raises(ValueError, match="CUDA"):
        ops.decode_query_attention(q, k8, k8, lengths, k_scale=ks,
                                   v_scale=ks, backend="cuda")
    assert ops.launch_counts() == before
