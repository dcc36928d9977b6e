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


# prefill attention (kernel D): tests/test_kernels.py's PREFILL_CASES, one
# case with dk != dv and one at S 1024 (four Pallas blocks of 256).
# Tolerances: float32 3e-5 (a softmax over up to 1024 keys, summed in
# another order than the Pallas kernel's blocks); bfloat16 3e-2 (both
# sides round their outputs to bfloat16, one step at these magnitudes).
PREFILL_CASES = [
    # (B, S, KV, G, dk, dv, bq, bk, window, causal, dtype)
    (2, 256, 2, 2, 32, 32, 64, 64, GLOBAL, True, "f32"),
    (1, 512, 1, 4, 64, 64, 128, 128, GLOBAL, True, "f32"),
    (2, 256, 2, 2, 32, 32, 64, 64, 64, True, "f32"),
    (1, 256, 2, 1, 64, 64, 128, 64, GLOBAL, False, "f32"),
    (1, 256, 1, 2, 32, 32, 64, 64, GLOBAL, True, "bf16"),
    (1, 256, 2, 2, 24, 40, 64, 64, 48, True, "f32"),
    (1, 1024, 1, 2, 32, 32, 256, 256, 200, True, "f32"),
]
PREFILL_TOL = {"f32": 3e-5, "bf16": 3e-2}


@pytest.mark.parametrize("B,S,KV,G,dk,dv,bq,bk,window,causal,dt",
                         PREFILL_CASES)
def test_prefill_attention_matches_pallas_and_oracle(B, S, KV, G, dk, dv, bq,
                                                     bk, window, causal, dt):
    from repro.kernels import ref as jref
    from repro.kernels.prefill_attention import prefill_attention as jpa
    rng = np.random.default_rng(S + dk + dv)
    q = rng.normal(size=(B, S, KV, G, dk)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, dk)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, dv)).astype(np.float32)
    jdt, tdt, _ = DTYPES[dt]
    jargs = [jnp.asarray(a, jdt) for a in (q, k, v)]
    got = ops.prefill_attention(*(torch.from_numpy(a).to(tdt)
                                  for a in (q, k, v)),
                                window=window, causal=causal)
    assert got.dtype == tdt and got.shape == (B, S, KV, G, dv)
    pallas = jpa(*jargs, window=window, causal=causal, block_q=bq,
                 block_k=bk, interpret=True)
    oracle = jref.prefill_attention_ref(*jargs, window=window,
                                        causal=causal)
    tol = PREFILL_TOL[dt]
    np.testing.assert_allclose(_f32(got), _f32(pallas), atol=tol, rtol=0)
    np.testing.assert_allclose(_f32(got), _f32(oracle), atol=tol, rtol=0)


def test_prefill_window_below_one_raises():
    """No key is visible below window 1 (and the Pallas result then
    depends on its block size): both routes refuse it."""
    from repro_torch.kernels import prefill_attention as pa
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.normal(size=(1, 16, 1, 2, 8)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 16, 1, 8)).astype(np.float32))
    before = ops.launch_counts()
    for window in (0, -3):
        with pytest.raises(ValueError, match="window"):
            ops.prefill_attention(q, k, k, window=window)
        with pytest.raises(ValueError, match="window"):
            pa.prefill_attention(q, k, k, window=window)
    assert ops.prefill_attention(q, k, k, window=1).shape == q.shape
    assert ops.launch_counts() == before


def test_prefill_kernel_wrapper_refuses_cpu_tensors():
    from repro_torch.kernels import prefill_attention as pa
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(1, 16, 1, 2, 8)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 16, 1, 8)).astype(np.float32))
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        pa.prefill_attention(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        ops.prefill_attention(q, k, k, backend="cuda")
    assert ops.launch_counts() == before
    assert "prefill_attention" in before


# The tensor-core body of kernel D (bf16): its CPU twin
# (kernels/ref.prefill_attention_tc_twin) walks the body's tiles (128 // G
# query positions x 64 keys, from the first tile the window reaches to the
# last query's diagonal), rounds q, k and v to bfloat16, splits P into a
# bfloat16 high and low part and sums in float32. Held to the JAX oracle
# everywhere and to the Pallas kernel (interpret mode) where its blocks
# divide S, at the bf16 tolerance 2e-2: both sides round the output to
# bfloat16 (one step at these magnitudes), and the split P moves an
# output by far less.
TWIN_CASES = [
    # (B, S, KV, G, dk, dv, window, causal, Pallas block or None)
    (2, 150, 2, 4, 32, 32, GLOBAL, True, 150),      # S not a multiple
    (1, 256, 2, 4, 64, 64, 1, True, 64),            # window 1
    (1, 200, 2, 3, 32, 32, 17, True, 200),          # G 3, window 17
    (1, 512, 1, 4, 32, 32, 256, True, 128),         # window 256
    (2, 130, 2, 2, 32, 48, 17, True, 130),          # dk != dv
    (1, 192, 2, 1, 64, 64, GLOBAL, False, 64),      # G 1, non-causal
    (1, 100, 1, 1, 16, 16, GLOBAL, True, None),     # G 1, one ragged tile
    (1, 96, 2, 5, 16, 32, 33, False, 96),           # G 5, windowed, both ways
]
TWIN_TOL = 2e-2


def _bf16_inputs(seed, B, S, KV, G, dk, dv):
    rng = np.random.default_rng(seed)
    arrs = (rng.normal(size=(B, S, KV, G, dk)).astype(np.float32),
            rng.normal(size=(B, S, KV, dk)).astype(np.float32),
            rng.normal(size=(B, S, KV, dv)).astype(np.float32))
    return ([jnp.asarray(a, jnp.bfloat16) for a in arrs],
            [torch.from_numpy(a).to(torch.bfloat16) for a in arrs])


@pytest.mark.parametrize("B,S,KV,G,dk,dv,window,causal,block", TWIN_CASES)
def test_prefill_tc_twin_matches_jax(B, S, KV, G, dk, dv, window, causal,
                                     block):
    from repro.kernels import ref as jref
    from repro.kernels.prefill_attention import prefill_attention as jpa
    jargs, targs = _bf16_inputs(S * 7 + G + dv, B, S, KV, G, dk, dv)
    got = ref.prefill_attention_tc_twin(*targs, window=window, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, KV, G, dv)
    oracle = jref.prefill_attention_ref(*jargs, window=window, causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(oracle), atol=TWIN_TOL,
                               rtol=0)
    if block is not None:
        pallas = jpa(*jargs, window=window, causal=causal, block_q=block,
                     block_k=block, interpret=True)
        np.testing.assert_allclose(_f32(got), _f32(pallas), atol=TWIN_TOL,
                                   rtol=0)


@pytest.mark.parametrize("G,window", [(4, GLOBAL), (4, 100), (3, GLOBAL),
                                      (1, 17)])
def test_prefill_tc_twin_is_batch_invariant(G, window):
    """An item's rows are bit-identical alone and inside a larger batch
    padded further: each item runs on its own over whole tiles, and keys
    past a causal row add exact zeros."""
    _, (q, k, v) = _bf16_inputs(G + window % 97, 3, 200, 2, G, 32, 32)
    batched = ref.prefill_attention_tc_twin(q, k, v, window=window)
    alone = ref.prefill_attention_tc_twin(q[1:2, :137], k[1:2, :137],
                                          v[1:2, :137], window=window)
    assert torch.equal(alone[0], batched[1, :137])


@pytest.mark.parametrize("dtype,dk,dv,want", [
    (torch.bfloat16, 128, 128, "tc"), (torch.bfloat16, 32, 48, "tc"),
    (torch.bfloat16, 16, 16, "tc"), (torch.bfloat16, 256, 128, "tc"),
    (torch.bfloat16, 24, 24, "fma"), (torch.bfloat16, 128, 40, "fma"),
    (torch.bfloat16, 8, 16, "fma"), (torch.float32, 128, 128, "fma"),
    (torch.float32, 16, 16, "fma"), (torch.float32, 24, 24, "fma")])
def test_prefill_body_rule(dtype, dk, dv, want):
    """One rule picks D's body, from the dtype and head dims alone: the
    tensor-core body for bfloat16 with dk and dv multiples of 16, the FMA
    body for everything else."""
    from repro_torch.kernels import prefill_attention as pa
    assert pa.body(dtype, dk, dv) == want


def test_prefill_launch_counts_per_body_reset():
    """D's per-body counts come with the launch counts and go back to 0
    with them (the CPU route launches nothing)."""
    from repro_torch.kernels import prefill_attention as pa
    pa.prefill_attention.launches_by_body["tc"] += 2
    assert ops.launch_counts()["prefill_attention_by_body"]["tc"] >= 2
    ops.reset_launch_counts()
    counts = ops.launch_counts()
    assert counts["prefill_attention"] == 0
    assert counts["prefill_attention_by_body"] == {"tc": 0, "fma": 0}


# Kernel A / B's float32 / bfloat16 body: its CPU twin
# (kernels/ref.decode_query_attention_twin) walks the kernel's splits of 64
# positions and its warps' sub-tiles of 16, each with its own softmax, and
# merges them in order. Held to the JAX oracle over GRID and to the Pallas
# kernel (interpret mode), at the tolerances above: the twin differs from
# both only in the order of float32 sums.
@pytest.mark.parametrize("B,lq,G,dk,window,dt", GRID)
def test_query_attention_twin_matches_jax_oracle(B, lq, G, dk, window, dt):
    S, KV = 256, 2
    arrs = _inputs(hash((B, lq, G, dk, window)) % 1000, B, S, KV, G, dk, dk,
                   lq)
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _both(arrs, dt)
    want = jops.decode_query_attention(jq, jk, jv, jl, window=window,
                                       backend="ref")
    got = ref.decode_query_attention_twin(tq, tk, tv, tl, window=window)
    assert got.dtype == tq.dtype and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_f32(got), _f32(want), atol=DTYPES[dt][2],
                               rtol=0)


@pytest.mark.parametrize("G,dk,window,dt",
                         list(itertools.product((1, 4), (16, 24, 128),
                                                (8, GLOBAL), ("f32", "bf16"))))
def test_decode_attention_twin_matches_jax_oracle(G, dk, window, dt):
    B, S, KV = 3, 256, 2
    arrs = _inputs(hash((G, dk, window)) % 1000, B, S, KV, G, dk, dk, None)
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _both(arrs, dt)
    want = jops.decode_attention(jq, jk, jv, jl, window=window,
                                 backend="ref")
    got = ref.decode_attention_twin(tq, tk, tv, tl, window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=DTYPES[dt][2],
                               rtol=0)


@pytest.mark.parametrize("lq,G,dk,window", [(1, 1, 16, GLOBAL),
                                            (3, 1, 24, 8),
                                            (3, 4, 128, GLOBAL),
                                            (1, 4, 24, 8)])
def test_query_attention_twin_matches_pallas_interpret(lq, G, dk, window):
    arrs = _inputs(7 + dk, 2, 256, 2, G, dk, dk, lq)
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _both(arrs, "f32")
    want = jops.decode_query_attention(jq, jk, jv, jl, window=window,
                                       backend="interpret")
    got = ref.decode_query_attention_twin(tq, tk, tv, tl, window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("split", [1, 2, 3])
@pytest.mark.parametrize("lq,window", [(1, GLOBAL), (3, GLOBAL), (3, 40)])
def test_query_attention_twin_at_split_boundaries(split, lq, window):
    """Lengths one below, at and one above a multiple of the split size
    (64): the last visible position is the last of a split, or the first
    of the next."""
    from repro_torch.kernels.ref import DECODE_SPLIT
    arrs = _inputs(split * 10 + lq, 3, 256, 2, 4, 32, 32, lq)
    n = split * DECODE_SPLIT
    arrs[3][:] = [n - 1, n, n + 1]
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _both(arrs, "f32")
    want = jops.decode_query_attention(jq, jk, jv, jl, window=window,
                                       backend="ref")
    got = ref.decode_query_attention_twin(tq, tk, tv, tl, window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("window", [GLOBAL, 0])
def test_query_attention_twin_rows_that_see_no_position(window):
    """lengths < Lq, an empty item, and a window of 0: the twin gives such
    rows the mean of V over all S positions, as the Pallas kernel
    (interpret mode) does."""
    rng = np.random.default_rng(17)
    B, Lq, S, KV, G, dk = 4, 3, 256, 2, 2, 16
    q = rng.normal(size=(B, Lq, KV, G, dk)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, dk)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, dk)).astype(np.float32)
    lengths = np.array([S, 1, 2, 0], np.int32)
    want = jops.decode_query_attention(
        *(jnp.asarray(a) for a in (q, k, v, lengths)), window=window,
        backend="interpret")
    got = ref.decode_query_attention_twin(
        *(torch.from_numpy(a) for a in (q, k, v, lengths)), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("n", [1, 63, 64, 65, 129, 200])
@pytest.mark.parametrize("lq,window", [(1, GLOBAL), (3, 50)])
def test_query_attention_twin_is_batch_invariant(n, lq, window):
    """An item's output is bit-identical alone (S 256) and inside a larger
    batch padded past two more splits (S 384): the splits depend on S
    alone and splits the item cannot see are never merged."""
    arrs = _inputs(n + lq, 3, 384, 2, 4, 32, 32, lq)
    arrs[3][1] = n
    t = [torch.from_numpy(a) for a in arrs]
    batched = ref.decode_query_attention_twin(*t, window=window)
    alone = ref.decode_query_attention_twin(t[0][1:2], t[1][1:2, :256],
                                            t[2][1:2, :256], t[3][1:2],
                                            window=window)
    # query rows before position 0 see nothing and take the mean over all
    # S positions, which depends on S (in the plain version too)
    first = max(0, lq - n)
    assert torch.equal(alone[0, first:], batched[1, first:])


# Kernel D's FMA body: its CPU twin (kernels/ref.prefill_attention_fma_twin)
# walks the body's row tiles of 16 (position x head) rows and key tiles of
# 32, online softmax in float32 with exp. Held to the JAX oracle and the
# Pallas kernel (interpret mode) over PREFILL_CASES at PREFILL_TOL.
@pytest.mark.parametrize("B,S,KV,G,dk,dv,bq,bk,window,causal,dt",
                         PREFILL_CASES)
def test_prefill_fma_twin_matches_pallas_and_oracle(B, S, KV, G, dk, dv, bq,
                                                    bk, window, causal, dt):
    from repro.kernels import ref as jref
    from repro.kernels.prefill_attention import prefill_attention as jpa
    rng = np.random.default_rng(S + dk + dv)
    q = rng.normal(size=(B, S, KV, G, dk)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, dk)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, dv)).astype(np.float32)
    jdt, tdt, _ = DTYPES[dt]
    jargs = [jnp.asarray(a, jdt) for a in (q, k, v)]
    got = ref.prefill_attention_fma_twin(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), window=window,
        causal=causal)
    assert got.dtype == tdt and got.shape == (B, S, KV, G, dv)
    pallas = jpa(*jargs, window=window, causal=causal, block_q=bq,
                 block_k=bk, interpret=True)
    oracle = jref.prefill_attention_ref(*jargs, window=window,
                                        causal=causal)
    tol = PREFILL_TOL[dt]
    np.testing.assert_allclose(_f32(got), _f32(pallas), atol=tol, rtol=0)
    np.testing.assert_allclose(_f32(got), _f32(oracle), atol=tol, rtol=0)


@pytest.mark.parametrize("G,window", [(4, GLOBAL), (4, 100), (3, GLOBAL),
                                      (1, 17), (5, 33)])
def test_prefill_fma_twin_is_batch_invariant(G, window):
    """An item's rows are bit-identical alone and inside a larger batch
    padded further: row tiles sit at fixed multiples of 16 rows, and keys
    past a causal row add exact zeros."""
    rng = np.random.default_rng(G * 7 + window % 89)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((3, 200, 2, G, 24), (3, 200, 2, 24),
                         (3, 200, 2, 24)))
    batched = ref.prefill_attention_fma_twin(q, k, v, window=window)
    alone = ref.prefill_attention_fma_twin(q[1:2, :137], k[1:2, :137],
                                           v[1:2, :137], window=window)
    assert torch.equal(alone[0], batched[1, :137])


# Kernel C over every layer of a chunk: the port's layered call ((L, B, S,
# KV, dk) with (L, KV, G, dk) stats) against `jax.vmap` of the Pallas kernel
# (interpret mode) over the layers, as the JAX package scores an item; and
# C's CPU twin (kernels/ref.expected_attention_scores_twin: stats reduced
# over g first, per-lane slices, a butterfly) against the plain version.
# Tolerance 2e-5 x max(1, |score|): float32 sums of dk terms, in another
# order (and, in the twin, after the reduction over g).
EA_CASES = [(L, S, G, dk, dt) for (G, dk, dt), (L, S) in zip(
    itertools.product((1, 4), (16, 24, 128), ("f32", "bf16")),
    itertools.cycle([(2, 64), (3, 256), (2, 128)]))]


def _ea_inputs(seed, L, B, S, KV, G, dk):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(L, B, S, KV, dk)).astype(np.float32),
            rng.normal(size=(L, KV, G, dk)).astype(np.float32),
            rng.random(size=(L, KV, G, dk)).astype(np.float32))


def _ea_close(got, want):
    want = np.asarray(want, np.float32)
    tol = 2e-5 * np.maximum(1.0, np.abs(want))
    assert np.all(np.abs(np.asarray(got, np.float32) - want) <= tol)


@pytest.mark.parametrize("L,S,G,dk,dt", EA_CASES)
def test_expected_attention_layered_matches_jax_vmap(L, S, G, dk, dt):
    import jax
    from repro.kernels import expected_attention as jea
    arrs = _ea_inputs(L * S + G + dk, L, 2, S, 2, G, dk)
    jdt, tdt, _ = DTYPES[dt]
    want = jax.vmap(lambda k, m, s: jea.expected_attention_scores(
        k, m, s, interpret=True))(*(jnp.asarray(a, jdt) for a in arrs))
    got = ops.expected_attention_scores(
        *(torch.from_numpy(a).to(tdt) for a in arrs))
    assert got.dtype == torch.float32 and got.shape == (L, 2, S, 2)
    _ea_close(got.numpy(), want)


@pytest.mark.parametrize("L,S,G,dk,dt", EA_CASES)
def test_expected_attention_twin_matches_plain(L, S, G, dk, dt):
    k, mu, sig2 = (torch.from_numpy(a).to(DTYPES[dt][1]) for a in
                   _ea_inputs(L + S * G + dk, L, 2, S, 2, G, dk))
    want = ref.expected_attention_scores_ref(k, mu, sig2)
    got = ref.expected_attention_scores_twin(k, mu, sig2)
    assert got.shape == want.shape == (L, 2, S, 2)
    _ea_close(got.numpy(), want.numpy())
    # one layer without the layer axis is the same call
    one = ref.expected_attention_scores_twin(k[1], mu[1], sig2[1])
    assert torch.equal(one, got[1])


@pytest.mark.parametrize("dtype,dk,want", [
    (torch.bfloat16, 128, 16), (torch.float32, 128, 32),
    (torch.float32, 256, 32), (torch.float32, 16, 4), (torch.bfloat16, 16, 2),
    (torch.float32, 24, 1), (torch.bfloat16, 24, 1), (torch.bfloat16, 18, 1),
    (torch.float32, 6, 1)])
def test_expected_attention_lanes_rule(dtype, dk, want):
    """Kernel C's lanes per K row: the count of 16-byte vectors when it is
    a power of two (capped at 32), else one thread per row."""
    assert ref.ea_lanes(dtype, dk) == want


def test_expected_attention_layered_wrapper_refuses_cpu_tensors():
    from repro_torch.kernels import expected_attention as ea
    k, mu, sig2 = (torch.from_numpy(a) for a in
                   _ea_inputs(0, 2, 1, 64, 2, 1, 16))
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        ea.expected_attention_scores(k, mu, sig2)
    with pytest.raises(ValueError, match="CUDA"):
        ops.expected_attention_scores(k, mu, sig2, backend="cuda")
    assert ops.expected_attention_scores(k, mu, sig2).shape == (2, 1, 64, 2)
    assert ops.launch_counts() == before


# The int8 decode body's CPU twin (ref.decode_query_attention_twin with
# k_scale / v_scale): K scale on the score after the product, V scale
# folded into P, bf16 P split in two where the kernel uses the tensor
# cores (bf16 q, dk 128). Held to the port's int8 plain version and the
# JAX package's int8 path (its oracle; the Pallas kernel in interpret mode
# for float32), at the dtype tolerances above.
I8_CASES = list(itertools.product((1, 3), (GLOBAL, 40), (24, 128),
                                  ("f32", "bf16")))


def _int8_inputs(seed, B, Lq, S, KV, G, dk):
    q, k, v, lengths = _inputs(seed, B, S, KV, G, dk, dk, Lq)
    (k8, ks), (v8, vs) = _quant(k), _quant(v)
    return q, k8, v8, ks, vs, lengths


@pytest.mark.parametrize("lq,window,dk,dt", I8_CASES)
def test_int8_twin_matches_plain_and_jax(lq, window, dk, dt):
    q, k8, v8, ks, vs, lengths = _int8_inputs(lq * 7 + dk, 3, lq, 256, 2, 4,
                                              dk)
    jdt, tdt, tol = DTYPES[dt]
    t = torch.from_numpy
    tq = t(q).to(tdt)
    got = ref.decode_query_attention_twin(tq, t(k8), t(v8), t(lengths),
                                          window=window, k_scale=t(ks),
                                          v_scale=t(vs))
    plain = ref.decode_query_attention_int8_ref(tq, t(k8), t(v8), t(ks),
                                                t(vs), t(lengths),
                                                window=window)
    backend = "interpret" if dt == "f32" else "ref"
    want = jops.decode_query_attention(
        jnp.asarray(q, jdt), jnp.asarray(k8), jnp.asarray(v8),
        jnp.asarray(lengths), window=window, backend=backend,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_f32(got), _f32(plain), atol=tol, rtol=0)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=0)
    if lq == 1:
        got1 = ref.decode_attention_twin(tq[:, 0], t(k8), t(v8), t(lengths),
                                         window=window, k_scale=t(ks),
                                         v_scale=t(vs))
        want1 = jops.decode_attention(
            jnp.asarray(q[:, 0], jdt), jnp.asarray(k8), jnp.asarray(v8),
            jnp.asarray(lengths), window=window, backend=backend,
            k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        np.testing.assert_allclose(_f32(got1), _f32(want1), atol=tol,
                                   rtol=0)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("window", [GLOBAL, 0])
def test_int8_twin_rows_that_see_no_position(dt, window):
    """lengths < Lq, an empty item, a window of 0: the int8 twin gives such
    rows the mean of the dequantised V over all S positions, as the JAX
    package's int8 path does."""
    q, k8, v8, ks, vs, lengths = _int8_inputs(19, 4, 3, 256, 2, 4, 128)
    lengths[:] = [256, 1, 2, 0]
    jdt, tdt, tol = DTYPES[dt]
    t = torch.from_numpy
    got = ref.decode_query_attention_twin(t(q).to(tdt), t(k8), t(v8),
                                          t(lengths), window=window,
                                          k_scale=t(ks), v_scale=t(vs))
    want = jops.decode_query_attention(
        jnp.asarray(q, jdt), jnp.asarray(k8), jnp.asarray(v8),
        jnp.asarray(lengths), window=window, backend="ref",
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=0)
    mean = (v8.astype(np.float32) * vs[..., None])[3].mean(0)
    np.testing.assert_allclose(_f32(got)[3, 0], np.broadcast_to(
        mean[:, None, :], (2, 4, 128)), atol=tol)


@pytest.mark.parametrize("n", [1, 127, 128, 129, 200])
def test_int8_twin_is_batch_invariant(n):
    """As the float twin: an item's int8 output is bit-identical alone (S
    256) and inside a larger batch padded past one more split (S 384)."""
    q, k8, v8, ks, vs, lengths = _int8_inputs(n, 3, 1, 384, 2, 4, 128)
    lengths[1] = n
    t = torch.from_numpy
    tq = t(q).to(torch.bfloat16)
    batched = ref.decode_query_attention_twin(
        tq, t(k8), t(v8), t(lengths), k_scale=t(ks), v_scale=t(vs))
    alone = ref.decode_query_attention_twin(
        tq[1:2], t(k8)[1:2, :256], t(v8)[1:2, :256], t(lengths)[1:2],
        k_scale=t(ks)[1:2, :256], v_scale=t(vs)[1:2, :256])
    assert torch.equal(alone[0], batched[1])


@pytest.mark.parametrize("dtype,dk,dv,quant,want", [
    (torch.bfloat16, 128, 128, True, True), (torch.bfloat16, 64, 32, True,
                                             True),
    (torch.bfloat16, 32, 32, True, False), (torch.bfloat16, 128, 48, True,
                                            False),
    (torch.float32, 128, 128, True, False),
    (torch.bfloat16, 32, 48, False, True), (torch.bfloat16, 24, 24, False,
                                            False)])
def test_decode_tensor_core_rule(dtype, dk, dv, quant, want):
    """Which A / B inputs run on the tensor cores: bf16 q, and head dims
    the body's fragments take (int8: dk 64 or 128, dv a multiple of 32)."""
    assert ref.decode_uses_mma(dtype, dk, dv, quant) == want
