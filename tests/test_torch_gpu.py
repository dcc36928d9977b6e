"""The hand-written CUDA kernels on the card, against their plain versions.

Needs a CUDA card and nvcc; everywhere else every test skips. It imports
neither JAX nor the JAX package, so it runs on a machine that has only
PyTorch:

    python -m pytest tests/test_torch_gpu.py -q

Tolerances: atol 2e-5 in float32; 2e-2 in bfloat16, where both sides
round their outputs to bfloat16 (one step at these magnitudes). The int8
kernels are held to the same tolerances of their query's type against
the plain versions, which dequantise up front.
"""
import pytest
import torch

from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import expected_attention as EA
from repro_torch.kernels import ops, ref

GLOBAL = 1 << 30
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    # decided here, at run time, never while the module is imported
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


def _inputs(seed, B, Lq, KV, G, dk, dv, S, dtype):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    lengths = torch.randint(Lq, S + 1, (B,), generator=g, device="cuda",
                            dtype=torch.int32)
    lengths[0] = S
    return (rnd(B, Lq, KV, G, dk), rnd(B, S, KV, dk), rnd(B, S, KV, dv),
            lengths)


# (B, Lq, KV, G, dk, dv, S, dtype, window): planted widths, the 8B widths,
# dv != dk, and head dims that take the scalar (unvectorised) loads
CASES = [(4, 1, 2, 1, 16, 16, 256, torch.float32, GLOBAL),
         (4, 3, 4, 1, 24, 24, 256, torch.float32, 8),
         (3, 1, 8, 4, 128, 128, 1152, torch.bfloat16, GLOBAL),
         (3, 3, 8, 4, 128, 128, 640, torch.bfloat16, 100),
         (2, 2, 2, 2, 32, 48, 200, torch.float32, GLOBAL),
         (2, 1, 2, 2, 18, 18, 130, torch.bfloat16, GLOBAL),
         (2, 3, 2, 1, 6, 6, 129, torch.float32, 5)]


@pytest.mark.parametrize("B,Lq,KV,G,dk,dv,S,dtype,window", CASES)
def test_decode_query_attention_matches_plain(gpu, B, Lq, KV, G, dk, dv, S,
                                              dtype, window):
    q, k, v, lengths = _inputs(S + dk, B, Lq, KV, G, dk, dv, S, dtype)
    got = DA.decode_query_attention(q, k, v, lengths, window=window)
    want = ref.decode_query_attention_ref(q, k, v, lengths, window=window)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("B,Lq,KV,G,dk,dv,S,dtype,window",
                         [c for c in CASES if c[1] == 1])
def test_decode_attention_matches_plain(gpu, B, Lq, KV, G, dk, dv, S, dtype,
                                        window):
    q, k, v, lengths = _inputs(S + dk, B, 1, KV, G, dk, dv, S, dtype)
    q = q[:, 0]
    got = DA.decode_attention(q, k, v, lengths, window=window)
    want = ref.decode_attention_ref(q, k, v, lengths, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)


def test_decode_output_does_not_depend_on_batch_or_padding(gpu):
    """An item's output is bit-identical alone and inside a larger batch
    padded further: the splits depend on S alone and empty ones add
    exact zeros."""
    q, k, v, lengths = _inputs(3, 3, 2, 8, 4, 128, 128, 384, torch.bfloat16)
    lengths[1] = 200
    alone = DA.decode_query_attention(q[1:2], k[1:2, :256], v[1:2, :256],
                                      lengths[1:2])
    batched = DA.decode_query_attention(q, k, v, lengths)
    assert torch.equal(alone[0], batched[1])


def _quantized(k, v):
    """int8 rows and (B, S, KV) absmax scales, as the int8 rungs hold them."""
    def q8(x):
        s = x.float().abs().amax(-1) / 127.0
        return torch.round(x.float() / s.clamp(min=1e-9)[..., None]) \
            .to(torch.int8), s
    (k8, ks), (v8, vs) = q8(k), q8(v)
    return k8, v8, ks, vs


@pytest.mark.parametrize("B,Lq,KV,G,dk,dv,S,dtype,window", CASES)
def test_decode_query_attention_int8_matches_plain(gpu, B, Lq, KV, G, dk, dv,
                                                   S, dtype, window):
    q, k, v, lengths = _inputs(S + dk + 1, B, Lq, KV, G, dk, dv, S, dtype)
    k8, v8, ks, vs = _quantized(k, v)
    got = DA.decode_query_attention_int8(q, k8, v8, ks, vs, lengths,
                                         window=window)
    want = ref.decode_query_attention_int8_ref(q, k8, v8, ks, vs, lengths,
                                               window=window)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("B,Lq,KV,G,dk,dv,S,dtype,window",
                         [c for c in CASES if c[1] == 1])
def test_decode_attention_int8_matches_plain(gpu, B, Lq, KV, G, dk, dv, S,
                                             dtype, window):
    q, k, v, lengths = _inputs(S + dk + 1, B, 1, KV, G, dk, dv, S, dtype)
    k8, v8, ks, vs = _quantized(k, v)
    q = q[:, 0]
    got = DA.decode_attention_int8(q, k8, v8, ks, vs, lengths, window=window)
    want = ref.decode_attention_int8_ref(q, k8, v8, ks, vs, lengths,
                                         window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rows_that_see_no_position_get_the_mean_of_v(gpu, quant, dtype):
    """lengths < Lq (query rows before position 0), an empty item, and a
    window of 0: such rows see no position, and the kernels return the
    mean of V over all S positions, as the plain versions (and the JAX
    package's kernels) do."""
    q, k, v, lengths = _inputs(11, 4, 3, 2, 4, 128, 128, 256, dtype)
    lengths[1], lengths[2], lengths[3] = 1, 2, 0
    args = _quantized(k, v) if quant else (k, v)
    for window in (GLOBAL, 0):
        if quant:
            got = DA.decode_query_attention_int8(q, *args, lengths,
                                                 window=window)
            want = ref.decode_query_attention_int8_ref(q, *args, lengths,
                                                       window=window)
            got1 = DA.decode_attention_int8(q[:, 0], *args, lengths,
                                            window=window)
            want1 = ref.decode_attention_int8_ref(q[:, 0], *args, lengths,
                                                  window=window)
        else:
            got = DA.decode_query_attention(q, k, v, lengths, window=window)
            want = ref.decode_query_attention_ref(q, k, v, lengths,
                                                  window=window)
            got1 = DA.decode_attention(q[:, 0], k, v, lengths, window=window)
            want1 = ref.decode_attention_ref(q[:, 0], k, v, lengths,
                                             window=window)
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=TOL[dtype], rtol=0)
        torch.testing.assert_close(got1.float(), want1.float(),
                                   atol=TOL[dtype], rtol=0)
    # the rows of item 3 (length 0) are exactly the mean of its V rows
    vf = ref.dequantize(args[1], args[3]) if quant else v.float()
    torch.testing.assert_close(got[3, 0].float(),
                               vf[3].mean(0)[:, None, :].expand(2, 4, 128),
                               atol=TOL[dtype], rtol=0)


def test_int8_output_does_not_depend_on_batch_or_padding(gpu):
    """As for the bf16 kernel, at int8 K/V. Rows that see no position
    (item 2 here) are left out: their value is the mean over all S
    positions given, so in the reference too it depends on the padding."""
    q, k, v, lengths = _inputs(5, 3, 3, 8, 4, 128, 128, 384, torch.bfloat16)
    lengths[1], lengths[2] = 200, 1
    k8, v8, ks, vs = _quantized(k, v)
    batched = DA.decode_query_attention_int8(q, k8, v8, ks, vs, lengths)
    for i in (0, 1):
        n = 384 if i == 0 else 256
        alone = DA.decode_query_attention_int8(
            q[i:i + 1], k8[i:i + 1, :n], v8[i:i + 1, :n], ks[i:i + 1, :n],
            vs[i:i + 1, :n], lengths[i:i + 1])
        assert torch.equal(alone[0], batched[i])
    one = DA.decode_attention_int8(q[1:2, 0], k8[1:2, :256], v8[1:2, :256],
                                   ks[1:2, :256], vs[1:2, :256],
                                   lengths[1:2] - 2)
    many = DA.decode_attention_int8(q[:, 0], k8, v8, ks, vs, lengths - 2)
    assert torch.equal(one[0], many[1])


@pytest.mark.parametrize("B,S,KV,G,dk,dtype", [
    (1, 1024, 8, 4, 128, torch.bfloat16), (2, 160, 4, 1, 24, torch.float32),
    (1, 160, 2, 1, 16, torch.float32), (1, 77, 2, 3, 18, torch.bfloat16)])
def test_expected_attention_matches_plain(gpu, B, S, KV, G, dk, dtype):
    g = torch.Generator(device="cuda").manual_seed(S)
    k = torch.randn((B, S, KV, dk), generator=g, device="cuda").to(dtype)
    mu = torch.randn((KV, G, dk), generator=g, device="cuda")
    sig2 = torch.rand((KV, G, dk), generator=g, device="cuda")
    got = EA.expected_attention_scores(k, mu, sig2)
    want = ref.expected_attention_scores_ref(k, mu, sig2)
    assert got.dtype == torch.float32 and got.shape == (B, S, KV)
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, atol=2e-5 * scale, rtol=0)


def test_backends_on_cuda_tensors(gpu):
    """`auto` and `cuda` launch the kernel and count it; `ref` runs the
    plain version on the card and counts nothing."""
    q, k, v, lengths = _inputs(2, 2, 3, 2, 4, 128, 128, 256, torch.float32)
    before = ops.launch_counts()["decode_query_attention"]
    got = ops.decode_query_attention(q, k, v, lengths)
    ops.decode_query_attention(q, k, v, lengths, backend="cuda")
    assert ops.launch_counts()["decode_query_attention"] == before + 2
    want = ops.decode_query_attention(q, k, v, lengths, backend="ref")
    assert ops.launch_counts()["decode_query_attention"] == before + 2
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


def test_backends_on_cuda_int8_caches(gpu):
    """int8 caches on the card launch the int8 kernels under `auto` and
    `cuda`; nothing dequantises and falls back to the plain version."""
    q, k, v, lengths = _inputs(4, 2, 3, 2, 4, 128, 128, 256, torch.float32)
    k8, v8, ks, vs = _quantized(k, v)
    before = ops.launch_counts()
    got = ops.decode_query_attention(q, k8, v8, lengths, k_scale=ks,
                                     v_scale=vs)
    got1 = ops.decode_attention(q[:, 0], k8, v8, lengths, k_scale=ks,
                                v_scale=vs, backend="cuda")
    after = ops.launch_counts()
    assert after["decode_query_attention_int8"] == \
        before["decode_query_attention_int8"] + 1
    assert after["decode_attention_int8"] == before["decode_attention_int8"] + 1
    assert after["decode_query_attention"] == before["decode_query_attention"]
    want = ops.decode_query_attention(q, k8, v8, lengths, k_scale=ks,
                                      v_scale=vs, backend="ref")
    want1 = ops.decode_attention(q[:, 0], k8, v8, lengths, k_scale=ks,
                                 v_scale=vs, backend="ref")
    assert ops.launch_counts() == after
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    torch.testing.assert_close(got1, want1, atol=2e-5, rtol=0)
