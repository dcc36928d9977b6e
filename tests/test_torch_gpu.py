"""The hand-written CUDA kernels on the card, against their plain versions.

Needs a CUDA card and nvcc; everywhere else every test skips. It imports
neither JAX nor the JAX package, so it runs on a machine that has only
PyTorch:

    python -m pytest tests/test_torch_gpu.py -q

Tolerances: atol 2e-5 in float32; 2e-2 in bfloat16, where both sides
round their outputs to bfloat16 (one step at these magnitudes).
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
