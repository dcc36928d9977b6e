"""The hand-written CUDA kernels on the card, against their plain versions.

Needs a CUDA card and nvcc; everywhere else every test skips. It imports
neither JAX nor the JAX package, so it runs on a machine that has only
PyTorch:

    python -m pytest tests/test_torch_gpu.py -q

Tolerances: atol 2e-5 in float32; 2e-2 in bfloat16, where both sides
round their outputs to bfloat16 (one step at these magnitudes). The int8
kernels are held to the same tolerances of their query's type against
the plain versions, which dequantise up front. The full-width
stretto-llama-8b prefill (32 layers, bfloat16) holds its caches and
logits, prefill kernel against the blocked attention, to 5 % of their
largest magnitude: bfloat16 rounding differences carried through 32
layers of random weights. The redesigned kernels (A / B's body over
float32 / bfloat16 and over int8 K/V, C, D's FMA body) are also held to
their CPU twins' blocked algorithms run on the card, at the same
tolerances: the two differ only in the order of float32 sums. C's
scores are held to 2e-5 x max(1, |score|) (float32 sums of dk terms).
Kernel E (the planner's Beta bounds), the optimizer's CUDA graph and the
comparison planners on the card state their tolerances where they are
tested, at the end of this file.
"""
import pytest
import torch

from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import expected_attention as EA
from repro_torch.kernels import ops, ref
from repro_torch.kernels import prefill_attention as PA

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


@pytest.mark.parametrize("B,Lq,KV,G,dk,dv,S,dtype,window", CASES + [
    (4, 3, 8, 4, 128, 128, 1152, torch.bfloat16, GLOBAL),    # R = 12 at 8B
    (4, 3, 8, 4, 128, 128, 1152, torch.float32, 300)])
def test_decode_query_attention_matches_twin(gpu, B, Lq, KV, G, dk, dv, S,
                                             dtype, window):
    q, k, v, lengths = _inputs(S + dk + 2, B, Lq, KV, G, dk, dv, S, dtype)
    got = DA.decode_query_attention(q, k, v, lengths, window=window)
    twin = ref.decode_query_attention_twin(q, k, v, lengths, window=window)
    want = ref.decode_query_attention_ref(q, k, v, lengths, window=window)
    torch.testing.assert_close(got.float(), twin.float(), atol=TOL[dtype],
                               rtol=0)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Lq,window", [(1, GLOBAL), (3, GLOBAL), (3, 70)])
def test_decode_split_boundaries_match_plain(gpu, dtype, Lq, window):
    """At the 8B widths, lengths one below, at and one above each multiple
    of the split size (64) up to S 1152: the last visible position ends a
    split or opens the next one. A and, at Lq 1, B."""
    n = [s * DA.SPLIT + o for s in range(1, 1152 // DA.SPLIT)
         for o in (-1, 0, 1)]
    B = len(n)
    q, k, v, _ = _inputs(Lq + 3, B, Lq, 8, 4, 128, 128, 1152, dtype)
    lengths = torch.tensor(n, dtype=torch.int32, device="cuda")
    got = DA.decode_query_attention(q, k, v, lengths, window=window)
    want = ref.decode_query_attention_ref(q, k, v, lengths, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)
    if Lq == 1:
        got1 = DA.decode_attention(q[:, 0], k, v, lengths, window=window)
        want1 = ref.decode_attention_ref(q[:, 0], k, v, lengths,
                                         window=window)
        torch.testing.assert_close(got1.float(), want1.float(),
                                   atol=TOL[dtype], rtol=0)


def test_decode_repeated_calls_reuse_the_arrival_counters(gpu):
    """Each launch leaves its arrival counters at zero, so calls in a row
    on the same scratch (and on another stream, with its own) give the
    same bits; a counter left behind would skip or repeat a merge."""
    q, k, v, lengths = _inputs(9, 6, 1, 8, 4, 128, 128, 1152, torch.bfloat16)
    first = DA.decode_query_attention(q, k, v, lengths)
    again = [DA.decode_query_attention(q, k, v, lengths) for _ in range(3)]
    b1 = DA.decode_attention(q[:, 0], k, v, lengths)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        other = DA.decode_query_attention(q, k, v, lengths)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert all(torch.equal(first, a) for a in again)
    assert torch.equal(first, other)
    assert torch.equal(first[:, 0], b1)
    for buf in DA._arrivals.values():
        assert int(buf.abs().sum()) == 0


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [63, 64, 65, 128, 200])
def test_decode_output_does_not_depend_on_batch_or_padding(gpu, dtype, n):
    """An item's output is bit-identical alone and inside a larger batch
    padded past two more splits (S 256 -> 384): the splits depend on S
    alone and splits the item cannot see are never merged. The twin, run
    on the card, is batch-invariant too."""
    q, k, v, lengths = _inputs(3, 3, 2, 8, 4, 128, 128, 384, dtype)
    lengths[1] = n
    alone = DA.decode_query_attention(q[1:2], k[1:2, :256], v[1:2, :256],
                                      lengths[1:2])
    batched = DA.decode_query_attention(q, k, v, lengths)
    assert torch.equal(alone[0], batched[1])
    one = DA.decode_attention(q[1:2, 0], k[1:2, :256], v[1:2, :256],
                              lengths[1:2])
    many = DA.decode_attention(q[:, 0], k, v, lengths)
    assert torch.equal(one[0], many[1])
    twin = ref.decode_query_attention_twin(q, k, v, lengths)
    twin1 = ref.decode_query_attention_twin(
        q[1:2], k[1:2, :256], v[1:2, :256], lengths[1:2])
    assert torch.equal(twin1[0], twin[1])


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


# (L, B, S, KV, G, dk, dtype): the 8B chunks (Session and hand plan), the
# planted chunks (dk 16: lanes of 16-byte vectors; dk 24: the row kernel),
# bf16 dk 18 (element loads), and the MLA latent chunks (the row kernel)
EA_CHUNKS = [(32, 4, 512, 8, 4, 128, torch.bfloat16),
             (4, 16, 1024, 8, 4, 128, torch.bfloat16),
             (2, 16, 160, 2, 1, 16, torch.float32),
             (2, 16, 160, 4, 1, 24, torch.float32),
             (3, 2, 77, 2, 3, 18, torch.bfloat16),
             (2, 3, 100, 2, 4, 128, torch.float32),
             # MLA latent rows [c_kv ; k_rope], one KV head: deepseek's
             # (r 512 + rope 64, G 16) and minicpm3's (256 + 32, G 40)
             (27, 4, 512, 1, 16, 576, torch.bfloat16),
             (6, 4, 512, 1, 40, 288, torch.bfloat16)]


def _ea_chunk(seed, L, B, S, KV, G, dk, dtype):
    g = torch.Generator(device="cuda").manual_seed(seed)
    k = torch.randn((L, B, S, KV, dk), generator=g, device="cuda").to(dtype)
    mu = torch.randn((L, KV, G, dk), generator=g, device="cuda").to(dtype)
    sig2 = torch.rand((L, KV, G, dk), generator=g, device="cuda").to(dtype)
    return k, mu, sig2


def _ea_close(got, want):
    tol = 2e-5 * want.abs().clamp(min=1.0)
    assert bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize("L,B,S,KV,G,dk,dtype", EA_CHUNKS)
def test_expected_attention_layered_matches_plain_and_twin(gpu, L, B, S, KV,
                                                           G, dk, dtype):
    """One launch over every layer and item of a chunk (stats in the model
    dtype), against the plain version and C's CPU twin run on the card."""
    k, mu, sig2 = _ea_chunk(S + dk, L, B, S, KV, G, dk, dtype)
    before = EA.expected_attention_scores.launches
    got = EA.expected_attention_scores(k, mu, sig2)
    assert EA.expected_attention_scores.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (L, B, S, KV)
    _ea_close(got, ref.expected_attention_scores_ref(k, mu, sig2))
    _ea_close(got, ref.expected_attention_scores_twin(k, mu, sig2))


@pytest.mark.parametrize("dtype,dk", [(torch.bfloat16, 128),
                                      (torch.float32, 16),
                                      (torch.float32, 24)])
def test_expected_attention_item_bitwise_alone_and_in_chunk(gpu, dtype, dk):
    """Every item's scores are bit-identical scored alone (its strided
    slice, or a contiguous copy) and at its place in the chunk: a score
    depends on its K row and its layer's stats alone."""
    k, mu, sig2 = _ea_chunk(dk, 3, 5, 300, 4, 2, dk, dtype)
    chunk = EA.expected_attention_scores(k, mu, sig2)
    for b in range(5):
        alone = EA.expected_attention_scores(k[:, b:b + 1], mu, sig2)
        copy = EA.expected_attention_scores(k[:, b:b + 1].contiguous(), mu,
                                            sig2)
        shorter = EA.expected_attention_scores(k[:, b:b + 1, :170], mu, sig2)
        assert torch.equal(alone[:, 0], chunk[:, b])
        assert torch.equal(copy[:, 0], chunk[:, b])
        assert torch.equal(shorter[:, 0], chunk[:, b, :170])
    # one layer without the layer axis: the same scores
    assert torch.equal(EA.expected_attention_scores(k[1], mu[1], sig2[1]),
                       chunk[1])


def test_expected_attention_planted_shapes_launch_the_kernel(gpu):
    """The planted chunks (float32, dk 16 and 24) go through `ops` to the
    kernel, never to the plain version."""
    from repro_torch.cache.compression import QueryStats, score_chunk
    for KV, dk in ((2, 16), (4, 24)):
        k, mu, sig2 = _ea_chunk(dk, 2, 16, 160, KV, 1, dk, torch.float32)
        before = ops.launch_counts()["expected_attention_scores"]
        got = score_chunk(None, {"k": k}, QueryStats(mu, sig2), [160] * 16)
        assert ops.launch_counts()["expected_attention_scores"] == before + 1
        want = ref.expected_attention_scores_ref(k, mu, sig2).mean(-1)
        _ea_close(got, want)


@pytest.mark.parametrize("B,Lq,KV,G,dk,dv,S,dtype,window", CASES + [
    (4, 3, 8, 4, 128, 128, 1152, torch.bfloat16, GLOBAL),    # R = 12 at 8B
    (4, 1, 8, 4, 64, 96, 640, torch.bfloat16, 200)])
def test_decode_int8_matches_twin(gpu, B, Lq, KV, G, dk, dv, S, dtype,
                                  window):
    """The int8 body against its CPU twin run on the card (and the plain
    version), A and, at Lq 1, B."""
    q, k, v, lengths = _inputs(S + dk + 5, B, Lq, KV, G, dk, dv, S, dtype)
    k8, v8, ks, vs = _quantized(k, v)
    got = DA.decode_query_attention_int8(q, k8, v8, ks, vs, lengths,
                                         window=window)
    twin = ref.decode_query_attention_twin(q, k8, v8, lengths, window=window,
                                           k_scale=ks, v_scale=vs)
    want = ref.decode_query_attention_int8_ref(q, k8, v8, ks, vs, lengths,
                                               window=window)
    torch.testing.assert_close(got.float(), twin.float(), atol=TOL[dtype],
                               rtol=0)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)
    if Lq == 1:
        got1 = DA.decode_attention_int8(q[:, 0], k8, v8, ks, vs, lengths,
                                        window=window)
        twin1 = ref.decode_attention_twin(q[:, 0], k8, v8, lengths,
                                          window=window, k_scale=ks,
                                          v_scale=vs)
        torch.testing.assert_close(got1.float(), twin1.float(),
                                   atol=TOL[dtype], rtol=0)


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


# (B, S, KV, G, dk, dv, dtype, window, causal, body): the planted widths,
# the 8B widths at the profile builds' lengths (S 512 and 1024, global and
# window 256), S 300 (a ragged last tile), window 1, G 1, non-causal,
# dk != dv, G 3, and a bf16 head dim the tensor-core tiles do not take.
# `body` is the body kernels/prefill_attention.body picks, asserted from
# the per-body launch counts.
PREFILL_CASES = [
    (16, 160, 2, 1, 16, 16, torch.float32, GLOBAL, True, "fma"),
    (16, 160, 4, 1, 24, 24, torch.float32, 8, True, "fma"),
    (4, 512, 8, 4, 128, 128, torch.bfloat16, GLOBAL, True, "tc"),
    (4, 1024, 8, 4, 128, 128, torch.bfloat16, GLOBAL, True, "tc"),
    (4, 1024, 8, 4, 128, 128, torch.bfloat16, 256, True, "tc"),
    (2, 300, 8, 4, 128, 128, torch.bfloat16, GLOBAL, True, "tc"),
    (2, 256, 2, 4, 128, 128, torch.bfloat16, 1, True, "tc"),
    (2, 256, 8, 1, 128, 128, torch.bfloat16, GLOBAL, True, "tc"),
    (2, 200, 2, 3, 64, 64, torch.bfloat16, 17, True, "tc"),
    (2, 200, 2, 2, 128, 128, torch.bfloat16, GLOBAL, False, "tc"),
    (2, 200, 2, 3, 24, 40, torch.float32, GLOBAL, False, "fma"),
    (2, 130, 2, 2, 32, 48, torch.bfloat16, 17, True, "tc"),
    (2, 130, 2, 2, 24, 24, torch.bfloat16, GLOBAL, True, "fma"),
    (2, 512, 8, 4, 128, 128, torch.float32, 100, True, "fma"),
    (3, 77, 2, 5, 20, 12, torch.float32, 9, True, "fma")]


def _prefill_inputs(seed, B, S, KV, G, dk, dv, dtype):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    return rnd(B, S, KV, G, dk), rnd(B, S, KV, dk), rnd(B, S, KV, dv)


@pytest.mark.parametrize("B,S,KV,G,dk,dv,dtype,window,causal,body",
                         PREFILL_CASES)
def test_prefill_attention_matches_plain(gpu, B, S, KV, G, dk, dv, dtype,
                                         window, causal, body):
    """Against the plain version and the blocked `flash_attention` at the
    dtype's tolerance, and against the CPU twin of the body that ran (its
    algorithm run on the card; same tolerance: the two differ only in the
    order of float32 sums)."""
    from repro_torch.models.layers import flash_attention
    q, k, v = _prefill_inputs(S + dk, B, S, KV, G, dk, dv, dtype)
    before = dict(ops.launch_counts()["prefill_attention_by_body"])
    got = PA.prefill_attention(q, k, v, window=window, causal=causal)
    after = ops.launch_counts()["prefill_attention_by_body"]
    assert {b: after[b] - before[b] for b in after} == \
        {b: int(b == body) for b in after}
    want = ref.prefill_attention_ref(q, k, v, window=window, causal=causal)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)
    blocked = flash_attention(q.reshape(B, S, KV * G, dk), k, v, window,
                              causal=causal).reshape(got.shape)
    torch.testing.assert_close(got.float(), blocked.float(),
                               atol=TOL[dtype], rtol=0)
    twin_fn = (ref.prefill_attention_tc_twin if body == "tc"
               else ref.prefill_attention_fma_twin)
    twin = twin_fn(q, k, v, window=window, causal=causal)
    torch.testing.assert_close(got.float(), twin.float(), atol=TOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_prefill_output_does_not_depend_on_batch_or_padding(gpu, dtype):
    """An item's rows are bit-identical alone and inside a larger batch
    padded further, in both bodies (bfloat16: tensor cores, float32: FMA):
    a row's sums run in one order fixed by its position, and keys past a
    causal row add exact zeros."""
    q, k, v = _prefill_inputs(7, 3, 512, 8, 4, 128, 128, dtype)
    for G in (4, 3):
        qg = q[:, :, :, :G].contiguous()
        for window in (GLOBAL, 100):
            batched = PA.prefill_attention(qg, k, v, window=window)
            alone = PA.prefill_attention(qg[1:2, :300], k[1:2, :300],
                                         v[1:2, :300], window=window)
            assert torch.equal(alone[0], batched[1, :300])


def test_prefill_backends_on_cuda_tensors(gpu):
    """`auto` and `cuda` launch the kernel and count it; `ref` runs the
    plain version on the card and counts nothing; a CPU tensor under
    `cuda` raises."""
    q, k, v = _prefill_inputs(5, 2, 96, 2, 2, 16, 16, torch.float32)
    before = ops.launch_counts()["prefill_attention"]
    got = ops.prefill_attention(q, k, v, window=9)
    ops.prefill_attention(q, k, v, window=9, backend="cuda")
    assert ops.launch_counts()["prefill_attention"] == before + 2
    want = ops.prefill_attention(q, k, v, window=9, backend="ref")
    assert ops.launch_counts()["prefill_attention"] == before + 2
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    with pytest.raises(ValueError, match="CUDA"):
        ops.prefill_attention(q.cpu(), k.cpu(), v.cpu(), backend="cuda")


def test_llama8b_prefill_kernel_matches_blocked_attention(gpu):
    """A full-width stretto-llama-8b prefill (32 layers, random weights
    from a seed): caches and last-token logits with the prefill kernel
    (kernels="cuda") against the blocked attention (kernels="ref")."""
    from repro_torch.configs.stretto_llama_8b import CONFIG as cfg
    from repro_torch.models import init_params, prefill
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, device="cuda")
    toks = torch.randint(3, 1000, (2, 384), generator=gen, device="cuda")
    lengths = torch.tensor([384, 300], dtype=torch.int32, device="cuda")
    before = ops.launch_counts()
    got = prefill(params, cfg, toks, lengths=lengths, kernels="cuda")
    after = ops.launch_counts()
    assert after["prefill_attention"] == \
        before["prefill_attention"] + cfg.n_layers
    # bfloat16, d 128: every layer on the tensor-core body
    by_body = {b: after["prefill_attention_by_body"][b]
               - before["prefill_attention_by_body"][b]
               for b in ("tc", "fma")}
    assert by_body == {"tc": cfg.n_layers, "fma": 0}
    want = prefill(params, cfg, toks, lengths=lengths, kernels="ref")
    for a, b in ((got[0], want[0]), (got[1]["k"], want[1]["k"]),
                 (got[1]["v"], want[1]["v"])):
        assert a.dtype == b.dtype and a.shape == b.shape
        scale = float(b.float().abs().max())
        assert bool(torch.isfinite(a.float()).all())
        torch.testing.assert_close(a.float(), b.float(), atol=0.05 * scale,
                                   rtol=0)
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# kernel E (the planner's Beta bounds), the optimizer's CUDA graph, and the
# comparison planners on the card
# ---------------------------------------------------------------------------

# E follows the plain version's float32 arithmetic operation by operation
# (csrc/beta_bounds.cu); what differs is CUDA's expf / logf / log1pf /
# lgammaf against the CPU's, by an ulp at times, and on the card the plain
# version's own PyTorch arithmetic (a division by a number is a
# multiplication by its reciprocal there). float32 lgamma(a + b) sits in
# betainc's exponent, so an ulp of it moves I by ~lgamma(a + b) * 6e-8
# relative: the terms' error grows with a + b and with min(I, 1 - I)
# (I ~ q at the root). Held, per a, b range (readings of
# scripts/beta_bounds_errors.py on an H100, the largest over q in the
# parenthesis):
#   [1, 60], the linear Sessions' soft counts: the root 2e-5 (3.6e-6);
#     the backward's terms 1e-5 * max(min(q, 1 - q) / 0.05, 0.02), so 1e-5
#     at the planner's q = 0.05 (3.1e-6 at q 0.05 and 0.95, 3.1e-5 at q
#     0.5); dI/da and dI/db formed from the terms as the backward forms
#     them within 15 % of their size (3.2 % at q 0.05, 7.0 % at q 0.5): a
#     kernel that drops the central-difference step reads 100 %, one that
#     swaps its signs 200 %; the pdf 1e-4 relative (7.7e-6).
#   [1, 401], the join trees' pair samples: the root 2e-5 (1.8e-5), the
#     terms 1e-3 (1.8e-4), the pdf 1e-3 (3.1e-5); the gradient is not held
#     there: float32 rounding already moves the plain version's central
#     difference by up to 39 % between the card and the CPU.
#   [0.5, 1e4] (lgamma to ~2e5, an ulp of 0.016): the root only, 1e-4
#     against the CPU (1.2e-5).
E_TOL = dict(x=2e-5, grad=0.15, pdf=1e-4)
E_TOL_401 = dict(x=2e-5, fd=1e-3, pdf=1e-3)
E_TOL_WIDE_X = 1e-4


def _fd_tol(q: float) -> float:
    """The backward's terms on a, b in [1, 60]: 1e-5 at q 0.05."""
    return 1e-5 * max(min(q, 1.0 - q) / 0.05, 0.02)


def _beta_grid(seed, n=256, hi=401.0, lo=1.0):
    """a, b log-uniform in [lo, hi], on the card."""
    g = torch.Generator().manual_seed(seed)
    ab = torch.exp(torch.empty(2, n).uniform_(
        float(torch.log(torch.tensor(lo))), float(torch.log(torch.tensor(hi))),
        generator=g))
    ab = ab.float().cuda()
    return ab[0].contiguous(), ab[1].contiguous()


def _grad_err(got, want) -> float:
    """max |got - want| over max |want|, for dI/da and dI/db: the
    larger."""
    return max(float((got[i] - want[i]).abs().max()
                     / want[i].abs().max().clamp(min=1e-30))
               for i in range(2))


def _e_against_plain_twin_cpu(a, b, qt):
    """E's root and gradient terms, and the same from the plain version
    on the card, the twin and the plain version on the CPU."""
    x = ops.beta_incinv(a, b, qt)
    fd, pdf = ops.beta_incinv_grad_terms(a, b, x)
    cpu = [t.cpu() for t in (a, b, qt, x)]
    want = {
        "plain": (ops.beta_incinv(a, b, qt, backend="ref"),
                  ops.beta_incinv_grad_terms(a, b, x, backend="ref")),
        "twin": (ref.betaincinv_twin(a, b, qt),
                 ref.betaincinv_grad_terms_twin(a, b, x)),
        "cpu": (ref.betaincinv_ref(*cpu[:3]).cuda(),
                [t.cuda() for t in ref.betaincinv_grad_terms_ref(
                    cpu[0], cpu[1], cpu[3])])}
    return (x, fd, pdf), want


@pytest.mark.parametrize("q", [1e-6, 0.05, 0.5, 0.95, 1 - 1e-6])
def test_beta_bounds_kernel_matches_plain_and_twin(gpu, q):
    from repro_torch.kernels import beta_bounds as BB
    # a and b in [1, 60]: root, terms, the gradient formed from them, pdf
    a, b = _beta_grid(int(q * 1e6) % 1000, hi=60.0)
    qt = torch.full_like(a, q)
    before = ops.launch_counts()
    (x, fd, pdf), want = _e_against_plain_twin_cpu(a, b, qt)
    after = ops.launch_counts()
    assert after["beta_incinv"] == before["beta_incinv"] + 1
    assert after["beta_incinv_grad_terms"] == \
        before["beta_incinv_grad_terms"] + 1
    assert bool(torch.isfinite(x).all()) and bool(((x >= 0) & (x <= 1)).all())
    grad = ref.fd_grads(fd, a, b)
    plain = ref.fd_grads(want["plain"][1][0], a, b)
    if 0.01 < q < 0.99:
        # the gradient check tells a right kernel from one that drops the
        # step or swaps its signs (at q 1e-6 and 1 - 1e-6 the four terms
        # lie within a few ulps of each other, in every version)
        assert _grad_err(ref.fd_grads(fd[[0, 0, 2, 2]], a, b), plain) \
            > E_TOL["grad"]
        assert _grad_err(ref.fd_grads(fd[[1, 0, 3, 2]], a, b), plain) \
            > E_TOL["grad"]
    for name, (wx, (wfd, wpdf)) in want.items():
        torch.testing.assert_close(x, wx, atol=E_TOL["x"], rtol=0, msg=name)
        torch.testing.assert_close(fd, wfd, atol=_fd_tol(q), rtol=0,
                                   msg=name)
        assert _grad_err(grad, ref.fd_grads(wfd, a, b)) <= E_TOL["grad"], \
            name
        torch.testing.assert_close(pdf, wpdf, rtol=E_TOL["pdf"], atol=0,
                                   msg=name)
    assert ops.launch_counts()["beta_incinv"] == after["beta_incinv"]
    with pytest.raises(ValueError, match="CUDA"):
        BB.beta_incinv(a.cpu(), b.cpu(), qt.cpu())
    # a and b in [1, 401]: root, terms, pdf
    a, b = _beta_grid(int(q * 1e6) % 1000 + 1)
    qt = torch.full_like(a, q)
    (x, fd, pdf), want = _e_against_plain_twin_cpu(a, b, qt)
    for name, (wx, (wfd, wpdf)) in want.items():
        torch.testing.assert_close(x, wx, atol=E_TOL_401["x"], rtol=0,
                                   msg=name)
        torch.testing.assert_close(fd, wfd, atol=E_TOL_401["fd"], rtol=0,
                                   msg=name)
        torch.testing.assert_close(pdf, wpdf, rtol=E_TOL_401["pdf"],
                                   atol=0, msg=name)
    # a and b from 0.5 to 1e4: the root against the CPU's plain version
    a, b = _beta_grid(7, lo=0.5, hi=1e4)
    qt = torch.full_like(a, q)
    torch.testing.assert_close(
        ops.beta_incinv(a, b, qt),
        ref.betaincinv_ref(a.cpu(), b.cpu(), qt.cpu()).cuda(),
        atol=E_TOL_WIDE_X, rtol=0)


def _planner_world(seed=0, N=48):
    """Two pipelines (a filter and a map, three operators each) with
    scores made with numpy from a seed."""
    import numpy as np
    from repro_torch.core import relaxation as TR
    rng = np.random.default_rng(seed)
    gold = rng.normal(size=N) * 2
    f = np.stack([gold + rng.normal(scale=0.8, size=N),
                  gold + rng.normal(scale=0.3, size=N),
                  gold]).astype(np.float32)
    conf = (np.abs(rng.normal(size=(3, N)))
            * np.array([[2.0], [3.0], [4.0]])).astype(np.float32)
    corr = np.stack([rng.uniform(size=N) < 0.8, rng.uniform(size=N) < 0.95,
                     np.ones(N, bool)]).astype(np.float32)
    costs = torch.tensor([1e-4, 4e-4, 2e-3])
    fixed = torch.tensor([2e-3, 3e-3, 6e-3])
    cap = torch.tensor([128.0, 64.0, 32.0])
    pipes = [TR.PipelineData(torch.from_numpy(f), costs, False, None, fixed,
                             cap, torch.tensor([float("nan"), 40.0,
                                                float("nan")])),
             TR.PipelineData(torch.from_numpy(conf), costs * 1.5, True,
                             torch.from_numpy(corr), fixed, cap)]
    return pipes, (gold > 0).astype(np.float32)


def _selections_equal_outside_ties(a, b, tie=5e-3) -> bool:
    """Equal stage selections, except where both plans' pick
    probabilities sit within `tie` of 0.5."""
    for sa, sb, pa, pb in zip(a.selected, b.selected, a.params, b.params):
        qa = torch.sigmoid(pa.pick_logits.double())
        qb = torch.sigmoid(pb.pick_logits.double())
        for i in (sa != sb).nonzero()[0]:
            if abs(float(qa[i]) - 0.5) >= tie or abs(float(qb[i]) - 0.5) >= tie:
                return False
    return True


@pytest.mark.parametrize("counts", ["query_counts", "tree_counts"])
def test_optimizer_graph_matches_eager_card_loop_and_the_cpu(gpu, counts):
    """One Adam step captured as a CUDA graph and replayed gives the
    eager step on the card bit for bit (every restart's parameters, every
    loss, every snapshot); optimize_query on the card against the CPU's
    selects the same stages outside the 0.5 ties; E's launches are
    counted per replay (two per step: the bounds and their gradient)."""
    from repro_torch.core import optimizer as TO
    from repro_torch.core import relaxation as TR
    pipes, g = _planner_world()
    cfg = TO.PlannerConfig(steps=200, restarts=3)
    kw = dict(batch_hint=TR.BatchHint(64.0, 4.0)) \
        if counts == "query_counts" else dict(groups=[
            TR.TreeGroup(1, "side", 0.5, TR.BatchHint(64.0, 0.5)),
            TR.TreeGroup(1, "pair", 2.0, TR.BatchHint(64.0, 2.0))])
    card_pipes = [p._replace(**{f: v.cuda() for f, v in p._asdict().items()
                                if isinstance(v, torch.Tensor)})
                  for p in pipes]
    prob = TO.setup_problem(card_pipes, g, 0.7, 0.7, cfg, **kw)
    assert all(p.scores.is_cuda for p in prob.pipelines)
    names = ("beta_incinv", "beta_incinv_grad_terms")
    before = [ops.launch_counts()[n] for n in names]
    graph = TO.adam_loop(prob.loss_fn, prob.flat0, cfg, prob.snap_steps)
    # warm-up (2 steps) and 200 replays, the bounds and (launched from
    # autograd's thread) their gradient terms
    assert [ops.launch_counts()[n] - b for n, b in zip(names, before)] \
        == [2 + 200, 2 + 200]
    assert graph.replays == 200
    eager = TO.adam_loop(prob.loss_fn, prob.flat0, cfg, prob.snap_steps,
                         graph=False)
    assert eager.replays == 0
    assert torch.equal(graph.flat, eager.flat)
    assert torch.equal(graph.losses, eager.losses)
    for i in prob.snap_steps:
        assert torch.equal(graph.snaps[i], eager.snaps[i])
    card = TO.optimize_query(card_pipes, g, 0.7, 0.7, cfg, device="cuda",
                             **kw)
    cpu = TO.optimize_query(pipes, g, 0.7, 0.7, cfg, device="cpu", **kw)
    assert _selections_equal_outside_ties(card, cpu)
    assert all(p.thr_hi.device.type == "cpu" for p in card.params)


def _pinned_wall(op_name: str, n: int) -> float:
    import re
    m = re.match(r"(sm|lg)-kv(\d\d)(i8)?$", op_name)
    if m is None:
        return 1e-4 + 1e-5 * n
    size = {"sm": 1.0, "lg": 3.0}[m.group(1)]
    keep = 1.0 - int(m.group(2)) / 100.0
    return 2e-3 * size + 1e-4 * size * (0.2 + keep) * n


def test_baselines_plan_on_the_card_as_on_the_cpu(gpu, tmp_path,
                                                  monkeypatch):
    """Each comparison planner over a planted world, on the card and on
    the CPU over the same stored profiles, both profiling clocks pinned:
    the same stages (the gradient ablations outside 0.5 ties), thresholds
    within 1e-4 (fixed rules), 0.05 (the local ablation) or 0.1 (the
    independent one: its single start carries E's rounding against the
    CPU's through the whole trajectory; 0.077 on this world's sm-kv50
    reject threshold, as 0.067 against the JAX package in
    tests/test_torch_baselines.py, where one float32 ulp of the start
    moves the port's own thresholds by up to 0.069:
    scripts/independent_gap.py)."""
    import repro_torch.runtime.executor as tex
    from repro_torch.cache.store import CacheStore
    from repro_torch.core import baselines as BL
    from repro_torch.core.logical import Query, SemFilter, SemMap
    from repro_torch.core.optimizer import PlannerConfig
    from repro_torch.data import synthetic as syn
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.operators import make_registry
    real = tex.run_operator

    def pinned(backend, op, op_name, items):
        out = real(backend, op, op_name, items)
        out.wall_s = _pinned_wall(op_name, len(items))
        return out
    monkeypatch.setattr(tex, "run_operator", pinned)
    ds = syn.make_dataset("baselines", 100, seed=5)
    regs = {}
    for dev in ("cuda", "cpu"):
        eng = ServingEngine(CacheStore(str(tmp_path)), device=dev)
        for size in ("sm", "lg"):
            mcfg = syn.planted_config(size)
            eng.register_model(size, mcfg, syn.make_planted_params(
                mcfg, seed=1, device=dev))
            if dev == "cuda":
                eng.build_profiles(size, ds.items, ratios=(0.0, 0.5),
                                   prefill_batch=40)
        regs[dev] = make_registry(eng, sm_ratios=(0.5, 0.0),
                                  lg_ratios=(0.5,))
    cfg = PlannerConfig(steps=150, restarts=2, snapshots=3)
    query = Query([SemFilter("f1", 1), SemMap("extract v3", 3)], 0.6, 0.6)
    sizes = [len(regs["cpu"](op)) for op in query.semantic_ops]
    calls = []          # what the recorded functions saw, per call

    def record(name):
        real_fn = getattr(BL, name)

        def wrapped(*args, **kwargs):
            out = real_fn(*args, **kwargs)
            # a reference only: inside a captured step nothing may sync
            calls.append(out if name == "optimize_query" else args[0])
            return out
        monkeypatch.setattr(BL, name, wrapped)
    record("optimize_query")
    record("unflatten_params")

    def chosen_picks(fn):
        """Per pipeline, the pick logits the planner selected from: the
        optimizer's plan per pipeline (local), the last flat vector
        (independent)."""
        if fn is BL.plan_stretto_local:
            return [c.params[0].pick_logits for c in calls]
        if fn is BL.plan_stretto_independent:
            flat, off, out = calls[-1].reshape(-1).cpu(), 0, []
            for n in sizes:
                out.append(flat[off:off + n])
                off += 3 * n
            return out
        return []
    for fn, kw, tol in ((BL.plan_lotus, {}, 1e-4),
                        (BL.plan_pareto_cascades, {}, 1e-4),
                        (BL.plan_stretto_local, {"cfg": cfg}, 0.05),
                        (BL.plan_stretto_independent, {"cfg": cfg}, 0.1)):
        plans, chosen = {}, {}
        for dev in ("cuda", "cpu"):
            calls.clear()
            plans[dev] = fn(query, ds.items, regs[dev], sample_frac=0.3,
                            device=dev, **kw)
            chosen[dev] = chosen_picks(fn)
        stages = {dev: {(s.logical_idx, s.op_name): s
                        for s in p.stages} for dev, p in plans.items()}
        tied = set()
        for li, (pa, pb) in enumerate(zip(chosen["cuda"], chosen["cpu"])):
            qa = torch.sigmoid(pa.double().cpu())
            qb = torch.sigmoid(pb.double().cpu())
            names = [o.name for o in regs["cpu"](query.semantic_ops[li])]
            for i in range(len(names) - 1):
                if bool(qa[i] > 0.5) != bool(qb[i] > 0.5):
                    assert abs(float(qa[i]) - 0.5) < 5e-3 \
                        and abs(float(qb[i]) - 0.5) < 5e-3, \
                        (fn.__name__, li, names[i], qa, qb)
                    tied.add((li, names[i]))
        assert set(stages["cuda"]) ^ set(stages["cpu"]) <= tied, fn.__name__
        if not tied:
            assert [(s.logical_idx, s.op_name) for s in
                    plans["cuda"].stages] == \
                [(s.logical_idx, s.op_name) for s in plans["cpu"].stages]
        for k in set(stages["cuda"]) & set(stages["cpu"]):
            a, b = stages["cuda"][k], stages["cpu"][k]
            for x, y in ((a.thr_hi, b.thr_hi), (a.thr_lo, b.thr_lo)):
                assert x == y or abs(x - y) < tol, (fn.__name__, k, x, y)


def _planted_card_engine(root, **kw):
    """The planted sm / lg models on the card, profiles at 0.5, gold and
    int8 0.5, over 40 items."""
    from repro_torch.cache.store import CacheStore
    from repro_torch.data import synthetic as syn
    from repro_torch.serving.engine import ServingEngine
    ds = syn.make_dataset("flush-inv", 40, seed=3)
    eng = ServingEngine(CacheStore(str(root)), device="cuda", **kw)
    for size in ("sm", "lg"):
        cfg = syn.planted_config(size)
        eng.register_model(size, cfg, syn.make_planted_params(
            cfg, seed=0, device="cuda"))
        eng.build_profiles(size, ds.items, ratios=(0.5, 0.0),
                           prefill_batch=40, quant_ratios=(0.5,))
    return eng, [it.item_id for it in ds.items]


@pytest.mark.parametrize("model,ratio,quant", [
    ("sm", 0.5, False), ("lg", 0.5, False), ("lg", 0.5, True),
    ("lg", 0.0, False)])
def test_flush_outputs_do_not_depend_on_the_batch_on_the_card(gpu, tmp_path,
                                                              model, ratio,
                                                              quant):
    """The card twin of tests/test_torch_scheduler.py's batch-invariance
    test: an item's log-odds and (value, confidence), bit-equal alone and
    in flushes of 2, 4, ... up to the profile's batch, first and last,
    with the dense layers at the engine's pinned row count."""
    from repro_torch.data import synthetic as syn
    from repro_torch.serving.engine import flush_invariance
    eng, ids = _planted_card_engine(tmp_path)
    assert eng.pin_rows
    got = flush_invariance(
        eng, model, ratio, ids[0], ids[1:],
        filter_args=([syn.filter_query_token(1)], syn.TOK_YES, syn.TOK_NO),
        map_args=([syn.map_query_token(2)],
                  [syn.value_token(v) for v in range(8)]), quant=quant)
    assert all(got.values()), got


def test_graph_capture_beside_live_flushes(gpu, tmp_path):
    """One thread captures and replays the optimizer's CUDA graph while
    another flushes decode batches through an engine on the same card
    (the scheduler's case: one query plans while others flush). Neither
    disturbs the other: the optimizer's result is bit-equal to the same
    loop run alone, every flush's scores to the same flush alone, and
    E's replays are counted as alone (202 per plan's loop)."""
    import threading
    import numpy as np
    from repro_torch.core import optimizer as TO
    from repro_torch.core import relaxation as TR
    from repro_torch.data import synthetic as syn
    eng, ids = _planted_card_engine(tmp_path)
    pipes, g = _planner_world()
    cfg = TO.PlannerConfig(steps=200, restarts=3)
    card_pipes = [p._replace(**{f: v.cuda() for f, v in p._asdict().items()
                                if isinstance(v, torch.Tensor)})
                  for p in pipes]
    prob = TO.setup_problem(card_pipes, g, 0.7, 0.7, cfg,
                            batch_hint=TR.BatchHint(64.0, 4.0))

    def flush(n):
        return eng.run_filter("lg", 0.5, ids[:n], [syn.filter_query_token(1)],
                              syn.TOK_YES, syn.TOK_NO)

    sizes = [1, 7, 16, 40] * 10
    alone_flush = {n: flush(n) for n in set(sizes)}
    alone = TO.adam_loop(prob.loss_fn, prob.flat0, cfg, prob.snap_steps)
    names = ("beta_incinv", "beta_incinv_grad_terms")
    before = [ops.launch_counts()[n] for n in names]
    errors, busy = [], []

    def flusher():
        try:
            for n in sizes:
                busy.append(np.array_equal(flush(n), alone_flush[n]))
        except BaseException as e:
            errors.append(e)

    t = threading.Thread(target=flusher)
    t.start()
    beside = TO.adam_loop(prob.loss_fn, prob.flat0, cfg, prob.snap_steps)
    t.join(timeout=300)
    assert not errors and len(busy) == len(sizes) and all(busy)
    assert [ops.launch_counts()[n] - b for n, b in zip(names, before)] \
        == [2 + 200, 2 + 200]
    assert torch.equal(beside.flat, alone.flat)
    assert torch.equal(beside.losses, alone.losses)


def test_remote_member_on_the_card_matches_the_local_pool(gpu, tmp_path):
    """An in-process worker on the card serves the planted "fast" tier
    over 127.0.0.1; the pool it joins runs one hand-set plan (first
    stages on "fast", gold on the local "accurate" engine) bit-equal to
    the all-local pool on the card: decisions, map values and integer
    StageStats, with wire calls and no fallback."""
    import math
    import numpy as np
    from repro_torch.api import EngineSpec, Session, SessionConfig
    from repro_torch.core.logical import Query, SemFilter, SemMap
    from repro_torch.core.physical import PhysicalPlan, PhysicalPlanStage
    from repro_torch.data import synthetic as syn
    from repro_torch.remote import RemoteWorker, start_server
    fast = dict(models=("sm",), sm_ratios=(0.8, 0.5), lg_ratios=())
    worker = RemoteWorker("fast", cache_dir=str(tmp_path / "w"), **fast)
    server, _, addr = start_server(worker)

    def session(spec, tag):
        return Session(SessionConfig(engines=(spec, EngineSpec(
            "accurate", models=("lg",), sm_ratios=(), lg_ratios=(0.5,),
            include_cheap=False, cache_dir=str(tmp_path / tag))),
            gold_engine="accurate"))

    local = session(EngineSpec("fast", cache_dir=str(tmp_path / "f"),
                               **fast), "al")
    remote = session(EngineSpec("fast", address=addr), "ar")
    stages = [(0, 0, "fast/sm-kv80", 2.5, -3.0, False, False, "fast"),
              (1, 0, "fast/sm-kv50", 1.5, -math.inf, True, False, "fast"),
              (0, 1, "accurate/lg-kv00", 0.0, 0.0, False, True, "accurate"),
              (1, 1, "accurate/lg-kv00", 0.0, 0.0, True, True, "accurate")]
    plan = PhysicalPlan([PhysicalPlanStage(*s[:7], 0.1, engine=s[7])
                         for s in stages], [], 0.0, 1.0, 1.0, True)
    query = Query([SemFilter("f1", 1), SemMap("extract v2", 2)])
    items = syn.make_dataset("remote", 90, seed=7).items
    try:
        assert worker.engine.device.type == "cuda"
        ints = lambda r: [(s.op_name, s.engine, s.n_tuples, s.n_llm_calls,
                           s.n_batches, s.kv_bytes) for s in r.stage_stats]
        for dispatcher in ("inline", "threads:2"):
            lr = local.run(plan, query, items, dispatcher=dispatcher)
            rr = remote.run(plan, query, items, dispatcher=dispatcher)
            assert np.array_equal(rr.accepted, lr.accepted)
            for li in lr.map_values:
                assert np.array_equal(rr.map_values[li], lr.map_values[li])
            assert ints(rr) == ints(lr)
            assert rr.remote["calls"] > 0 and rr.remote["fallbacks"] == 0
    finally:
        local.close()
        remote.close()
        server.shutdown()
        server.server_close()


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "minicpm3-4b"])
def test_mla_latent_scores_launch_the_kernel(gpu, arch):
    """`score_chunk` of a reduced-depth MLA model at full width on the
    card: one launch of C over the latent rows (KV 1, dk r + rope), equal
    to the plain version's scores."""
    import dataclasses
    from repro_torch.cache.compression import calibrate_query_stats, \
        score_chunk
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, prefill
    cfg = dataclasses.replace(get_config(arch), n_layers=2)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 256), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(1))
    _, cache = prefill(params, cfg, tokens=toks)
    stats = calibrate_query_stats(params, cfg, tokens=toks)
    m = cfg.mla
    assert tuple(stats.mu.shape) == (2, 1, cfg.n_heads,
                                     m.kv_lora_rank + m.qk_rope_dim)
    before = EA.expected_attention_scores.launches
    got = score_chunk(cfg, cache, stats, [256, 200])
    assert EA.expected_attention_scores.launches == before + 1
    want = score_chunk(cfg, cache, stats, [256, 200], kernels="ref")
    live = want.isfinite()
    assert torch.equal(got.isfinite(), live)
    _ea_close(got[live], want[live])


def test_sharded_planted_bit_equal_to_inline_on_the_card(gpu, tmp_path):
    """A hand plan over the planted world on the card under sharded:2
    and mesh:2: decisions, map values and integer StageStats bit-equal to
    inline (each run from a cold device LRU)."""
    import math

    import numpy as np
    from repro_torch.core.logical import Query, SemFilter, SemMap
    from repro_torch.core.physical import PhysicalPlan, PhysicalPlanStage
    from repro_torch.data import synthetic as syn
    from repro_torch.runtime.backend import KVCacheBackend
    from repro_torch.runtime.executor import run_plan
    eng, ids = _planted_card_engine(tmp_path)
    items = syn.make_dataset("flush-inv", 40, seed=3).items
    stages = [(0, 0, "sm-kv50", 2.5, -3.0, False, False),
              (1, 0, "sm-kv50", 1.5, -math.inf, True, False),
              (0, 1, "lg-kv50", 3.0, -4.0, False, False),
              (0, 2, "lg-kv00", 0.0, 0.0, False, True),
              (1, 1, "lg-kv00", 0.0, 0.0, True, True)]
    plan = PhysicalPlan([PhysicalPlanStage(*st, cost=0.1) for st in stages],
                        [], 0.0, 1.0, 1.0, True)
    query = Query([SemFilter("t1", 1), SemMap("f2", 2)])
    backend = KVCacheBackend(eng, sm_ratios=(0.5,), lg_ratios=(0.5,),
                             include_cheap=False)
    ints = lambda r: sorted((s.op_name, s.logical_idx, s.stage, s.n_tuples,
                             s.n_llm_calls, s.kv_bytes)
                            for s in r.stage_stats)
    runs = {}
    for spec in ("inline", "sharded:2", "mesh:2"):
        eng.evict()
        runs[spec] = run_plan(plan, query, items, backend, dispatcher=spec)
    base = runs.pop("inline")
    for spec, r in runs.items():
        assert r.dispatcher == spec.split(":")[0]
        assert np.array_equal(r.accepted, base.accepted)
        for li in base.map_values:
            assert np.array_equal(r.map_values[li], base.map_values[li])
        assert ints(r) == ints(base)
        assert not eng._placed_params       # the card's own weights


# ---------------------------------------------------------------------------
# hymba-1.5b at full width, cut in depth: B, C and D at KV 5, G 5, d 64
# ---------------------------------------------------------------------------

def _hymba_cut():
    """hymba-1.5b at its published widths, 2 layers: the global layer 0
    and a windowed one (window 1024), bfloat16, random weights."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = dataclasses.replace(get_config("hymba-1.5b"), n_layers=2,
                              global_layers=(0,))
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    return cfg, params


def _bf16_close(got, want):
    """5 % of the largest magnitude: bfloat16 rounding differences of the
    two attention routes carried through the layers (as the 8B prefill
    test holds them)."""
    scale = float(want.float().abs().max())
    assert bool(torch.isfinite(got.float()).all())
    torch.testing.assert_close(got.float(), want.float(), atol=0.05 * scale,
                               rtol=0)


def test_hymba_prefill_chunk_launches_d_and_c(gpu):
    """One hymba prefill chunk (2 items of 1200 and 1100 tokens, longer
    than the window): D's tensor-core body in both layers, caches, states
    and last logits against the plain route; then C over the chunk, one
    launch, against its plain version."""
    from repro_torch.cache.compression import calibrate_query_stats, \
        score_chunk
    from repro_torch.models import prefill
    cfg, params = _hymba_cut()
    assert cfg.n_heads // cfg.n_kv_heads == 5 and cfg.d_head == 64
    toks = torch.randint(3, cfg.vocab_size, (2, 1200), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(1))
    lengths = torch.tensor([1200, 1100], dtype=torch.int32, device="cuda")
    before = ops.launch_counts()
    got = prefill(params, cfg, toks, lengths=lengths, kernels="cuda")
    after = ops.launch_counts()
    assert after["prefill_attention_by_body"]["tc"] \
        == before["prefill_attention_by_body"]["tc"] + cfg.n_layers
    want = prefill(params, cfg, toks, lengths=lengths, kernels="ref")
    _bf16_close(got[0], want[0])
    for key in ("k", "v", "conv", "ssm"):
        assert got[1][key].dtype == want[1][key].dtype
        _bf16_close(got[1][key], want[1][key])
    stats = calibrate_query_stats(params, cfg, tokens=toks)
    n = EA.expected_attention_scores.launches
    scores = score_chunk(cfg, got[1], stats, [1200, 1100])
    assert EA.expected_attention_scores.launches == n + 1
    plain = score_chunk(cfg, got[1], stats, [1200, 1100], kernels="ref")
    live = plain.isfinite()
    assert torch.equal(scores.isfinite(), live)
    _ea_close(scores[live], plain[live])
    del params
    torch.cuda.empty_cache()


@pytest.mark.parametrize("quant", [False, True])
def test_hymba_decode_flush_launches_b(gpu, quant):
    """One hymba decode step over a prefilled cache (int8: quantised, and
    dequantised to bfloat16 before the mixer): B in both layers, never
    B-int8 or A, each launch against the plain version on its inputs, and
    the logits and states against the plain route."""
    from repro_torch.cache.compression import quantize_kv
    from repro_torch.models import decode_step, prefill
    cfg, params = _hymba_cut()
    toks = torch.randint(3, cfg.vocab_size, (3, 1100), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(2))
    _, cache = prefill(params, cfg, toks[:, :-1], max_len=1152,
                       kernels="cuda")
    if quant:
        q8 = quantize_kv({k: cache[k] for k in ("k", "v")})
        cache.update(q8)
    calls = []
    real = ops.decode_attention

    def rec(*a, **kw):
        out = real(*a, **kw)
        calls.append((a, kw, out))
        return out
    ops.decode_attention = rec
    try:
        before = ops.launch_counts()
        got, gc = decode_step(params, cfg, {k: v.clone()
                                            for k, v in cache.items()},
                              tokens=toks[:, -1:], kernels="cuda", rows=8)
        after = ops.launch_counts()
    finally:
        ops.decode_attention = real
    assert after["decode_attention"] == \
        before["decode_attention"] + cfg.n_layers
    for name in ("decode_attention_int8", "decode_query_attention",
                 "decode_query_attention_int8"):
        assert after[name] == before[name]
    for a, kw, out in calls:
        q, k, v, lengths = a
        assert k.dtype == torch.bfloat16 and q.shape[1:] == (5, 5, 64)
        want = ref.decode_attention_ref(q, k, v, lengths,
                                        window=min(kw["window"], GLOBAL))
        torch.testing.assert_close(out.float(), want.float(),
                                   atol=TOL[torch.bfloat16], rtol=0)
    want, wc = decode_step(params, cfg, {k: v.clone()
                                         for k, v in cache.items()},
                           tokens=toks[:, -1:], kernels="ref", rows=8)
    _bf16_close(got, want)
    for key in ("conv", "ssm"):
        _bf16_close(gc[key], wc[key])
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# training: no kernel cuts the graph
# ---------------------------------------------------------------------------

def test_kernels_under_autograd_raise_and_training_takes_the_blocked_route(
        gpu):
    """A GQA forward on the card with the default kernels, under autograd
    with weights that require grad, raises (the prefill kernel has no
    backward); under no_grad it still launches D. The differentiable
    route (the blocked attention) gives wq / wk / wv non-zero grads within
    1e-4 of the max of the CPU's on the same weights and tokens (float32
    sums in another order), and launches no kernel."""
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params
    from repro_torch.training.train_step import value_and_grad
    from repro_torch.training.tree import tree_map
    cfg = get_config("granite-8b").reduced(dtype="float32")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 96), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(1))
    live = {**params, "layers": {**params["layers"], "attn": {
        k: v.detach().requires_grad_(True)
        for k, v in params["layers"]["attn"].items()}}}
    before = ops.launch_counts()
    with pytest.raises(RuntimeError, match="no backward"):
        forward(live, cfg, tokens=toks)
    with torch.no_grad():
        forward(live, cfg, tokens=toks)
    assert ops.launch_counts()["prefill_attention"] \
        == before["prefill_attention"] + cfg.n_layers
    before = ops.launch_counts()
    loss, grads, missing = value_and_grad(params, {"tokens": toks}, cfg,
                                          remat=False)
    assert ops.launch_counts() == before and missing == []
    cpu = tree_map(lambda t: t.cpu(), params)
    closs, cgrads, _ = value_and_grad(cpu, {"tokens": toks.cpu()}, cfg,
                                      remat=False)
    assert abs(float(loss) - float(closs)) <= 1e-5 * abs(float(closs))
    for name in ("wq", "wk", "wv"):
        g = grads["layers"]["attn"][name].cpu()
        want = cgrads["layers"]["attn"][name]
        assert float(g.abs().max()) > 0
        assert float((g - want).abs().max()) <= \
            1e-4 * float(want.abs().max())
