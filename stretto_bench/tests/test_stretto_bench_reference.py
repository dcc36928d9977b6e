"""The plain reference against the port, at tiny widths on the CPU.

Both sides get the same float32 inputs from `stretto_bench.inputs`, so
the only differences are the order of float32 sums (blocked against
whole softmaxes, fused against separate products): about 1e-6 relative
over two layers. Every tolerance below is 1e-4 relative, a hundred times
that, while a wrong formula (a missing norm scale, RoPE at the wrong
position, a dropped expert or key) moves the result by 1e-2 or more.
The tests import the port; the reference does not."""
import dataclasses
import json

import pytest
import torch

from stretto_bench import compare, harness, inputs
from stretto_bench.reference.model import Reference
from stretto_bench_tiny import ROOT, shrink_config

RTOL = 1e-4


def tiny(name, **extra):
    model = shrink_config(json.loads(
        (ROOT / "stretto_bench" / "configs" / f"{name}.json").read_text()))
    model.update(extra)
    cfg = dataclasses.replace(harness.port_config(model), dtype="float32")
    return model, cfg


def test_gqa_decode_matches_the_port():
    from repro_torch.models import decode_multi
    model, cfg = tiny("granite-8b-l4")
    lengths = [37, 90, 5, 64]
    S = inputs.round_up(max(lengths) + 3, 16)
    _, params = inputs.weights(model, 7, "cpu", dtype=torch.float32)
    stds = {"k": 2.5, "v": 1.0}
    cache = inputs.cache(model, lengths, S, 7, "cpu", stds, torch.float32)
    tokens = torch.tensor([[3], [250], [17], [0]])
    got = decode_multi(params, cfg, cache, tokens=tokens, kernels="auto",
                       rows=8)[0]
    fresh = inputs.cache(model, lengths, S, 7, "cpu", stds, torch.float32)
    want = Reference(model, params).decode(fresh, lengths, tokens.T)[0]
    assert compare.rel_l2(got, want) < RTOL


def test_mla_moe_decode_matches_the_port():
    """16 tokens over 8 experts, 2 each: capacity max(4, 1.25 * 2 * 16 / 8)
    = 5 against 4 a expert on average, so the capacity rule drops some."""
    from repro_torch.models import decode_step
    model, cfg = tiny("deepseek-v2-lite-16b-l8")
    lengths = [int(n) for n in torch.randint(5, 60, (16,),
                                             generator=torch.Generator()
                                             .manual_seed(0))]
    S = inputs.round_up(max(lengths) + 3, 16)
    _, params = inputs.weights(model, 11, "cpu", dtype=torch.float32)
    stds = {"c_kv": 8.0, "k_rope": 3.0}
    cache = inputs.cache(model, lengths, S, 11, "cpu", stds, torch.float32)
    tokens = torch.arange(16)[:, None] * 13 % 256
    got, _ = decode_step(params, cfg, cache, tokens=tokens, kernels="auto",
                         rows=32)
    fresh = inputs.cache(model, lengths, S, 11, "cpu", stds, torch.float32)
    want = Reference(model, params).decode(fresh, lengths, tokens.T)[0]
    assert compare.rel_l2(got, want) < RTOL


def test_moe_capacity_rule_matches_the_port():
    """The reference's token-order capacity against the port's MoE layer
    at 64 tokens (capacity 20, 16 a expert on average)."""
    from repro_torch.models import layers
    model, cfg = tiny("deepseek-v2-lite-16b-l8")
    _, params = inputs.weights(model, 3, "cpu", dtype=torch.float32)
    h = torch.randn(64, 64, generator=torch.Generator().manual_seed(1))
    p = {"mlp": {k: (v[0] if not isinstance(v, dict) else
                     {kk: vv[0] for kk, vv in v.items()})
                 for k, v in params["layers"]["mlp"].items()}}
    got = layers.moe_mlp(p["mlp"], h[None], cfg, impl="dense")[0]
    want = Reference(model, params).ffn(0, h, 64)
    assert compare.rel_l2(got, want) < RTOL


def test_gqa_prefill_and_keep_scores_match_the_port():
    from repro_torch.cache.compression import QueryStats, score_chunk
    from repro_torch.models import prefill
    model, cfg = tiny("granite-8b-l4")
    _, params = inputs.weights(model, 5, "cpu", dtype=torch.float32)
    mu, sig2 = inputs.query_stats(model, 5, "cpu", 1.28, torch.float32)
    lens = [70, 33]
    toks = torch.zeros(2, 80, dtype=torch.long)
    g = torch.Generator().manual_seed(2)
    docs = [torch.randint(0, 256, (n,), generator=g) for n in lens]
    for b, d in enumerate(docs):
        toks[b, :len(d)] = d
    logits, cache = prefill(params, cfg, tokens=toks, max_len=80,
                            lengths=torch.tensor(lens), kernels="auto")
    scores = score_chunk(cfg, cache, QueryStats(mu, sig2), lens,
                         kernels="auto")
    ref = Reference(model, params)
    for b, d in enumerate(docs):
        n = len(d)
        r_logits, K, V = ref.prefill(d, block=32)
        assert compare.rel_l2(logits[b], r_logits) < RTOL
        assert compare.rel_l2(cache["k"][:, b, :n], K) < RTOL
        assert compare.rel_l2(cache["v"][:, b, :n], V) < RTOL
        assert compare.rel_l2(scores[:, b, :n],
                              ref.keep_scores(K, mu, sig2)) < RTOL


@pytest.mark.parametrize("name", ["granite-8b-l4",
                                  "deepseek-v2-lite-16b-l8"])
def test_the_layout_is_the_ports(name):
    model, cfg = tiny(name)
    harness.check_layout(cfg, model)
    full = json.loads((ROOT / "stretto_bench" / "configs"
                       / f"{name}.json").read_text())
    harness.check_layout(harness.port_config(full), full)
