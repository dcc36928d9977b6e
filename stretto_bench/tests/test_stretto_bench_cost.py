"""The benchmark's frozen arithmetic, pinned to PERF.md's kernel table and
to hand counts at tiny shapes."""
import pytest

from stretto_bench import cost


def test_prefill_attention_bound_at_granite_32k():
    """PERF.md: D at B 1 x S 32768 (KV 8, G 4, d 128, causal, bf16) is
    8.796e12 flops, 8.894 ms by operations."""
    flops, _ = cost.prefill_work(1, 32768, 8, 4, 128, 128, 2, cost.GLOBAL,
                                 True)
    assert flops == pytest.approx(8.796e12, rel=5e-4)
    t, by = cost.bound_s(*reversed(cost.prefill_work(
        1, 32768, 8, 4, 128, 128, 2, cost.GLOBAL, True)))
    assert by == "operations" and t * 1e3 == pytest.approx(8.894, abs=5e-4)


def test_decode_bound_at_granite_32k():
    """PERF.md: B at B 128 x S 32768 is 5.129 ms by bytes."""
    flops, nbytes = cost.decode_work(128, 1, 8, 4, 128, 128, 32768,
                                     [32768] * 128, cost.GLOBAL, 2, 2)
    t, by = cost.bound_s(nbytes, flops)
    assert by == "bytes" and t * 1e3 == pytest.approx(5.129, abs=5e-4)


GQA = {"hidden_size": 4, "num_attention_heads": 2, "num_key_value_heads": 1,
       "head_dim": 2, "intermediate_size": 3, "num_hidden_layers": 1,
       "vocab_size": 8}
MLA = {"hidden_size": 4, "num_attention_heads": 1, "kv_lora_rank": 2,
       "qk_nope_head_dim": 2, "qk_rope_head_dim": 2, "v_head_dim": 2,
       "n_routed_experts": 2, "num_experts_per_tok": 1,
       "moe_intermediate_size": 1, "n_shared_experts": 1,
       "intermediate_size": 7, "num_hidden_layers": 1, "vocab_size": 4}


@pytest.mark.parametrize("model, lengths, want", [
    # projections 48 (wq, wo 16 each; wk, wv 8), norms 8, SwiGLU 36;
    # visible rows 4 + 6 at 8 bytes; head 32 + final norm 4.
    # bytes: (48+8+36)*2 + 10*8 + 36*2 + embed 2*4*2 + logits 2*8*2 = 384
    # flops: 2*2*(48+36) + 10 rows * (2 heads * 2 * 2 * 2) + 2*2*32 = 624
    (GQA, [3, 5], (624, 384)),
    # projections 16 + 16 + 8 + 8 = 48, norms 2*4 + 2; experts: shared 12 +
    # router 8, and 2 * (1 - 1/2) = 1 routed expert of 12 expected;
    # 2 rows of (2 + 2) * 2 bytes; head 16 + norm 4.
    # bytes: (48+10+32)*2 + 16 + 20*2 + 8 + 8 = 252
    # flops: 2*(48+32) + 2 rows * 1 head * 2 * (2*2 + 2) + 2*16 = 216
    (MLA, [1], (216, 252)),
])
def test_decode_step_work_hand_counted(model, lengths, want):
    assert cost.decode_step_work(model, lengths) == pytest.approx(want)


def test_prefill_step_work_hand_counted():
    # 3 tokens: products 2*3*(48+36) = 504, 6 causal pairs * 16 = 96, the
    # head at the last position 2*4*8 = 64, kernel C over 6 K elements
    # (24) and 4 stats elements (16): 704 flops. Bytes: 3 cache rows of 8,
    # C's 12 + 16 + 12, weights (48+8+36)*2 = 184, head (32+4)*2 = 72.
    assert cost.prefill_step_work(GQA, [3]) == pytest.approx((704, 320))


def test_expected_experts():
    assert cost.expected_experts(64, 6, 1) == pytest.approx(6.0)
    assert cost.expected_experts(64, 6, 32) == pytest.approx(
        64 * (1 - (58 / 64) ** 32))
