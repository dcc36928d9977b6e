"""deepseek-v2-lite-16b — MLA kv_lora=512 + MoE 64e top-6 (+2 shared)."""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1408,              # per-expert width (assigned)
    vocab_size=102400,
    attn_kind="mla",
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=0,      # v2-lite projects q directly
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        n_experts=64,
        n_shared_experts=2,
        top_k=6,
        d_ff_expert=1408,
    ),
)
