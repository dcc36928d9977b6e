"""dbrx-132b — fine-grained MoE, 16 experts top-4 [hf:databricks/dbrx-base]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=10752,
    vocab_size=100352,
    attn_kind="gqa",
    moe=MoEConfig(
        n_experts=16,
        n_shared_experts=0,
        top_k=4,
        d_ff_expert=10752,
    ),
)
