"""rwkv6-1.6b (Finch) — attn-free data-dependent-decay linear recurrence."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=0,              # attention-free
    n_kv_heads=0,
    d_head=0,
    d_ff=7168,              # channel-mix width
    vocab_size=65536,
    attn_kind="rwkv6",
    rwkv_head_size=64,      # 32 wkv heads
)
