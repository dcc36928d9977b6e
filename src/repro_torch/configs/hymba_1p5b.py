"""hymba-1.5b — hybrid parallel attention+mamba heads [arXiv:2411.13676]."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_head=64,
    d_ff=5504,
    vocab_size=32001,
    attn_kind="hymba",
    window=1024,                    # sliding-window attention heads
    global_layers=(0, 15, 31),      # full-attention layers (hymba paper)
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
)
