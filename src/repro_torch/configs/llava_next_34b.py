"""llava-next-34b — VLM backbone (anyres tiling frontend is a stub)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_head=128,
    d_ff=20480,
    vocab_size=64000,
    attn_kind="gqa",
    frontend="vision",      # input_specs() hands precomputed patch embeddings
)
