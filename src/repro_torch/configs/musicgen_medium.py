"""musicgen-medium — decoder-only over EnCodec tokens [arXiv:2306.05284].

The EnCodec frontend is a stub: input_specs() provides precomputed frame
embeddings; the backbone is a plain MHA decoder (kv == q heads).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_head=64,
    d_ff=6144,
    vocab_size=2048,
    attn_kind="gqa",
    frontend="audio",
)
