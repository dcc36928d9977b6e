"""Paper's own operator model — Llama-3.1-8B [arXiv:2407.21783].

Stretto's KV-cache-enabled operators in the paper are built on Llama-3.1
8B/70B; this is the 8B config, the port's full-width model.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stretto-llama-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=128256,
    attn_kind="gqa",
    rope_theta=500_000.0,
)
