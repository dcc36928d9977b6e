"""gemma3-27b — dense 5:1 local:global GQA, 128k ctx [hf:google/gemma-3]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    d_head=128,
    d_ff=21504,
    vocab_size=262144,
    attn_kind="gqa",
    window=1024,            # local layers: 1k sliding window
    global_every=6,         # every 6th layer is global  -> 5:1 local:global
    rope_theta=1_000_000.0,
)
