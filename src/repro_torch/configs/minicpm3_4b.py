"""minicpm3-4b — dense MLA model [hf:openbmb/MiniCPM3-4B]."""
from repro_torch.configs.base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,          # MLA: per-head K/V reconstructed from shared latent
    d_head=64,
    d_ff=6400,
    vocab_size=73448,
    attn_kind="mla",
    mla=MLAConfig(
        kv_lora_rank=256,
        q_lora_rank=768,
        qk_nope_dim=64,
        qk_rope_dim=32,
        v_head_dim=64,
    ),
)
