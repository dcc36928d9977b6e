"""Architecture configs of the port: ``get_config("<arch-id>")``.

Copies of the JAX package's eleven configs (`repro.configs`) and its four
shape cells (`SHAPES`)."""
from repro_torch.configs import (dbrx_132b, deepseek_v2_lite_16b, gemma3_27b,
                                 granite_8b, hymba_1p5b, llava_next_34b,
                                 minicpm3_4b, minitron_8b, musicgen_medium,
                                 rwkv6_1p6b, stretto_llama_8b)
from repro_torch.configs.base import (ALL_SHAPES, SHAPES, MLAConfig,
                                      ModelConfig, MoEConfig, ShapeConfig,
                                      SSMConfig, applicable_shapes,
                                      supports_long_context)

REGISTRY = {
    m.CONFIG.name: m.CONFIG
    for m in (
        granite_8b, minicpm3_4b, gemma3_27b, minitron_8b, llava_next_34b,
        hymba_1p5b, musicgen_medium, deepseek_v2_lite_16b, dbrx_132b,
        rwkv6_1p6b, stretto_llama_8b,
    )
}

ASSIGNED = tuple(n for n in REGISTRY if n != "stretto-llama-8b")


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = ["ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig", "REGISTRY",
           "ASSIGNED", "get_config", "ShapeConfig", "SHAPES", "ALL_SHAPES",
           "applicable_shapes", "supports_long_context"]
