"""Architecture configs of the port: ``get_config("<arch-id>")``."""
from repro_torch.configs import stretto_llama_8b
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, SSMConfig

REGISTRY = {m.CONFIG.name: m.CONFIG for m in (stretto_llama_8b,)}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = ["ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig", "REGISTRY",
           "get_config"]
