"""Model configuration dataclasses for the PyTorch port.

A copy of `repro.configs.base.ModelConfig` and its sub-configs: the port
keeps its own so it never imports the JAX package. The shape cells
(`ShapeConfig`, the four production shapes) are copied for the launch
specs (`launch/specs.py`); which arch runs which shape stays behind with
the dry-run tooling.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0            # routed experts
    n_shared_experts: int = 0     # always-on experts (DeepSeek-style)
    top_k: int = 0
    d_ff_expert: int = 0          # per-expert FFN width
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 0
    q_lora_rank: int = 0          # 0 = direct q projection
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2               # mamba inner expansion


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                  # query heads (0 for attn-free archs)
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int

    # token-mixer kind: gqa | mla | hymba | rwkv6
    attn_kind: str = "gqa"

    # sliding-window / local:global structure.
    # window == 0  -> full causal attention everywhere.
    # window  > 0  -> local layers attend within `window`; layers whose index
    #                 is in `global_every`-step positions are global.
    window: int = 0
    global_every: int = 0
    global_layers: Tuple[int, ...] = ()

    mla: MLAConfig = field(default_factory=MLAConfig)
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)

    frontend: str = "none"        # none | vision | audio (stub embeddings)
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    rwkv_head_size: int = 64

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU tests."""
        small = dict(
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_head=16,
            d_ff=128,
            vocab_size=256,
        )
        if self.attn_kind == "mla":
            small["mla"] = MLAConfig(
                kv_lora_rank=16, q_lora_rank=0, qk_nope_dim=16,
                qk_rope_dim=8, v_head_dim=16)
        if self.moe.n_experts:
            small["moe"] = MoEConfig(
                n_experts=4, n_shared_experts=min(self.moe.n_shared_experts, 1),
                top_k=2, d_ff_expert=32, capacity_factor=2.0)
        if self.attn_kind == "hymba":
            small["ssm"] = SSMConfig(d_state=4, d_conv=4, expand=2)
            small["global_layers"] = (0,)
        if self.window:
            small["window"] = 8
        if self.global_every:
            small["global_every"] = 2
        if self.attn_kind == "rwkv6":
            small["rwkv_head_size"] = 16
            small["n_heads"] = 0
            small["n_kv_heads"] = 0
        small.update(overrides)
        return dataclasses.replace(self, name=self.name + "-reduced", **small)

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a multiple of 256 (same table shapes as the JAX
        package, so one weight dict loads in both)."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def is_mla(self) -> bool:
        return self.attn_kind == "mla"

    @property
    def is_moe(self) -> bool:
        return self.moe.n_experts > 0

    @property
    def embed_scale(self) -> Optional[float]:
        """The factor the token (or frontend) embeddings are scaled by in
        the model dtype: sqrt(d_model) for gemma3, as the JAX package's
        forward does; None elsewhere."""
        return math.sqrt(self.d_model) if self.name.startswith("gemma3") \
            else None

    @property
    def n_params(self) -> int:
        """Analytic parameter count (embedding + layers + head)."""
        d, L = self.d_model, self.n_layers
        n = self.vocab_size * d                      # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d                 # lm head
        per_layer = 2 * d                            # two RMSNorm scales
        if self.attn_kind == "gqa" or self.attn_kind == "hymba":
            q = d * self.n_heads * self.d_head
            kv = 2 * d * self.n_kv_heads * self.d_head
            o = self.n_heads * self.d_head * d
            per_layer += q + kv + o
            if self.attn_kind == "hymba":
                di = self.ssm.expand * d
                per_layer += d * 2 * di + di * self.ssm.d_conv \
                    + di * (2 * self.ssm.d_state + 2) + di * d
        elif self.attn_kind == "mla":
            m = self.mla
            qdim = self.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
            per_layer += (d * m.q_lora_rank + m.q_lora_rank * qdim) if m.q_lora_rank else d * qdim
            per_layer += d * (m.kv_lora_rank + m.qk_rope_dim)
            per_layer += m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_head_dim)
            per_layer += self.n_heads * m.v_head_dim * d
        elif self.attn_kind == "rwkv6":
            per_layer += 6 * d * d + 2 * d * self.d_ff_channel_mix
        if self.is_moe:
            e = self.moe
            per_layer += d * e.n_experts                                  # router
            per_layer += 3 * d * e.d_ff_expert * (e.n_experts + e.n_shared_experts)
        elif self.attn_kind != "rwkv6":
            per_layer += 3 * d * self.d_ff                                # swiglu
        return n + L * per_layer

    @property
    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only top_k + shared experts)."""
        if not self.is_moe:
            return self.n_params
        e = self.moe
        inactive = (e.n_experts - e.top_k) * 3 * self.d_model * e.d_ff_expert
        return self.n_params - self.n_layers * inactive

    @property
    def d_ff_channel_mix(self) -> int:
        return self.d_ff

    @property
    def rwkv_n_heads(self) -> int:
        return self.d_model // self.rwkv_head_size


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}


def supports_long_context(cfg: ModelConfig) -> bool:
    """long_500k is only runnable for sub-quadratic archs (SSM/hybrid/local)."""
    if cfg.attn_kind in ("rwkv6", "hymba"):
        return True
    if cfg.global_every or cfg.window:   # local:global (gemma3)
        return True
    return False


def applicable_shapes(cfg: ModelConfig):
    out = []
    for s in ALL_SHAPES:
        if s.name == "long_500k" and not supports_long_context(cfg):
            continue
        out.append(s)
    return tuple(out)
