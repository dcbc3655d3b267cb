"""Model configuration: the port's own copy of ``repro/configs/base.py``.

One ``ModelConfig`` describes an architecture; ``reduced()`` gives the
family-preserving small config the CPU tests use.  The sub-configs (MoE, SSM,
MLA) are kept so a config reads the same in both packages; the port serves
every family (MLA in the dense one).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

__all__ = [
    "MoEConfig",
    "SSMConfig",
    "MLAConfig",
    "ModelConfig",
    "register",
    "get_config",
    "list_archs",
]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0  # qwen2-moe: shared experts (merged into one MLP)
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    router_norm_topk: bool = True  # renormalize top-k weights to sum to 1
    mode: str = "tp"  # "tp": d_ff sharded over model | "ep": expert-parallel a2a


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int  # N
    head_dim: int = 64  # P
    expand: int = 2  # d_inner = expand * d_model
    conv_width: int = 4
    n_groups: int = 1
    dt_min: float = 0.001
    dt_max: float = 0.1
    chunk: int = 64  # SSD chunk length


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads (gemma: 256)
    mlp_act: str = "silu"  # silu -> SwiGLU, gelu -> GeGLU (gated in both cases)
    mlp_gated: bool = True  # whisper uses a plain (ungated) GELU MLP
    qkv_bias: bool = False  # qwen2.5 / minicpm3 style
    window: Optional[int] = None  # sliding-window attention (mixtral, hymba)
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"  # rmsnorm | layernorm (whisper)
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    mla: Optional[MLAConfig] = None
    hybrid: bool = False  # hymba: parallel attn + ssm heads in each layer
    # encoder-decoder (whisper): encoder_layers > 0 enables cross-attention
    encoder_layers: int = 0
    encoder_seq: int = 1500  # whisper: 30 s of audio frames after conv stub
    frontend: Optional[str] = None  # "audio_stub" | "vision_stub"
    frontend_dim: int = 0  # raw feature dim entering the stub projection
    num_patches: int = 0  # vlm: image patch embeddings per sample
    source: str = ""  # provenance note

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid / sliding-window)."""
        return self.family in ("ssm", "hybrid") or self.window is not None

    @property
    def causal_layout(self) -> str:
        """Striped layout balances the causal mask (paper §3.7) but breaks the
        SSM recurrence's contiguity, so SSM/hybrid archs shard contiguously."""
        return "contiguous" if (self.ssm is not None) else "striped"

    def reduced(self) -> "ModelConfig":
        """Family-preserving small config for CPU smoke tests."""
        changes = dict(
            num_layers=min(self.num_layers, 2),
            d_model=128,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=32 if self.head_dim else None,
            d_ff=256,
            vocab_size=512,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=32 if self.encoder_layers else self.encoder_seq,
            num_patches=8 if self.num_patches else 0,
            frontend_dim=16 if self.frontend_dim else 0,
            window=16 if self.window else None,
        )
        if self.moe:
            changes["moe"] = dataclasses.replace(
                self.moe,
                num_experts=4,
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=64,
                d_ff_shared=128 if self.moe.d_ff_shared else 0,
            )
        if self.ssm:
            changes["ssm"] = dataclasses.replace(
                self.ssm, state_dim=16, head_dim=16, chunk=8
            )
        if self.mla:
            changes["mla"] = MLAConfig(
                q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                qk_rope_head_dim=16, v_head_dim=32,
            )
        return dataclasses.replace(self, **changes)



_REGISTRY = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    from repro_torch.configs import ARCHS

    if name not in ARCHS:
        raise ValueError(f"unknown arch {name!r}; this port serves {list(ARCHS)}")
    if name not in _REGISTRY:
        importlib.import_module(f"repro_torch.configs.{name.replace('-', '_').replace('.', '_')}")
    return _REGISTRY[name]


def list_archs():
    from repro_torch.configs import ARCHS

    return list(ARCHS)
