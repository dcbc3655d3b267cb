"""Mixtral-8x7B: sparse MoE (8 experts, top-2) with sliding-window attention.

[arXiv:2401.04088; hf] — 32L, d_model=4096, 32 heads (GQA kv=8),
expert d_ff=14336, vocab=32000, SWA window 4096.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(
    ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=32000,
        window=4096,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=14336, mode="tp"),
        source="arXiv:2401.04088 (hf)",
    )
)
