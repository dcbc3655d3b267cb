"""Pixtral-12B: Pixtral-ViT frontend (stub) + Mistral-Nemo decoder backbone.

[hf:mistralai/Pixtral-12B-2409; unverified] — 40L, d_model=5120, 32 heads
(GQA kv=8, head_dim=128), d_ff=14336, vocab=131072.  The vision frontend is
a STUB per the assignment: ``input_specs()`` supplies precomputed 1024-d
patch embeddings which a learned projection maps into the token stream.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="pixtral-12b",
        family="vlm",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=131072,
        mlp_act="silu",
        rope_theta=1e6,
        frontend="vision_stub",
        frontend_dim=1024,
        num_patches=1024,
        source="hf:mistralai/Pixtral-12B-2409 (unverified)",
    )
)
