"""Gemma-7B: dense transformer with GeGLU and head_dim=256.

[arXiv:2403.08295; hf] — 28L, d_model=3072, 16 heads (kv=16, head_dim=256),
d_ff=24576, vocab=256000, tied embeddings.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="gemma-7b",
        family="dense",
        num_layers=28,
        d_model=3072,
        num_heads=16,
        num_kv_heads=16,
        head_dim=256,
        d_ff=24576,
        vocab_size=256000,
        mlp_act="gelu",
        tie_embeddings=True,
        source="arXiv:2403.08295 (hf)",
    )
)
