"""Granite-8B (code): llama-architecture dense transformer.

[arXiv:2405.04324; hf] — 36L, d_model=4096, 32 heads (GQA kv=8),
d_ff=14336, vocab=49152.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="granite-8b",
        family="dense",
        num_layers=36,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=49152,
        source="arXiv:2405.04324 (hf)",
    )
)
