"""Qwen2.5-32B: dense GQA transformer with QKV bias.

[hf:Qwen/Qwen2.5-0.5B family scaling; hf] — 64L, d_model=5120, 40 heads
(GQA kv=8, head_dim=128), d_ff=27648, vocab=152064, rope_theta=1e6.  The
Q, K and V projections carry biases (``bq``, ``bk``, ``bv``; zeros at init).
About 32.8e9 parameters: ~65.5 GB in bf16, one H100 holds it whole.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen2.5-32b",
        family="dense",
        num_layers=64,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=27648,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1e6,
        source="hf:Qwen/Qwen2.5-32B (hf)",
    )
)
