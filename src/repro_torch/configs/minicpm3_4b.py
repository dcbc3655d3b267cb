"""MiniCPM3-4B: dense transformer with Multi-head Latent Attention (MLA).

[hf:openbmb/MiniCPM3-4B; hf] — 62L, d_model=2560, 40 heads (kv=40),
d_ff=6400, vocab=73448.  MLA compresses Q through a 768-rank bottleneck and
KV through a 256-rank latent; prefill and training attend over the
decompressed per-head K/V (head dim 96, V padded from 64), and the cache
stores the latent (one head of 256 + 32 dims), which decode reads with
W^{kv_b} absorbed into q and the output.
"""

from repro_torch.configs.base import MLAConfig, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="minicpm3-4b",
        family="dense",
        num_layers=62,
        d_model=2560,
        num_heads=40,
        num_kv_heads=40,
        d_ff=6400,
        vocab_size=73448,
        qkv_bias=False,
        mla=MLAConfig(
            q_lora_rank=768,
            kv_lora_rank=256,
            qk_nope_head_dim=64,
            qk_rope_head_dim=32,
            v_head_dim=64,
        ),
        source="hf:openbmb/MiniCPM3-4B (hf)",
    )
)
