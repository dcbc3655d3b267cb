"""Qwen2-MoE-A2.7B (Qwen1.5-MoE-A2.7B): fine-grained MoE, 60 routed top-4 +
4 shared experts.

[hf:Qwen/Qwen1.5-MoE-A2.7B; hf] — 24L, d_model=2048, 16 heads (kv=16),
expert d_ff=1408 (shared expert 4x1408=5632), vocab=151936.  The "ep" mode
names expert parallelism over the sequence ring; on one rank the experts are
not padded and the mode changes nothing.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=1408,
        vocab_size=151936,
        moe=MoEConfig(
            num_experts=60,
            top_k=4,
            d_ff_expert=1408,
            num_shared=4,
            d_ff_shared=5632,
            mode="ep",
        ),
        source="hf:Qwen/Qwen1.5-MoE-A2.7B (hf)",
    )
)
