"""Hymba-1.5B: hybrid-head transformer — parallel attention + Mamba heads
inside every layer.

[arXiv:2411.13676; hf] — 32L, d_model=1600, 25 heads (GQA kv=5, head_dim=64),
d_ff=5504, vocab=32001, ssm_state=16.  Attention heads use sliding-window
(per the paper, most layers are SWA); SSM heads run the SSD scan in parallel
and the two outputs are mean-fused.  Meta-tokens are omitted.  Contiguous
(non-striped) sequence layout because of the SSM recurrence.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(
    ModelConfig(
        name="hymba-1.5b",
        family="hybrid",
        num_layers=32,
        d_model=1600,
        num_heads=25,
        num_kv_heads=5,
        head_dim=64,
        d_ff=5504,
        vocab_size=32001,
        window=1024,
        hybrid=True,
        ssm=SSMConfig(state_dim=16, head_dim=64, expand=2, conv_width=4),
        source="arXiv:2411.13676 (hf)",
    )
)
