"""Mamba2-370m: attention-free SSD (state-space duality) stack.

[arXiv:2405.21060; unverified] — 48L, d_model=1024, vocab=50280,
ssm_state=128.  d_inner = 2*d_model = 2048 -> 32 SSD heads of P=64.
Every layer is an SSD block: prefill runs the chunked scan (kernel
``csrc/ssd_scan.cu``), decode the O(1) state recurrence.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(
    ModelConfig(
        name="mamba2-370m",
        family="ssm",
        num_layers=48,
        d_model=1024,
        num_heads=32,  # SSD heads (d_inner / head_dim)
        num_kv_heads=32,
        d_ff=0,  # attention-free, MLP-free (SSD blocks only)
        vocab_size=50280,
        ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4),
        tie_embeddings=True,
        source="arXiv:2405.21060 (unverified)",
    )
)
