"""Whisper-base: encoder-decoder audio transformer, conv frontend stubbed.

[arXiv:2212.04356; unverified] — 6 encoder + 6 decoder layers, d_model=512,
8 heads (MHA), d_ff=2048, vocab=51865.  LayerNorm + plain GELU MLP.  The conv
frontend is a STUB: ``input_specs()`` provides 80-d mel-frame features; a
learned projection stands in for the two conv layers (1500 frames / 30 s).
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="whisper-base",
        family="audio",
        num_layers=6,  # decoder layers
        encoder_layers=6,
        encoder_seq=1536,  # whisper's 1500 frames padded to a multiple of the
        # 16-wide model axis so the encoder sequence shards evenly
        d_model=512,
        num_heads=8,
        num_kv_heads=8,
        d_ff=2048,
        vocab_size=51865,
        mlp_act="gelu",
        mlp_gated=False,
        norm="layernorm",
        frontend="audio_stub",
        frontend_dim=80,
        tie_embeddings=True,
        source="arXiv:2212.04356 (unverified)",
    )
)
