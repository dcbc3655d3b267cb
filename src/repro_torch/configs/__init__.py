"""Architecture registry of the port: the dense decoders (gemma-7b among
them: head dim 256, GeGLU, tied embeddings), the attention-free SSD stack,
the hybrid attention + SSD model, the MoE decoders, the VLM (pixtral-12b: a
decoder with a stubbed patch frontend) and the encoder-decoder (whisper-base:
a stubbed audio frontend, a non-causal encoder and cross-attention), and
minicpm3-4b (MLA: a latent KV cache for serving, expanded heads for
training).
``--arch <id>`` resolves here."""

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, SSMConfig, get_config, register

ARCHS = [
    "granite-8b", "paper-mha-7b", "qwen2.5-32b", "mamba2-370m", "hymba-1.5b", "qwen2-moe-a2.7b",
    "mixtral-8x7b", "gemma-7b", "pixtral-12b", "whisper-base", "minicpm3-4b",
]
