"""Architecture registry of the port: the two dense decoders this slice
serves.  ``--arch <id>`` resolves here."""

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, SSMConfig, get_config, register

ARCHS = ["granite-8b", "paper-mha-7b"]
