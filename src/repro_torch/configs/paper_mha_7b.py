"""The paper's §4.1 attention configuration (32 heads x head_dim 128 =
hidden 4096, MHA) embedded in a llama-7B-style dense body — used by the
paper-table benchmarks (Tables 3/4, Figs. 8/9/10) and as the most
"representative of the paper's technique" hillclimb cell.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="paper-mha-7b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,  # MHA, as in the paper's main tables
        head_dim=128,
        d_ff=11008,
        vocab_size=32000,
        source="paper §4.1 attention config; llama-7b body",
    )
)
