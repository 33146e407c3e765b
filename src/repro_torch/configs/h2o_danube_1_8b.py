"""H2O-Danube 1.8B: llama+mistral mix with sliding-window attention.

[arXiv:2401.16818; hf] — 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000, SWA window 4096.

The same values as the JAX package's ``repro.configs.h2o_danube_1_8b``.
"""
from repro_torch.configs.base import ArchConfig, AttentionConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    source="arXiv:2401.16818; hf",
    num_layers=24,
    d_model=2560,
    d_ff=6912,
    vocab_size=32000,
    attn=AttentionConfig(num_heads=32, num_kv_heads=8, head_dim=80,
                         window=4096, rope_theta=10_000.0),
    block_pattern=("attn",),
    ffn_act="silu",
    gated_ffn=True,
    norm="rmsnorm",
    max_position=524288,             # window cache => long ctx OK
)
