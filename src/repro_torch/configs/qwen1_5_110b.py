"""Qwen1.5-110B: dense decoder with QKV bias.

[hf:Qwen/Qwen1.5-0.5B; hf] — 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064.

The same values as the JAX package's ``repro.configs.qwen1_5_110b``.
"""
from repro_torch.configs.base import ArchConfig, AttentionConfig

CONFIG = ArchConfig(
    name="qwen1.5-110b",
    family="dense",
    source="hf:Qwen/Qwen1.5-0.5B; hf",
    num_layers=80,
    d_model=8192,
    d_ff=49152,
    vocab_size=152064,
    attn=AttentionConfig(num_heads=64, num_kv_heads=8, head_dim=128,
                         qkv_bias=True, rope_theta=1_000_000.0),
    block_pattern=("attn",),
    ffn_act="silu",
    gated_ffn=True,
    norm="rmsnorm",
    max_position=32768,
    optimizer="adafactor",           # as the JAX package's config
)
