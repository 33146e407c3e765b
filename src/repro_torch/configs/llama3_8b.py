"""Llama-3 8B: dense decoder, GQA, 128k vocab.

[arXiv:2407.21783; unverified] — 32L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=128256.

The same values as the JAX package's ``repro.configs.llama3_8b``.
"""
from repro_torch.configs.base import ArchConfig, AttentionConfig

CONFIG = ArchConfig(
    name="llama3-8b",
    family="dense",
    source="arXiv:2407.21783; unverified",
    num_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=128256,
    attn=AttentionConfig(num_heads=32, num_kv_heads=8, head_dim=128,
                         rope_theta=500_000.0),
    block_pattern=("attn",),
    ffn_act="silu",
    gated_ffn=True,
    norm="rmsnorm",
    max_position=131072,
)
