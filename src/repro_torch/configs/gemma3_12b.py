"""Gemma-3 12B: dense, 5:1 local:global attention interleave, 128k ctx.

[hf:google/gemma-3-1b-pt; unverified] — 48L d_model=3840 16H (GQA kv=8)
d_ff=15360 vocab=262144. Local layers use a 1024-token sliding window
(ring-buffer KV cache); every 6th layer is global full attention.

The same values as the JAX package's ``repro.configs.gemma3_12b``.
"""
from repro_torch.configs.base import ArchConfig, AttentionConfig

CONFIG = ArchConfig(
    name="gemma3-12b",
    family="dense",
    source="hf:google/gemma-3-1b-pt; unverified",
    num_layers=48,
    d_model=3840,
    d_ff=15360,
    vocab_size=262144,
    attn=AttentionConfig(num_heads=16, num_kv_heads=8, head_dim=256,
                         window=1024, global_period=6, global_offset=5,
                         rope_theta=1_000_000.0, rope_local_theta=10_000.0),
    block_pattern=("attn",),
    ffn_act="gelu",
    gated_ffn=True,
    norm="rmsnorm",
    tie_embeddings=True,
    max_position=131072,
)
