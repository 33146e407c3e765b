"""DeepSeek-V2-Lite (16B): MLA attention + fine-grained MoE with shared
experts. The same values as the JAX package's
``repro.configs.deepseek_v2_lite_16b``.

[arXiv:2405.04434; hf] — 27L d_model=2048 16H (kv=16 via MLA) d_ff=1408
vocab=102400, MoE 64e top-6 with 2 shared experts, MLA kv_lora_rank=512.
"""
from repro_torch.configs.base import (ArchConfig, AttentionConfig,
                                      MLAConfig, MoEConfig)

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    source="arXiv:2405.04434; hf",
    num_layers=27,
    d_model=2048,
    d_ff=0,                          # all FFNs are MoE (+shared experts)
    vocab_size=102400,
    attn=AttentionConfig(
        num_heads=16, num_kv_heads=16,
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0,
                      rope_head_dim=64, nope_head_dim=128, v_head_dim=128),
        rope_theta=10_000.0),
    moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408,
                  num_shared_experts=2, d_shared=1408, moe_period=1),
    block_pattern=("attn",),
    ffn_act="silu",
    gated_ffn=True,
    norm="rmsnorm",
    max_position=163840,
)
