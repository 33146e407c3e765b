"""The paper's own evaluation models (MPipeMoE Table III): MoE layers
sized from GPT-3 S/XL and BERT-L FFNs, 64 experts, top-1 routing, in a
12-layer decoder with an MoE FFN in every other layer. The same values
as the JAX package's ``repro.configs.paper_moe``.
"""
from repro_torch.configs.base import ArchConfig, AttentionConfig, MoEConfig


def _paper(name: str, d_model: int, d_hidden: int) -> ArchConfig:
    return ArchConfig(
        name=name,
        family="moe",
        source="MPipeMoE Table III",
        num_layers=12,
        d_model=d_model,
        d_ff=d_hidden,
        vocab_size=50304,
        attn=AttentionConfig(num_heads=max(8, d_model // 128),
                             num_kv_heads=max(8, d_model // 128)),
        moe=MoEConfig(num_experts=64, top_k=1, d_expert=d_hidden,
                      moe_period=2, moe_offset=1),
        block_pattern=("attn",),
        ffn_act="gelu",
        gated_ffn=False,
        norm="layernorm",
        positional="learned",
        max_position=8192,
    )


MOE_GPT3_S = _paper("moe-gpt3-s", 768, 3072)
MOE_GPT3_XL = _paper("moe-gpt3-xl", 2048, 8192)
MOE_BERT_L = _paper("moe-bert-l", 1024, 4096)
