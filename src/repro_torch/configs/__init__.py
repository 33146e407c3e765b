"""Config registry of the port: ``get_config("<arch-id>")``.

The port serves the paper's three MoE models, DeepSeek-V2-Lite (MLA
attention, shared experts) and four dense GQA decoders with rotary
positions: Llama-3 8B, H2O-Danube 1.8B (sliding window), Gemma-3 12B
(local and global layers, tied embeddings) and Qwen1.5-110B (QKV bias).
The JAX package's other five architectures (jamba, whisper, xlstm,
arctic, qwen2-vl) come with ROADMAP.md's "Other architectures" slice.
"""
from repro_torch.configs.base import (ArchConfig, AttentionConfig,
                                      EncoderConfig, MambaConfig, MLAConfig,
                                      MoEConfig, XLSTMConfig)
from repro_torch.configs.deepseek_v2_lite_16b import \
    CONFIG as DEEPSEEK_V2_LITE_16B
from repro_torch.configs.gemma3_12b import CONFIG as GEMMA3_12B
from repro_torch.configs.h2o_danube_1_8b import CONFIG as H2O_DANUBE_1_8B
from repro_torch.configs.llama3_8b import CONFIG as LLAMA3_8B
from repro_torch.configs.paper_moe import MOE_BERT_L, MOE_GPT3_S, MOE_GPT3_XL
from repro_torch.configs.qwen1_5_110b import CONFIG as QWEN1_5_110B

ARCHS = {c.name: c for c in [MOE_GPT3_S, MOE_GPT3_XL, MOE_BERT_L,
                             DEEPSEEK_V2_LITE_16B, LLAMA3_8B,
                             H2O_DANUBE_1_8B, GEMMA3_12B, QWEN1_5_110B]}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(
            f"unknown arch {name!r} for the PyTorch port; available: "
            f"{sorted(ARCHS)} (jamba, whisper, xlstm, arctic and qwen2-vl "
            f"come with ROADMAP.md's 'Other architectures' slice)")
    return ARCHS[name]


def list_archs():
    return sorted(ARCHS)


__all__ = [
    "ARCHS", "ArchConfig", "AttentionConfig", "EncoderConfig",
    "MambaConfig", "MLAConfig", "MoEConfig", "XLSTMConfig", "get_config",
    "list_archs",
]
