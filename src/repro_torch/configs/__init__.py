"""Config registry of the port: ``get_config("<arch-id>")``.

The port serves the paper's three MoE models and DeepSeek-V2-Lite (MLA
attention, shared experts). The JAX package's other nine architectures
come with ROADMAP.md's "Other architectures" slice.
"""
from repro_torch.configs.base import (ArchConfig, AttentionConfig,
                                      EncoderConfig, MambaConfig, MLAConfig,
                                      MoEConfig, XLSTMConfig)
from repro_torch.configs.deepseek_v2_lite_16b import \
    CONFIG as DEEPSEEK_V2_LITE_16B
from repro_torch.configs.paper_moe import MOE_BERT_L, MOE_GPT3_S, MOE_GPT3_XL

ARCHS = {c.name: c for c in [MOE_GPT3_S, MOE_GPT3_XL, MOE_BERT_L,
                             DEEPSEEK_V2_LITE_16B]}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(
            f"unknown arch {name!r} for the PyTorch port; available: "
            f"{sorted(ARCHS)} (other architectures: ROADMAP.md, "
            f"'Other architectures' slice)")
    return ARCHS[name]


def list_archs():
    return sorted(ARCHS)


__all__ = [
    "ARCHS", "ArchConfig", "AttentionConfig", "EncoderConfig",
    "MambaConfig", "MLAConfig", "MoEConfig", "XLSTMConfig", "get_config",
    "list_archs",
]
