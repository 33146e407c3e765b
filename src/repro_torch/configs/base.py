"""Architecture configuration schema (the port's own copy).

Field for field the same dataclasses as the JAX package's
``repro.configs.base``, so a configuration compares equal across the two
packages under ``dataclasses.asdict``. ``reduced()`` gives the same tiny
same-family configuration for CPU tests. Only ``param_count`` differs:
it counts the port's own parameter specs.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple
# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings for layers that carry an MoE FFN."""
    num_experts: int
    top_k: int
    d_expert: int                   # hidden dim of each expert FFN
    num_shared_experts: int = 0     # DeepSeek-style always-on experts
    d_shared: int = 0               # hidden dim of the shared expert(s)
    dense_residual: bool = False    # Arctic-style parallel dense FFN
    capacity_factor: float = 1.25
    moe_period: int = 1             # every `moe_period`-th layer is MoE
    moe_offset: int = 0             # which index within the period
    gate_bias: bool = False
    aux_loss_weight: float = 1e-2
    z_loss_weight: float = 1e-3
    # --- MPipeMoE knobs (the paper's technique) -----------------------
    pipeline: bool = True           # micro-batch pipelining on/off
    num_partitions: int = 0         # 0 = adaptive (Algorithm 1)
    memory_reuse_strategy: str = "adaptive"  # none|s1|s2|s3|s4|adaptive
    pipeline_unroll: bool = True    # unrolled chunks (overlap) vs lax.scan


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2)."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0            # 0 = no q compression
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                # 0 => ceil(d_model / 16)


@dataclass(frozen=True)
class XLSTMConfig:
    slstm_period: int = 8           # 1 sLSTM every `period` blocks
    slstm_offset: int = 0
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 4.0 / 3.0
    conv1d_kernel: int = 4


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder tower for enc-dec models (whisper)."""
    num_layers: int = 24
    context_len: int = 1500         # whisper: 30s audio -> 1500 frames
    d_model: int = 1024
    num_heads: int = 16
    d_ff: int = 4096


@dataclass(frozen=True)
class AttentionConfig:
    num_heads: int = 16
    num_kv_heads: int = 16
    head_dim: int = 0               # 0 => d_model // num_heads
    qkv_bias: bool = False
    window: int = 0                 # 0 = full; >0 = sliding-window size
    # local:global interleave (gemma3 "5:1"): period 6, global at offset 5
    global_period: int = 1          # 1 = every layer uses `window` as-is
    global_offset: int = 0
    rope_theta: float = 10_000.0
    rope_local_theta: float = 0.0   # gemma3 uses different theta locally
    mrope: bool = False             # qwen2-vl multimodal rotary
    mla: Optional[MLAConfig] = None
    logit_softcap: float = 0.0


# ---------------------------------------------------------------------------
# Main config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | audio | vlm
    kind: str = "decoder"           # decoder | encdec
    source: str = ""                # citation tag from the assignment

    num_layers: int = 12
    d_model: int = 768
    d_ff: int = 3072                # dense FFN hidden (0 = no FFN)
    vocab_size: int = 32000

    attn: AttentionConfig = field(default_factory=AttentionConfig)
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    encoder: Optional[EncoderConfig] = None

    # Layer mixer pattern, repeated every `len(block_pattern)` layers.
    # entries: "attn" | "mamba" | "mlstm" | "slstm"
    block_pattern: Tuple[str, ...] = ("attn",)

    ffn_act: str = "silu"           # silu | gelu | relu
    gated_ffn: bool = True          # SwiGLU-style (2 up-proj) vs plain MLP
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    tie_embeddings: bool = False
    positional: str = "rope"        # rope | learned | sincos | none
    max_position: int = 131072
    frontend: str = "none"          # none | audio_stub | vision_stub

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat_policy: str = "nothing"   # layer-level remat: nothing|full|dots

    # large-model memory knobs (see DESIGN §8)
    optimizer: str = "adamw"        # adamw | adafactor | adamw8bit

    # ---------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.attn.head_dim or self.d_model // self.attn.num_heads

    @property
    def period(self) -> int:
        """Length of the repeating layer pattern (for scan-over-layers).

        Must account for block_pattern and the MoE period simultaneously.
        """
        p = len(self.block_pattern)
        if self.moe is not None:
            p = _lcm(p, self.moe.moe_period)
        if self.xlstm is not None:
            p = _lcm(p, self.xlstm.slstm_period)
        if self.attn.global_period > 1:
            p = _lcm(p, self.attn.global_period)
        return p

    @property
    def num_periods(self) -> int:
        assert self.num_layers % self.period == 0, (
            f"{self.name}: num_layers={self.num_layers} not divisible by "
            f"layer period {self.period}")
        return self.num_layers // self.period

    def layer_roles(self) -> Tuple[dict, ...]:
        """Per-layer-in-period role descriptors (mixer kind, moe?, global?)."""
        roles = []
        for i in range(self.period):
            mixer = self.block_pattern[i % len(self.block_pattern)]
            if self.xlstm is not None:
                mixer = ("slstm" if i % self.xlstm.slstm_period ==
                         self.xlstm.slstm_offset else "mlstm")
            is_moe = (self.moe is not None
                      and i % self.moe.moe_period == self.moe.moe_offset)
            is_global = (self.attn.global_period <= 1
                         or i % self.attn.global_period
                         == self.attn.global_offset)
            roles.append(dict(mixer=mixer, moe=is_moe, global_attn=is_global))
        return tuple(roles)

    # ---------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        attn = replace(
            self.attn,
            num_heads=max(2, min(self.attn.num_heads, 4)),
            num_kv_heads=max(1, min(self.attn.num_kv_heads, 2)),
            head_dim=16,
            window=min(self.attn.window, 32) if self.attn.window else 0,
            mla=replace(self.attn.mla, kv_lora_rank=16, rope_head_dim=8,
                        nope_head_dim=16, v_head_dim=16, q_lora_rank=0)
            if self.attn.mla else None,
        )
        moe = None
        if self.moe is not None:
            moe = replace(
                self.moe,
                num_experts=4,
                top_k=min(self.moe.top_k, 2),
                d_expert=32,
                d_shared=32 if self.moe.num_shared_experts else 0,
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                num_partitions=2,
            )
        enc = (replace(self.encoder, num_layers=2, context_len=16,
                       d_model=64, num_heads=4, d_ff=128)
               if self.encoder else None)
        return replace(
            self,
            name=self.name + "-reduced",
            num_layers=2 * self.period,
            d_model=64,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            attn=attn,
            moe=moe,
            encoder=enc,
            mamba=replace(self.mamba, d_state=8, d_conv=4, expand=2)
            if self.mamba else None,
            max_position=4096,
            param_dtype="float32",
            compute_dtype="float32",
        )

    # ---------------------------------------------------------------
    def param_count(self) -> int:
        """Exact parameter count (from the model's spec tree)."""
        from repro_torch.models import lm  # lazy; avoids cycles
        return lm.count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models import lm
        return lm.count_params(self, active_only=True)


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)
