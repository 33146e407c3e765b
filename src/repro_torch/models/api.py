"""Model API dispatch and the one place that decides whether (and how) a
config can be served, as ``repro.models.api``.

The port has the decoder-only ``lm`` only; ``get_model`` raises for an
encoder-decoder config, which comes with ROADMAP.md's 'Other
architectures' slice (whisper).
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.configs.base import ArchConfig


def get_model(cfg: ArchConfig):
    if cfg.kind == "encdec":
        raise NotImplementedError(
            "encoder-decoder models (whisper) come with ROADMAP.md's "
            "'Other architectures' slice")
    from repro_torch.models import lm
    return lm


def serving_support(cfg: ArchConfig) -> Tuple[Optional[str], str]:
    """Capability query for the serving engine: which state-cache kind
    ``cfg`` needs, or why it cannot be served at all; the JAX package's
    function, with its reason strings.

    Returns ``(cache_kind, reason)``:

    * ``("paged", "")``: every mixer is attention (paged KV pools, or
      MLA's latent pools);
    * ``("constant", "")``: no attention mixer at all (pure SSM or
      xLSTM), O(1) recurrent state a slot;
    * ``("composite", "")``: mixed mixers (jamba);
    * ``(None, reason)``: not servable: encoder-decoder models, non-token
      frontends, M-RoPE positions, unknown mixers or positional schemes.

    The port's engine serves ``"paged"`` only: ``check_servable`` refuses
    the other kinds."""
    if cfg.kind != "decoder":
        return None, "serving requires a decoder-only model"
    if cfg.frontend != "none":
        return None, f"frontend {cfg.frontend!r} not supported by engine"
    if cfg.attn.mrope:
        return None, "m-rope positions not supported by engine"
    if cfg.positional not in ("rope", "learned", "none"):
        return None, f"positional {cfg.positional!r} not supported"
    mixers = {r["mixer"] for r in cfg.layer_roles()}
    unknown = mixers - {"attn", "mamba", "mlstm", "slstm"}
    if unknown:
        return None, f"unknown mixers: {sorted(unknown)}"
    if mixers == {"attn"}:
        return "paged", ""
    if "attn" not in mixers:
        return "constant", ""
    return "composite", ""


def check_servable(cfg: ArchConfig) -> str:
    """The kind the port's engine serves ``cfg`` with: ``"paged"``, or
    ``NotImplementedError``: with ``serving_support``'s reason where the
    JAX engine refuses too, naming ROADMAP.md's item where the JAX engine
    serves a recurrent state cache the port does not have yet. The
    engine and the serve launcher both call it first."""
    kind, why = serving_support(cfg)
    if kind is None:
        raise NotImplementedError(f"{cfg.name}: {why}")
    if kind != "paged":
        raise NotImplementedError(
            f"{cfg.name}: the {kind!r} state cache comes with ROADMAP.md's "
            f"'Other architectures' slice (the recurrent mixers: mamba, "
            f"mLSTM, sLSTM)")
    return kind
