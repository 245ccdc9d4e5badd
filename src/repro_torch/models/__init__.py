"""Model registry: family string -> model class.

``dense``, ``moe`` and ``vlm`` -> :class:`TransformerLM`, ``ssm`` ->
:class:`MambaLM`, ``hybrid`` -> :class:`HybridLM`, ``encdec`` / ``audio``
-> :class:`EncDecLM`, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.models.config import ModelConfig, ParallelConfig


def build_model(cfg: ModelConfig, par: Optional[ParallelConfig] = None,
                policy=None, device=None, ctx=None):
    """The model for ``cfg`` on ``device`` (default: the CUDA card), its
    activations placed on ``ctx``'s mesh if one is given."""
    from repro_torch.models.encdec import EncDecLM
    from repro_torch.models.hybrid import HybridLM
    from repro_torch.models.mamba_lm import MambaLM
    from repro_torch.models.transformer import TransformerLM

    par = par if par is not None else ParallelConfig()
    if cfg.family in ("dense", "moe", "vlm"):
        return TransformerLM(cfg, par, policy=policy, device=device, ctx=ctx)
    if cfg.family == "ssm":
        return MambaLM(cfg, par, policy=policy, device=device, ctx=ctx)
    if cfg.family == "hybrid":
        return HybridLM(cfg, par, policy=policy, device=device, ctx=ctx)
    if cfg.family in ("encdec", "audio"):
        return EncDecLM(cfg, par, policy=policy, device=device, ctx=ctx)
    raise ValueError(f"unknown model family {cfg.family!r}")
