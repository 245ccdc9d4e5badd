"""Model registry: family string -> model class.

Ported: ``dense`` and ``moe`` (:class:`TransformerLM`), ``ssm``
(:class:`MambaLM`) and ``hybrid`` (:class:`HybridLM`); the other families
raise until their slice lands.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.models.config import ModelConfig, ParallelConfig


def build_model(cfg: ModelConfig, par: Optional[ParallelConfig] = None,
                policy=None, device=None):
    """The model for ``cfg`` on ``device`` (default: the CUDA card)."""
    from repro_torch.models.hybrid import HybridLM
    from repro_torch.models.mamba_lm import MambaLM
    from repro_torch.models.transformer import TransformerLM

    par = par if par is not None else ParallelConfig()
    if cfg.family in ("dense", "moe"):
        return TransformerLM(cfg, par, policy=policy, device=device)
    if cfg.family == "ssm":
        return MambaLM(cfg, par, policy=policy, device=device)
    if cfg.family == "hybrid":
        return HybridLM(cfg, par, policy=policy, device=device)
    raise NotImplementedError(
        f"model family {cfg.family!r} is not ported yet (ROADMAP, \"The "
        f"rest of the plain model layer, VLM and encoder-decoder\")")
