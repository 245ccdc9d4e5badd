"""Gradient compression for the cross-pod boundary: symmetric per-tensor
int8, the JAX package's ``parallel/compress.py`` formula.

The error-feedback residual that makes the quantization noise contractive
lives in the optimizer (``train/optim.py``, ``compression="int8_ef"``).
The exchange itself (``allreduce_int8`` / ``allreduce_bf16``, int8 or bf16
on the wire between pods) needs a process group and comes with the
scale-out slice.
"""
from __future__ import annotations

from typing import Tuple

import torch


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 -> (q int8, scale f32 0-d): ``scale =
    max(max|g| / 127, 1e-12)``, ``q = clip(round(g / scale), -127, 127)``
    (round half to even), all in f32 on ``g``'s device."""
    g = g.float()
    scale = torch.clamp_min(g.abs().max() / 127.0, 1e-12)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale
