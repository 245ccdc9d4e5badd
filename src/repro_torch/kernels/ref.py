"""Plain PyTorch oracles, written for clarity, not speed.

The same functions as the JAX package's ``kernels/ref.py``: f32 math,
results in the input dtype.
"""
from __future__ import annotations

from typing import Optional

import torch


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True,
              scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention oracle.  q: [B,H,Sq,D], k/v: [B,Hkv,Skv,D].

    GQA by repeating kv heads; f32 softmax; the causal mask aligns the
    queries with the end of the keys (offset ``Skv - Sq``)."""
    b, h, sq, d = q.shape
    hkv = k.shape[1]
    if hkv != h:
        if h % hkv:
            raise ValueError(f"{h} query heads over {hkv} kv heads")
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        skv = k.shape[2]
        qi = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        ki = torch.arange(skv, device=q.device)[None, :]
        logits = logits.masked_fill(ki > qi, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.float())
    return out.to(q.dtype)
