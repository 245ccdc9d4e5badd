"""Plain PyTorch oracles, written for clarity, not speed.

The same functions as the JAX package's ``kernels/ref.py``: f32 math,
results in the input dtype.
"""
from __future__ import annotations

from typing import Optional

import torch


def gemm(a: torch.Tensor, b: torch.Tensor,
         out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """C = A @ B with f32 accumulation."""
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Scalar sum with f32 accumulation (the paper's reduction benchmark)."""
    return torch.sum(x, dtype=torch.float32)


def histogram(values: torch.Tensor, num_bins: int) -> torch.Tensor:
    """int32 counts of values clipped into [0, num_bins) (the paper's
    histogram benchmark)."""
    clipped = values.reshape(-1).to(torch.int64).clamp(0, num_bins - 1)
    return torch.bincount(clipped, minlength=num_bins).to(torch.int32)


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
