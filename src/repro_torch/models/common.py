"""Shared model machinery: init, parameter-layout accessors, norms, rotary.

Norms dispatch through the lowering registry under the policy's mode (the
default is the library row, the plain version; ``native`` launches the
rmsnorm kernel).  The norm->projection and residual->norm hot pairs take
the policy's kernel view (``policy.kernel()``) under a fusing policy, so
the main path's ``native`` mode launches the hand-written fused kernels;
otherwise the unfused sequence runs.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.registry import (LIBRARY_POLICY, ExecutionPolicy,
                                       resolve_policy)

# --------------------------------------------------------------------------
# Initialization (explicit torch.Generator; its device is the tensor's)
# --------------------------------------------------------------------------


def dense_init(generator: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """Truncated-normal fan-in init (std = 1/sqrt(fan_in)), drawn in f32."""
    std = shape[in_axis] ** -0.5
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * std).to(dtype)


def embed_init(generator: torch.Generator, shape, device=None) -> torch.Tensor:
    """Normal(0, 0.02) embedding table, kept in f32 (cast at use)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t.normal_(0.0, 1.0, generator=generator)
    return t * 0.02


# --------------------------------------------------------------------------
# Device and the stacked [L, ...] parameter layout
# --------------------------------------------------------------------------


def resolve_device(device=None) -> torch.device:
    """``device`` or the CUDA card; the card must exist when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain versions on the CPU")
    return dev


def layer_view(blocks, i: int):
    """Layer ``i`` of the stacked ``[L, ...]`` block tree (views)."""
    return {k: layer_view(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


def stack_like(tree, n: int):
    """Empty ``[n, ...]`` tensors shaped like the leaves of one layer."""
    return {k: stack_like(v, n) if isinstance(v, dict) else
            torch.empty((n,) + tuple(v.shape), dtype=v.dtype, device=v.device)
            for k, v in tree.items()}


def copy_into(stacked, tree, i: int) -> None:
    """Write one layer's leaves into row ``i`` of the stacked tensors."""
    for k, v in tree.items():
        if isinstance(v, dict):
            copy_into(stacked[k], v, i)
        else:
            stacked[k][i].copy_(v)


# --------------------------------------------------------------------------
# Parameter-layout accessors: a fusable group is stored per matrix
# ("wq"/"wk"/"wv", "wi"/"wg") or concatenated ("wqkv", "wig").
# --------------------------------------------------------------------------


def concat_param(params, cat_key: str, part_keys: Sequence[str]):
    """The whole concatenated tensor for a fused lowering: the persisted
    one, else a per-call last-axis concat of the per-matrix weights."""
    if cat_key in params:
        return params[cat_key]
    return torch.cat([params[k] for k in part_keys], dim=-1)


def split_param(params, cat_key: str, part_keys: Sequence[str],
                widths: Sequence[int]):
    """Per-matrix views for unfused math, on either stored layout."""
    if cat_key in params:
        w = params[cat_key]
        parts, off = [], 0
        for width in widths:
            parts.append(w[..., off:off + width])
            off += width
        return tuple(parts)
    return tuple(params[k] for k in part_keys)


def stored_concat(params, cat_key: str) -> bool:
    """Whether this group is persisted concatenated: the decode-tick
    fusion gate (a per-call concat would cost a weight-sized copy)."""
    return cat_key in params


# --------------------------------------------------------------------------
# Norms / activations
# --------------------------------------------------------------------------


def rmsnorm(x, weight, eps: float = 1e-6,
            policy: Optional[ExecutionPolicy] = None):
    """The model norm through the registry under the policy's mode
    (default: the library row, the plain version)."""
    from repro_torch.kernels import ops as kernel_ops
    return kernel_ops.rmsnorm(
        x, weight, eps=eps,
        policy=resolve_policy(policy=policy, default=LIBRARY_POLICY))


def rmsnorm_matmul(x, weight, w_proj, eps: float = 1e-6,
                   policy: Optional[ExecutionPolicy] = None):
    """``rmsnorm(x, weight) @ w_proj``: fused under a fusing policy (the
    policy's kernel view picks the lowering), else the unfused pair."""
    from repro_torch.kernels import ops as kernel_ops
    pol = resolve_policy(policy=policy, default=LIBRARY_POLICY)
    if pol.fuses():
        return kernel_ops.fused_rmsnorm_matmul(x, weight, w_proj, eps=eps,
                                               policy=pol.kernel())
    y = rmsnorm(x, weight, eps, policy=pol)
    return torch.matmul(y, w_proj.to(y.dtype))


def rmsnorm_swiglu(x, weight, w_cat, eps: float = 1e-6,
                   policy: Optional[ExecutionPolicy] = None):
    """``silu(y @ wg) * (y @ wi)`` for ``y = rmsnorm(x, weight)`` and
    ``w_cat = [wi|wg]``; same gate as :func:`rmsnorm_matmul`."""
    from repro_torch.kernels import ops as kernel_ops
    pol = resolve_policy(policy=policy, default=LIBRARY_POLICY)
    if pol.fuses():
        return kernel_ops.fused_rmsnorm_swiglu(x, weight, w_cat, eps=eps,
                                               policy=pol.kernel())
    y = rmsnorm(x, weight, eps, policy=pol)
    f = w_cat.shape[1] // 2
    hi = torch.matmul(y, w_cat[:, :f].to(y.dtype))
    hg = torch.matmul(y, w_cat[:, f:].to(y.dtype))
    return F.silu(hg) * hi


def add_rmsnorm(x, delta, weight, eps: float = 1e-6,
                policy: Optional[ExecutionPolicy] = None):
    """``(rmsnorm(x + delta), x + delta)``: one add_rmsnorm kernel under a
    fusing policy (same gate as :func:`rmsnorm_matmul`), else the add and
    then the registry norm."""
    from repro_torch.kernels import ops as kernel_ops
    pol = resolve_policy(policy=policy, default=LIBRARY_POLICY)
    if pol.fuses():
        return kernel_ops.fused_add_rmsnorm(x, delta, weight, eps=eps,
                                            policy=pol.kernel())
    s = x + delta
    return rmsnorm(s, weight, eps, policy=pol), s


def apply_norm(x, params, kind: str, eps: float,
               policy: Optional[ExecutionPolicy] = None):
    if kind != "rmsnorm":
        raise NotImplementedError(f"norm {kind!r} is not ported yet")
    return rmsnorm(x, params["scale"], eps, policy=policy)


def activation(x, kind: str):
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


# --------------------------------------------------------------------------
# Rotary embeddings (half-split convention: the first and second halves of
# the head dimension are the two rotated components)
# --------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None):
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return float(theta) ** -exponents


def apply_rope(x, positions, theta: float):
    """x: [..., S, D]; positions: broadcastable to [..., S]."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)
    angles = positions[..., None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
