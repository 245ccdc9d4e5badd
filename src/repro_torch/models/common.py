"""Shared model machinery: init, parameter-layout accessors, norms, rotary
and sinusoidal positions, the cross-entropy loss.

Norms dispatch through the lowering registry under the policy's mode (the
default is the library row, the plain version; ``native`` launches the
rmsnorm kernel).  The norm->projection and residual->norm hot pairs take
the policy's kernel view (``policy.kernel()``) under a fusing policy, so
the main path's ``native`` mode launches the hand-written fused kernels;
otherwise the unfused sequence runs.
"""
from __future__ import annotations

import functools
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


def layer_views(blocks):
    """Every layer of the stacked ``[L, ...]`` block tree, as a list of view
    trees: one ``torch.unbind`` per leaf, whose backward stacks the layers'
    grads once (a per-layer select's backward fills a stack-sized zero
    tensor for every layer)."""
    split = {k: layer_views(v) if isinstance(v, dict) else torch.unbind(v)
             for k, v in blocks.items()}
    n = len(next(iter(split.values())))
    return [{k: parts[i] for k, parts in split.items()} for i in range(n)]


def _save_products(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: keep the 2-D
    products (the projections), recompute the rest (attention's batched
    products among them), as JAX's ``checkpoint_dots_with_no_batch_dims``."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(fn, remat: str, *args):
    """``fn(*args)``, with what the backward recomputes set by ``remat``:
    ``"full"`` every activation of ``fn``, ``"dots"`` all but its 2-D
    products, ``"none"`` nothing.  Outside grad mode it is a plain call."""
    if remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    if remat == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    if remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _save_products))
    raise ValueError(f"remat must be full, dots or none, got {remat!r}")


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
# Weight quantization: the kernel layer owns the scheme (per-output-channel
# symmetric int8, kernels/fused.py); scales ride the tree as ``<key>_scale``
# siblings of the int8 leaves, on the same persisted concats the layout
# planner owns
# --------------------------------------------------------------------------


def quantize_weight(w):
    from repro_torch.kernels.fused import quantize_weight as _qw
    return _qw(w)


def dequantize_weight(q, scale, dtype=torch.float32):
    from repro_torch.kernels.fused import dequantize_weight as _dw
    return _dw(q, scale, dtype)


#: the hot-pair weight leaves the int8 precision quantizes, by block
#: subgroup: the persisted concats and attention's wo, the operands of the
#: three int8 fused lowerings
QUANT_GROUPS = (("attn", ("wqkv", "wo")), ("mlp", ("wig",)))


def _quantize_group(sub, keys):
    sub = dict(sub)
    for key in keys:
        if key not in sub or sub[key].dtype == torch.int8:
            continue
        sub[key], sub[key + "_scale"] = quantize_weight(sub[key])
    return sub


def quantize_params(params):
    """The tree with every ``blocks/attn/{wqkv,wo}`` and ``blocks/mlp/wig``
    leaf (and a MoE shared expert's ``wig``) int8, beside an f32
    ``<key>_scale`` sibling: per-channel scales over the input axis, so a
    stacked ``[L, d, n]`` leaf gets ``[L, n]`` scales.  Int8 leaves stay as
    they are; embeddings, norms, the head, the MLP down projection and
    per-matrix layouts keep their dtype.  A new tree: the input's leaves
    are not changed."""
    blocks = dict(params["blocks"])
    for group, keys in QUANT_GROUPS:
        if group in blocks:
            blocks[group] = _quantize_group(blocks[group], keys)
    if "moe" in blocks and "shared" in blocks["moe"]:
        moe_p = dict(blocks["moe"])
        moe_p["shared"] = _quantize_group(moe_p["shared"], ("wig",))
        blocks["moe"] = moe_p
    return dict(params, blocks=blocks)


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
                   policy: Optional[ExecutionPolicy] = None, w_scale=None):
    """``rmsnorm(x, weight) @ w_proj``: fused under a fusing policy (the
    policy's kernel view picks the lowering), else the unfused pair.
    ``w_scale`` rides along with an int8 ``w_proj``: a fusing policy hands
    it to the lowering, an unfused one dequantizes up front."""
    from repro_torch.kernels import ops as kernel_ops
    pol = resolve_policy(policy=policy, default=LIBRARY_POLICY)
    if pol.fuses():
        return kernel_ops.fused_rmsnorm_matmul(x, weight, w_proj, eps=eps,
                                               policy=pol.kernel(),
                                               w_scale=w_scale)
    y = rmsnorm(x, weight, eps, policy=pol)
    if w_scale is not None:
        w_proj = dequantize_weight(w_proj, w_scale, y.dtype)
    return torch.matmul(y, w_proj.to(y.dtype))


def rmsnorm_swiglu(x, weight, w_cat, eps: float = 1e-6,
                   policy: Optional[ExecutionPolicy] = None, w_scale=None):
    """``silu(y @ wg) * (y @ wi)`` for ``y = rmsnorm(x, weight)`` and
    ``w_cat = [wi|wg]``; same gate and ``w_scale`` split as
    :func:`rmsnorm_matmul`."""
    from repro_torch.kernels import ops as kernel_ops
    pol = resolve_policy(policy=policy, default=LIBRARY_POLICY)
    if pol.fuses():
        return kernel_ops.fused_rmsnorm_swiglu(x, weight, w_cat, eps=eps,
                                               policy=pol.kernel(),
                                               w_scale=w_scale)
    y = rmsnorm(x, weight, eps, policy=pol)
    if w_scale is not None:
        w_cat = dequantize_weight(w_cat, w_scale, y.dtype)
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


def layernorm(x, weight, bias, eps: float = 1e-5):
    """LayerNorm in f32 (mean, biased variance, ``rsqrt``), back to x's
    dtype.  Plain PyTorch in every policy: no kernel computes it, in
    either package."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def apply_norm(x, params, kind: str, eps: float,
               policy: Optional[ExecutionPolicy] = None):
    if kind == "rmsnorm":
        return rmsnorm(x, params["scale"], eps, policy=policy)
    return layernorm(x, params["scale"], params["bias"], eps)


def init_norm(d: int, kind: str, dtype=torch.float32, device=None):
    """A norm's parameters: ones of ``d`` (and, layernorm, zero bias)."""
    params = {"scale": torch.ones(d, dtype=dtype, device=device)}
    if kind != "rmsnorm":
        params["bias"] = torch.zeros(d, dtype=dtype, device=device)
    return params


def norm_specs(kind: str):
    """The logical axes of a norm's parameters, as the JAX package names
    them."""
    if kind == "rmsnorm":
        return {"scale": ("norm",)}
    return {"scale": ("norm",), "bias": ("norm",)}


def lift_specs(specs):
    """A layer's spec tree with the stacked ``[L, ...]`` axis prepended,
    unsharded."""
    if isinstance(specs, dict):
        return {k: lift_specs(v) for k, v in specs.items()}
    return (None,) + specs


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


def sinusoidal_positions(n: int, d: int, device=None):
    """[n, d] f32: sin at even columns, cos at odd, angle ``pos /
    10000^(2i/d)``."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0, device=device), dim / d)
    pe = torch.zeros((n, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle)
    return pe


# --------------------------------------------------------------------------
# Losses
# --------------------------------------------------------------------------


def cross_entropy(logits, labels):
    """Token-mean cross entropy of logits [..., V] (in f32) at int labels."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()
