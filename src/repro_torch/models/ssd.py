"""Mamba2 / SSD blocks (arXiv:2405.21060), the JAX package's
``models/ssd.py`` function for function.

Prefill runs the chunked SSD scan (the quadratic form inside a chunk, a
linear recurrence carrying the [N,P] state across chunks); its final state
and the last ``conv_width - 1`` pre-conv inputs seed decode.  Decode is the
pure recurrence ``h <- exp(dt A) h + dt B (x) x``, ``y = C.h + D x``.

Precision follows the JAX package: the depthwise causal conv and the silu
after it run in f32 with one cast back (prefill and decode alike), softplus
runs in f32, the ``D`` skip is formed in f32 and cast, and the gated norm is
``rmsnorm(y * silu(z))``.  The scan and the decode recurrence route through
the SSD kernels (``kernels/ssd.py``) in the policy's kernel mode exactly
where the policy fuses; the gated norm goes through the registry's rmsnorm
in the policy's mode (the library row, plain PyTorch, unless ``isa_mode``
is set); the conv and the projections are plain PyTorch.  ``ctx`` moves
the heads and the plain scan's carried state to their mesh layouts.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.registry import LIBRARY_POLICY, resolve_policy
from repro_torch.kernels import ssd as kernel_ssd
from repro_torch.models import common
from repro_torch.models.config import SSMConfig
from repro_torch.parallel.sharding import shard


def conv_dim(cfg: SSMConfig, d_model: int) -> int:
    d_inner = cfg.expand * d_model
    return d_inner + 2 * cfg.n_groups * cfg.state_dim


def init_mamba_block(generator: torch.Generator, d_model: int,
                     cfg: SSMConfig, dtype, device=None):
    """Random block parameters (the JAX package's shapes and dtypes: the
    dt bias, A_log and D stay f32)."""
    d_inner = cfg.expand * d_model
    nh = d_inner // cfg.head_dim
    cdim = conv_dim(cfg, d_model)
    proj = 2 * d_inner + 2 * cfg.n_groups * cfg.state_dim + nh
    conv_w = torch.empty((cfg.conv_width, cdim), dtype=torch.float32,
                         device=device)
    conv_w.normal_(0.0, 1.0, generator=generator)
    dt = torch.linspace(cfg.dt_min, cfg.dt_max, nh, dtype=torch.float32,
                        device=device)
    return {
        "in_proj": common.dense_init(generator, (d_model, proj), 0, dtype,
                                     device),
        "conv_w": (conv_w * cfg.conv_width ** -0.5).to(dtype),
        "conv_b": torch.zeros(cdim, dtype=dtype, device=device),
        "dt_bias": torch.log(torch.expm1(dt)),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32,
                                          device=device)),
        "D": torch.ones(nh, dtype=torch.float32, device=device),
        "norm_scale": torch.ones(d_inner, dtype=dtype, device=device),
        "out_proj": common.dense_init(generator, (d_inner, d_model), 0,
                                      dtype, device),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv in f32.  x [B,L,C]; w [W,C]; b [C] -> f32
    [B,L,C] (the caller casts once, after the silu)."""
    width = w.shape[0]
    length = x.shape[1]
    xp = F.pad(x.float(), (0, 0, width - 1, 0))
    wf = w.float()
    out = xp[:, 0:length] * wf[0]
    for k in range(1, width):
        out = out + xp[:, k:k + length] * wf[k]
    return out + b.float()


def _split_proj(z_xbc_dt, d_inner: int, gn2: int, nh: int):
    z = z_xbc_dt[..., :d_inner]
    xbc = z_xbc_dt[..., d_inner:2 * d_inner + gn2]
    dt_raw = z_xbc_dt[..., 2 * d_inner + gn2:]
    if dt_raw.shape[-1] != nh:
        raise ValueError(f"in_proj gives {dt_raw.shape[-1]} dt columns, "
                         f"not {nh}")
    return z, xbc, dt_raw


def _conv_tail(xbc_pre_conv, width: int):
    """The last ``width - 1`` pre-conv inputs: the decode conv cache seed."""
    length = xbc_pre_conv.shape[1]
    if length >= width - 1:
        return xbc_pre_conv[:, length - (width - 1):]
    return F.pad(xbc_pre_conv, (0, 0, width - 1 - length, 0))


def _gated_out(params, y, xh, z, nh: int, eps: float, policy):
    """``D`` skip (f32, cast), then ``rmsnorm(y * silu(z)) @ out_proj``."""
    y = y + (params["D"].reshape(nh, 1) * xh.float()).to(y.dtype)
    y = y.reshape(*z.shape)
    y = common.rmsnorm(y * F.silu(z), params["norm_scale"], eps,
                       policy=policy)
    return torch.matmul(y, params["out_proj"].to(y.dtype))


def mamba_block_specs():
    """The logical axes of :func:`init_mamba_block`'s leaves."""
    return {
        "in_proj": ("embed", "ssm_inner"),
        "conv_w": ("conv_width", "ssm_inner"),
        "conv_b": ("ssm_inner",),
        "dt_bias": ("ssm_heads",),
        "A_log": ("ssm_heads",),
        "D": ("ssm_heads",),
        "norm_scale": ("ssm_inner",),
        "out_proj": ("ssm_inner", "embed"),
    }


def apply_mamba_block(params, x, cfg: SSMConfig, d_model: int, eps: float,
                      initial_state=None, return_state: bool = False,
                      policy=None, ctx=None):
    """The whole block over a sequence.  x [B,L,D] -> [B,L,D], and with
    ``return_state`` also (final state f32 [B,G,Hg,N,P], conv tail
    [B,W-1,conv_dim])."""
    b, l, _ = x.shape
    d_inner = cfg.expand * d_model
    nh = d_inner // cfg.head_dim
    gn2 = 2 * cfg.n_groups * cfg.state_dim

    proj = torch.matmul(x, params["in_proj"].to(x.dtype))
    z, xbc, dt_raw = _split_proj(proj, d_inner, gn2, nh)
    xbc = F.silu(_causal_conv(xbc, params["conv_w"], params["conv_b"])
                 ).to(x.dtype)                      # silu in f32, one cast
    xs = xbc[..., :d_inner]
    B_mat = xbc[..., d_inner:d_inner + gn2 // 2].reshape(
        b, l, cfg.n_groups, cfg.state_dim)
    C_mat = xbc[..., d_inner + gn2 // 2:].reshape(
        b, l, cfg.n_groups, cfg.state_dim)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])   # [B,L,H] f32
    A = -torch.exp(params["A_log"])
    xh = shard(xs.reshape(b, l, nh, cfg.head_dim),
               ("act_batch", "act_seq_unsharded", "act_ssm_heads",
                "act_ssm_state"), ctx)
    pol = resolve_policy(policy=policy, default=LIBRARY_POLICY)
    if pol.fuses():
        from repro_torch.kernels import ops as kernel_ops
        y, state = kernel_ops.fused_ssd_scan(
            xh, dt, A, B_mat, C_mat, chunk=cfg.chunk_size,
            initial_state=initial_state, policy=pol.kernel())
    else:
        def hook(h):
            return shard(h, ("act_batch", None, "act_ssm_heads",
                             "act_ssm_state", None), ctx)
        y, state = kernel_ssd.ssd_scan_plain(
            xh, dt, A, B_mat, C_mat, initial_state, chunk=cfg.chunk_size,
            state_hook=None if ctx is None else hook)
    out = _gated_out(params, y, xh, z, nh, eps, policy)
    if return_state:
        tail = _conv_tail(proj[..., d_inner:2 * d_inner + gn2],
                          cfg.conv_width)
        return out, (state, tail)
    return out


def mamba_decode_step(params, x_t, cfg: SSMConfig, d_model: int, eps: float,
                      state, conv_buf, policy=None):
    """One token.  x_t [B,D]; state [B,G,Hg,N,P] f32 and conv_buf
    [B,W-1,conv_dim] are updated in place (this layer's cache entries).
    Returns y [B,D]."""
    b, _ = x_t.shape
    d_inner = cfg.expand * d_model
    nh = d_inner // cfg.head_dim
    gn2 = 2 * cfg.n_groups * cfg.state_dim

    proj = torch.matmul(x_t, params["in_proj"].to(x_t.dtype))
    z, xbc_new, dt_raw = _split_proj(proj, d_inner, gn2, nh)
    window = torch.cat([conv_buf, xbc_new[:, None, :].to(conv_buf.dtype)],
                       dim=1)                         # [B,W,C]
    conv_out = (window.float() * params["conv_w"].float()).sum(dim=1) \
        + params["conv_b"].float()
    xbc = F.silu(conv_out).to(x_t.dtype)
    conv_buf.copy_(window[:, 1:])

    xs = xbc[..., :d_inner]
    B_t = xbc[..., d_inner:d_inner + gn2 // 2].reshape(
        b, cfg.n_groups, cfg.state_dim)
    C_t = xbc[..., d_inner + gn2 // 2:].reshape(
        b, cfg.n_groups, cfg.state_dim)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    xh = xs.reshape(b, nh, cfg.head_dim)
    pol = resolve_policy(policy=policy, default=LIBRARY_POLICY)
    if pol.fuses():
        from repro_torch.kernels import ops as kernel_ops
        _, y = kernel_ops.fused_ssd_decode(state, xh, dt, A, B_t, C_t,
                                           out=state, policy=pol.kernel())
    else:
        _, y = kernel_ssd.ssd_decode_plain(state, xh, dt, A, B_t, C_t,
                                           out=state)
    return _gated_out(params, y, xh, z, nh, eps, policy)
