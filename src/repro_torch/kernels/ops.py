"""Public kernel API: a thin shim over :meth:`LoweringRegistry.select`.

Importing this module installs the kernel variants in
:data:`repro_torch.core.registry.REGISTRY`.  Callers pick a lowering by
``mode=`` (kernel-layer tests), ``policy=`` (threaded from the model), or
the ambient :func:`~repro_torch.core.registry.use_policy` context, else
:data:`DEFAULT_POLICY` (the native kernel).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.registry import (DEFAULT_POLICY, REGISTRY,
                                       ExecutionPolicy, resolve_policy)
from repro_torch.kernels import attention as _attention  # noqa: F401
from repro_torch.kernels import fused as _fused  # noqa: F401 (registers)
from repro_torch.kernels import gemm as _gemm  # noqa: F401 (registers)
from repro_torch.kernels import histogram as _histogram  # noqa: F401
from repro_torch.kernels import reduction as _reduction  # noqa: F401
from repro_torch.kernels import rmsnorm as _rmsnorm  # noqa: F401
from repro_torch.kernels import ssd as _ssd  # noqa: F401 (registers)


def _select(op: str, mode, policy: Optional[ExecutionPolicy], device):
    return REGISTRY.select(op, resolve_policy(mode, policy, DEFAULT_POLICY),
                           device=device)


def matmul(a, b, *, mode=None, policy: Optional[ExecutionPolicy] = None,
           out_dtype=torch.float32):
    """``a @ b`` with f32 accumulation (Table V, row 1)."""
    low = _select("gemm", mode, policy, a.device)
    return low.impl(a, b, out_dtype=out_dtype)


def reduce_sum(x, *, mode=None, policy: Optional[ExecutionPolicy] = None):
    """Sum of all elements with f32 accumulation (Table V, row 2)."""
    low = _select("reduction", mode, policy, x.device)
    return low.impl(x)


def histogram(values, num_bins: int = 256, *, mode=None,
              policy: Optional[ExecutionPolicy] = None):
    """int32 counts of values clipped into ``[0, num_bins)`` (Table V,
    row 3)."""
    low = _select("histogram", mode, policy, values.device)
    return low.impl(values, num_bins)


def flash_attention(q, k, v, *, causal: bool = True,
                    kv_offset: Optional[int] = None, mode=None,
                    policy: Optional[ExecutionPolicy] = None):
    """Softmax attention ``[B,H,Sq,D] -> [B,H,Sq,D]`` (k/v ``[B,Hkv,Skv,D]``),
    causal with ``kv_offset`` (default ``Skv - Sq``)."""
    low = _select("flash_attention", mode, policy, q.device)
    return low.impl(q, k, v, causal=causal, kv_offset=kv_offset)


def rmsnorm(x, weight, *, eps: float = 1e-6, mode=None,
            policy: Optional[ExecutionPolicy] = None):
    """RMSNorm over the last axis."""
    low = _select("rmsnorm", mode, policy, x.device)
    return low.impl(x, weight, eps=eps)


def fused_rmsnorm_matmul(x, weight, w_proj, *, eps: float = 1e-6, mode=None,
                         policy: Optional[ExecutionPolicy] = None,
                         w_scale=None):
    """``rmsnorm(x, weight) @ w_proj``.  ``w_scale`` marks ``w_proj`` as
    int8 with per-channel scales: a quantized selection (the policy's
    precision) takes it along, or quantizes a float weight itself; an f32
    selection dequantizes an int8 weight first."""
    low = _select("rmsnorm_matmul", mode, policy, x.device)
    if low.op.endswith("_q8"):
        return low.impl(x, weight, w_proj, eps=eps, w_scale=w_scale)
    if w_scale is not None:
        w_proj = _fused.dequantize_weight(w_proj, w_scale, x.dtype)
    return low.impl(x, weight, w_proj, eps=eps)


def fused_add_rmsnorm(x, residual, weight, *, eps: float = 1e-6, mode=None,
                      policy: Optional[ExecutionPolicy] = None):
    """``(rmsnorm(x + residual), x + residual)``."""
    low = _select("add_rmsnorm", mode, policy, x.device)
    return low.impl(x, residual, weight, eps=eps)


def fused_rmsnorm_swiglu(x, weight, w_cat, *, eps: float = 1e-6, mode=None,
                         policy: Optional[ExecutionPolicy] = None,
                         w_scale=None):
    """``silu(y @ wg) * (y @ wi)`` for ``y = rmsnorm(x, weight)`` (``w_scale``
    as in :func:`fused_rmsnorm_matmul`)."""
    low = _select("rmsnorm_swiglu", mode, policy, x.device)
    if low.op.endswith("_q8"):
        return low.impl(x, weight, w_cat, eps=eps, w_scale=w_scale)
    if w_scale is not None:
        w_cat = _fused.dequantize_weight(w_cat, w_scale, x.dtype)
    return low.impl(x, weight, w_cat, eps=eps)


def fused_flash_attention_matmul(q, k, v, w_out, *, causal: bool = True,
                                 kv_offset: Optional[int] = None, mode=None,
                                 policy: Optional[ExecutionPolicy] = None,
                                 pos=None, block_tables=None, w_scale=None,
                                 k_scale=None, v_scale=None):
    """``attention(q, k, v) @ wo``: causal, by ``pos`` frontier, or paged
    (``block_tables`` with k/v page pools).  ``w_scale`` marks an int8
    ``w_out``; ``k_scale``/``v_scale`` int8 page pools.  A quantized
    selection takes them along; an f32 selection dequantizes first."""
    low = _select("flash_attention_matmul", mode, policy, q.device)
    causal = causal and pos is None
    if low.op.endswith("_q8"):
        return low.impl(q, k, v, w_out, causal=causal, kv_offset=kv_offset,
                        pos=pos, block_tables=block_tables, w_scale=w_scale,
                        k_scale=k_scale, v_scale=v_scale)
    if w_scale is not None:
        w_out = _fused.dequantize_weight(w_out, w_scale, q.dtype)
    if k_scale is not None:
        k = (k.float() * k_scale).to(q.dtype)
        v = (v.float() * v_scale).to(q.dtype)
    return low.impl(q, k, v, w_out, causal=causal, kv_offset=kv_offset,
                    pos=pos, block_tables=block_tables)


def fused_ssd_scan(x, dt, A, B_mat, C_mat, *, chunk: Optional[int] = None,
                   initial_state=None, mode=None,
                   policy: Optional[ExecutionPolicy] = None):
    """The whole chunked SSD scan in one kernel: ``(y [B,L,H,P], final
    state f32 [B,G,Hg,N,P])``, the final state seeding the decode
    recurrence.  ``chunk`` is required (the tuning table is ROADMAP's "The
    UISA core remainder, tuning and auto")."""
    low = _select("ssd_scan", mode, policy, x.device)
    return low.impl(x, dt, A, B_mat, C_mat, initial_state, chunk=chunk)


def fused_ssd_decode(state, x_t, dt_t, A, B_t, C_t, *, out=None, mode=None,
                     policy: Optional[ExecutionPolicy] = None):
    """One SSD decode tick for every slot and head in one kernel: ``(new
    state f32 [B,G,Hg,N,P], y [B,H,P])``.  ``out`` receives the new state
    (it may be ``state``, for an update in place)."""
    low = _select("ssd_decode", mode, policy, state.device)
    return low.impl(state, x_t, dt_t, A, B_t, C_t, out=out)
