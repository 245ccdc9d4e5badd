"""Public kernel API: a thin shim over :meth:`LoweringRegistry.select`.

Importing this module installs the kernel variants in
:data:`repro_torch.core.registry.REGISTRY`.  Callers pick a lowering by
``mode=`` (kernel-layer tests), ``policy=`` (threaded from the model), or
the ambient :func:`~repro_torch.core.registry.use_policy` context, else
:data:`DEFAULT_POLICY` (the native kernel).  Each wrapper hands the
registry the call's shape signature (the JAX package's ``shape=`` keys),
which ``mode="auto"`` ranks the lowerings' structural costs at; shapes are
Python ints read off tensor sizes, so selection reads no tensor.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.registry import (DEFAULT_POLICY, REGISTRY,
                                       ExecutionPolicy, IsaMode,
                                       resolve_policy)
from repro_torch.kernels import attention as _attention  # noqa: F401
from repro_torch.kernels import collective as _collective  # noqa: F401
from repro_torch.kernels import fused as _fused  # noqa: F401 (registers)
from repro_torch.kernels import gemm as _gemm  # noqa: F401 (registers)
from repro_torch.kernels import histogram as _histogram  # noqa: F401
from repro_torch.kernels import reduction as _reduction  # noqa: F401
from repro_torch.kernels import rmsnorm as _rmsnorm  # noqa: F401
from repro_torch.kernels import ssd as _ssd  # noqa: F401 (registers)
from repro_torch.parallel.sharding import has_dtensor, replicated_call

#: representative shapes per op for cost-ranked selection probes (the JAX
#: package's rows)
PROBE_SHAPES = {
    "gemm": dict(m=1024, n=1024, k=1024),
    "reduction": dict(n=1 << 20),
    "rmsnorm": dict(rows=1024, d=1024),
    "histogram": dict(n=1 << 18, num_bins=256),
    "flash_attention": dict(b=1, h=4, sq=1024, skv=1024, d=64, causal=True),
    "rmsnorm_matmul": dict(rows=1024, d=1024, n=1024),
    "add_rmsnorm": dict(rows=1024, d=1024),
    "flash_attention_matmul": dict(b=1, h=4, sq=1024, skv=1024, d=64,
                                   n=256, causal=True),
    "rmsnorm_swiglu": dict(rows=1024, d=1024, f=1024),
    "rmsnorm_matmul_q8": dict(rows=1024, d=1024, n=1024),
    "flash_attention_matmul_q8": dict(b=1, h=4, sq=1024, skv=1024, d=64,
                                      n=256, causal=True),
    "rmsnorm_swiglu_q8": dict(rows=1024, d=1024, f=1024),
    "ssd_scan": dict(b=1, seq=1024, h=8, p=64, g=1, n=128),
    "ssd_decode": dict(b=8, h=8, p=64, g=1, n=128),
    # the tensor-parallel twins: their bases' geometry (at the ambient
    # tp = 1 the collective term is zero)
    "gemm_tp": dict(m=1024, n=1024, k=1024),
    "rmsnorm_matmul_tp": dict(rows=1024, d=1024, n=1024),
    "rmsnorm_swiglu_tp": dict(rows=1024, d=1024, f=1024),
    "flash_attention_matmul_tp": dict(b=1, h=4, sq=1024, skv=1024, d=64,
                                      n=256, causal=True),
}


def _rows(x) -> int:
    rows = 1
    for s in x.shape[:-1]:
        rows *= s
    return rows


def _select(op: str, mode, policy: Optional[ExecutionPolicy], device,
            shape: Optional[dict] = None):
    return REGISTRY.select(op, resolve_policy(mode, policy, DEFAULT_POLICY),
                           shape=shape, device=device)


def _run(low, *args, **kwargs):
    """``low.impl(*args, **kwargs)``.  A kernel lowering handed DTensors
    runs on their whole tensors (``sharding.replicated_call``); a library
    row is plain PyTorch, which shards DTensors itself."""
    if low.mode is not IsaMode.LIBRARY and has_dtensor(args, kwargs):
        return replicated_call(low.impl, *args, **kwargs)
    return low.impl(*args, **kwargs)


def run_op(op: str, *args, mode=None,
           policy: Optional[ExecutionPolicy] = None,
           shape: Optional[dict] = None, device=None, **kwargs):
    """Dispatch by registered op name: ``shape`` feeds auto's ranking
    (default: the op's :data:`PROBE_SHAPES` row), ``device`` is where the
    operands live (default: the first tensor argument's), the rest goes to
    the selected lowering."""
    if device is None:
        device = next((a.device for a in args
                       if isinstance(a, torch.Tensor)), None)
    low = _select(op, mode, policy, device, shape or PROBE_SHAPES.get(op))
    return _run(low, *args, **kwargs)


def matmul(a, b, *, mode=None, policy: Optional[ExecutionPolicy] = None,
           out_dtype=torch.float32):
    """``a @ b`` with f32 accumulation (Table V, row 1)."""
    low = _select("gemm", mode, policy, a.device, dict(
        m=a.shape[0], n=b.shape[1], k=a.shape[1], dtype=a.dtype))
    return _run(low, a, b, out_dtype=out_dtype)


def reduce_sum(x, *, mode=None, policy: Optional[ExecutionPolicy] = None):
    """Sum of all elements with f32 accumulation (Table V, row 2)."""
    low = _select("reduction", mode, policy, x.device, dict(n=x.numel()))
    return _run(low, x)


def histogram(values, num_bins: int = 256, *, mode=None,
              policy: Optional[ExecutionPolicy] = None):
    """int32 counts of values clipped into ``[0, num_bins)`` (Table V,
    row 3)."""
    low = _select("histogram", mode, policy, values.device,
                  dict(n=values.numel(), num_bins=num_bins))
    return _run(low, values, num_bins)


def flash_attention(q, k, v, *, causal: bool = True,
                    kv_offset: Optional[int] = None, mode=None,
                    policy: Optional[ExecutionPolicy] = None):
    """Softmax attention ``[B,H,Sq,D] -> [B,H,Sq,D]`` (k/v ``[B,Hkv,Skv,D]``),
    causal with ``kv_offset`` (default ``Skv - Sq``)."""
    low = _select("flash_attention", mode, policy, q.device, dict(
        b=q.shape[0], h=q.shape[1], sq=q.shape[2], skv=k.shape[2],
        d=q.shape[3], causal=causal, block_q=None, block_kv=None))
    return _run(low, q, k, v, causal=causal, kv_offset=kv_offset)


def rmsnorm(x, weight, *, eps: float = 1e-6, mode=None,
            policy: Optional[ExecutionPolicy] = None):
    """RMSNorm over the last axis."""
    low = _select("rmsnorm", mode, policy, x.device,
                  dict(rows=_rows(x), d=x.shape[-1]))
    return _run(low, x, weight, eps=eps)


def fused_rmsnorm_matmul(x, weight, w_proj, *, eps: float = 1e-6, mode=None,
                         policy: Optional[ExecutionPolicy] = None,
                         w_scale=None):
    """``rmsnorm(x, weight) @ w_proj``.  ``w_scale`` marks ``w_proj`` as
    int8 with per-channel scales: a quantized selection (the policy's
    precision) takes it along, or quantizes a float weight itself; an f32
    selection dequantizes an int8 weight first."""
    low = _select("rmsnorm_matmul", mode, policy, x.device, dict(
        rows=_rows(x), d=x.shape[-1], n=w_proj.shape[1]))
    if low.op.endswith("_q8"):          # a "_tp" twin runs its base's impl
        return _run(low, x, weight, w_proj, eps=eps, w_scale=w_scale)
    if w_scale is not None:
        w_proj = _fused.dequantize_weight(w_proj, w_scale, x.dtype)
    return _run(low, x, weight, w_proj, eps=eps)


def fused_add_rmsnorm(x, residual, weight, *, eps: float = 1e-6, mode=None,
                      policy: Optional[ExecutionPolicy] = None):
    """``(rmsnorm(x + residual), x + residual)``."""
    low = _select("add_rmsnorm", mode, policy, x.device,
                  dict(rows=_rows(x), d=x.shape[-1]))
    return _run(low, x, residual, weight, eps=eps)


def fused_rmsnorm_swiglu(x, weight, w_cat, *, eps: float = 1e-6, mode=None,
                         policy: Optional[ExecutionPolicy] = None,
                         w_scale=None):
    """``silu(y @ wg) * (y @ wi)`` for ``y = rmsnorm(x, weight)`` (``w_scale``
    as in :func:`fused_rmsnorm_matmul`)."""
    low = _select("rmsnorm_swiglu", mode, policy, x.device, dict(
        rows=_rows(x), d=x.shape[-1], f=w_cat.shape[1] // 2))
    if low.op.endswith("_q8"):
        return _run(low, x, weight, w_cat, eps=eps, w_scale=w_scale)
    if w_scale is not None:
        w_cat = _fused.dequantize_weight(w_cat, w_scale, x.dtype)
    return _run(low, x, weight, w_cat, eps=eps)


def fused_flash_attention_matmul(q, k, v, w_out, *, causal: bool = True,
                                 kv_offset: Optional[int] = None, mode=None,
                                 policy: Optional[ExecutionPolicy] = None,
                                 pos=None, block_tables=None, w_scale=None,
                                 k_scale=None, v_scale=None):
    """``attention(q, k, v) @ wo``: causal, by ``pos`` frontier, or paged
    (``block_tables`` with k/v page pools).  ``w_scale`` marks an int8
    ``w_out``; ``k_scale``/``v_scale`` int8 page pools.  A quantized
    selection takes them along; an f32 selection dequantizes first."""
    if block_tables is not None:
        # paged: costs ranked at every page of every slot occupied, the
        # static worst case (the live pages are a device quantity)
        page_size = k.shape[2]
        maxp = block_tables.shape[1]
        shape = dict(b=q.shape[0], h=q.shape[1], sq=q.shape[2],
                     skv=maxp * page_size, d=q.shape[3], n=w_out.shape[1],
                     causal=False, block_q=None, block_kv=page_size,
                     page_size=page_size, pages_occupied=q.shape[0] * maxp)
    else:
        shape = dict(b=q.shape[0], h=q.shape[1], sq=q.shape[2],
                     skv=k.shape[2], d=q.shape[3], n=w_out.shape[1],
                     causal=causal and pos is None, block_q=None,
                     block_kv=None)
    low = _select("flash_attention_matmul", mode, policy, q.device, shape)
    causal = causal and pos is None
    if low.op.endswith("_q8"):
        return _run(low, q, k, v, w_out, causal=causal, kv_offset=kv_offset,
                    pos=pos, block_tables=block_tables, w_scale=w_scale,
                    k_scale=k_scale, v_scale=v_scale)
    if w_scale is not None:
        w_out = _fused.dequantize_weight(w_out, w_scale, q.dtype)
    if k_scale is not None:
        k = (k.float() * k_scale).to(q.dtype)
        v = (v.float() * v_scale).to(q.dtype)
    return _run(low, q, k, v, w_out, causal=causal, kv_offset=kv_offset,
                pos=pos, block_tables=block_tables)


def fused_ssd_scan(x, dt, A, B_mat, C_mat, *, chunk: Optional[int] = None,
                   initial_state=None, mode=None,
                   policy: Optional[ExecutionPolicy] = None):
    """The whole chunked SSD scan in one kernel: ``(y [B,L,H,P], final
    state f32 [B,G,Hg,N,P])``, the final state seeding the decode
    recurrence.  ``chunk=None`` resolves the chunk as the JAX package does
    (``ssd.resolve_chunk``, for the selected mode and the policy's
    dialect)."""
    pol = resolve_policy(mode, policy, DEFAULT_POLICY)
    b, l, h, p = x.shape
    g, n = B_mat.shape[2], B_mat.shape[3]
    low = REGISTRY.select("ssd_scan", pol, shape=dict(
        b=b, seq=l, h=h, p=p, g=g, n=n, chunk=chunk), device=x.device)
    chunk = _ssd.resolve_chunk(l, chunk, mode=low.mode.value, p=p, n=n,
                               plan_dialect=pol.dialect)
    return _run(low, x, dt, A, B_mat, C_mat, initial_state, chunk=chunk)


def fused_ssd_decode(state, x_t, dt_t, A, B_t, C_t, *, out=None, mode=None,
                     policy: Optional[ExecutionPolicy] = None):
    """One SSD decode tick for every slot and head in one kernel: ``(new
    state f32 [B,G,Hg,N,P], y [B,H,P])``.  ``out`` receives the new state
    (it may be ``state``, for an update in place)."""
    b, g, hg, n, p = state.shape
    low = _select("ssd_decode", mode, policy, state.device, dict(
        b=b, h=g * hg, p=p, g=g, n=n, block_b=None))
    return _run(low, state, x_t, dt_t, A, B_t, C_t, out=out)


#: op -> its structural cost model (the JAX package's table)
STRUCTURAL_COSTS = {
    "gemm": _gemm.structural_cost,
    "reduction": _reduction.structural_cost,
    "histogram": _histogram.structural_cost,
    "flash_attention": _attention.structural_cost,
    "rmsnorm": _rmsnorm.structural_cost,
    **_fused.COSTS,
    **_ssd.COSTS,
    **_collective.TP_COSTS,
}
