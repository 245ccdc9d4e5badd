"""Tensor-parallel twin lowerings: the mesh-aware rows of the registry.

The JAX package's ``kernels/collective.py``.  Each projection op gets a
``_tp`` twin registered as an op of its own.  A twin runs its base op's
Hopper kernel (the twin rows change the cost model, not the kernel); its
structural cost prices the sharded execution:

- the weight stream is divided over the tensor-parallel axis (each device
  re-reads only its ``1/T`` slice of the projection weight), and
- a :class:`repro_torch.core.dialect.CollectiveCost` term is added: the
  all-gather (column-parallel) or all-reduce (row-parallel) the sharded
  projection pays, in HBM-equivalent bytes through the dialect's
  interconnect, so that :func:`~repro_torch.core.registry.cost_key` weighs
  it against the saved weight traffic.

Under ``mode="auto"`` with a model axis in the ambient mesh
(:func:`~repro_torch.core.registry.use_mesh_axes` or an entered
``DeviceMesh``) the twin's rows join the base op's candidates and win
exactly when the saved weight bytes exceed the collective's: decode-shaped
GEMMs on a small model axis pick the twin, a large axis (more hops,
thinner shards) the replicated op.  Partitioning:

- ``gemm_tp`` / ``rmsnorm_matmul_tp`` / ``rmsnorm_swiglu_tp``:
  column-parallel, the ``[K, N]`` weight sharded over ``N``, one
  all-gather of the output;
- ``flash_attention_matmul_tp``: row-parallel, heads (and the ``wo`` rows
  they feed) sharded over the axis, one all-reduce of the output.

Every cost model takes the port's ``target=`` (the compile target whose
parameters it reads; the parity tests pass the JAX package's) and prices
the collective on ``plan_dialect``'s interconnect when one is named, else
on ``target``'s.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.core.dialect import (TARGET, Dialect, collective_cost,
                                      dtype_bytes, get_dialect)
from repro_torch.core.primitives import IsaMode
from repro_torch.core.registry import REGISTRY, tp_axis_size
from repro_torch.kernels import fused as _fused
from repro_torch.kernels import gemm as _gemm

#: the tensor-parallel twins this module registers (base name + "_tp")
TP_OPS = ("gemm_tp", "rmsnorm_matmul_tp", "rmsnorm_swiglu_tp",
          "flash_attention_matmul_tp")


def _resolve_tp(tp) -> int:
    """An explicit ``tp=`` wins; None reads the ambient mesh's model axis."""
    if tp is None:
        tp = tp_axis_size()
    return max(1, int(tp))


def _apply_tp(cost: dict, *, kind: str, payload_bytes: int, tp: int,
              ws_full: int, ws_shard: int, plan_dialect: Optional[str],
              target: Dialect) -> dict:
    """Re-price a base cost dict for the sharded execution.

    The weight-stream delta comes off ``hbm_bytes`` and
    ``hbm_bytes_unfused_pair`` alike (both sides of the pair would shard
    the same weight), which keeps ``hbm == pair - saved``; the collective
    lands in the ``collective_*`` columns."""
    delta = max(0, ws_full - ws_shard)
    cost["hbm_bytes"] = cost["hbm_bytes"] - delta
    if "hbm_bytes_unfused_pair" in cost:
        cost["hbm_bytes_unfused_pair"] -= delta
    if "weight_stream_bytes" in cost:
        cost["weight_stream_bytes"] = ws_shard
    dialect = target if plan_dialect is None else get_dialect(plan_dialect)
    cost.update(collective_cost(kind, payload_bytes, tp, dialect).cost_keys())
    cost["tp_axis"] = tp
    return cost


def structural_cost_gemm_tp(m: int, n: int, k: int, mode: str,
                            dtype=torch.float32,
                            plan_dialect: Optional[str] = None,
                            tp: Optional[int] = None,
                            target: Dialect = TARGET) -> dict:
    """Column-parallel GEMM: ``[K, N]`` sharded over N, all-gather of C."""
    tp = _resolve_tp(tp)
    cost = dict(_gemm.structural_cost(m=m, n=n, k=k, mode=mode, dtype=dtype,
                                      plan_dialect=plan_dialect,
                                      target=target))
    itemsize = dtype_bytes(dtype)
    ws_full, rereads = _fused._weight_stream(m, n, k, mode, dtype,
                                             plan_dialect, target)
    ws_shard = k * -(-n // tp) * itemsize * rereads
    return _apply_tp(cost, kind="all_gather", payload_bytes=m * n * itemsize,
                     tp=tp, ws_full=ws_full, ws_shard=ws_shard,
                     plan_dialect=plan_dialect, target=target)


def structural_cost_rmsnorm_matmul_tp(rows: int, d: int, n: int, mode: str,
                                      dtype=torch.float32,
                                      plan_dialect: Optional[str] = None,
                                      tp: Optional[int] = None,
                                      target: Dialect = TARGET) -> dict:
    """Column-parallel fused norm + projection: all-gather of [rows, N]."""
    tp = _resolve_tp(tp)
    cost = dict(_fused.structural_cost_rmsnorm_matmul(
        rows, d, n, mode, dtype=dtype, plan_dialect=plan_dialect,
        target=target))
    itemsize = dtype_bytes(dtype)
    _, rereads = _fused._weight_stream(rows, n, d, mode, dtype, plan_dialect,
                                       target)
    ws_shard = d * -(-n // tp) * itemsize * rereads
    return _apply_tp(cost, kind="all_gather",
                     payload_bytes=rows * n * itemsize, tp=tp,
                     ws_full=cost["weight_stream_bytes"], ws_shard=ws_shard,
                     plan_dialect=plan_dialect, target=target)


def structural_cost_rmsnorm_swiglu_tp(rows: int, d: int, f: int, mode: str,
                                      dtype=torch.float32,
                                      plan_dialect: Optional[str] = None,
                                      tp: Optional[int] = None,
                                      target: Dialect = TARGET) -> dict:
    """Column-parallel fused norm + SwiGLU: the ``[D, 2F]`` concat sharded
    over F (each device keeps matched wi/wg column slices, so the gate
    stays local); all-gather of the gated ``[rows, F]`` output."""
    tp = _resolve_tp(tp)
    cost = dict(_fused.structural_cost_rmsnorm_swiglu(
        rows, d, f, mode, dtype=dtype, plan_dialect=plan_dialect,
        target=target))
    itemsize = dtype_bytes(dtype)
    _, rereads = _fused._weight_stream(rows, 2 * f, d, mode, dtype,
                                       plan_dialect, target)
    ws_shard = d * -(-(2 * f) // tp) * itemsize * rereads
    return _apply_tp(cost, kind="all_gather",
                     payload_bytes=rows * f * itemsize, tp=tp,
                     ws_full=cost["weight_stream_bytes"], ws_shard=ws_shard,
                     plan_dialect=plan_dialect, target=target)


def structural_cost_flash_attention_matmul_tp(
        b: int, h: int, sq: int, skv: int, d: int, n: int, causal: bool,
        mode: str, block_q=None, block_kv=None, dtype=torch.float32,
        plan_dialect: Optional[str] = None, page_size: Optional[int] = None,
        pages_occupied: Optional[int] = None, tp: Optional[int] = None,
        target: Dialect = TARGET) -> dict:
    """Row-parallel fused attention + projection: heads (and the ``wo``
    rows they feed) sharded over the axis, all-reduce of the partial
    ``[B.Sq, N]`` outputs.  Only the weight stream's shard is claimed (the
    per-device K/V stream shrinks with the heads too, but that saving is
    not counted, as the fused ops' ``hbm_bytes_saved`` counts none)."""
    tp = _resolve_tp(tp)
    cost = dict(_fused.structural_cost_flash_attention_matmul(
        b, h, sq, skv, d, n, causal, mode, block_q=block_q,
        block_kv=block_kv, dtype=dtype, plan_dialect=plan_dialect,
        page_size=page_size, pages_occupied=pages_occupied, target=target))
    itemsize = dtype_bytes(dtype)
    _, rereads = _fused._weight_stream(b * sq, n, h * d, mode, dtype,
                                       plan_dialect, target)
    ws_shard = -(-(h * d) // tp) * n * itemsize * rereads
    return _apply_tp(cost, kind="all_reduce",
                     payload_bytes=b * sq * n * itemsize, tp=tp,
                     ws_full=cost["weight_stream_bytes"], ws_shard=ws_shard,
                     plan_dialect=plan_dialect, target=target)


TP_COSTS = {
    "gemm_tp": structural_cost_gemm_tp,
    "rmsnorm_matmul_tp": structural_cost_rmsnorm_matmul_tp,
    "rmsnorm_swiglu_tp": structural_cost_rmsnorm_swiglu_tp,
    "flash_attention_matmul_tp": structural_cost_flash_attention_matmul_tp,
}

# --------------------------------------------------------------------------
# Registration: each twin reuses its base op's impl (the Hopper kernel in
# every mode, the plain version in library) under a contract re-keyed to
# the twin's name and the cost model above; the fallbacks mirror the base
# op's.
# --------------------------------------------------------------------------

for _twin, _cost_fn in TP_COSTS.items():
    _base = _twin[:-len("_tp")]
    for _mode_s in REGISTRY.modes(_base):
        _mode = IsaMode(_mode_s)
        _low = REGISTRY.variant(_base, _mode)
        _contract = (None if _mode is IsaMode.LIBRARY else
                     dataclasses.replace(_low.contract, kernel=_twin))
        REGISTRY.register(_twin, _mode, _low.impl, contract=_contract,
                          cost=functools.partial(_cost_fn, mode=_mode_s))
    for _missing in IsaMode:
        _fb = REGISTRY.fallback_for(_base, _missing)
        if _fb is not None:
            REGISTRY.declare_fallback(_twin, _fb.missing, _fb.to, _fb.reason)
    REGISTRY.register_collective_variant(_base, _twin)
