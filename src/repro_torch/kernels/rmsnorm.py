"""RMSNorm as a hand-written Hopper kernel.

:func:`rmsnorm` replaces the Pallas kernel ``kernels/rmsnorm.py::rmsnorm``
of the JAX package (``_rmsnorm_kernel`` over ``normalize_block``):
``x * rsqrt(mean(x^2) + eps) * w`` over the last axis, in f32, the result
in x's dtype (``csrc/rmsnorm.cu``, sharing the row code of
``csrc/row_norm.cuh`` with the add_rmsnorm kernel: each row held in
registers and read once, or, past the registers, one warp a row in two
passes; the C entry decides and reports the route, ``LAST_ROUTE``).

Beside the wrapper is its plain PyTorch version (:func:`rmsnorm_plain`).
The wrapper runs the plain version on CPU tensors; on CUDA tensors it
launches the kernel or raises.  The op registers the JAX package's
lowerings: ``abstract``, ``abstract+shuffle`` and ``native`` (the kernel,
``mode``; only the loads and the moment's cross-lane stage change: a
shared-memory tree with the moment re-staged, or the warp butterfly,
over element loads, or native's vector loads) and ``library`` (the plain
version, which is ``kernels/ref.py::rmsnorm``).  Like the JAX package it
declares no ``abstract+shuffle -> abstract`` fallback.  Each launch adds
one to ``LAUNCHES["rmsnorm"]`` (``rmsnorm_<mode>`` outside native;
``kernels/_launch.py``).  :func:`structural_cost` is the JAX package's
model of the moment's scratch traffic, for a compile target's wave width.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.core import (REGISTRY, TARGET, Dialect, IsaMode,
                              KernelContract, Primitive, dtype_bytes,
                              register_op_space, tuned_plan,
                              validate_contract)
from repro_torch.core.shuffle import scratch_tree_bytes, tree_stages
from repro_torch.kernels._launch import (MODE_CODES, check_device,
                                         check_mode, count_name, dtype_code,
                                         launch, stream)
from repro_torch.kernels.fused import row_norm_mode

#: the JAX package's contracts (its kernels/rmsnorm.py), field by field
ABSTRACT_CONTRACT = KernelContract(
    kernel="rmsnorm", mode=IsaMode.ABSTRACT,
    primitives=frozenset({
        Primitive.LOCKSTEP_GROUP, Primitive.MANAGED_SCRATCHPAD,
        Primitive.WORKGROUP_BARRIER, Primitive.HIERARCHICAL_MEMORY,
        Primitive.IDENTITY_REGISTERS, Primitive.ASYNC_MEMORY}))
SHUFFLE_CONTRACT = KernelContract(
    kernel="rmsnorm", mode=IsaMode.ABSTRACT_SHUFFLE,
    primitives=ABSTRACT_CONTRACT.primitives | {Primitive.LANE_SHUFFLE})
NATIVE_CONTRACT = KernelContract(
    kernel="rmsnorm", mode=IsaMode.NATIVE, primitives=frozenset(Primitive),
    native_features=frozenset({"fused_epilogue", "dimension_semantics",
                               "multi_buffering"}))
for _c in (ABSTRACT_CONTRACT, SHUFFLE_CONTRACT, NATIVE_CONTRACT):
    validate_contract(_c)

#: the JAX plan's latency cap (its tuning space's)
_MAX_BLOCK_ROWS = 64
register_op_space("rmsnorm", "rowwise", max_block_rows=_MAX_BLOCK_ROWS)


def rmsnorm_plain(x, weight, *, eps: float = 1e-6, mode: str = "native"):
    """``x * rsqrt(mean(x^2) + eps) * weight`` in f32, in x's dtype, the
    moment folded as the kernel folds it in ``mode``
    (``fused.row_norm_mode``)."""
    return row_norm_mode(x, weight, eps, mode)


def rmsnorm(x, weight, *, eps: float = 1e-6, mode: str = "native"):
    """RMSNorm over the last axis in one kernel: each row read once into
    registers (the widest in two passes), the moment's cross-lane stage
    in ``mode``.

    x: [..., D]; weight: [D] -> [..., D] in x.dtype.  CPU tensors run the
    plain version of ``mode``."""
    if not x.is_cuda:
        return rmsnorm_plain(x, weight, eps=eps, mode=mode)
    dev = check_device(x, weight)
    code = dtype_code(x, weight)
    d = x.shape[-1]
    if weight.shape != (d,):
        raise ValueError(f"rmsnorm: x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)}")
    x2 = x.reshape(-1, d).contiguous()
    out = torch.empty_like(x2)
    weight = weight.contiguous()
    if x2.shape[0]:
        launch("rmsnorm", MODE_CODES[check_mode(mode)], code,
               x2.data_ptr(), weight.data_ptr(), out.data_ptr(),
               x2.shape[0], d, float(eps), stream(dev),
               count_as=count_name("rmsnorm", mode))
    return out.reshape(x.shape)


def structural_cost(rows: int, d: int, mode: str, dtype=torch.float32,
                    plan_dialect: Optional[str] = None,
                    target: Dialect = TARGET) -> dict:
    """Scratch-traffic delta of the moment reduction (the JAX package's
    model): HBM traffic is the same in every mode; the abstract moment
    pays log2(W) scratch round trips plus its re-stage, the shuffle mode
    log2(W) lane shuffles, native a fused reduce.  Rows are padded to
    ``target``'s wave width outside native."""
    lanes = target.W
    itemsize = dtype_bytes(dtype)
    d_padded = d if mode == "native" else d + ((-d) % lanes)
    plan = tuned_plan("rmsnorm", rows, d_padded * itemsize,
                      mode=mode if mode != "library" else "native",
                      dialect=plan_dialect, max_block_rows=_MAX_BLOCK_ROWS,
                      semantics=("parallel",))
    blocks = plan.grid[0]
    if mode == "abstract":
        round_trips = tree_stages(lanes) + 1   # tree + moment re-stage
        scratch_bytes = blocks * (
            scratch_tree_bytes(lanes, rows=plan.block_rows)
            + 3 * plan.block_rows * 4)         # moment store + 2 reloads
    else:
        round_trips = 0
        scratch_bytes = 0
    return {
        "hbm_bytes": rows * d * itemsize * 2 + d * itemsize,
        "scratch_round_trips_per_block": round_trips,
        "scratch_bytes_total": scratch_bytes,
        "lane_shuffles_per_block": tree_stages(lanes)
        if mode == "abstract+shuffle" else 0,
        "blocks": blocks,
        "block_rows": plan.block_rows,
        "pipeline_occupancy": plan.occupancy,
        "fused_epilogue": mode in ("native", "library"),
    }


for _mode, _contract in (("abstract", ABSTRACT_CONTRACT),
                         ("abstract+shuffle", SHUFFLE_CONTRACT)):
    REGISTRY.register("rmsnorm", _mode, functools.partial(rmsnorm, mode=_mode),
                      contract=_contract,
                      cost=functools.partial(structural_cost, mode=_mode))
REGISTRY.register("rmsnorm", IsaMode.NATIVE, rmsnorm,
                  contract=NATIVE_CONTRACT,
                  cost=functools.partial(structural_cost, mode="native"))
REGISTRY.register("rmsnorm", IsaMode.LIBRARY, rmsnorm_plain,
                  cost=functools.partial(structural_cost, mode="library"))
REGISTRY.declare_fallback(
    "rmsnorm", IsaMode.NATIVE, IsaMode.LIBRARY,
    reason="the native kernel is pinned to its target; the plain norm is "
           "the declared escape")
