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
``kernels/_launch.py``).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import (REGISTRY, IsaMode, KernelContract, Primitive,
                              validate_contract)
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


for _mode, _contract in (("abstract", ABSTRACT_CONTRACT),
                         ("abstract+shuffle", SHUFFLE_CONTRACT)):
    REGISTRY.register("rmsnorm", _mode, functools.partial(rmsnorm, mode=_mode),
                      contract=_contract)
REGISTRY.register("rmsnorm", IsaMode.NATIVE, rmsnorm,
                  contract=NATIVE_CONTRACT)
REGISTRY.register("rmsnorm", IsaMode.LIBRARY, rmsnorm_plain)
REGISTRY.declare_fallback(
    "rmsnorm", IsaMode.NATIVE, IsaMode.LIBRARY,
    reason="the native kernel is pinned to its target; the plain norm is "
           "the declared escape")
