"""RMSNorm as a hand-written Hopper kernel.

:func:`rmsnorm` replaces the Pallas kernel ``kernels/rmsnorm.py::rmsnorm``
of the JAX package (``_rmsnorm_kernel`` over ``normalize_block``):
``x * rsqrt(mean(x^2) + eps) * w`` over the last axis, in f32, the result
in x's dtype (``csrc/rmsnorm.cu``, sharing the row code of
``csrc/row_norm.cuh`` with the add_rmsnorm kernel).

Beside the wrapper is its plain PyTorch version (:func:`rmsnorm_plain`).
The wrapper runs the plain version on CPU tensors; on CUDA tensors it
launches the kernel or raises.  Each launch adds one to
``LAUNCHES["rmsnorm"]`` (``kernels/_launch.py``).  The op registers a
``native`` lowering (the kernel) and a ``library`` lowering (the plain
version, which is ``kernels/ref.py::rmsnorm``); the ``abstract`` pair
comes with ROADMAP A.9.
"""
from __future__ import annotations

import torch

from repro_torch.core import (REGISTRY, IsaMode, KernelContract, Primitive,
                              validate_contract)
from repro_torch.kernels import ref as _ref
from repro_torch.kernels._launch import (check_device, dtype_code, launch,
                                         stream)

NATIVE_CONTRACT = KernelContract(
    kernel="rmsnorm", mode=IsaMode.NATIVE, primitives=frozenset(Primitive),
    native_features=frozenset({"fused_epilogue", "dimension_semantics",
                               "multi_buffering"}))
validate_contract(NATIVE_CONTRACT)


def rmsnorm_plain(x, weight, *, eps: float = 1e-6):
    """``x * rsqrt(mean(x^2) + eps) * weight`` in f32, in x's dtype."""
    return _ref.rmsnorm(x, weight, eps)


def rmsnorm(x, weight, *, eps: float = 1e-6):
    """RMSNorm over the last axis in one kernel: one warp per row.

    x: [..., D]; weight: [D] -> [..., D] in x.dtype.  CPU tensors run the
    plain version."""
    if not x.is_cuda:
        return rmsnorm_plain(x, weight, eps=eps)
    dev = check_device(x, weight)
    code = dtype_code(x, weight)
    d = x.shape[-1]
    if weight.shape != (d,):
        raise ValueError(f"rmsnorm: x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)}")
    x2 = x.reshape(-1, d).contiguous()
    out = torch.empty_like(x2)
    if x2.shape[0]:
        launch("rmsnorm", code, x2.data_ptr(), weight.contiguous().data_ptr(),
               out.data_ptr(), x2.shape[0], d, float(eps), stream(dev))
    return out.reshape(x.shape)


REGISTRY.register("rmsnorm", IsaMode.NATIVE, rmsnorm,
                  contract=NATIVE_CONTRACT)
REGISTRY.register("rmsnorm", IsaMode.LIBRARY, rmsnorm_plain)
REGISTRY.declare_fallback(
    "rmsnorm", IsaMode.NATIVE, IsaMode.LIBRARY,
    reason="the native kernel is pinned to its target; the plain norm is "
           "the declared escape")
