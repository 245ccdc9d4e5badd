"""Tiled GEMM (paper Table V, row 1) as a hand-written Hopper kernel in two
modes, both in full f32 on the FMA units.

Replaces the JAX package's ``kernels/gemm.py::gemm`` (source and design
notes in ``csrc/gemm.cu``).  The two modes run the same algorithm (one
output tile per block, a K loop with the accumulator in registers) and
differ in the primitive budget they spend:

- ``abstract``: square tiles sized by the scratchpad budget alone
  (:func:`abstract_block_shape`), no matrix-unit query, plain loads and
  barriers;
- ``native``: tiles aligned to the queried matrix unit and shaped for
  reuse (:func:`native_block_shape`), register blocking and ``cp.async``
  double buffering.

``abstract+shuffle`` has no variant: lane shuffle takes no part in the
contraction, so a request for it takes the declared fallback to
``abstract``, recorded on CPU operands and refused on CUDA ones.

:func:`gemm_plain` repeats the kernel's accumulation (f32, one K tile of
the mode after another) in tensor ops; the wrappers run it on CPU tensors.
On CUDA tensors they launch the kernel or raise.  bf16 operands are
widened to f32 before the kernel (a cast, exact), as the JAX kernel
accumulates them in f32.  Each launch adds one to
``LAUNCHES["gemm_<mode>"]``.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.core import (REGISTRY, TARGET, IsaMode, KernelContract,
                              Primitive, validate_contract)
from repro_torch.kernels import ref as _ref
from repro_torch.kernels._launch import (MODE_CODES, check_device, launch,
                                         stream)

MODES = ("abstract", "native")
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}

ABSTRACT_CONTRACT = KernelContract(
    kernel="gemm", mode=IsaMode.ABSTRACT,
    primitives=frozenset({
        Primitive.LOCKSTEP_GROUP, Primitive.MANAGED_SCRATCHPAD,
        Primitive.HIERARCHICAL_MEMORY, Primitive.WORKGROUP_BARRIER,
        Primitive.IDENTITY_REGISTERS, Primitive.ASYNC_MEMORY,
        Primitive.REGISTER_OCCUPANCY,
    }))
NATIVE_CONTRACT = KernelContract(
    kernel="gemm", mode=IsaMode.NATIVE,
    primitives=frozenset(Primitive),
    native_features=frozenset({"mxu_aligned_tiles", "dimension_semantics",
                               "multi_buffering"}))
CONTRACTS = {"abstract": ABSTRACT_CONTRACT, "native": NATIVE_CONTRACT}
for _c in CONTRACTS.values():
    validate_contract(_c)


def abstract_block_shape() -> Tuple[int, int, int]:
    """Square tile edge from the scratchpad budget alone (no matrix-unit
    query), the JAX package's derivation on the port's target: a quarter
    of the scratchpad (two buffers at an occupancy of two) shared by three
    f32 tiles (A, B, the accumulator), the edge rounded down to the wave
    width.  On Hopper: sqrt(232448 / 4 / 12) = 69 -> 64."""
    budget = TARGET.S // (2 * 2)
    edge = int((budget / (3 * 4)) ** 0.5)
    edge = max(TARGET.W, edge // TARGET.W * TARGET.W)
    return (edge, edge, edge)


def native_block_shape() -> Tuple[int, int, int]:
    """Tiles aligned to the queried matrix unit and shaped for reuse: two
    of its 64-row tiles, half its 256-wide N, its 16-deep K: (128, 128,
    16)."""
    tile_m, tile_n, tile_k = TARGET.matrix_unit.tile
    return (2 * tile_m, tile_n // 2, tile_k)


def block_shape(mode: str) -> Tuple[int, int, int]:
    if mode == "abstract":
        return abstract_block_shape()
    if mode == "native":
        return native_block_shape()
    raise ValueError(f"gemm kernels: {MODES}, got {mode!r}")


def _check_operands(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm takes A [M,K] and B [K,N], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")


def gemm_plain(a: torch.Tensor, b: torch.Tensor, *, mode: str = "native",
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``A @ B`` accumulated in f32 one K tile of ``mode`` after another,
    as the kernel's K loop does."""
    _check_operands(a, b)
    bk = block_shape(mode)[2]
    af, bf = a.float(), b.float()
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32,
                      device=a.device)
    for k0 in range(0, a.shape[1], bk):
        acc += af[:, k0:k0 + bk] @ bf[k0:k0 + bk]
    return acc.to(out_dtype)


def gemm_kernel(a: torch.Tensor, b: torch.Tensor, mode: str,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch the ``mode`` kernel: ``A @ B`` in ``out_dtype``."""
    _check_operands(a, b)
    bm, bn, bk = block_shape(mode)
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"gemm writes float32 or bfloat16, got {out_dtype}")
    for t in (a, b):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"gemm takes float32 or bfloat16, got {t.dtype}")
    dev = check_device(a, b)
    m, k = a.shape
    n = b.shape[1]
    if 0 in (m, n, k):
        return torch.zeros(m, n, dtype=out_dtype, device=dev)
    a = a.float().contiguous()
    b = b.float().contiguous()
    out = torch.empty(m, n, dtype=out_dtype, device=dev)
    launch("gemm", MODE_CODES[mode], _OUT_CODES[out_dtype], a.data_ptr(),
           b.data_ptr(), out.data_ptr(), m, n, k, bm, bn, bk, stream(dev),
           count_as=f"gemm_{mode}")
    return out


def gemm(a: torch.Tensor, b: torch.Tensor, *, mode: str = "native",
         out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """C[M,N] = A[M,K] @ B[K,N] with f32 accumulation.  CPU tensors run the
    plain version."""
    if not a.is_cuda:
        return gemm_plain(a, b, mode=mode, out_dtype=out_dtype)
    return gemm_kernel(a, b, mode, out_dtype)


def launch_params(mode: str, m: int, n: int, k: int) -> dict:
    """The launch of one call, as the kernel runs it."""
    bm, bn, bk = block_shape(mode)
    return dict(grid=[-(-n // bn), -(-m // bm)], block=256,
                tile=[bm, bn, bk],
                per_thread="8x8" if mode == "native" else "4x4",
                loads="cp.async, double-buffered" if mode == "native"
                else "plain loads + barriers")


REGISTRY.register("gemm", IsaMode.ABSTRACT,
                  functools.partial(gemm, mode="abstract"),
                  contract=ABSTRACT_CONTRACT)
REGISTRY.register("gemm", IsaMode.NATIVE,
                  functools.partial(gemm, mode="native"),
                  contract=NATIVE_CONTRACT)
REGISTRY.register("gemm", IsaMode.LIBRARY, _ref.gemm)
REGISTRY.declare_fallback(
    "gemm", IsaMode.ABSTRACT_SHUFFLE, IsaMode.ABSTRACT,
    reason="lane shuffle does not participate in the contraction")
