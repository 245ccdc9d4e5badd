"""Tiled GEMM (paper Table V, row 1) as a hand-written Hopper kernel in two
modes, both at f32 accuracy on the tensor cores (3xTF32).

Replaces the JAX package's ``kernels/gemm.py::gemm`` (source and design
notes in ``csrc/gemm.cu``).  The two modes run the same algorithm (one
output tile per block, a K loop with the accumulator in registers, every
element split into two TF32 halves and each product taken as three TF32
products, the small terms first, summed per K tile and added to the f32
accumulator) and differ in the primitive budget they spend:

- ``abstract``: square tiles sized by the scratchpad budget alone
  (:func:`abstract_block_shape`), no matrix-unit query, ``mma.sync`` fed
  by ``cp.async`` into two buffers;
- ``native``: tiles aligned to the queried matrix unit and shaped for
  reuse (:func:`native_block_shape`), ``wgmma`` fed by a four-stage TMA
  ring (4-byte ``cp.async`` where the operands' rows or bases do not allow
  TMA, :func:`copy_bytes`).

``abstract+shuffle`` has no variant: lane shuffle takes no part in the
contraction, so a request for it takes the declared fallback to
``abstract``, recorded on CPU operands and refused on CUDA ones.

:func:`gemm_plain` repeats the kernel's arithmetic in tensor ops: the
split (:func:`split_tf32`), then the three products of each K tile of
the mode, accumulated in f32; the wrappers run it on CPU tensors.  On
CUDA tensors they launch the kernel or raise.  bf16 operands are widened
to f32 before the kernel (a cast, exact; their low halves are 0), as the
JAX kernel accumulates them in f32.  Each launch adds one to
``LAUNCHES["gemm_<mode>"]``.

:func:`structural_cost` is the JAX package's tiled-GEMM traffic model (A
re-read ``ceil(N / bn)`` times, B ``ceil(M / bm)`` times), ranked by
``auto`` and composed by the fused norm-GEMM costs.  Its tiles come from
:func:`block_shape_for` (the tuning table, then the JAX package's rules
on the compile target: :func:`modeled_abstract_block_shape`,
:func:`modeled_native_block_shape`); they model the JAX lowerings and are
not the Hopper kernels' own tiles (:func:`block_shape`).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.core import (REGISTRY, TARGET, Dialect, IsaMode,
                              KernelContract, Primitive, choose_block_bytes,
                              dtype_bytes, register_op_space, tuned_block,
                              validate_contract)
from repro_torch.kernels import ref as _ref
from repro_torch.kernels._launch import (MODE_CODES, check_device, entry,
                                         launch, stream)

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

register_op_space("gemm", "gemm")


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
    of its 64-row tiles, half its 256-wide N, two of its 16-deep K steps
    (32 f32: 128-byte rows): (128, 128, 32)."""
    tile_m, tile_n, tile_k = TARGET.matrix_unit.tile
    return (2 * tile_m, tile_n // 2, 2 * tile_k)


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


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds: on the int32 view,
    ``(bits + 0x1000) & ~0x1fff``."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)``, both TF32: ``hi = round_tf32(x)``, ``lo = x - hi``
    (exact in f32) truncated to TF32 (``bits & ~0x1fff``), so that a NaN
    in ``x - hi`` stays one.  ``hi + lo`` keeps a finite ``|x|`` below
    0x7f7ff000 to 2^-21; every other ``x`` leaves ``hi`` inf or ``lo``
    NaN (``csrc/gemm.cu::split_tf32``)."""
    x = x.float()
    hi = round_tf32(x)
    lo = ((x - hi).contiguous().view(torch.int32) & ~0x1FFF).view(
        torch.float32)
    return hi, lo


def gemm_plain(a: torch.Tensor, b: torch.Tensor, *, mode: str = "native",
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``A @ B`` as the kernel computes it: both operands split into TF32
    halves; for each K tile of ``mode``, ``lo.hi``, ``hi.lo`` and
    ``hi.hi`` added in that order into the tile's partial sum, which is
    then added to the f32 accumulator.  An output that comes out inf or
    NaN (an inf, a NaN or an ``|x|`` near FLT_MAX reached it) is the plain
    product's instead, as the kernel sums it again in f32 (here in
    float64, rounded to f32)."""
    _check_operands(a, b)
    bk = block_shape(mode)[2]
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32,
                      device=a.device)
    for k0 in range(0, a.shape[1], bk):
        ks = slice(k0, k0 + bk)
        part = a_lo[:, ks] @ b_hi[ks]
        part += a_hi[:, ks] @ b_lo[ks]
        part += a_hi[:, ks] @ b_hi[ks]
        acc += part
    bad = ~torch.isfinite(acc)
    if bool(bad.any()):
        exact = (a.double() @ b.double()).float()
        acc = torch.where(bad, exact, acc)
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


def copy_bytes(a: torch.Tensor, b: torch.Tensor) -> int:
    """How the kernels copy these CUDA operands (f32, contiguous, as
    :func:`gemm_kernel` hands them on), as the library decides it: 16 when
    K and N are multiples of 4 and both bases 16-byte aligned (native:
    TMA; abstract: 16-byte ``cp.async``), else 4 (4-byte ``cp.async``)."""
    return int(entry("gemm_copy_bytes")(a.data_ptr(), b.data_ptr(),
                                        b.shape[1], a.shape[1]))


def launch_params(mode: str, m: int, n: int, k: int) -> dict:
    """The launch of one call, as the kernel runs it (aligned operands)."""
    bm, bn, bk = block_shape(mode)
    out = dict(grid=[-(-n // bn), -(-m // bm)], tile=[bm, bn, bk],
               products="3 TF32 MMAs a fragment pair (lo.hi, hi.lo, hi.hi)")
    if mode == "native":
        # four stages of A [128][32] and B [32][136] (each rounded up to
        # 1 KB), two lo tiles of A, an mbarrier a stage, 1 KB to align
        stage_bytes = (bm * bk + bk * (bn + 8)) * 4
        stage = -(-stage_bytes // 1024) * 1024
        return dict(out, block=256, mma="wgmma m64n128k8 (C^T = B^T A^T)",
                    stages=4, smem_bytes=1024 + 4 * stage + 2 * bm * bk * 4
                    + 4 * 8,
                    loads="TMA ring (4-byte cp.async when unaligned)")
    return dict(out, block=128, mma="mma.sync m16n8k8, 32x32 a warp",
                stages=2, smem_bytes=2 * (bm * (bk + 4) + bk * (bn + 8)) * 4,
                loads="cp.async 16 B (4 B when unaligned), two buffers")


# --------------------------------------------------------------------------
# The structural cost model (the JAX package's)
# --------------------------------------------------------------------------


def modeled_abstract_block_shape(dtype=torch.float32,
                                 target: Dialect = TARGET
                                 ) -> Tuple[int, int, int]:
    """The JAX package's ``abstract_block_shape`` on ``target``: a square
    edge from the scratchpad budget alone (three tiles, double-buffered at
    an occupancy of two), rounded down to its 128 granule: (128, 128, 128)
    on Hopper, whose 227 KB give an edge of 69 before the floor."""
    itemsize = dtype_bytes(dtype)
    budget = choose_block_bytes(target.S, target, n_buffers=2,
                                min_occupancy=2)
    edge = int((budget / (3 * max(itemsize, 4))) ** 0.5)
    edge = max(128, (edge // 128) * 128)
    return (edge, edge, edge)


def modeled_native_block_shape(dtype=torch.float32,
                               target: Dialect = TARGET
                               ) -> Tuple[int, int, int]:
    """The JAX package's ``native_block_shape`` on ``target``: four matrix
    tiles by four by two, (256, 1024, 32) for Hopper's (64, 256, 16)."""
    del dtype
    tile_m, tile_n, tile_k = target.matrix_unit.tile
    return (4 * tile_m, 4 * tile_n, 2 * tile_k)


def block_shape_for(mode: str, m: int, n: int, k: int, dtype=torch.float32,
                    plan_dialect: Optional[str] = None,
                    target: Dialect = TARGET) -> Tuple[int, int, int]:
    """The modelled (bm, bn, bk) of one call: the tuning table's winner
    (the ``plan_dialect`` slice), else the rule of ``mode`` on
    ``target``."""
    tuned = tuned_block("gemm", mode, m, n, k, dialect=plan_dialect)
    if tuned is not None:
        return tuned
    if mode == "native":
        return modeled_native_block_shape(dtype, target)
    return modeled_abstract_block_shape(dtype, target)


def structural_cost(m: int, n: int, k: int, mode: str, dtype=torch.float32,
                    plan_dialect: Optional[str] = None,
                    target: Dialect = TARGET) -> dict:
    """Modeled HBM traffic + FLOPs (the JAX package's model): A re-read
    ``N / bn`` times, B ``M / bm`` times, C written once in f32."""
    itemsize = dtype_bytes(dtype)
    if mode == "library":
        bm = bn = bk = 512  # the JAX model's indicative library tiling
    else:
        bm, bn, bk = block_shape_for(mode, m, n, k, dtype, plan_dialect,
                                     target)
    n_reads_a = max(1, -(-n // bn))
    n_reads_b = max(1, -(-m // bm))
    hbm_bytes = (m * k * itemsize * n_reads_a
                 + k * n * itemsize * n_reads_b
                 + m * n * 4)
    mxu_tile = target.matrix_unit.tile[0]
    pad = lambda d, b: -(-d // b) * b  # noqa: E731
    padded_flops = 2 * pad(m, bm) * pad(n, bn) * pad(k, bk)
    return {
        "flops": 2 * m * n * k,
        "padded_flops": padded_flops,
        "hbm_bytes": int(hbm_bytes),
        "block": (bm, bn, bk),
        "mxu_aligned": (bm % mxu_tile == 0 and bn % mxu_tile == 0
                        and bk % mxu_tile == 0),
        "vmem_working_set": (bm * bk + bk * bn) * itemsize + bm * bn * 4,
    }


REGISTRY.register("gemm", IsaMode.ABSTRACT,
                  functools.partial(gemm, mode="abstract"),
                  contract=ABSTRACT_CONTRACT,
                  cost=functools.partial(structural_cost, mode="abstract"))
REGISTRY.register("gemm", IsaMode.NATIVE,
                  functools.partial(gemm, mode="native"),
                  contract=NATIVE_CONTRACT,
                  cost=functools.partial(structural_cost, mode="native"))
REGISTRY.register("gemm", IsaMode.LIBRARY, _ref.gemm,
                  cost=functools.partial(structural_cost, mode="library"))
REGISTRY.declare_fallback(
    "gemm", IsaMode.ABSTRACT_SHUFFLE, IsaMode.ABSTRACT,
    reason="lane shuffle does not participate in the contraction")
