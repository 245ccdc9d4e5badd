"""Histogram (paper Table V, row 3): the atomic-contention benchmark, as a
hand-written Hopper kernel in three modes.

Replaces the JAX package's ``kernels/histogram.py::histogram`` (source and
design notes in ``csrc/histogram.cu``).  The TPU has no atomics, so the JAX
modes privatise and reduce; Hopper has them, which restores the paper's
own CUDA pair:

- ``abstract``: one shared-memory histogram per block, every value a
  shared ``atomicAdd`` (ATOMIC_RMW is in the abstract contract);
- ``abstract+shuffle``: no shared atomics: private 16-bit counts per lane
  (a ``[bins][32]`` column table per warp), each bin's 32 lane counts
  summed by the warp's xor tree (LANE_SHUFFLE), the JAX mode's per-row
  privates merged by the rotate tree;
- ``native``: one shared-memory histogram per warp, merged at the end of
  the block, with 16-byte loads, four in flight.

Blocks add their counts into the output with int32 ``atomicAdd``, exact
in any order.  Values are clipped into ``[0, num_bins)``, not dropped.

:func:`histogram_plain` repeats the kernels' arithmetic in tensor ops
(private counts per block, per lane or per warp, summed); the wrappers
run it on CPU tensors.  On CUDA tensors they launch the kernel or raise.  Each
launch adds one to ``LAUNCHES["histogram_<mode>"]``.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import (REGISTRY, TARGET, IsaMode, KernelContract,
                              Primitive, validate_contract)
from repro_torch.kernels import ref as _ref
from repro_torch.kernels._launch import MODE_CODES, check_device, launch, stream

#: threads per block (``kHistThreads`` in csrc/histogram.cu)
THREADS = 256
WARPS = THREADS // 32
#: values per block, as the reduction's
TILE = 512 * 128
MODES = ("abstract", "abstract+shuffle", "native")

_ATOMIC_LOWERING = frozenset({
    Primitive.LOCKSTEP_GROUP, Primitive.MASKED_DIVERGENCE,
    Primitive.MANAGED_SCRATCHPAD, Primitive.WORKGROUP_BARRIER,
    Primitive.HIERARCHICAL_MEMORY, Primitive.IDENTITY_REGISTERS,
    Primitive.ASYNC_MEMORY, Primitive.ATOMIC_RMW,
})
ABSTRACT_CONTRACT = KernelContract(
    kernel="histogram", mode=IsaMode.ABSTRACT, primitives=_ATOMIC_LOWERING)
SHUFFLE_CONTRACT = KernelContract(
    kernel="histogram", mode=IsaMode.ABSTRACT_SHUFFLE,
    primitives=_ATOMIC_LOWERING | {Primitive.LANE_SHUFFLE})
NATIVE_CONTRACT = KernelContract(
    kernel="histogram", mode=IsaMode.NATIVE,
    primitives=frozenset(Primitive),
    native_features=frozenset({"mxu_aligned_tiles", "dimension_semantics",
                               "multi_buffering"}))
CONTRACTS = {"abstract": ABSTRACT_CONTRACT,
             "abstract+shuffle": SHUFFLE_CONTRACT,
             "native": NATIVE_CONTRACT}
for _c in CONTRACTS.values():
    validate_contract(_c)


def _copies(mode: str) -> int:
    """Private histograms per block: one, one per lane, or one per warp."""
    if mode not in MODES:
        raise ValueError(f"unknown histogram mode {mode!r}; modes: {MODES}")
    return {"abstract": 1, "abstract+shuffle": THREADS,
            "native": WARPS}[mode]


def _smem_per_bin(mode: str) -> int:
    """Shared-memory bytes per bin: int32 copies, or, abstract+shuffle,
    a 16-bit column per lane and an int32 sum per warp."""
    if mode == "abstract+shuffle":
        return WARPS * (32 * 2 + 4)
    return 4 * _copies(mode)


def max_bins(mode: str) -> int:
    """The most bins the ``mode`` kernel takes: its private counts fit the
    shared memory a block may have."""
    return TARGET.S // _smem_per_bin(mode)


def histogram_plain(values: torch.Tensor, num_bins: int = 256, *,
                    mode: str = "native") -> torch.Tensor:
    """int32 counts of ``values`` clipped into ``[0, num_bins)``, as the
    kernel counts them: private counts per block (``abstract``), per lane
    (``abstract+shuffle``: value ``i`` of a block on thread ``i % 256``) or
    per warp (``native``: value ``i`` of a block to the warp whose thread
    loads its 4-value vector), then summed."""
    copies = _copies(mode)
    v = values.reshape(-1).to(torch.int64).clamp(0, num_bins - 1)
    n = v.numel()
    i = torch.arange(n, device=v.device)
    owner = i // TILE * copies
    if mode == "abstract+shuffle":
        owner = owner + (i % TILE) % THREADS
    elif mode == "native":  # 4-value vectors, vector j on thread j % 256
        owner = owner + (i % TILE) // 4 % THREADS // 32
    blocks = max(1, -(-n // TILE))
    private = torch.bincount(owner * num_bins + v,
                             minlength=blocks * copies * num_bins)
    return private.reshape(-1, num_bins).sum(dim=0).to(torch.int32)


def histogram_kernel(values: torch.Tensor, num_bins: int,
                     mode: str) -> torch.Tensor:
    """Launch the ``mode`` kernel.  Values of another integer dtype are
    cast to int32 first, as the JAX kernel does."""
    if values.is_floating_point() or values.is_complex():
        raise TypeError(f"histogram takes integer values, got {values.dtype}")
    if not 1 <= num_bins <= max_bins(mode):
        raise ValueError(f"histogram [{mode}] takes 1 to {max_bins(mode)} "
                         f"bins, got {num_bins}")
    dev = check_device(values)
    v = values.reshape(-1).to(torch.int32).contiguous()
    out = torch.empty(num_bins, dtype=torch.int32, device=dev)
    launch("histogram", MODE_CODES[mode], v.data_ptr(), v.numel(), TILE,
           num_bins, out.data_ptr(), stream(dev),
           count_as=f"histogram_{mode}")
    return out


def histogram(values: torch.Tensor, num_bins: int = 256, *,
              mode: str = "native") -> torch.Tensor:
    """int32 counts of ``values`` clipped into ``[0, num_bins)``.  CPU
    tensors run the plain version."""
    if not values.is_cuda:
        return histogram_plain(values, num_bins, mode=mode)
    return histogram_kernel(values, num_bins, mode)


def launch_params(mode: str, n: int, num_bins: int) -> dict:
    """The launch of one call, as the kernel runs it."""
    return dict(grid=-(-n // TILE), block=THREADS, tile=TILE,
                private_histograms=_copies(mode),
                smem_bytes=_smem_per_bin(mode) * num_bins,
                loads="16-byte vectors, 4 in flight" if mode == "native"
                else "one value")


for _mode in MODES:
    REGISTRY.register("histogram", _mode,
                      functools.partial(histogram, mode=_mode),
                      contract=CONTRACTS[_mode])
REGISTRY.register("histogram", IsaMode.LIBRARY, _ref.histogram)
