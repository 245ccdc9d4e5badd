"""Histogram (paper Table V, row 3): the atomic-contention benchmark, as a
hand-written Hopper kernel in three modes.

Replaces the JAX package's ``kernels/histogram.py::histogram`` (source and
design notes in ``csrc/histogram.cu``).  The TPU has no atomics, so the JAX
modes privatise and reduce; Hopper has them, which restores the paper's
own CUDA pair.  Every mode walks the values the same way: a persistent
grid (the resident blocks, :func:`launch_params`), block ``b`` taking
tiles ``b, b + grid, ...`` of :data:`TILE` values, each thread loading its
:data:`LOADS` values of a tile before it counts them:

- ``abstract``: one shared-memory histogram per block, every value a
  shared ``atomicAdd`` (ATOMIC_RMW is in the abstract contract);
- ``abstract+shuffle``: no shared atomics: private 8-bit counts per lane
  (a ``[bins][32]`` byte table per warp), flushed every
  :data:`FLUSH_TILES` tiles, before any can pass 255: each bin's 32 lane
  counts summed by the warp's xor tree (LANE_SHUFFLE), two 16-bit counts
  a word, into 32-bit per-warp sums; the JAX mode's per-row privates
  merged by the rotate tree;
- ``native``: one shared-memory histogram per warp, merged at the end of
  the block, with 16-byte loads where the base is 16-byte aligned.

Blocks add their counts into the output with int32 ``atomicAdd``, exact
in any order.  Values are clipped into ``[0, num_bins)``, not dropped.

:func:`histogram_plain` is the clipped ``bincount``: the counts are
exact integers, so however a mode assigns the values to private copies,
their sum is the same (``tests/test_torch_histogram_numerics.py`` emulates
abstract+shuffle's walk and flushes against it).  The wrappers run it on
CPU tensors.  On CUDA tensors they launch the kernel or raise.  Each
launch adds one to ``LAUNCHES["histogram_<mode>"]``.

:func:`structural_cost` is the JAX package's model of its privatize +
reduce lowerings (private copies, the abstract tree's scratch round trips
across a block's elements), evaluated for a compile target's wave width;
``auto`` ranks the modes by it.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.core import (REGISTRY, TARGET, Dialect, IsaMode,
                              KernelContract, Primitive, register_op_space,
                              tuned_plan, validate_contract)
from repro_torch.core.shuffle import scratch_tree_bytes, tree_stages
from repro_torch.kernels import ref as _ref
from repro_torch.kernels._launch import (MODE_CODES, check_device, entry,
                                         launch, stream)

# Mirrors of csrc/histogram.cu's constants, not read from the library
# (tests/test_torch_histogram_numerics.py holds them to the source):
#: threads per block (``kHistThreads``)
THREADS = 256
WARPS = THREADS // 32
#: values a thread loads before it counts them, and a tile: the values a
#: block takes at a time (``kHistLoads``, ``kHistTile``)
LOADS = 16
TILE = THREADS * LOADS
#: abstract+shuffle's tiles between flushes: at most 240 values a lane, so
#: its 8-bit lane counts never pass 255 (``kFlushTiles``)
FLUSH_TILES = 255 // LOADS
MODES = ("abstract", "abstract+shuffle", "native")
#: the JAX plan's cap, 32 rows of a wave a step (its tuning space's)
_MAX_BLOCK_ROWS = 32
register_op_space("histogram", "rowwise", max_block_rows=_MAX_BLOCK_ROWS,
                  pow2_blocks=True)

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


def smem_bytes(mode: str, num_bins: int) -> int:
    """A block's shared memory: int32 copies, or, abstract+shuffle, a
    warp's table of 8-bit lane counts and its int32 sums, both over the
    bins rounded up to 4 (a lane's 32-bit word holds four)."""
    if mode == "abstract+shuffle":
        return -(-num_bins // 4) * 4 * WARPS * (32 + 4)
    return 4 * _copies(mode) * num_bins


def max_bins(mode: str) -> int:
    """The most bins the ``mode`` kernel takes: its private counts fit the
    shared memory a block may have."""
    return TARGET.S // smem_bytes(mode, 4) * 4 \
        if mode == "abstract+shuffle" else TARGET.S // smem_bytes(mode, 1)


def histogram_plain(values: torch.Tensor, num_bins: int = 256, *,
                    mode: str = "native") -> torch.Tensor:
    """int32 counts of ``values`` clipped into ``[0, num_bins)``: what
    every mode's kernel counts (its private copies sum to these exact
    integers)."""
    _copies(mode)                                   # a known mode
    v = values.reshape(-1).to(torch.int64).clamp(0, num_bins - 1)
    return torch.bincount(v, minlength=num_bins).to(torch.int32)


def histogram_kernel(values: torch.Tensor, num_bins: int,
                     mode: str) -> torch.Tensor:
    """Launch the ``mode`` kernel.  Values of another integer dtype are
    cast to int32 first, as the JAX kernel does."""
    if values.is_floating_point() or values.is_complex():
        raise TypeError(f"histogram takes integer values, got {values.dtype}")
    if not 1 <= num_bins <= max_bins(mode):
        raise ValueError(f"histogram [{mode}] takes 1 to {max_bins(mode)} "
                         f"bins, got {num_bins}")
    dev = check_device("histogram", values)
    v = values.reshape(-1).to(torch.int32).contiguous()
    out = torch.empty(num_bins, dtype=torch.int32, device=dev)
    launch("histogram", MODE_CODES[mode], v.data_ptr(), v.numel(), num_bins,
           out.data_ptr(), stream(dev), count_as=f"histogram_{mode}")
    return out


def histogram(values: torch.Tensor, num_bins: int = 256, *,
              mode: str = "native") -> torch.Tensor:
    """int32 counts of ``values`` clipped into ``[0, num_bins)``.  CPU
    tensors run the plain version."""
    if not values.is_cuda:
        return histogram_plain(values, num_bins, mode=mode)
    return histogram_kernel(values, num_bins, mode)


def launch_params(mode: str, n: int, num_bins: int,
                  values: torch.Tensor | None = None) -> dict:
    """The launch of one call, as the kernel runs it.  The grid is the
    card's resident blocks (or the tiles, where fewer): given ``values`` on
    a card, the library's (``uisa_histogram_grid``), else a description.
    ``tile`` and ``flush_tiles`` are this module's mirrors of the kernel's
    constants (:data:`TILE`, :data:`FLUSH_TILES`)."""
    grid = "resident blocks"
    if values is not None and values.is_cuda and n > 0:
        grid = int(entry("histogram_grid")(MODE_CODES[mode], n, num_bins))
    loads = ("16-byte vectors, 4 a thread in flight (ld.global.cs)"
             if mode == "native" else
             f"one value, {LOADS} a thread in flight (ld.global.cs)")
    return dict(grid=grid, block=THREADS, tile=TILE,
                private_histograms=_copies(mode),
                smem_bytes=smem_bytes(mode, num_bins), loads=loads,
                flush_tiles=FLUSH_TILES if mode == "abstract+shuffle"
                else None)


def _plan(rows: int, mode: str, plan_dialect, target: Dialect):
    # pow2 blocks: the abstract tree runs across the block's elements
    return tuned_plan("histogram", rows, target.W * 4, mode=mode,
                      dialect=plan_dialect,
                      max_block_rows=_MAX_BLOCK_ROWS,
                      pow2_blocks=True, semantics=("arbitrary",))


def structural_cost(n: int, num_bins: int, mode: str,
                    plan_dialect: Optional[str] = None,
                    target: Dialect = TARGET) -> dict:
    """Privatization structure + the scratch-traffic delta (the JAX
    package's model, rows of ``target``'s wave width)."""
    lanes = target.W
    rows = -(-n // lanes)
    plan = _plan(rows, mode if mode != "library" else "native",
                 plan_dialect, target)
    blocks = plan.grid[0]
    block_elems = plan.block_rows * lanes
    private_copies = plan.block_rows if mode in ("native",
                                                 "abstract+shuffle") else 1
    if mode == "abstract":
        round_trips = tree_stages(block_elems)
        scratch_bytes = blocks * scratch_tree_bytes(
            block_elems, rows=num_bins)  # tree runs across the elem axis
    else:
        round_trips = 0
        scratch_bytes = 0
    return {
        "hbm_bytes": n * 4 + num_bins * 4,
        "private_histograms_per_block": private_copies,
        "compare_ops": n * num_bins,            # identical across variants
        "mxu_routed": mode == "native",
        "atomic_free": True,                    # the JAX lowering's
        "blocks": blocks,
        "block_rows": plan.block_rows,
        "scratch_round_trips_per_block": round_trips,
        "scratch_bytes_total": scratch_bytes,
        "lane_shuffles_per_block": tree_stages(lanes)
        if mode == "abstract+shuffle" else 0,
    }


for _mode in MODES:
    REGISTRY.register("histogram", _mode,
                      functools.partial(histogram, mode=_mode),
                      contract=CONTRACTS[_mode],
                      cost=functools.partial(structural_cost, mode=_mode))
REGISTRY.register("histogram", IsaMode.LIBRARY, _ref.histogram,
                  cost=functools.partial(structural_cost, mode="library"))
