"""Parallel reduction (paper Table V, row 2): the §VII.C kernel, as a
hand-written Hopper kernel in three modes.

Replaces the JAX package's ``kernels/reduction.py::reduce_sum`` (source
and design notes in ``csrc/reduction.cu``).  Every mode shares one
loading stage, each thread folding its elements into one f32 register,
and they differ in the block's cross-lane stage (``csrc/lanes.cuh``):

- ``abstract``: the shared-memory tree, log2(256) = 8 barrier-separated
  stages, no shuffle (primitives 1-10);
- ``abstract+shuffle``: a warp butterfly (5 shuffles), one shared
  exchange of the 8 warp partials, a final butterfly (primitive 11);
- ``native``: the shuffle stage, with 16-byte loads, four in flight (at
  the default tile; at :data:`SMALL_TILE` native is abstract+shuffle's
  kernel, ``csrc/reduction.cu`` says why).

A block sums one tile of :data:`TILE` elements and writes its partial; a
second pass sums the partials in a fixed order (no float atomics).  At a
tile of 2 elements a thread (:data:`SMALL_TILE`, the classic kernel) the
C library takes its ``persistent`` route: resident blocks walk the tiles,
each tile's loads made ahead of its tree (one element a load in every
mode), and one block folds the partials in a dependent launch; every other
tile takes the ``tile`` route (a block a tile, then a second launch).
The launch reports its route (``_launch.LAST_ROUTE["reduction_<mode>"]``).

:func:`reduce_sum_plain` repeats that arithmetic in tensor ops, through the
plain lane functions of :mod:`repro_torch.core.shuffle`: the wrappers run
it on CPU tensors.  On CUDA tensors they launch the kernel or raise.  Each
launch adds one to ``LAUNCHES["reduction_<mode>"]``.

:func:`structural_cost` is the JAX package's cost model (the scratch round
trips of the abstract tree, the §VII.C mechanism in numbers), evaluated
for a compile target's wave width and its Eq. 1 plan; ``auto`` ranks the
modes by it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core import (REGISTRY, TARGET, Dialect, IsaMode,
                              KernelContract, Primitive, dtype_bytes,
                              register_op_space, tuned_plan,
                              validate_contract)
from repro_torch.core.shuffle import (lane_tree_reduce, scratch_tree_bytes,
                                      scratch_tree_reduce, tree_stages)
from repro_torch.kernels import ref as _ref
from repro_torch.kernels._launch import (MODE_CODES, check_device, entry,
                                         launch, stream)

#: threads per block (``kRedThreads`` in csrc/reduction.cu)
THREADS = 256
#: elements per block: the JAX plan's cap, 512 rows x 128 TPU lanes
TILE = 512 * 128
#: the classic tile, 2 elements a thread: the ``persistent`` route
SMALL_TILE = 2 * THREADS
MODES = ("abstract", "abstract+shuffle", "native")
#: the JAX plan's latency cap (its tuning space's)
_MAX_BLOCK_ROWS = 512
register_op_space("reduction", "rowwise", max_block_rows=_MAX_BLOCK_ROWS)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}

ABSTRACT_CONTRACT = KernelContract(
    kernel="reduction", mode=IsaMode.ABSTRACT,
    primitives=frozenset({
        Primitive.LOCKSTEP_GROUP, Primitive.MANAGED_SCRATCHPAD,
        Primitive.WORKGROUP_BARRIER, Primitive.HIERARCHICAL_MEMORY,
        Primitive.IDENTITY_REGISTERS, Primitive.ASYNC_MEMORY,
    }))
SHUFFLE_CONTRACT = KernelContract(
    kernel="reduction", mode=IsaMode.ABSTRACT_SHUFFLE,
    primitives=ABSTRACT_CONTRACT.primitives | {Primitive.LANE_SHUFFLE})
NATIVE_CONTRACT = KernelContract(
    kernel="reduction", mode=IsaMode.NATIVE,
    primitives=frozenset(Primitive),
    native_features=frozenset({"dimension_semantics", "multi_buffering"}))
CONTRACTS = {"abstract": ABSTRACT_CONTRACT,
             "abstract+shuffle": SHUFFLE_CONTRACT,
             "native": NATIVE_CONTRACT}
for _c in CONTRACTS.values():
    validate_contract(_c)


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown reduction mode {mode!r}; kernel modes: "
                         f"{MODES}")


def _block_pass(flat: torch.Tensor, mode: str, tile: int) -> torch.Tensor:
    """One pass of the kernel: f32 partial of every ``tile``-element block.
    Thread ``t`` of a block folds its elements ``t, t + 256, ...`` in that
    order, from 0; then the block's cross-lane stage of ``mode``."""
    blocks = -(-flat.numel() // tile)
    xf = flat.float()
    pad = blocks * tile - xf.numel()
    if pad:
        xf = torch.cat([xf, xf.new_zeros(pad)])
    rows = xf.reshape(blocks, tile // THREADS, THREADS)
    per_thread = torch.zeros_like(rows[:, 0])
    for i in range(rows.shape[1]):
        per_thread = per_thread + rows[:, i]
    if mode == "abstract":
        return scratch_tree_reduce(per_thread,
                                   torch.empty_like(per_thread))[:, 0]
    warps = lane_tree_reduce(per_thread.reshape(blocks, -1, 32))[..., 0]
    return lane_tree_reduce(warps)[:, 0]


def reduce_sum_plain(x: torch.Tensor, *, mode: str = "native",
                     tile: int = TILE) -> torch.Tensor:
    """The sum of every element of ``x`` as an f32 scalar, by the kernel's
    two passes: block partials, then one block over the partials.  At
    :data:`SMALL_TILE` the kernel equals it bitwise in every mode; at
    other tiles native's vector loads fold another order."""
    _check_mode(mode)
    flat = x.reshape(-1)
    if flat.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=x.device)
    parts = _block_pass(flat, mode, tile)
    if parts.numel() > 1:
        parts = _block_pass(parts, mode, -(-parts.numel() // THREADS)
                            * THREADS)
    return parts[0]


def reduce_sum_kernel(x: torch.Tensor, mode: str, tile: int = TILE
                      ) -> torch.Tensor:
    """Launch the ``mode`` kernel at ``tile`` elements per block (a
    positive multiple of 8).  The public :func:`reduce_sum` keeps the
    default; the Table V benchmark also times a tile of 2 elements per
    thread, the classic one-tree-per-small-tile kernel."""
    _check_mode(mode)
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"reduction kernels take float32, bfloat16 or int32, "
                        f"got {x.dtype}")
    if tile <= 0 or tile % 8:
        raise ValueError(f"tile must be a positive multiple of 8, got {tile}")
    dev = check_device("reduce_sum", x)
    x = x.contiguous()
    n = x.numel()
    partials = torch.empty(max(1, -(-n // tile)), dtype=torch.float32,
                           device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    launch("reduction", MODE_CODES[mode], _DTYPE_CODES[x.dtype], x.data_ptr(),
           n, tile, partials.data_ptr(), out.data_ptr(), stream(dev),
           count_as=f"reduction_{mode}")
    return out


def reduce_sum(x: torch.Tensor, *, mode: str = "native") -> torch.Tensor:
    """Sum of all elements of ``x`` (any shape; f32, bf16 or int32) with
    f32 accumulation, as an f32 scalar.  CPU tensors run the plain
    version."""
    if not x.is_cuda:
        return reduce_sum_plain(x, mode=mode)
    return reduce_sum_kernel(x, mode)


def launch_params(mode: str, n: int, tile: int = TILE,
                  x: Optional[torch.Tensor] = None) -> dict:
    """The launch of one call, as the kernel runs it: ``abstract`` and
    ``abstract+shuffle`` share route, block, tile and loads exactly.  The
    persistent route's grid is the card's resident blocks: given ``x`` on
    a card, the library's (``uisa_reduce_sum_grid``), else a description.
    ``passes`` counts the launches (a second pass is a second launch)."""
    _check_mode(mode)
    tiles = -(-n // tile)
    persistent = tile == SMALL_TILE
    grid = tiles if not persistent else "resident blocks"
    if persistent and x is not None and x.is_cuda:
        code = ctypes.c_int(-1)
        grid = int(entry("reduction_grid")(
            MODE_CODES[mode], _DTYPE_CODES[x.dtype], x.data_ptr(), n, tile,
            ctypes.byref(code)))
    if not persistent:
        loads = ("16-byte vectors, 4 in flight" if mode == "native"
                 else "one element")
        second = "one block, a second launch" if tiles > 1 else None
    else:
        loads = "one element, evict-first, 2 tiles in flight a thread"
        second = None if tiles == 1 else "one block, a dependent launch"
    return dict(route="persistent" if persistent else "tile", grid=grid,
                block=THREADS, tile=tile, per_thread=tile // THREADS,
                loads=loads,
                block_stage="shared-memory tree, 8 barriers"
                if mode == "abstract" else "warp butterfly + 1 exchange",
                second_pass=second, passes=1 if second is None else 2)


def _plan(rows: int, mode: str, plan_dialect, target: Dialect):
    return tuned_plan("reduction", rows, target.W * 4, mode=mode,
                      dialect=plan_dialect,
                      max_block_rows=_MAX_BLOCK_ROWS,
                      semantics=("arbitrary",))


def structural_cost(n: int, mode: str, dtype=torch.float32,
                    plan_dialect: Optional[str] = None,
                    target: Dialect = TARGET) -> dict:
    """Bytes moved + scratch round trips (the JAX package's model): the
    HBM traffic is the same in every mode; the abstract tree pays
    log2(W) scratch round trips a block, the shuffle mode as many lane
    shuffles, native neither.  ``W`` is ``target``'s wave width."""
    lanes = target.W
    itemsize = dtype_bytes(dtype)
    rows = -(-n // lanes)
    plan = _plan(rows, mode if mode != "library" else "native",
                 plan_dialect, target)
    blocks = plan.grid[0]
    if mode == "abstract":
        round_trips = tree_stages(lanes)
        scratch_bytes = blocks * scratch_tree_bytes(lanes)
    else:  # library / native / abstract+shuffle: no scratch round trips
        round_trips = 0
        scratch_bytes = 0
    return {
        "hbm_bytes": n * itemsize,
        "scratch_round_trips_per_block": round_trips,
        "scratch_bytes_total": scratch_bytes,
        "lane_shuffles_per_block": tree_stages(lanes)
        if mode == "abstract+shuffle" else 0,
        "blocks": blocks,
        "block_rows": plan.block_rows,
        "pipeline_occupancy": plan.occupancy,
    }


# Registry: the §VII.C kernel carries the full Table V mode matrix.
for _mode in MODES:
    REGISTRY.register("reduction", _mode,
                      functools.partial(reduce_sum, mode=_mode),
                      contract=CONTRACTS[_mode],
                      cost=functools.partial(structural_cost, mode=_mode))
REGISTRY.register("reduction", IsaMode.LIBRARY, _ref.reduce_sum,
                  cost=functools.partial(structural_cost, mode="library"))
