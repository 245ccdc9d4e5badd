"""Lane-shuffle primitive API (primitive 11) as plain tensor functions.

The counterpart of the JAX package's ``core/shuffle.py``.  There the lane
axis is the TPU's 128-lane vreg and the rotate lowers to ``pltpu.roll``;
here the same functions act on the last (or a chosen) axis of a tensor,
with the rotation by :func:`torch.roll`.  They are the plain versions of
the device functions in ``csrc/lanes.cuh``, where the lanes are a warp's
32 threads (``__shfl_*_sync``) and the scratch tree runs through shared
memory with one ``__syncthreads`` per halving stage.

The width is always taken from the input, as in the JAX package, so the
same function describes a 32-lane warp on Hopper and a 128-lane vreg on
the TPU.  :data:`LANES` is the port's target wave width (32), the default
of :func:`fold_rows`, :func:`row_reduce_shuffle` and :func:`tree_stages`.

- :func:`lane_shuffle_down` / :func:`lane_shuffle_up`: lane ``i`` receives
  lane ``(i + delta) mod W`` / ``(i - delta) mod W`` (the rotate flavour).
- :func:`lane_shuffle_xor`: lane ``i`` receives lane ``i ^ mask``.
- :func:`lane_tree_reduce`: the log2(W) rotate tree; every lane ends with
  the full reduction.
- :func:`fold_rows` / :func:`row_reduce_shuffle`: register folds of a
  ``(..., n*W)`` row down to ``W`` lanes, then one tree.
- :func:`scratch_tree_reduce`: the shuffle-free tree through a scratch
  tensor the caller allocates (the abstract budget's cross-lane stage).
- :func:`lane_inclusive_scan`: the Hillis-Steele inclusive scan over the
  lanes, each stage a :func:`lane_shuffle_up` added where the lane index is
  at least the offset.
- :func:`scratch_inclusive_scan`: the same scan with every stage stored to
  a scratch tensor and reloaded shifted (the abstract budget's scan).
- :func:`tree_stages` / :func:`scratch_tree_bytes`: the cost vocabulary.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.core.dialect import TARGET

#: wave width of the target dialect (queried, never assumed): 32 on Hopper
LANES = TARGET.W

Op = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def lane_shuffle_down(x: torch.Tensor, delta: int,
                      axis: int = -1) -> torch.Tensor:
    """Lane ``i`` receives the value of lane ``(i + delta) mod W``."""
    return torch.roll(x, -delta, dims=axis)


def lane_shuffle_up(x: torch.Tensor, delta: int,
                    axis: int = -1) -> torch.Tensor:
    """Lane ``i`` receives the value of lane ``(i - delta) mod W``."""
    return torch.roll(x, delta, dims=axis)


def lane_shuffle_xor(x: torch.Tensor, mask: int,
                     axis: int = -1) -> torch.Tensor:
    """Butterfly exchange: lane ``i`` receives lane ``i ^ mask``.

    As in the JAX package: two rotates and a lane-id select (lanes with the
    mask bit set fetch from ``i - mask``, the rest from ``i + mask``)."""
    size = x.shape[axis]
    if mask <= 0 or mask & (mask - 1) or mask >= size:
        raise ValueError(f"mask must be a power of two < {size}, got {mask}")
    axis = axis % x.dim()
    shape = [1] * x.dim()
    shape[axis] = size
    lane = torch.arange(size, device=x.device).reshape(shape)
    return torch.where((lane & mask) != 0, lane_shuffle_up(x, mask, axis),
                       lane_shuffle_down(x, mask, axis))


def lane_tree_reduce(x: torch.Tensor, op: Op = torch.add,
                     axis: int = -1) -> torch.Tensor:
    """log2(W) rotate tree over ``axis``; every lane ends with the full
    reduction.  ``op`` must be associative and commutative."""
    size = x.shape[axis]
    if size & (size - 1):
        raise ValueError(f"tree reduce needs a power-of-two width, got {size}")
    shift = size // 2
    while shift >= 1:
        x = op(x, lane_shuffle_down(x, shift, axis))
        shift //= 2
    return x


def fold_rows(x: torch.Tensor, op: Op = torch.add,
              lanes: int = LANES) -> torch.Tensor:
    """Fold the last axis of ``x`` (``(..., d)``, d a multiple of
    ``lanes``) to ``(..., lanes)``, one ``lanes``-wide group after another
    (register accumulation, no lane crossing)."""
    d = x.shape[-1]
    if d % lanes:
        raise ValueError(f"row width {d} not a multiple of {lanes} lanes")
    folded = x.reshape(x.shape[:-1] + (d // lanes, lanes))
    acc = folded[..., 0, :]
    for g in range(1, d // lanes):
        acc = op(acc, folded[..., g, :])
    return acc


def row_reduce_shuffle(x: torch.Tensor, op: Op = torch.add,
                       lanes: int = LANES) -> torch.Tensor:
    """Reduce the last axis of ``x`` to ``(..., 1)``: register folds, then
    one rotate tree."""
    return lane_tree_reduce(fold_rows(x, op, lanes), op, axis=-1)[..., :1]


def scratch_tree_reduce(x: torch.Tensor, scratch: torch.Tensor,
                        op: Op = torch.add, axis: int = -1) -> torch.Tensor:
    """The shuffle-free tree: halving stages through ``scratch``.

    ``scratch`` is a preallocated tensor of ``x``'s shape (``x`` is 2D).
    Each stage reads two halves of the live prefix and stores their
    combination over the first half, as the device version does in shared
    memory between barriers.  Returns the reduced slice: ``(rows, 1)`` for
    ``axis=-1``, ``(1, cols)`` for ``axis=0`` (a view of ``scratch``)."""
    if x.dim() != 2:
        raise ValueError(f"scratch tree reduce is 2D-only, got ndim={x.dim()}")
    if scratch.shape != x.shape:
        raise ValueError(f"scratch {tuple(scratch.shape)} is not "
                         f"{tuple(x.shape)}")
    axis = axis % 2
    width = x.shape[axis]
    if width & (width - 1):
        raise ValueError(f"tree reduce needs a power-of-two width, got {width}")
    scratch.copy_(x)
    w = width // 2
    while w >= 1:
        lo = scratch.narrow(axis, 0, w)
        hi = scratch.narrow(axis, w, w)
        lo.copy_(op(lo, hi))
        w //= 2
    return scratch.narrow(axis, 0, 1)


def lane_inclusive_scan(x: torch.Tensor, op: Op = torch.add,
                        axis: int = -1) -> torch.Tensor:
    """Inclusive scan over ``axis``: log2(W) stages; at offset ``o`` lane
    ``i >= o`` takes ``op(x_i, x_{i-o})`` from :func:`lane_shuffle_up`.
    ``op`` must be associative."""
    size = x.shape[axis]
    axis = axis % x.dim()
    shape = [1] * x.dim()
    shape[axis] = size
    lane = torch.arange(size, device=x.device).reshape(shape)
    off = 1
    while off < size:
        x = torch.where(lane >= off, op(x, lane_shuffle_up(x, off, axis)), x)
        off *= 2
    return x


def scratch_inclusive_scan(x: torch.Tensor, scratch: torch.Tensor,
                           op: Op = torch.add, axis: int = -1) -> torch.Tensor:
    """The shuffle-free inclusive scan over ``axis``: each Hillis-Steele
    stage stores ``x`` to ``scratch`` (a preallocated tensor of ``x``'s
    shape) and reloads it shifted by the stage's offset, as the device
    version does in shared memory between two barriers."""
    if scratch.shape != x.shape:
        raise ValueError(f"scratch {tuple(scratch.shape)} is not "
                         f"{tuple(x.shape)}")
    size = x.shape[axis]
    off = 1
    while off < size:
        scratch.copy_(x)
        shifted = scratch.narrow(axis, 0, size - off)
        x = torch.cat([x.narrow(axis, 0, off),
                       op(x.narrow(axis, off, size - off), shifted)],
                      dim=axis)
        off *= 2
    return x


# ---------------------------------------------------------------------------
# Cost vocabulary
# ---------------------------------------------------------------------------


def tree_stages(width: int = LANES) -> int:
    """Halving stages of a ``width``-wide tree (= shuffles, or round-trips)."""
    if width <= 0 or width & (width - 1):
        raise ValueError(f"width must be a power of two, got {width}")
    return int(math.log2(width))


def scratch_tree_bytes(width: int, rows: int = 1, itemsize: int = 4) -> int:
    """Scratch traffic of one :func:`scratch_tree_reduce`: stage ``k``
    reads two ``width >> k`` slices and writes one, per row."""
    return rows * sum(3 * (width >> k) * itemsize
                      for k in range(1, tree_stages(width) + 1))
