"""The abstract execution model (paper §V), the JAX package's
``core/execution_model.py`` on this package's target.

Thread hierarchy (Fig. 1): Grid -> Workgroup -> Wave -> lane, plus the
optional cluster level.  On Hopper a "workgroup" is a thread block on one
SM, a "wave" a 32-lane warp, the cluster level a thread-block cluster, and
the grid the CUDA grid.

The model is deliberately *thin* (§VIII.B): it validates launch geometry
against the active dialect and computes occupancies, but never prescribes
how a backend schedules.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.core.dialect import Dialect, TARGET


@dataclasses.dataclass(frozen=True)
class LaunchGeometry:
    """Grid x workgroup shape in the abstract model."""

    grid: Tuple[int, ...]
    workgroup: int                      # threads per workgroup
    regs_per_thread: int = 32
    scratchpad_bytes: int = 0
    cluster: Optional[int] = None       # optional 4th level (Fig. 1, dashed)

    @property
    def total_workgroups(self) -> int:
        return math.prod(self.grid)

    @property
    def total_threads(self) -> int:
        return self.total_workgroups * self.workgroup


class LaunchError(Exception):
    pass


def validate_launch(geom: LaunchGeometry, dialect: Dialect = TARGET) -> None:
    """Reject geometries the dialect cannot host (thin checks only)."""
    if any(g <= 0 for g in geom.grid):
        raise LaunchError(f"grid must be positive, got {geom.grid}")
    if dialect.max_workgroup > 1 and not dialect.validate_workgroup(geom.workgroup):
        raise LaunchError(
            f"workgroup {geom.workgroup} exceeds dialect max "
            f"{dialect.max_workgroup}")
    if geom.scratchpad_bytes > dialect.S:
        raise LaunchError(
            f"scratchpad request {geom.scratchpad_bytes} exceeds dialect "
            f"S={dialect.S}")
    if geom.regs_per_thread > dialect.R:
        raise LaunchError(
            f"register request {geom.regs_per_thread} exceeds dialect "
            f"R={dialect.R}")


def occupancy(geom: LaunchGeometry, dialect: Dialect = TARGET) -> int:
    """Resident waves per core under Eq. 1, bounded by scratchpad demand.

    Classic GPU occupancy calculation, driven entirely by dialect queries:
      O_regs  = floor(F / (R*W*w))          (Eq. 1)
      O_scr   = floor(S / scratch_per_wg) * waves_per_wg
    """
    o_regs = dialect.occupancy(geom.regs_per_thread)
    if geom.scratchpad_bytes > 0 and dialect.max_workgroup > 1:
        waves_per_wg = max(1, math.ceil(geom.workgroup / dialect.W))
        o_scr = (dialect.S // geom.scratchpad_bytes) * waves_per_wg
        return max(0, min(o_regs, o_scr))
    return max(0, o_regs)


def tpu_pipeline_occupancy(block_bytes: int, n_buffers: int = 2,
                           dialect: Dialect = TARGET) -> int:
    """Eq. 1 re-derived for resident buffers (see
    Dialect.buffer_occupancy); the name is the JAX package's."""
    return dialect.buffer_occupancy(block_bytes, n_buffers)


def choose_block_bytes(working_set: int, dialect: Dialect = TARGET,
                       n_buffers: int = 2, min_occupancy: int = 2) -> int:
    """Pick the largest block working-set that keeps >= min_occupancy
    pipeline stages resident — the kernel-side consumer of the occupancy
    tradeoff.  Returns a byte budget, clamped to the dialect scratchpad."""
    budget = dialect.S // (n_buffers * min_occupancy)
    return min(working_set, max(1, budget))


@dataclasses.dataclass(frozen=True)
class WaveView:
    """Lane-level view inside one wave: identity registers (primitive 9)."""

    wave_width: int

    def lane_ids(self, device) -> torch.Tensor:
        """Abstract iota over lanes, on ``device``; backends realize it
        natively (%laneid / VGPR0 / sr0 / thread_position)."""
        return torch.arange(self.wave_width, dtype=torch.int32,
                            device=device)


def grid_for(total: int, per_step: int) -> int:
    """Ceil-div grid sizing helper used by kernels."""
    if per_step <= 0:
        raise ValueError("per_step must be positive")
    return -(-total // per_step)
