"""Shared multi-buffered pipeline planning (Eq. 1 occupancy algebra).

The JAX package's ``core/pipeline.py``: one place that turns the paper's
occupancy algebra (Eq. 1, re-derived for buffers in
``Dialect.buffer_occupancy``)

    O = floor(S / (n_buffers x block_bytes))

into a row-block staging plan.  A :class:`PipelinePlan` picks the largest
block that keeps at least ``min_occupancy`` pipeline stages resident
(``choose_block_bytes``), clamped by a per-kernel latency cap, and carries
the grid, the padding and the ``dimension_semantics`` annotation.  On
Hopper ``S`` is the 227 KB of shared memory one block may claim
(``NVIDIA_HOPPER_SM90.S = 232448``), so the same algebra gives blocks
about 290 times smaller than on the TPU's 64 MB VMEM.

The plans feed the structural cost models and the tuning table; the Hopper
kernels size their own tiles.  The JAX plan's ``compiler_params`` property
is the Pallas ``CompilerParams`` switch, which has no counterpart here
(this package has no Pallas), so it is not ported; ``semantics`` stays as
the record of what the native budget would annotate.  The second-minor
granule :data:`SUBLANES` is the JAX package's literal (a TPU f32 tile's
sublanes), kept so the plans equal the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.dialect import Dialect, TARGET
from repro_torch.core.execution_model import choose_block_bytes

#: minimal second-minor granule of the JAX package's plans (TPU sublanes)
SUBLANES = 8


@dataclasses.dataclass(frozen=True)
class PipelinePlan:
    """Staging decision for a rowwise (grid over row-blocks) kernel."""

    block_rows: int                 # rows per grid step
    row_bytes: int                  # bytes per row of the working set
    n_buffers: int                  # multi-buffer depth
    occupancy: int                  # resident block buffers under Eq. 1
    grid: Tuple[int, ...]           # 1-D grid over row-blocks
    padded_rows: int                # rows after padding to a block multiple
    mode: str                       # isa mode the plan was made for
    semantics: Tuple[str, ...]      # dimension_semantics for native mode

    @property
    def block_bytes(self) -> int:
        return self.block_rows * self.row_bytes


def plan_row_pipeline(total_rows: int, row_bytes: int, *, mode: str,
                      dialect: Dialect = TARGET, n_buffers: int = 2,
                      max_block_rows: Optional[int] = None,
                      min_occupancy: int = 2, pow2_blocks: bool = False,
                      semantics: Tuple[str, ...] = ("arbitrary",),
                      tuned: Optional[Mapping] = None) -> PipelinePlan:
    """Size a row-block from the dialect scratchpad budget.

    ``max_block_rows`` is the kernel's latency/tail cap; ``pow2_blocks``
    rounds the block down to a power of two (kernels whose cross-lane
    stage tree-reduces over the block rows).  ``tuned`` is an optional
    tuning-table override (``core/tuning.py``) with ``block_rows`` /
    ``n_buffers`` keys: a tuned block supersedes the heuristic and the
    cap, but the Eq. 1 occupancy invariant and the problem-size / pow2
    clamps still apply, so an entry that would break them degrades to the
    heuristic point.
    """
    if total_rows <= 0 or row_bytes <= 0:
        raise ValueError("total_rows and row_bytes must be positive")
    tuned_block = None
    if tuned:
        n_buffers = int(tuned.get("n_buffers", n_buffers))
        if tuned.get("block_rows"):
            tuned_block = max(SUBLANES,
                              int(tuned["block_rows"]) // SUBLANES * SUBLANES)
    budget = choose_block_bytes(total_rows * row_bytes, dialect,
                                n_buffers=n_buffers,
                                min_occupancy=min_occupancy)
    block_rows = max(SUBLANES, (budget // row_bytes) // SUBLANES * SUBLANES)
    if max_block_rows is not None:
        block_rows = min(block_rows, max_block_rows)
    if tuned_block is not None and dialect.buffer_occupancy(
            tuned_block * row_bytes, n_buffers) >= min_occupancy:
        block_rows = tuned_block
    # never pad a small input past one block of its own (rounded) size
    rounded_total = -(-total_rows // SUBLANES) * SUBLANES
    block_rows = min(block_rows, rounded_total)
    if pow2_blocks:
        block_rows = 1 << (block_rows.bit_length() - 1)
    padded_rows = -(-total_rows // block_rows) * block_rows
    return PipelinePlan(
        block_rows=block_rows, row_bytes=row_bytes, n_buffers=n_buffers,
        occupancy=dialect.buffer_occupancy(block_rows * row_bytes, n_buffers),
        grid=(padded_rows // block_rows,), padded_rows=padded_rows,
        mode=mode, semantics=semantics)


def pad_rows(x2d: torch.Tensor, plan: PipelinePlan,
             constant_value=0) -> torch.Tensor:
    """Pad a ``(rows, d)`` tensor up to the plan's block multiple."""
    pad = plan.padded_rows - x2d.shape[0]
    if pad:
        x2d = F.pad(x2d, (0, 0, 0, pad), value=constant_value)
    return x2d
