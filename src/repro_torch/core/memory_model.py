"""Scoped memory model (paper Fig. 2 + Table IV 'memory order' resolution).

The paper resolves the axiomatic/counter/scoreboard/async divergence with
scoped acquire/release at four scopes: wave, workgroup, device, system.
On Hopper the scopes lower to PTX's own:

  wave       -> warp-synchronous program order (``__syncwarp``)
  workgroup  -> ``fence.acq_rel.cta`` / ``bar.sync`` within a block
  device     -> ``fence.acq_rel.gpu`` (and mbarrier / stream order between
                kernels)
  system     -> ``fence.acq_rel.sys`` / collectives across cards

This is the JAX package's ``core/memory_model.py``.  ``fence`` is an
auditable no-op in Python: the kernels carry their own PTX fences; it
stays in the API so code written against the model states its ordering
intent.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Tuple


class Scope(enum.Enum):
    WAVE = "wave"
    WORKGROUP = "workgroup"
    DEVICE = "device"
    SYSTEM = "system"

    @property
    def rank(self) -> int:
        return {"wave": 0, "workgroup": 1, "device": 2, "system": 3}[self.value]


class Ordering(enum.Enum):
    RELAXED = "relaxed"
    ACQUIRE = "acquire"
    RELEASE = "release"
    ACQ_REL = "acq_rel"


@dataclasses.dataclass(frozen=True)
class MemorySpace:
    """One level of the mandatory 3-level hierarchy (+ optional levels)."""

    name: str
    scope: Scope        # widest scope at which this space is coherent
    explicit: bool      # programmer-managed placement (scratchpad) or not


REGISTERS = MemorySpace("registers", Scope.WAVE, explicit=True)
SCRATCHPAD = MemorySpace("scratchpad", Scope.WORKGROUP, explicit=True)
DEVICE_MEMORY = MemorySpace("device", Scope.SYSTEM, explicit=False)

MANDATORY_HIERARCHY: Tuple[MemorySpace, ...] = (
    REGISTERS, SCRATCHPAD, DEVICE_MEMORY)


def fence(scope: Scope, ordering: Ordering = Ordering.ACQ_REL) -> None:
    """Ordering intent marker (an auditable no-op: the CUDA kernels carry
    their own fences)."""
    assert isinstance(scope, Scope) and isinstance(ordering, Ordering)


def requires_fence(producer_scope: Scope, consumer_scope: Scope) -> bool:
    """True when a release/acquire pair is needed for the handoff: any
    communication at a scope wider than WAVE needs one at >= that scope."""
    widest = max(producer_scope.rank, consumer_scope.rank)
    return widest >= Scope.WORKGROUP.rank
