"""The hardware-invariant primitives (paper Table II + the shuffle refinement)
and the kernel contracts that spend them.

A :class:`KernelContract` declares which primitives and native features a
kernel variant uses; :func:`validate_contract` enforces the paper's
*abstract* discipline: an abstract kernel may only touch the universal set
(primitives 1-10), ``abstract+shuffle`` adds primitive 11, ``native`` may
use anything.  The per-vendor realization table (``SPECS``) of the JAX
package is not part of this module yet.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import FrozenSet

from repro_torch.core.dialect import Dialect, TARGET


class Primitive(enum.Enum):
    """Paper Table II (1-10) plus the §VII.C refinement (11)."""

    LOCKSTEP_GROUP = 1
    MASKED_DIVERGENCE = 2
    REGISTER_OCCUPANCY = 3
    MANAGED_SCRATCHPAD = 4
    ZERO_COST_SWITCH = 5
    HIERARCHICAL_MEMORY = 6
    ATOMIC_RMW = 7
    WORKGROUP_BARRIER = 8
    IDENTITY_REGISTERS = 9
    ASYNC_MEMORY = 10
    LANE_SHUFFLE = 11

    @property
    def universal(self) -> bool:
        """Member of the original ten-invariant set."""
        return self.value <= 10


UNIVERSAL_SET: FrozenSet[Primitive] = frozenset(p for p in Primitive if p.universal)
UNIVERSAL_PLUS_SHUFFLE: FrozenSet[Primitive] = UNIVERSAL_SET | {Primitive.LANE_SHUFFLE}


class IsaMode(enum.Enum):
    """Which primitive budget a kernel variant is allowed to spend."""

    ABSTRACT = "abstract"                  # primitives 1-10 only
    ABSTRACT_SHUFFLE = "abstract+shuffle"  # + primitive 11
    NATIVE = "native"                      # full target feature set
    LIBRARY = "library"                    # the plain PyTorch version

    @property
    def allowed(self) -> FrozenSet[Primitive]:
        if self is IsaMode.ABSTRACT:
            return UNIVERSAL_SET
        if self is IsaMode.ABSTRACT_SHUFFLE:
            return UNIVERSAL_PLUS_SHUFFLE
        return frozenset(Primitive)


#: target-specific features outside the abstract model.  The names are the
#: JAX package's, so contracts compare equal across the two packages; on
#: Hopper "mxu_aligned_tiles" reads as tiles chosen for the tensor cores.
NATIVE_FEATURES: FrozenSet[str] = frozenset({
    "mxu_aligned_tiles",
    "multi_buffering",
    "fused_epilogue",
    "dimension_semantics",
    "lane_shuffle_intrinsics",
})


@dataclasses.dataclass(frozen=True)
class KernelContract:
    """Declares which primitives and native features a kernel variant uses."""

    kernel: str
    mode: IsaMode
    primitives: FrozenSet[Primitive]
    native_features: FrozenSet[str] = frozenset()

    def __post_init__(self):
        unknown = self.native_features - NATIVE_FEATURES
        if unknown:
            raise ValueError(f"unknown native features: {sorted(unknown)}")


class ContractViolation(Exception):
    pass


def validate_contract(contract: KernelContract,
                      dialect: Dialect = TARGET) -> None:
    """Enforce the Table V discipline: abstract kernels spend only the
    universal primitive budget and zero native features."""
    illegal = contract.primitives - contract.mode.allowed
    if illegal:
        raise ContractViolation(
            f"{contract.kernel} [{contract.mode.value}] uses primitives "
            f"outside its budget: {sorted(p.name for p in illegal)}")
    if contract.mode in (IsaMode.ABSTRACT, IsaMode.ABSTRACT_SHUFFLE):
        if contract.native_features:
            raise ContractViolation(
                f"{contract.kernel} [{contract.mode.value}] uses native "
                f"features: {sorted(contract.native_features)}")
    if Primitive.LANE_SHUFFLE in contract.primitives and not dialect.has_lane_shuffle:
        raise ContractViolation(
            f"{contract.kernel} requires lane shuffle but dialect "
            f"{dialect.name} lacks it")
    if Primitive.ATOMIC_RMW in contract.primitives and not dialect.has_hw_atomics:
        needed = {Primitive.MANAGED_SCRATCHPAD, Primitive.WORKGROUP_BARRIER}
        if not needed <= contract.primitives:
            raise ContractViolation(
                f"{contract.kernel}: dialect {dialect.name} has no HW "
                f"atomics; ATOMIC_RMW must lower to privatize+reduce "
                f"(requires scratchpad+barrier in the contract)")
