"""The hardware-invariant primitives (paper Table II + the shuffle refinement)
and the kernel contracts that spend them.

A :class:`KernelContract` declares which primitives and native features a
kernel variant uses; :func:`validate_contract` enforces the paper's
*abstract* discipline: an abstract kernel may only touch the universal set
(primitives 1-10), ``abstract+shuffle`` adds primitive 11, ``native`` may
use anything.  ``SPECS`` is the per-vendor realization table of the JAX
package (Table II, each primitive's classification and its TPU row), with
this package's Hopper realization beside the NVIDIA entry.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, FrozenSet, Tuple

from repro_torch.core.dialect import Dialect, TARGET


class Classification(enum.Enum):
    INVARIANT = "invariant"            # present in all four vendors
    PARAMETERIZABLE = "parameterizable"  # same concept, queryable parameter
    DIVERGENT = "divergent"            # incompatible approaches; abstraction boundary


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
class PrimitiveSpec:
    primitive: Primitive
    classification: Classification
    rationale: str                      # physical-constraint argument (§IV.A.1)
    vendor_realization: Dict[str, str]  # Table II row
    tpu_realization: str                # DESIGN.md §2 row
    tpu_direct: bool                    # True if a direct native mapping exists
    #: this package"s target (Hopper, sm_90a); the JAX table has no column
    hopper_realization: str = ""


SPECS: Dict[Primitive, PrimitiveSpec] = {
    Primitive.LOCKSTEP_GROUP: PrimitiveSpec(
        Primitive.LOCKSTEP_GROUP, Classification.INVARIANT,
        "instruction fetch costs 10-100x single-lane arithmetic; one fetch "
        "must be amortized across W lanes",
        {"NVIDIA": "warp (32)", "AMD": "wavefront (32/64)",
         "Intel": "sub-group (8-16)", "Apple": "SIMD-group (32)"},
        "VPU vreg minor dimension: W=128 lanes; MXU 128x128 tile for matrix",
        True, "warp (32)"),
    Primitive.MASKED_DIVERGENCE: PrimitiveSpec(
        Primitive.MASKED_DIVERGENCE, Classification.DIVERGENT,
        "only mechanism compatible with lockstep execution that preserves "
        "correctness without branch prediction",
        {"NVIDIA": "per-thread PC + predicates", "AMD": "EXEC register",
         "Intel": "predicated SIMD", "Apple": "hardware stack in r0l"},
        "@pl.when predication + jnp.where lane masks (compiler-managed)",
        True, "per-thread PC + predicates (independent thread scheduling)"),
    Primitive.REGISTER_OCCUPANCY: PrimitiveSpec(
        Primitive.REGISTER_OCCUPANCY, Classification.INVARIANT,
        "fixed SRAM area: O = floor(F/(R*W*w)) (Eq. 1)",
        {"NVIDIA": "255 regs / 256KB per SM", "AMD": "256 VGPRs/wave",
         "Intel": "128 GRF/thread", "Apple": "128 GPRs / 208KB"},
        "VMEM-occupancy: pipeline depth O = floor(VMEM/(n_buffers*block_bytes))",
        True, "255 regs / 256KB per SM"),
    Primitive.MANAGED_SCRATCHPAD: PrimitiveSpec(
        Primitive.MANAGED_SCRATCHPAD, Classification.INVARIANT,
        "parallel access patterns require explicit placement caches cannot "
        "predict",
        {"NVIDIA": "shared memory (228KB)", "AMD": "LDS (64-160KB)",
         "Intel": "SLM (64-512KB)", "Apple": "threadgroup (~60KB)"},
        "VMEM via BlockSpec tiling + pltpu scratch shapes (fully managed)",
        True, "shared memory (227KB a block, opt-in)"),
    Primitive.ZERO_COST_SWITCH: PrimitiveSpec(
        Primitive.ZERO_COST_SWITCH, Classification.DIVERGENT,
        "memory latency (100-800 cyc) dominates; SRAM thread state is "
        "cheaper than speculation",
        {"NVIDIA": "all warp state resident", "AMD": "all wave state resident",
         "Intel": "IMT 7-8 threads/EU", "Apple": "24 SIMD-groups resident"},
        "NO thread analogue (single-threaded core); constraint met by async "
        "DMA double/triple buffering — occupancy-by-buffers",
        False, "all warp state resident (64 warps per SM)"),
    Primitive.HIERARCHICAL_MEMORY: PrimitiveSpec(
        Primitive.HIERARCHICAL_MEMORY, Classification.INVARIANT,
        "memory-compute bandwidth gap forces a hierarchy",
        {"NVIDIA": "reg/shmem/L1/L2/DRAM", "AMD": "reg/LDS/L0-2/VRAM",
         "Intel": "reg/SLM/L1-2/DRAM", "Apple": "reg/TG/L1-3/DRAM"},
        "vreg -> VMEM -> HBM, explicit (no transparent cache in between)",
        True, "reg/shmem/L1/L2/HBM3"),
    Primitive.ATOMIC_RMW: PrimitiveSpec(
        Primitive.ATOMIC_RMW, Classification.DIVERGENT,
        "concurrent accumulation needs a conflict-resolution mechanism",
        {"NVIDIA": "atom/red all scopes", "AMD": "DS/buffer/global atomics",
         "Intel": "SEND atomics", "Apple": "32-bit device atomics"},
        "NO HW atomics: privatize + deterministic reduce (one-hot matmul "
        "accumulation in-kernel, XLA collectives across cores)",
        False, "atom/red all scopes"),
    Primitive.WORKGROUP_BARRIER: PrimitiveSpec(
        Primitive.WORKGROUP_BARRIER, Classification.INVARIANT,
        "global barriers would require all workgroups simultaneously "
        "resident; workgroup scope is the residency-compatible scope",
        {"NVIDIA": "bar.sync (16 named)", "AMD": "S_BARRIER",
         "Intel": "barrier (WG scope)", "Apple": "threadgroup_barrier"},
        "program order within a core; sequential grid steps / semaphores "
        "across; collectives across chips",
        True, "bar.sync (16 named) + mbarrier; cluster barriers"),
    Primitive.IDENTITY_REGISTERS: PrimitiveSpec(
        Primitive.IDENTITY_REGISTERS, Classification.INVARIANT,
        "data decomposition requires each execution to know its coordinates",
        {"NVIDIA": "%tid/%ctaid/%laneid", "AMD": "VGPR0 thread_id",
         "Intel": "sr0 local_id", "Apple": "thread_position"},
        "pl.program_id(axis) + jax.lax.axis_index(mesh axis)",
        True, "%tid/%ctaid/%laneid/%clusterid"),
    Primitive.ASYNC_MEMORY: PrimitiveSpec(
        Primitive.ASYNC_MEMORY, Classification.INVARIANT,
        "overlap of data movement with compute is mandatory once "
        "bandwidth/latency dominate",
        {"NVIDIA": "cp.async/mbarrier", "AMD": "S_WAITCNT counters",
         "Intel": "SEND + scoreboard", "Apple": "device_load + wait"},
        "pltpu.make_async_copy / emit_pipeline + DMA semaphores (direct)",
        True, "cp.async / TMA cp.async.bulk + mbarrier"),
    Primitive.LANE_SHUFFLE: PrimitiveSpec(
        Primitive.LANE_SHUFFLE, Classification.INVARIANT,
        "register-speed lane exchange; replacing it with scratchpad "
        "round-trips costs up to 37.5% on latency-sensitive schedulers "
        "(paper §VII.C: the reduction finding)",
        {"NVIDIA": "__shfl_*_sync", "AMD": "DPP/ds_permute",
         "Intel": "sub-group shuffle", "Apple": "simd_shuffle"},
        "intra-vreg lane rotation (pltpu.roll / strided slice-add tree)",
        True, "__shfl_*_sync"),
}


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


def invariants() -> Tuple[Primitive, ...]:
    return tuple(p for p in Primitive if SPECS[p].classification
                 is Classification.INVARIANT)


def divergences() -> Tuple[Primitive, ...]:
    return tuple(p for p in Primitive if SPECS[p].classification
                 is Classification.DIVERGENT)
