"""Parameterizable dialects (paper Table III) as queryable constants.

The six dialects of the JAX package (four GPU vendors from the paper, the
TPU v5e target, and the ten-invariant universal profile) plus the dialect
this package targets: NVIDIA Hopper (``sm_90a``).  Programs never hardcode
these parameters; they query a :class:`Dialect`.

The collective cost model (:func:`collective_cost`, the alpha-beta ring
model of the JAX package's ``core/dialect.py``) prices a collective in
the registry's ranking currency; the tensor-parallel ops that pay one come
with the scale-out slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

# Register width w in bytes (paper Table I, "typically 4").
REGISTER_WIDTH_BYTES = 4

#: hbm-equivalent bytes of a collective on a dialect with no multi-device
#: interconnect (apple-g13): large enough that a TP-fused lowering never
#: out-ranks a replicated one, finite so the ranking tuple stays ordered
NO_INTERCONNECT_BYTES = 1 << 60


@dataclasses.dataclass(frozen=True)
class Interconnect:
    """One vendor's chip-to-chip link profile: bytes/s per link per
    direction and the per-hop latency (the alpha of the alpha-beta model)."""

    link_bandwidth: float          # bytes/s, per link per direction
    hop_latency_s: float           # per-hop latency (seconds)
    topology: str = "ring"


@dataclasses.dataclass(frozen=True)
class CollectiveCost:
    """Modeled cost of one collective under a dialect's interconnect.

    ``wire_bytes`` follows the ring formulas (all-reduce ``2S(G-1)/G``,
    all-gather / reduce-scatter / all-to-all ``S(G-1)/G``, permute ``S``);
    ``hbm_equiv_bytes`` converts the alpha-beta wire time into the
    registry's ranking currency, HBM bytes at the dialect's bandwidth:
    ``wire * hbm_bw / link_bw + hops * alpha * hbm_bw``."""

    kind: str                      # all_reduce | all_gather | ...
    payload_bytes: int             # S: logical tensor bytes at the boundary
    group: int                     # G: devices participating
    wire_bytes: int                # ring bytes actually moved per device
    hops: int                      # ring steps (latency-bearing)
    hbm_equiv_bytes: int           # ranking currency (see above)

    def cost_keys(self) -> dict:
        """The structural-cost columns a TP-variant cost dict carries."""
        return {
            "collective": self.kind,
            "collective_group": self.group,
            "collective_payload_bytes": self.payload_bytes,
            "collective_bytes": self.wire_bytes,
            "collective_hops": self.hops,
            "collective_hbm_equiv_bytes": self.hbm_equiv_bytes,
        }


#: ring wire-byte factors by collective kind
_RING_WIRE = {
    "all_reduce": lambda s, g: 2 * s * (g - 1) // g,
    "all_gather": lambda s, g: s * (g - 1) // g,
    "reduce_scatter": lambda s, g: s * (g - 1) // g,
    "all_to_all": lambda s, g: s * (g - 1) // g,
    "permute": lambda s, g: s,
}

_RING_HOPS = {
    "all_reduce": lambda g: 2 * (g - 1),
    "all_gather": lambda g: g - 1,
    "reduce_scatter": lambda g: g - 1,
    "all_to_all": lambda g: g - 1,
    "permute": lambda g: 1,
}


def collective_cost(kind: str, payload_bytes: int, group: int,
                    dialect: "Dialect") -> CollectiveCost:
    """Model one collective's cost on ``dialect``'s interconnect.

    ``group <= 1`` is the single-device case: every term is zero.  A
    dialect without an interconnect prices the collective at
    :data:`NO_INTERCONNECT_BYTES`."""
    if kind not in _RING_WIRE:
        raise KeyError(f"unknown collective kind {kind!r}; "
                       f"known: {sorted(_RING_WIRE)}")
    if group <= 1:
        return CollectiveCost(kind=kind, payload_bytes=payload_bytes,
                              group=max(group, 1), wire_bytes=0, hops=0,
                              hbm_equiv_bytes=0)
    wire = int(_RING_WIRE[kind](payload_bytes, group))
    hops = int(_RING_HOPS[kind](group))
    link = dialect.interconnect
    if link is None:
        return CollectiveCost(kind=kind, payload_bytes=payload_bytes,
                              group=group, wire_bytes=wire, hops=hops,
                              hbm_equiv_bytes=NO_INTERCONNECT_BYTES)
    hbm_bw = dialect.hbm_bandwidth or TARGET.hbm_bandwidth
    equiv = (wire * hbm_bw / link.link_bandwidth
             + hops * link.hop_latency_s * hbm_bw)
    return CollectiveCost(kind=kind, payload_bytes=payload_bytes,
                          group=group, wire_bytes=wire, hops=hops,
                          hbm_equiv_bytes=int(math.ceil(equiv)))


@dataclasses.dataclass(frozen=True)
class MatrixUnit:
    """Opaque-but-queryable matrix capability (paper Table IV resolution):
    ``tile`` is the native (M, N, K) the unit consumes, ``dtypes`` the
    supported input precisions."""

    tile: Tuple[int, int, int]
    dtypes: Tuple[str, ...]
    throughput_flops: Optional[float] = None  # peak FLOP/s, if public


@dataclasses.dataclass(frozen=True)
class Dialect:
    """One vendor's parameter set for the universal execution model.

    Fields mirror paper Tables I & III:
      W  wave width (threads per lockstep group); a range for Intel.
      R  max registers per thread (32-bit).
      S  scratchpad bytes visible to one workgroup.
      F  register-file bytes per core (for Eq. 1 occupancy).
    """

    name: str
    vendor: str
    wave_width: Tuple[int, ...]
    max_regs_per_thread: int
    scratchpad_bytes: int
    regfile_bytes_per_core: int
    max_workgroup: int
    named_barriers: int
    native_fp64: bool
    memory_levels: Tuple[str, ...]
    divergence_mechanism: str
    matrix_unit: Optional[MatrixUnit] = None
    has_hw_atomics: bool = True
    has_lane_shuffle: bool = True
    hbm_bandwidth: Optional[float] = None  # bytes/s
    peak_flops_bf16: Optional[float] = None
    interconnect: Optional[Interconnect] = None
    notes: str = ""

    @property
    def W(self) -> int:  # noqa: N802 - paper notation
        return self.wave_width[0]

    @property
    def R(self) -> int:  # noqa: N802
        return self.max_regs_per_thread

    @property
    def S(self) -> int:  # noqa: N802
        return self.scratchpad_bytes

    @property
    def F(self) -> int:  # noqa: N802
        return self.regfile_bytes_per_core

    def occupancy(self, regs_per_thread: int, wave_width: Optional[int] = None,
                  reg_width: int = REGISTER_WIDTH_BYTES) -> int:
        """Paper Eq. 1: O = floor(F / (R x W x w))."""
        w_width = self.W if wave_width is None else wave_width
        if regs_per_thread <= 0:
            raise ValueError("regs_per_thread must be positive")
        if regs_per_thread > self.R:
            return 0
        return self.F // (regs_per_thread * w_width * reg_width)

    def buffer_occupancy(self, block_bytes: int, n_buffers: int = 2) -> int:
        """Eq. 1 re-derived for resident buffers: how many block-sized
        pipeline stages fit the scratchpad, ``O = floor(S / (n_buffers x
        block_bytes))`` (on Hopper S is the 227 KB of shared memory a block
        may claim)."""
        if block_bytes <= 0 or n_buffers <= 0:
            raise ValueError("block_bytes and n_buffers must be positive")
        return self.S // (n_buffers * block_bytes)

    def validate_workgroup(self, size: int) -> bool:
        return 0 < size <= self.max_workgroup

    def query(self, key: str):
        """String-keyed query API: 'we do not prescribe W; we query it'."""
        table = {
            "W": self.W,
            "wave_widths": self.wave_width,
            "R": self.R,
            "S": self.S,
            "F": self.F,
            "max_workgroup": self.max_workgroup,
            "named_barriers": self.named_barriers,
            "native_fp64": self.native_fp64,
            "matrix_tile": self.matrix_unit.tile if self.matrix_unit else None,
            "matrix_dtypes": self.matrix_unit.dtypes if self.matrix_unit else (),
            "has_hw_atomics": self.has_hw_atomics,
            "has_lane_shuffle": self.has_lane_shuffle,
            "memory_levels": self.memory_levels,
        }
        if key not in table:
            raise KeyError(f"unknown dialect query {key!r}")
        return table[key]


# ---------------------------------------------------------------------------
# The six dialects shared with the JAX package (same values, field by field)
# ---------------------------------------------------------------------------

NVIDIA_SM89 = Dialect(
    name="nvidia-ada-sm89",
    vendor="NVIDIA",
    wave_width=(32,),
    max_regs_per_thread=255,
    scratchpad_bytes=228 * 1024,
    regfile_bytes_per_core=256 * 1024,
    max_workgroup=1024,
    named_barriers=16,
    native_fp64=True,
    memory_levels=("reg", "shared", "L1", "L2", "DRAM"),
    divergence_mechanism="per-thread PC + predicates (hardware)",
    matrix_unit=MatrixUnit(tile=(16, 16, 16), dtypes=("f16", "bf16", "tf32", "i8")),
    hbm_bandwidth=1008e9,
    interconnect=Interconnect(link_bandwidth=32e9, hop_latency_s=3e-6),
    notes="PTX virtual ISA; per-thread scalar semantics.",
)

AMD_RDNA3 = Dialect(
    name="amd-rdna3",
    vendor="AMD",
    wave_width=(32, 64),
    max_regs_per_thread=256,
    scratchpad_bytes=128 * 1024,
    regfile_bytes_per_core=192 * 1024,
    max_workgroup=1024,
    named_barriers=32,
    native_fp64=True,
    memory_levels=("reg", "LDS", "L0", "L1", "L2", "VRAM"),
    divergence_mechanism="EXEC mask (compiler-managed)",
    matrix_unit=MatrixUnit(tile=(16, 16, 16), dtypes=("f16", "bf16", "i8")),
    hbm_bandwidth=960e9,
    interconnect=Interconnect(link_bandwidth=32e9, hop_latency_s=3e-6),
    notes="SALU/VALU split; compiler hoists uniform ops to scalar unit.",
)

INTEL_XE_HPG = Dialect(
    name="intel-xe-hpg",
    vendor="Intel",
    wave_width=(8, 16),
    max_regs_per_thread=128,
    scratchpad_bytes=512 * 1024,
    regfile_bytes_per_core=64 * 1024,
    max_workgroup=1024,
    named_barriers=1,
    native_fp64=False,
    memory_levels=("reg", "SLM", "L1", "L2", "DRAM"),
    divergence_mechanism="predicated SIMD (compiler-managed)",
    matrix_unit=MatrixUnit(tile=(8, 16, 16), dtypes=("f16", "bf16", "i8")),
    hbm_bandwidth=560e9,
    interconnect=Interconnect(link_bandwidth=32e9, hop_latency_s=3e-6),
    notes="SIMD-register ISA; fixed-function via SEND messages.",
)

APPLE_G13 = Dialect(
    name="apple-g13",
    vendor="Apple",
    wave_width=(32,),
    max_regs_per_thread=128,
    scratchpad_bytes=60 * 1024,
    regfile_bytes_per_core=208 * 1024,
    max_workgroup=1024,
    named_barriers=1,
    native_fp64=False,
    memory_levels=("reg", "threadgroup", "L1", "L2", "L3", "DRAM"),
    divergence_mechanism="hardware execution stack in r0l",
    matrix_unit=None,
    hbm_bandwidth=68e9,
    interconnect=None,
    notes="reverse-engineered (flagged confidence); unified memory.",
)

TPU_V5E = Dialect(
    name="tpu-v5e",
    vendor="Google",
    wave_width=(128,),
    max_regs_per_thread=64,
    scratchpad_bytes=64 * 1024 * 1024,
    regfile_bytes_per_core=64 * 1024 * 1024,
    max_workgroup=1,
    named_barriers=32,
    native_fp64=False,
    memory_levels=("vreg", "VMEM", "HBM"),
    divergence_mechanism="predication (@pl.when / lane masks)",
    matrix_unit=MatrixUnit(tile=(128, 128, 128), dtypes=("bf16", "f32", "i8"),
                           throughput_flops=197e12),
    has_hw_atomics=False,
    has_lane_shuffle=True,
    hbm_bandwidth=819e9,
    peak_flops_bf16=197e12,
    interconnect=Interconnect(link_bandwidth=50e9, hop_latency_s=1e-6),
    notes="systolic+VLIW; latency hidden by async DMA buffers, not waves.",
)

UISA_UNIVERSAL10 = Dialect(
    name="uisa-universal10",
    vendor="UISA",
    wave_width=(32,),
    max_regs_per_thread=128,
    scratchpad_bytes=48 * 1024,
    regfile_bytes_per_core=64 * 1024,
    max_workgroup=256,
    named_barriers=1,
    native_fp64=False,
    memory_levels=("reg", "scratch", "DRAM"),
    divergence_mechanism="abstract (vendor-managed)",
    matrix_unit=None,
    has_hw_atomics=False,
    has_lane_shuffle=False,
    hbm_bandwidth=256e9,
    interconnect=Interconnect(link_bandwidth=16e9, hop_latency_s=5e-6),
    notes="hypothetical minimum universal profile (paper §V, before the "
          "§VII.C shuffle finding promoted primitive 11 to mandatory)",
)

# ---------------------------------------------------------------------------
# The port's target: NVIDIA H100 SXM (Hopper, sm_90a).  Values from NVIDIA's
# H100 data sheet and the Hopper architecture white paper.
# ---------------------------------------------------------------------------

NVIDIA_HOPPER_SM90 = Dialect(
    name="nvidia-hopper-sm90",
    vendor="NVIDIA",
    wave_width=(32,),
    max_regs_per_thread=255,
    scratchpad_bytes=232_448,             # 227 KB opt-in dynamic shared memory
    regfile_bytes_per_core=64 * 1024 * 4,  # 64K 32-bit registers per SM
    max_workgroup=1024,
    named_barriers=16,
    native_fp64=True,
    memory_levels=("reg", "shared", "L1", "L2", "HBM"),
    divergence_mechanism="per-thread PC + predicates (hardware)",
    # wgmma: 64 rows x N (multiple of 8, up to 256) x 16 bf16 deep
    matrix_unit=MatrixUnit(tile=(64, 256, 16),
                           dtypes=("f16", "bf16", "tf32", "fp8", "i8"),
                           throughput_flops=989e12),
    hbm_bandwidth=3.35e12,
    peak_flops_bf16=989e12,
    # NVLink 4: 450 GB/s each way; the hop latency is a model parameter
    interconnect=Interconnect(link_bandwidth=450e9, hop_latency_s=1e-6),
    notes="PTX/SASS; wgmma + TMA + thread-block clusters on sm_90a.",
)

DIALECTS: Dict[str, Dialect] = {
    d.name: d for d in (NVIDIA_SM89, AMD_RDNA3, INTEL_XE_HPG, APPLE_G13,
                        TPU_V5E, UISA_UNIVERSAL10, NVIDIA_HOPPER_SM90)
}

#: the dialect every kernel of this package is compiled against
TARGET = NVIDIA_HOPPER_SM90


def get_dialect(name: str) -> Dialect:
    try:
        return DIALECTS[name]
    except KeyError:
        raise KeyError(
            f"unknown dialect {name!r}; known: {sorted(DIALECTS)}") from None


def gpu_dialects() -> Tuple[Dialect, ...]:
    """The four vendors analysed by the paper (the JAX package's list: it
    leaves out the TPU target, and this package's Hopper target too)."""
    return (NVIDIA_SM89, AMD_RDNA3, INTEL_XE_HPG, APPLE_G13)


def align_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def mxu_align(dim: int, dialect: Dialect = TARGET) -> int:
    """Round ``dim`` up to the dialect's matrix-tile edge (query, not
    assume)."""
    if dialect.matrix_unit is None:
        return dim
    return align_up(dim, dialect.matrix_unit.tile[0])


def dtype_bytes(dtype) -> int:
    """Bytes per element of a torch dtype (or its name): the cost models'
    ``itemsize``."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    if not isinstance(dtype, torch.dtype):
        raise TypeError(f"not a torch dtype: {dtype!r}")
    return dtype.itemsize
