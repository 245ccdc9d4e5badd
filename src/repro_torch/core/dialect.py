"""Parameterizable dialects (paper Table III) as queryable constants.

The six dialects of the JAX package (four GPU vendors from the paper, the
TPU v5e target, and the ten-invariant universal profile) plus the dialect
this package targets: NVIDIA Hopper (``sm_90a``).  Programs never hardcode
these parameters; they query a :class:`Dialect`.

The collective cost model of the JAX package (``collective_cost``) is not
part of this module yet; it arrives with the scale-out slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

# Register width w in bytes (paper Table I, "typically 4").
REGISTER_WIDTH_BYTES = 4


@dataclasses.dataclass(frozen=True)
class Interconnect:
    """One vendor's chip-to-chip link profile: bytes/s per link per
    direction and the per-hop latency (the alpha of the alpha-beta model)."""

    link_bandwidth: float          # bytes/s, per link per direction
    hop_latency_s: float           # per-hop latency (seconds)
    topology: str = "ring"


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
