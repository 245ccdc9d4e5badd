"""The port's UISA core against the JAX package's, field by field: the six
shared dialects, the Hopper target, the contracts, the execution policy a
ParallelConfig resolves, the layout plan, and explicit-mode selection."""
import dataclasses
import itertools
import warnings

import pytest
import torch

from repro.configs import get_config as ref_config, get_reduced as ref_reduced
from repro.core import dialect as ref_dialect
from repro.core import primitives as ref_primitives
from repro.core.registry import REGISTRY as REF_REGISTRY
from repro.kernels import ops as _ref_ops  # noqa: F401 (registers ref ops)
from repro.models.config import ParallelConfig as RefPar
from repro.models.config import ParamLayout as RefLayout

from repro_torch.configs import get_config, get_reduced
from repro_torch.core import dialect, primitives
from repro_torch.core.registry import (REGISTRY, ExecutionPolicy,
                                       LoweringFallbackWarning,
                                       LoweringRegistry, UnsupportedLowering)
from repro_torch.kernels import fused
from repro_torch.models.config import ParallelConfig, ParamLayout

SHARED = sorted(ref_dialect.DIALECTS)


@pytest.mark.parametrize("name", SHARED)
def test_shared_dialects_equal_reference(name):
    assert dataclasses.asdict(dialect.get_dialect(name)) == \
        dataclasses.asdict(ref_dialect.get_dialect(name))


def test_hopper_dialect_is_the_target():
    d = dialect.TARGET
    assert d.name == "nvidia-hopper-sm90" and d.name not in SHARED
    assert (d.W, d.R, d.S, d.F) == (32, 255, 232_448, 65_536 * 4)
    assert d.matrix_unit.tile == (64, 256, 16)
    assert d.hbm_bandwidth == 3.35e12
    assert d.interconnect.link_bandwidth == 450e9
    assert d.occupancy(64) == 32          # Eq. 1: 256 KiB / (64 x 32 x 4)


def _port_contract(c):
    return primitives.KernelContract(
        kernel=c.kernel, mode=primitives.IsaMode(c.mode.value),
        primitives=frozenset(primitives.Primitive[p.name]
                             for p in c.primitives),
        native_features=c.native_features)


@pytest.mark.parametrize("op", sorted(fused.CONTRACTS))
def test_native_contracts_equal_reference(op):
    ref = [c for c in REF_REGISTRY.contracts(op)
           if c.mode is ref_primitives.IsaMode.NATIVE]
    assert len(ref) == 1
    assert fused.CONTRACTS[op] == _port_contract(ref[0])
    if op not in fused.MODE_OPS:
        assert REGISTRY.modes(op) == ("native", "library")
        return
    # the ops whose abstract and abstract+shuffle kernels are ported too
    assert REGISTRY.modes(op) == ("abstract", "abstract+shuffle", "native",
                                  "library")
    for c in REF_REGISTRY.contracts(op):
        if c.mode.value in ("abstract", "abstract+shuffle"):
            assert fused.MODE_CONTRACTS[(op, c.mode.value)] == \
                _port_contract(c)


def test_contract_validation_agrees_on_every_reference_contract():
    """Every contract the reference registers, on every shared dialect:
    the port's validator raises exactly when the reference's does."""
    checked = 0
    for op in REF_REGISTRY.ops():
        for c in REF_REGISTRY.contracts(op):
            pc = _port_contract(c)
            for name in SHARED:
                ref_ok = port_ok = True
                try:
                    ref_primitives.validate_contract(
                        c, ref_dialect.get_dialect(name))
                except ref_primitives.ContractViolation:
                    ref_ok = False
                try:
                    primitives.validate_contract(pc, dialect.get_dialect(name))
                except primitives.ContractViolation:
                    port_ok = False
                assert ref_ok == port_ok, (op, c.mode, name)
                checked += 1
    assert checked > 100


# (reference dialect, port dialect): each package's own target maps onto
# the other's, foreign dialects stay themselves
DIALECT_PAIRS = [(None, None), ("tpu-v5e", "nvidia-hopper-sm90"),
                 ("nvidia-ada-sm89", "nvidia-ada-sm89")]
GRID = list(itertools.product(
    [None, "library", "native", "abstract", "auto"],
    [None, True, False], DIALECT_PAIRS, [False, True]))


@pytest.mark.parametrize("isa_mode,fuse,dialects,pallas", GRID)
def test_execution_policy_agrees_with_reference(isa_mode, fuse, dialects,
                                                pallas):
    ref_d, port_d = dialects
    ref = RefPar(isa_mode=isa_mode, fuse_epilogues=fuse, isa_dialect=ref_d,
                 use_pallas_attn=pallas).execution_policy()
    got = ParallelConfig(isa_mode=isa_mode, fuse_epilogues=fuse,
                         isa_dialect=port_d,
                         use_pallas_attn=pallas).execution_policy()
    assert (got.mode, got.kernel_mode, got.fuse, got.precision) == \
        (ref.mode, ref.kernel_mode, ref.fuse, ref.precision)
    assert got.fuses() == ref.fuses()
    assert got.kernel().mode == ref.kernel().mode
    assert got.kernel().fuses() == ref.kernel().fuses()
    for cfg_name in ("granite-8b", "granite-8b-reduced"):
        ref_cfg = (ref_config("granite-8b") if cfg_name == "granite-8b"
                   else ref_reduced("granite-8b"))
        cfg = (get_config("granite-8b") if cfg_name == "granite-8b"
               else get_reduced("granite-8b"))
        assert dataclasses.asdict(ParamLayout.plan(cfg, got)) == \
            dataclasses.asdict(RefLayout.plan(ref_cfg, ref))


def test_unported_arch_raises():
    """Every architecture of the JAX package is ported
    (tests/test_torch_archs.py holds the ten configs); a name outside
    ``ARCHS`` raises ``KeyError``, under either spelling."""
    for name in ("qwen3-64b", "qwen3_64b"):
        with pytest.raises(KeyError, match="unknown architecture"):
            get_config(name)
    with pytest.raises(KeyError, match="unknown architecture"):
        get_reduced("qwen3-64b")


class TestSelect:
    def test_main_path_policy_selects_the_kernels(self):
        pol = ParallelConfig(fuse_epilogues=True,
                             use_pallas_attn=True).execution_policy()
        assert pol.fuses() and pol.kernel().mode == "native"
        assert REGISTRY.select("rmsnorm_matmul", pol.kernel()).impl \
            is fused.rmsnorm_matmul
        assert REGISTRY.select("flash_attention_matmul", pol.kernel()).impl \
            is fused.flash_attention_matmul
        assert REGISTRY.select("rmsnorm_swiglu", pol).impl \
            is fused.rmsnorm_swiglu_plain

    def test_foreign_dialect_takes_the_declared_fallback(self):
        pol = ExecutionPolicy(mode="native", dialect="nvidia-ada-sm89")
        before = len(REGISTRY.fallback_events)
        with pytest.warns(LoweringFallbackWarning):
            low = REGISTRY.select("rmsnorm_swiglu", pol)
        assert low.impl is fused.rmsnorm_swiglu_plain
        assert len(REGISTRY.fallback_events) == before + 1

    def test_foreign_dialect_raises_for_operands_on_the_card(self):
        pol = ExecutionPolicy(mode="native", dialect="nvidia-ada-sm89")
        before = len(REGISTRY.fallback_events)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            for op in ("rmsnorm_matmul", "rmsnorm_swiglu",
                       "flash_attention_matmul"):
                with pytest.raises(UnsupportedLowering, match="on the card"):
                    REGISTRY.select(op, pol, device=torch.device("cuda", 0))
        assert len(REGISTRY.fallback_events) == before
        with pytest.warns(LoweringFallbackWarning):
            low = REGISTRY.select("rmsnorm_matmul", pol,
                                  device=torch.device("cpu"))
        assert low.impl is fused.rmsnorm_matmul_plain

    def test_auto_and_int8_raise_not_implemented(self):
        """``auto`` no longer raises: at a shape it picks the cheapest
        legal kernel lowering (tests/test_torch_auto.py pins the picks);
        int8 in a registry where no op declares an int8 variant keeps the
        base row, as the JAX package's select does (the process registry's
        fused ops do declare one, tests/test_torch_int8.py)."""
        low = REGISTRY.select("rmsnorm_matmul", ExecutionPolicy(mode="auto"),
                              shape=dict(rows=8, d=4096, n=6144))
        assert low.op == "rmsnorm_matmul" and low.mode.value != "library"
        reg = LoweringRegistry()
        low = reg.register("rmsnorm_matmul", "native", fused.rmsnorm_matmul,
                           contract=fused.CONTRACTS["rmsnorm_matmul"])
        assert reg.select("rmsnorm_matmul", ExecutionPolicy(
            mode="native", precision="int8")) is low

    def test_unregistered_mode_raises(self):
        """An op with a native row only has no abstract row and declares
        no fallback for it (a bare registry, so that no port of a further
        lowering changes what this test holds)."""
        reg = LoweringRegistry()
        reg.register("rmsnorm_matmul", "native", fused.rmsnorm_matmul,
                     contract=fused.CONTRACTS["rmsnorm_matmul"])
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            with pytest.raises(RuntimeError, match="no fallback"):
                reg.select("rmsnorm_matmul",
                           ExecutionPolicy(mode="abstract"))

    def test_registration_checks_contracts(self):
        reg = LoweringRegistry()
        c = fused.CONTRACTS["rmsnorm_matmul"]
        with pytest.raises(primitives.ContractViolation, match="drift"):
            reg.register("other", "native", fused.rmsnorm_matmul, contract=c)
        with pytest.raises(primitives.ContractViolation):
            reg.register("x", "native", fused.rmsnorm_matmul)
        bad = primitives.KernelContract(
            kernel="x", mode=primitives.IsaMode.ABSTRACT,
            primitives=frozenset({primitives.Primitive.LANE_SHUFFLE}))
        with pytest.raises(primitives.ContractViolation):
            reg.register("x", "abstract", fused.rmsnorm_matmul, contract=bad)
        low = reg.register("rmsnorm_matmul", "native", fused.rmsnorm_matmul,
                           contract=c)
        assert low.target == dialect.TARGET.name
        with pytest.raises(ValueError, match="already"):
            reg.register("rmsnorm_matmul", "native", fused.rmsnorm_matmul,
                         contract=c)
