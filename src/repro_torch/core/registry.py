"""Dialect-aware lowering registry + execution policy (the Table V dispatch).

Every kernel variant registers a :class:`Lowering` (op, :class:`IsaMode`,
:class:`KernelContract`, impl), contract-checked at registration.  An
:class:`ExecutionPolicy` is resolved once per model and threaded through
the layers above the kernels; every fused hot spot routes through
:meth:`LoweringRegistry.select`.  Native lowerings are pinned to the
dialect they were built for (:data:`TARGET`, Hopper): under a foreign
dialect a request for them follows a *declared* fallback, warned and
recorded, never a silent rewrite, and never for operands on the card.

The precision axis: ``ExecutionPolicy(precision="int8")`` retargets an op
onto the quantized twin it declared (:meth:`LoweringRegistry.
register_precision_variant`); an op without one (a norm, plain attention)
runs its own rows, as in the JAX package, whatever the precision.
Explicit modes only in this slice: ``mode="auto"`` needs the structural
cost model and raises :class:`NotImplementedError` (ROADMAP, "The UISA
core remainder, tuning and auto").
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import warnings
from typing import Callable, Dict, Optional, Tuple

from repro_torch.core.dialect import Dialect, TARGET, get_dialect
from repro_torch.core.primitives import (ContractViolation, IsaMode,
                                         KernelContract, validate_contract)

AUTO = "auto"
POLICY_MODES = tuple(m.value for m in IsaMode) + (AUTO,)
POLICY_PRECISIONS = (None, "f32", "int8")

_PORTABILITY = {IsaMode.ABSTRACT: 0, IsaMode.ABSTRACT_SHUFFLE: 1,
                IsaMode.NATIVE: 2, IsaMode.LIBRARY: 3}


class UnsupportedLowering(RuntimeError):
    """Requested a lowering the registry cannot legally provide."""


class LoweringFallbackWarning(UserWarning):
    """A declared fallback was taken."""


@dataclasses.dataclass(frozen=True)
class ExecutionPolicy:
    """How the layers above the kernels want their hot spots lowered.

    ``mode`` is an :class:`IsaMode` value or ``"auto"``; ``dialect`` names
    the target whose legality rules apply; ``kernel_mode`` optionally
    overrides ``mode`` for kernel-routed hot spots; ``fuse`` gates the
    fused lowerings (None: fuse exactly when ``mode == "auto"``);
    ``precision`` is the weight-precision axis."""

    mode: str = AUTO
    dialect: str = TARGET.name
    kernel_mode: Optional[str] = None
    fuse: Optional[bool] = None
    precision: Optional[str] = None

    def __post_init__(self):
        for m in (self.mode, self.kernel_mode):
            if m is not None and m not in POLICY_MODES:
                raise ValueError(
                    f"unknown isa mode {m!r}; valid: {POLICY_MODES}")
        if self.precision not in POLICY_PRECISIONS:
            raise ValueError(
                f"unknown precision {self.precision!r}; valid: "
                f"{POLICY_PRECISIONS}")

    def resolved_dialect(self) -> Dialect:
        return get_dialect(self.dialect)

    def kernel(self) -> "ExecutionPolicy":
        """The policy for kernel-routed hot spots."""
        if self.kernel_mode is None or self.kernel_mode == self.mode:
            return self
        return dataclasses.replace(self, mode=self.kernel_mode,
                                   kernel_mode=None)

    def fuses(self) -> bool:
        """Whether model hot pairs route through the fused lowerings."""
        if self.fuse is not None:
            return self.fuse
        return self.mode == AUTO


DEFAULT_POLICY = ExecutionPolicy(mode=IsaMode.NATIVE.value)
LIBRARY_POLICY = ExecutionPolicy(mode=IsaMode.LIBRARY.value)

_policy_var: contextvars.ContextVar[Optional[ExecutionPolicy]] = \
    contextvars.ContextVar("uisa_torch_execution_policy", default=None)


def current_policy() -> Optional[ExecutionPolicy]:
    """The ambient policy installed by :func:`use_policy`, if any."""
    return _policy_var.get()


@contextlib.contextmanager
def use_policy(policy: ExecutionPolicy):
    """Install ``policy`` as the ambient default for the dynamic extent."""
    token = _policy_var.set(policy)
    try:
        yield policy
    finally:
        _policy_var.reset(token)


def resolve_policy(mode=None, policy: Optional[ExecutionPolicy] = None,
                   default: ExecutionPolicy = DEFAULT_POLICY
                   ) -> ExecutionPolicy:
    """explicit mode > explicit policy > ambient > ``default``."""
    base = policy or current_policy() or default
    if mode is not None:
        if isinstance(mode, IsaMode):
            mode = mode.value
        return dataclasses.replace(base, mode=mode, kernel_mode=None)
    return base


@dataclasses.dataclass(frozen=True)
class Lowering:
    """One registered realization of an abstract op."""

    op: str
    mode: IsaMode
    impl: Callable
    contract: KernelContract
    #: dialect a native lowering is pinned to; portable lowerings carry None
    target: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class Fallback:
    op: str
    missing: IsaMode
    to: IsaMode
    reason: str


@dataclasses.dataclass(frozen=True)
class FallbackEvent:
    op: str
    requested: str
    used: str
    reason: str


class LoweringRegistry:
    """op -> {IsaMode -> Lowering}, plus declared fallbacks + event log."""

    EVENT_LOG_MAXLEN = 256

    def __init__(self):
        self._variants: Dict[str, Dict[IsaMode, Lowering]] = {}
        self._fallbacks: Dict[Tuple[str, IsaMode], Fallback] = {}
        #: (base op, precision) -> quantized op name
        self._precision_variants: Dict[Tuple[str, str], str] = {}
        self.fallback_events: "collections.deque[FallbackEvent]" = \
            collections.deque(maxlen=self.EVENT_LOG_MAXLEN)

    def register(self, op: str, mode, impl: Callable, *,
                 contract: Optional[KernelContract] = None,
                 target: Optional[str] = None) -> Lowering:
        """Install a variant.  Raises :class:`ContractViolation` when the
        declared contract is out of budget, drifted (wrong op/mode), or
        illegal on its own target dialect."""
        mode = IsaMode(mode)
        if contract is None:
            if mode is not IsaMode.LIBRARY:
                raise ContractViolation(
                    f"{op} [{mode.value}]: non-library lowerings must "
                    f"declare a KernelContract")
            contract = KernelContract(kernel=op, mode=IsaMode.LIBRARY,
                                      primitives=frozenset())
        if contract.kernel != op or contract.mode is not mode:
            raise ContractViolation(
                f"contract drift: registering {op} [{mode.value}] with a "
                f"contract for {contract.kernel} [{contract.mode.value}]")
        if contract.native_features and target is None:
            target = TARGET.name
        validate_contract(contract,
                          TARGET if target is None else get_dialect(target))
        variants = self._variants.setdefault(op, {})
        if mode in variants:
            raise ValueError(f"{op} [{mode.value}] already registered")
        low = Lowering(op=op, mode=mode, impl=impl, contract=contract,
                       target=target)
        variants[mode] = low
        return low

    def declare_fallback(self, op: str, missing, to, reason: str) -> None:
        """Declare that requesting ``missing`` for ``op`` legally lowers to
        ``to``: the explicit replacement for silent mode rewrites."""
        missing, to = IsaMode(missing), IsaMode(to)
        self._fallbacks[(op, missing)] = Fallback(op, missing, to, reason)

    def register_precision_variant(self, base_op: str, precision: str,
                                   quant_op: str) -> None:
        """Declare that ``base_op`` under ``ExecutionPolicy(precision=)``
        dispatches to ``quant_op``, the quantized twin registered as an op
        of its own (own rows, own fallbacks).  Both ops must be registered
        already."""
        if precision not in POLICY_PRECISIONS or precision in (None, "f32"):
            raise ValueError(f"not a quantized precision: {precision!r}")
        for name in (base_op, quant_op):
            if name not in self._variants:
                raise UnsupportedLowering(
                    f"precision variant maps unknown op {name!r}")
        self._precision_variants[(base_op, precision)] = quant_op

    def precision_variant(self, op: str, precision: Optional[str]
                          ) -> Optional[str]:
        """The quantized twin of ``op`` at ``precision``, if declared."""
        if precision in (None, "f32"):
            return None
        return self._precision_variants.get((op, precision))

    def ops(self) -> Tuple[str, ...]:
        return tuple(sorted(self._variants))

    def modes(self, op: str) -> Tuple[str, ...]:
        modes = sorted(self._variants[op], key=_PORTABILITY.__getitem__)
        return tuple(m.value for m in modes)

    def legal(self, op: str, mode, dialect: Dialect) -> bool:
        """Table V legality of a registered variant under ``dialect``."""
        low = self._variants[op].get(IsaMode(mode))
        if low is None:
            return False
        if low.target is not None and low.target != dialect.name:
            return False
        try:
            validate_contract(low.contract, dialect)
            return True
        except ContractViolation:
            return False

    def select(self, op: str, policy: Optional[ExecutionPolicy] = None, *,
               device=None) -> Lowering:
        """Resolve policy -> one legal Lowering.

        ``device`` is where the operands live.  A declared fallback runs a
        different lowering than the one asked for; on a CUDA device that
        would put the plain version in the kernel's place, so there it
        raises :class:`UnsupportedLowering` instead.  The policy's
        precision is consulted once, here at entry: a declared variant
        replaces ``op``, and every decision below runs against the
        variant's own rows; an op with no variant keeps its own."""
        policy = policy or current_policy() or DEFAULT_POLICY
        quant_op = self.precision_variant(op, policy.precision)
        if quant_op is not None:
            op = quant_op
        if policy.mode == AUTO:
            raise NotImplementedError(
                f"{op}: mode='auto' needs the structural cost model "
                f"(ROADMAP, \"The UISA core remainder, tuning and "
                f"auto\"), not ported yet")
        dialect = policy.resolved_dialect()
        try:
            variants = self._variants[op]
        except KeyError:
            raise UnsupportedLowering(f"unknown op {op!r}; registered: "
                                      f"{self.ops()}") from None
        mode = IsaMode(policy.mode)
        if mode in variants and self.legal(op, mode, dialect):
            return variants[mode]
        fb = self._fallbacks.get((op, mode))
        if fb is not None and fb.to in variants \
                and self.legal(op, fb.to, dialect):
            if getattr(device, "type", device) == "cuda":
                raise UnsupportedLowering(
                    f"{op} [{mode.value}] is not legal for dialect "
                    f"{dialect.name}; its declared fallback [{fb.to.value}] "
                    f"is not taken for operands on the card")
            self._record(op, mode.value, fb.to.value, fb.reason)
            return variants[fb.to]
        raise UnsupportedLowering(
            f"{op} [{mode.value}] is not a legal lowering for dialect "
            f"{dialect.name} and declares no fallback")

    def _record(self, op: str, requested: str, used: str,
                reason: str) -> None:
        self.fallback_events.append(FallbackEvent(op, requested, used,
                                                  reason))
        warnings.warn(f"{op}: {requested} -> {used} ({reason})",
                      LoweringFallbackWarning, stacklevel=3)


#: the process-wide registry every kernel module installs its variants in
REGISTRY = LoweringRegistry()
