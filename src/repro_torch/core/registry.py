"""Dialect-aware lowering registry + execution policy (the Table V dispatch).

The JAX package's ``core/registry.py``.  Every kernel variant registers a
:class:`Lowering` (op, :class:`IsaMode`, :class:`KernelContract`, impl,
structural cost), contract-checked at registration.  An
:class:`ExecutionPolicy` is resolved once per model and threaded through
the layers above the kernels; every fused hot spot routes through
:meth:`LoweringRegistry.select`.  Native lowerings are pinned to the
dialect they were built for (:data:`TARGET`, Hopper): under a foreign
dialect a request for them follows a *declared* fallback, warned and
recorded, never a silent rewrite, and never for operands on the card.

``mode="auto"`` picks the cheapest legal non-library lowering by its
structural cost model (:func:`cost_key`: scratch traffic first, the
paper's §VII.C currency, then round trips, then HBM bytes, the more
portable budget breaking ties), ranked with the policy's dialect as the
tuning-table slice.  Only when no kernel lowering is legal does it take
the ``library`` row, and that escape, like a declared fallback, is taken
for CPU operands only.  The serving tick issues every launch from the
host, so a pick is memoised per (op, policy, shape, device type) and the
memo is cleared whenever the rows change.

The precision axis: ``ExecutionPolicy(precision="int8")`` retargets an op
onto the quantized twin it declared (:meth:`LoweringRegistry.
register_precision_variant`); an op without one (a norm, plain attention)
runs its own rows, as in the JAX package, whatever the precision.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import functools
import warnings
from typing import Callable, Dict, Mapping, Optional, Tuple

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
    """A declared fallback (or the auto library escape) was taken."""


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
AUTO_POLICY = ExecutionPolicy(mode=AUTO)

_policy_var: contextvars.ContextVar[Optional[ExecutionPolicy]] = \
    contextvars.ContextVar("uisa_torch_execution_policy", default=None)

#: ambient mesh axes installed by :func:`use_mesh_axes` (axis name -> size)
_mesh_axes_var: contextvars.ContextVar[Optional[Mapping[str, int]]] = \
    contextvars.ContextVar("uisa_torch_mesh_axes", default=None)

#: the tensor-parallel mesh axis the collective twins shard over
TP_AXIS = "model"


@contextlib.contextmanager
def use_mesh_axes(axes: Mapping[str, int]):
    """Install ``axes`` (axis name -> size) as the ambient mesh for the
    dynamic extent: selection and cost models read axis sizes here first,
    so a mesh-sensitive ranking runs without a process group."""
    token = _mesh_axes_var.set(dict(axes))
    try:
        yield axes
    finally:
        _mesh_axes_var.reset(token)


@functools.lru_cache(maxsize=1)
def _mesh_env():
    """``torch.distributed``'s record of the entered device meshes (None in
    a build without it), imported once: selection reads it per call."""
    try:
        from torch.distributed.device_mesh import _mesh_resources
    except ImportError:
        return None
    return _mesh_resources


def _entered_device_mesh():
    """The innermost ``torch.distributed`` ``DeviceMesh`` entered with
    ``with mesh:``, or None."""
    stack = getattr(_mesh_env(), "mesh_stack", None)
    return stack[-1] if stack else None


def ambient_mesh_axes() -> Dict[str, int]:
    """The ambient mesh axis sizes: :func:`use_mesh_axes` first, else the
    innermost entered ``DeviceMesh`` (its dim names and sizes), else empty
    (as for a mesh without dim names)."""
    axes = _mesh_axes_var.get()
    if axes is not None:
        return dict(axes)
    mesh = _entered_device_mesh()
    if mesh is None or not mesh.mesh_dim_names:
        return {}
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def tp_axis_size(axis: str = TP_AXIS) -> int:
    """Size of the tensor-parallel axis in the ambient mesh (1: none)."""
    axes = _mesh_axes_var.get()
    if axes is None:
        if _entered_device_mesh() is None:   # the common case, per select
            return 1
        axes = ambient_mesh_axes()
    return int(axes.get(axis, 1))


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
    cost: Optional[Callable[..., Mapping]] = None
    #: dialect a native lowering is pinned to; portable lowerings carry None
    target: Optional[str] = None

    def structural_cost(self, plan_dialect: Optional[str] = None,
                        target: Optional[Dialect] = None,
                        **shape) -> Mapping:
        """Modeled cost at ``shape``; ``plan_dialect`` names the tuning-
        table slice the model consults (None: ambient, then TARGET),
        ``target`` the compile target whose parameters it reads (None:
        TARGET; the parity tests pass the JAX package's)."""
        if self.cost is None:
            return {}
        if plan_dialect is not None:
            shape["plan_dialect"] = plan_dialect
        if target is not None:
            shape["target"] = target
        return self.cost(**shape)


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


def cost_key(cost: Mapping, mode: IsaMode) -> Tuple:
    """Cheapness ranking for auto selection.

    Scratch traffic is the §VII.C currency, round trips its latency proxy,
    HBM bytes (with any collective traffic at its HBM-equivalent bytes) the
    bandwidth term; the primitive-budget rank breaks ties in favor of the
    more portable variant (so abstract+shuffle beats native when both
    model to zero scratch and the same bytes)."""
    return (cost.get("scratch_bytes_total", 0),
            cost.get("scratch_round_trips_per_block", 0),
            cost.get("hbm_bytes", 0)
            + cost.get("collective_hbm_equiv_bytes", 0),
            _PORTABILITY[mode])


class LoweringRegistry:
    """op -> {IsaMode -> Lowering}, plus declared fallbacks + event log."""

    EVENT_LOG_MAXLEN = 256

    def __init__(self):
        self._variants: Dict[str, Dict[IsaMode, Lowering]] = {}
        self._fallbacks: Dict[Tuple[str, IsaMode], Fallback] = {}
        #: (base op, precision) -> quantized op name
        self._precision_variants: Dict[Tuple[str, str], str] = {}
        #: base op -> its tensor-parallel twin (kernels/collective.py)
        self._collective_variants: Dict[str, str] = {}
        self.fallback_events: "collections.deque[FallbackEvent]" = \
            collections.deque(maxlen=self.EVENT_LOG_MAXLEN)
        #: auto picks by (op, policy, shape items, device type, tp size)
        self._auto_memo: Dict[Tuple, Lowering] = {}

    def register(self, op: str, mode, impl: Callable, *,
                 contract: Optional[KernelContract] = None,
                 cost: Optional[Callable[..., Mapping]] = None,
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
                       cost=cost, target=target)
        variants[mode] = low
        self._auto_memo.clear()
        return low

    def unregister(self, op: str, mode=None) -> None:
        """Remove one row of ``op`` (or, with no ``mode``, the op with its
        fallbacks, precision variants and collective pairs)."""
        if mode is None:
            self._variants.pop(op, None)
            for key in [k for k in self._fallbacks if k[0] == op]:
                del self._fallbacks[key]
            for key in [k for k, v in self._precision_variants.items()
                        if k[0] == op or v == op]:
                del self._precision_variants[key]
            for key in [k for k, v in self._collective_variants.items()
                        if k == op or v == op]:
                del self._collective_variants[key]
        else:
            self._variants.get(op, {}).pop(IsaMode(mode), None)
        self._auto_memo.clear()

    def declare_fallback(self, op: str, missing, to, reason: str) -> None:
        """Declare that requesting ``missing`` for ``op`` legally lowers to
        ``to``: the explicit replacement for silent mode rewrites."""
        missing, to = IsaMode(missing), IsaMode(to)
        self._fallbacks[(op, missing)] = Fallback(op, missing, to, reason)
        self._auto_memo.clear()

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
        self._auto_memo.clear()

    def precision_variant(self, op: str, precision: Optional[str]
                          ) -> Optional[str]:
        """The quantized twin of ``op`` at ``precision``, if declared."""
        if precision in (None, "f32"):
            return None
        return self._precision_variants.get((op, precision))

    def register_collective_variant(self, base_op: str, tp_op: str) -> None:
        """Declare ``tp_op`` the tensor-parallel twin of ``base_op``: a
        registered op whose cost carries a ``collective_hbm_equiv_bytes``
        term.  Under ``auto`` with a model axis in the ambient mesh, the
        twin's legal rows join the base op's candidates.  Both ops must be
        registered already."""
        for name in (base_op, tp_op):
            if name not in self._variants:
                raise UnsupportedLowering(
                    f"collective variant maps unknown op {name!r}")
        self._collective_variants[base_op] = tp_op
        self._auto_memo.clear()

    def collective_variant(self, op: str) -> Optional[str]:
        """The tensor-parallel twin of ``op``, if declared."""
        return self._collective_variants.get(op)

    def collective_variants(self) -> Dict[str, str]:
        """Every declared base -> twin pair."""
        return dict(self._collective_variants)

    def ops(self) -> Tuple[str, ...]:
        return tuple(sorted(self._variants))

    def modes(self, op: str) -> Tuple[str, ...]:
        modes = sorted(self._variants[op], key=_PORTABILITY.__getitem__)
        return tuple(m.value for m in modes)

    def variant(self, op: str, mode) -> Lowering:
        try:
            return self._variants[op][IsaMode(mode)]
        except KeyError:
            raise UnsupportedLowering(
                f"{op} has no registered {mode!r} lowering") from None

    def contracts(self, op: str) -> Tuple[KernelContract, ...]:
        """``op``'s contracts in portability order."""
        modes = sorted(self._variants[op], key=_PORTABILITY.__getitem__)
        return tuple(self._variants[op][m].contract for m in modes)

    def structural_cost(self, op: str, mode, **shape) -> Mapping:
        return self.variant(op, mode).structural_cost(**shape)

    def fallback_for(self, op: str, mode) -> Optional[Fallback]:
        return self._fallbacks.get((op, IsaMode(mode)))

    def legal(self, op: str, mode, dialect: Dialect,
              target: Optional[Dialect] = None) -> bool:
        """Table V legality of a registered variant under ``dialect``.  A
        native lowering is pinned to the compile target: its own
        (:data:`TARGET`), or ``target`` where given (the JAX package's
        tables were made for the TPU)."""
        low = self._variants[op].get(IsaMode(mode))
        if low is None:
            return False
        pinned = low.target if target is None or low.target is None \
            else target.name
        if pinned is not None and pinned != dialect.name:
            return False
        try:
            validate_contract(low.contract, dialect)
            return True
        except ContractViolation:
            return False

    def ranked(self, op: str, dialect: Dialect,
               shape: Optional[Mapping] = None,
               target: Optional[Dialect] = None) -> Tuple[Lowering, ...]:
        """The legal non-library lowerings of ``op`` under ``dialect``,
        cheapest first by :func:`cost_key` at ``shape``, each cost ranked
        with ``dialect`` as its tuning-table slice and ``target`` (None:
        TARGET) as the compile target (native pinned to it).  With a model
        axis of more than one device in the ambient mesh, the rows of
        ``op``'s tensor-parallel twin rank beside its own."""
        shape = dict(shape or {})
        names = [op]
        tp_op = self._collective_variants.get(op)
        if tp_op is not None and tp_axis_size() > 1:
            names.append(tp_op)
        candidates = [low for name in names
                      for m, low in self._variants[name].items()
                      if m is not IsaMode.LIBRARY
                      and self.legal(name, m, dialect, target=target)]
        return tuple(sorted(candidates, key=lambda lo: cost_key(
            lo.structural_cost(plan_dialect=dialect.name, target=target,
                               **shape), lo.mode)))

    def select(self, op: str, policy: Optional[ExecutionPolicy] = None,
               shape: Optional[Mapping] = None, *, device=None) -> Lowering:
        """Resolve policy -> one legal Lowering.

        ``shape`` is the call's shape signature (the JAX package's keys),
        which ``auto`` ranks costs at.  ``device`` is where the operands
        live.  A declared fallback, and auto's library escape, run a
        different lowering than a kernel; on a CUDA device that would put
        the plain version in the kernel's place, so there they raise
        :class:`UnsupportedLowering` instead.  The policy's precision is
        consulted once, here at entry: a declared variant replaces ``op``,
        and every decision below runs against the variant's own rows; an
        op with no variant keeps its own."""
        policy = policy or current_policy() or DEFAULT_POLICY
        quant_op = self.precision_variant(op, policy.precision)
        if quant_op is not None:
            op = quant_op
        dialect = policy.resolved_dialect()
        try:
            variants = self._variants[op]
        except KeyError:
            raise UnsupportedLowering(f"unknown op {op!r}; registered: "
                                      f"{self.ops()}") from None
        on_card = getattr(device, "type", device) == "cuda"
        if policy.mode == AUTO:
            return self._select_auto(op, policy, dialect, shape, on_card)
        mode = IsaMode(policy.mode)
        if mode in variants and self.legal(op, mode, dialect):
            return variants[mode]
        fb = self._fallbacks.get((op, mode))
        if fb is not None and fb.to in variants \
                and self.legal(op, fb.to, dialect):
            if on_card:
                raise UnsupportedLowering(
                    f"{op} [{mode.value}] is not legal for dialect "
                    f"{dialect.name}; its declared fallback [{fb.to.value}] "
                    f"is not taken for operands on the card")
            self._record(op, mode.value, fb.to.value, fb.reason)
            return variants[fb.to]
        raise UnsupportedLowering(
            f"{op} [{mode.value}] is not a legal lowering for dialect "
            f"{dialect.name} and declares no fallback")

    def auto_picks(self) -> Dict[Tuple, Lowering]:
        """The memoised auto picks, by (op, policy, shape items, on the
        card, model-axis size)."""
        return dict(self._auto_memo)

    def _select_auto(self, op: str, policy: ExecutionPolicy,
                     dialect: Dialect, shape: Optional[Mapping],
                     on_card: bool) -> Lowering:
        """auto: the cheapest legal kernel lowering (:meth:`ranked`, the
        tensor-parallel twin's rows among them under a model axis),
        memoised per (op, policy, shape, device type, model-axis size); the
        library escape (recorded once per memo key) only for CPU operands.
        Shapes are Python values: nothing here reads a tensor."""
        key = (op, policy, tuple(sorted((shape or {}).items())), on_card,
               tp_axis_size())
        low = self._auto_memo.get(key)
        if low is not None:
            return low
        ranked = self.ranked(op, dialect, shape)
        if ranked:
            low = ranked[0]
        else:
            library = self._variants[op].get(IsaMode.LIBRARY)
            if library is None:
                raise UnsupportedLowering(
                    f"{op}: no lowering legal for dialect {dialect.name} "
                    f"and no library reference registered")
            if on_card:
                raise UnsupportedLowering(
                    f"{op}: no kernel lowering is legal for dialect "
                    f"{dialect.name}; auto's library escape is not taken "
                    f"for operands on the card")
            self._record(op, AUTO, IsaMode.LIBRARY.value,
                         f"no portable lowering legal for {dialect.name}")
            low = library
        self._auto_memo[key] = low
        return low

    def _record(self, op: str, requested: str, used: str,
                reason: str) -> None:
        self.fallback_events.append(FallbackEvent(op, requested, used,
                                                  reason))
        warnings.warn(f"{op}: {requested} -> {used} ({reason})",
                      LoweringFallbackWarning, stacklevel=3)


#: the process-wide registry every kernel module installs its variants in
REGISTRY = LoweringRegistry()
