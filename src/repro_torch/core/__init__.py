"""UISA core of the PyTorch port: dialects, primitives, contracts, and the
lowering registry with its execution policy."""
from repro_torch.core.dialect import DIALECTS, TARGET, Dialect, get_dialect
from repro_torch.core.primitives import (ContractViolation, IsaMode,
                                         KernelContract, Primitive,
                                         validate_contract)
from repro_torch.core.registry import (DEFAULT_POLICY, LIBRARY_POLICY,
                                       REGISTRY, ExecutionPolicy,
                                       LoweringRegistry, UnsupportedLowering,
                                       current_policy, resolve_policy,
                                       use_policy)

__all__ = [
    "DIALECTS", "TARGET", "Dialect", "get_dialect", "ContractViolation",
    "IsaMode", "KernelContract", "Primitive", "validate_contract", "DEFAULT_POLICY", "LIBRARY_POLICY",
    "REGISTRY", "ExecutionPolicy", "LoweringRegistry", "UnsupportedLowering",
    "current_policy", "resolve_policy", "use_policy",
]
