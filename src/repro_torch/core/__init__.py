"""UISA core of the PyTorch port: the paper's contribution as a layer (the
JAX package's ``repro.core``, less its scale-out pieces).

- :mod:`repro_torch.core.dialect`: parameterizable dialects (Table III),
  queryable, and the collective cost model.
- :mod:`repro_torch.core.primitives`: the 11 primitives (Table II +
  §VII.C), their per-vendor table, and the kernel-contract validator.
- :mod:`repro_torch.core.execution_model`: thread hierarchy, Eq. 1
  occupancy.
- :mod:`repro_torch.core.memory_model`: scoped acquire/release (Fig. 2).
- :mod:`repro_torch.core.mapping`: Fig. 3 mapping reports.
- :mod:`repro_torch.core.shuffle`: primitive 11 as an API (§VII.C).
- :mod:`repro_torch.core.pipeline`: multi-buffer staging plans (Eq. 1).
- :mod:`repro_torch.core.tuning`: candidate grids, the tuning table.
- :mod:`repro_torch.core.registry`: the lowering registry, its execution
  policy and ``auto``.
"""
from repro_torch.core.dialect import (DIALECTS, NVIDIA_HOPPER_SM90, TARGET,
                                      TPU_V5E, UISA_UNIVERSAL10, Dialect,
                                      align_up, dtype_bytes, get_dialect,
                                      gpu_dialects, mxu_align)
from repro_torch.core.primitives import (SPECS, UNIVERSAL_PLUS_SHUFFLE,
                                         UNIVERSAL_SET, Classification,
                                         ContractViolation, IsaMode,
                                         KernelContract, Primitive,
                                         validate_contract)
from repro_torch.core.execution_model import (LaunchError, LaunchGeometry,
                                              choose_block_bytes, grid_for,
                                              occupancy,
                                              tpu_pipeline_occupancy,
                                              validate_launch)
from repro_torch.core.memory_model import (MANDATORY_HIERARCHY, Ordering,
                                           Scope, fence, requires_fence)
from repro_torch.core.shuffle import (fold_rows, lane_shuffle_down,
                                      lane_shuffle_up, lane_shuffle_xor,
                                      lane_tree_reduce, row_reduce_shuffle,
                                      scratch_tree_bytes, scratch_tree_reduce,
                                      tree_stages)
from repro_torch.core.pipeline import PipelinePlan, pad_rows, plan_row_pipeline
from repro_torch.core.tuning import (TUNING_TABLE, TuningTable,
                                     register_op_space,
                                     tuned_attention_blocks, tuned_block,
                                     tuned_plan)
from repro_torch.core.registry import (AUTO_POLICY, DEFAULT_POLICY,
                                       LIBRARY_POLICY, REGISTRY,
                                       ExecutionPolicy, Lowering,
                                       LoweringFallbackWarning,
                                       LoweringRegistry, UnsupportedLowering,
                                       current_policy, resolve_policy,
                                       use_policy)

__all__ = [
    "Dialect", "DIALECTS", "TARGET", "TPU_V5E", "UISA_UNIVERSAL10",
    "NVIDIA_HOPPER_SM90", "get_dialect", "gpu_dialects", "mxu_align",
    "align_up", "dtype_bytes", "Primitive", "IsaMode", "KernelContract",
    "ContractViolation", "validate_contract", "UNIVERSAL_SET",
    "UNIVERSAL_PLUS_SHUFFLE", "SPECS", "Classification", "LaunchGeometry",
    "LaunchError", "validate_launch", "occupancy", "tpu_pipeline_occupancy",
    "choose_block_bytes", "grid_for", "Scope", "Ordering", "fence",
    "requires_fence", "MANDATORY_HIERARCHY", "lane_shuffle_down",
    "lane_shuffle_up", "lane_shuffle_xor", "lane_tree_reduce", "fold_rows",
    "row_reduce_shuffle", "scratch_tree_reduce", "tree_stages",
    "scratch_tree_bytes", "PipelinePlan", "plan_row_pipeline", "pad_rows",
    "TUNING_TABLE", "TuningTable", "register_op_space",
    "tuned_attention_blocks", "tuned_block", "tuned_plan",
    "AUTO_POLICY", "DEFAULT_POLICY", "ExecutionPolicy", "LIBRARY_POLICY",
    "Lowering", "LoweringFallbackWarning", "LoweringRegistry", "REGISTRY",
    "UnsupportedLowering", "current_policy", "resolve_policy", "use_policy",
]
