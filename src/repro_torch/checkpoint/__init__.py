"""Checkpoints in the JAX package's format: atomic, async,
retention-managed, migrating the parameter layout and precision."""
from repro_torch.checkpoint.manager import (LAYOUT_GROUPS, CheckpointManager,
                                            layout_of, migrate_layout)

__all__ = ["CheckpointManager", "LAYOUT_GROUPS", "layout_of",
           "migrate_layout"]
