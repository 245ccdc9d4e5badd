"""Data: the deterministic synthetic LM pipeline."""
from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset

__all__ = ["DataConfig", "SyntheticLMDataset"]
