"""Architecture registry of the port: ``get_config(name)`` /
``get_reduced(name)`` resolve an arch id (dashes or underscores) to the
module's ``CONFIG`` (the full-size model) and ``REDUCED`` (a same-family
config small enough for a CPU test).

All ten architectures of the JAX package, in its order: the dense family
(mistral-nemo-12b, granite-8b, qwen3-32b with qk_norm, mistral-large-123b),
the MoE family (llama4-scout-17b-16e, granite-moe-3b-a800m), the VLM
(llava-next-mistral-7b, a patch-embedding prefix), the encoder-decoder
(whisper-base), the SSM (mamba2-2.7b) and the hybrid (zamba2-1.2b).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHS = (
    "llama4-scout-17b-16e",
    "granite-moe-3b-a800m",
    "mistral-nemo-12b",
    "granite-8b",
    "qwen3-32b",
    "mistral-large-123b",
    "whisper-base",
    "zamba2-1.2b",
    "mamba2-2.7b",
    "llava-next-mistral-7b",
)


def _module(name: str):
    if name not in ARCHS and name.replace("_", "-") not in ARCHS:
        raise KeyError(f"unknown architecture {name!r}; known: {ARCHS}")
    mod_name = name.replace("-", "_").replace(".", "p")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _module(name).REDUCED
