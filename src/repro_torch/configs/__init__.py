"""Architecture registry of the port: ``get_config(name)`` /
``get_reduced(name)`` resolve an arch id (dashes or underscores) to the
module's ``CONFIG`` (the full-size model) and ``REDUCED`` (a same-family
config small enough for a CPU test).

Ported: granite-8b (dense), mamba2-2.7b (ssm), granite-moe-3b-a800m
(moe) and zamba2-1.2b (hybrid); the other six architectures of the JAX
package follow with their families (ROADMAP, "The remaining dense
configs" and "The rest of the plain model layer, VLM and
encoder-decoder").
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHS = ("granite-8b", "mamba2-2.7b", "granite-moe-3b-a800m",
         "zamba2-1.2b")


def _module(name: str):
    if name not in ARCHS and name.replace("_", "-") not in ARCHS:
        raise KeyError(f"architecture {name!r} is not ported yet; "
                       f"ported: {ARCHS}")
    mod_name = name.replace("-", "_").replace(".", "p")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _module(name).REDUCED
