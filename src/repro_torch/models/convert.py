"""Parameter conversion from the JAX package's tree.

The caller hands over the reference parameters with numpy leaves (for
example ``jax.tree.map(np.asarray, params)``); this module never imports
JAX.  Keys and the stacked ``[L, ...]`` layout are the same in both
packages.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaf(arr, device, dtype):
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":          # ml_dtypes bfloat16
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device, dtype=None):
    """Nested dict of numpy arrays -> the same dict of tensors on
    ``device``.  Every leaf keeps its dtype unless ``dtype`` is given, in
    which case floating leaves are cast to it."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    return _leaf(tree, torch.device(device), dtype)
