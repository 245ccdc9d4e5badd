"""Parameter conversion from the JAX package's tree.

The caller hands over the reference parameters with numpy leaves (for
example ``jax.tree.map(np.asarray, params)``); this module never imports
JAX.  Keys and the stacked ``[L, ...]`` layout are the same in both
packages.
"""
from __future__ import annotations

import numpy as np
import torch


def _keeps_f32(key) -> bool:
    """The f32 scales of an int8 leaf (``<key>_scale``, or the paged
    cache's ``*_scale_pages``) stay f32 whatever ``dtype`` says."""
    return key is not None and (key.endswith("_scale")
                                or key.endswith("_scale_pages"))


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
    which case floating leaves are cast to it, except the f32 scales of a
    quantized tree (``*_scale``, ``*_scale_pages``), which stay f32."""
    dev = torch.device(device)

    def walk(node, key):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return _leaf(node, dev, None if _keeps_f32(key) else dtype)
    return walk(tree, None)
