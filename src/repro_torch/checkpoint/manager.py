"""Fault-tolerant checkpoints in the JAX package's format
(``checkpoint/manager.py``): a checkpoint written by either package
restores in the other.

- **Format**: ``step_<n:08d>/`` holds one ``.npy`` a leaf, named by its
  slash-joined tree path with ``/`` -> ``__``, and ``manifest.json``
  (``step``, ``time``, ``extra``, ``param_layout``, ``precision``,
  ``leaves``: shape and dtype a leaf).  Nested dicts flatten in sorted key
  order, as ``jax.tree_util`` flattens them, so both packages write the
  same manifest and the same files.
- **bf16**: numpy has no bfloat16.  A bf16 leaf is held on the host as its
  16-bit patterns (numpy ``V2``) and written with the ``'<V2'`` header
  that ``np.save`` gives an ``ml_dtypes`` bfloat16 array, beside
  ``"dtype": "bfloat16"``: the file is the one JAX writes.  ``np.load``
  reads such a file back as ``|V2`` whoever wrote it, so a leaf is read by
  the manifest's dtype.
- **Atomic commit**: a save lands in ``step_<n>.tmp/`` and is renamed to
  ``step_<n>/`` once every file is fsync'd.
- **Async save**: ``save(..., blocking=False)`` copies the tree to host
  memory at once (the caller may update it in place right after), then
  writes from a thread; ``wait()`` re-raises its error.
- **Retention**: the newest ``keep`` checkpoints plus every multiple of
  ``keep_period``.
- **Layout and precision migration**: :func:`migrate_layout` reconciles
  the per-matrix (``wq``/``wk``/``wv``, ``wi``/``wg``) and the
  concatenated (``wqkv``, ``wig``) layouts in both directions, bitwise,
  and dequantizes or quantizes (power-of-two at-rest scales,
  :func:`quantize_leaf`) toward the template's dtypes.

Restoring onto a device mesh (``restore(shardings=...)``) comes with the
scale-out slice.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.tree import flatten
from repro_torch.tree import map as map_tree
from repro_torch.tree import unflatten

#: concatenated-layout leaf basename -> its legacy per-matrix parts, in
#: concatenation order
LAYOUT_GROUPS = {"wqkv": ("wq", "wk", "wv"), "wig": ("wi", "wg")}
_PART_TO_CAT = {part: (cat, parts)
                for cat, parts in LAYOUT_GROUPS.items() for part in parts}

#: the host form of a bf16 leaf: its 16-bit patterns
BF16 = np.dtype("V2")

def host_dtype(dtype) -> np.dtype:
    """The numpy dtype of a leaf's host form (``BF16`` for bfloat16) for a
    torch or numpy dtype or a manifest's dtype name."""
    if dtype == torch.bfloat16 or str(dtype) == "bfloat16":
        return BF16
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def dtype_name(dtype) -> str:
    """The manifest's name of a host dtype (JAX's ``str(dtype)``)."""
    dtype = np.dtype(dtype)
    return "bfloat16" if dtype == BF16 else str(dtype)


def bf16_to_f32(arr: np.ndarray) -> np.ndarray:
    """bf16 patterns -> f32, exactly."""
    return (arr.view(np.uint16).astype(np.uint32) << 16).view(np.float32)


def f32_to_bf16(arr: np.ndarray) -> np.ndarray:
    """f32 -> bf16 patterns, rounded to nearest even (NaN kept a NaN)."""
    u = np.array(arr, dtype=np.float32, order="C").view(np.uint32)
    rounded = ((u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1)))
               >> 16).astype(np.uint16)
    nan = np.isnan(arr)
    rounded[nan] = ((u[nan] >> 16) | np.uint32(0x40)).astype(np.uint16)
    return rounded.view(BF16)


def _to_f32(arr: np.ndarray) -> np.ndarray:
    return bf16_to_f32(arr) if arr.dtype == BF16 else arr.astype(np.float32)


def layout_of(flat_keys) -> str:
    """'concat' when any leaf is a persisted fused-layout tensor."""
    for key in flat_keys:
        if key.rpartition("/")[2] in LAYOUT_GROUPS:
            return "concat"
    return "legacy"


def precision_of(flat: Mapping[str, Any]) -> str:
    """'int8' when any weight leaf is quantized (has a scale sibling)."""
    for key, leaf in flat.items():
        if np.dtype(leaf.dtype) == np.int8 and key + "_scale" in flat:
            return "int8"
    return "f32"


def quantize_leaf(arr: np.ndarray):
    """Per-output-channel symmetric int8 with power-of-two scales
    ``2^(floor(log2 max) - 6)``: dequantize -> requantize is a fixed point
    (the same scale, the same int8 bytes)."""
    a = _to_f32(arr)
    m = np.maximum(np.max(np.abs(a), axis=-2), 1e-8)
    _, e = np.frexp(m)                           # m = f * 2^e, f in [.5,1)
    scale = np.ldexp(np.float32(1.0), e - 7).astype(np.float32)
    q = np.clip(np.round(a / np.expand_dims(scale, -2)),
                -127, 127).astype(np.int8)
    return q, scale


def dequantize_leaf(q: np.ndarray, scale: np.ndarray, dtype=np.float32):
    out = q.astype(np.float32) * np.expand_dims(scale, -2)
    dtype = host_dtype(dtype)
    return f32_to_bf16(out) if dtype == BF16 else out.astype(dtype)


def migrate_layout(flat: Dict[str, np.ndarray],
                   template_shapes: Mapping[str, tuple],
                   template_dtypes: Optional[Mapping[str, Any]] = None
                   ) -> Dict[str, np.ndarray]:
    """Reconcile checkpoint leaves to the template's layout and precision.

    A template key missing from ``flat`` is made from the other layout:
    joined by last-axis concatenation, or split at the widths of the
    template's parts; consumed leaves the template does not name are
    dropped.  With ``template_dtypes``, int8 leaves beside a ``_scale``
    sibling are first dequantized unless the template wants that key int8,
    and template keys declared int8 are quantized last
    (:func:`quantize_leaf`).  Bitwise on weights in both directions."""
    out = dict(flat)
    dtypes = {k: host_dtype(v) for k, v in (template_dtypes or {}).items()}
    f32 = np.dtype(np.float32)
    for key in list(out):
        if key not in out:                 # a scale popped by a prior key
            continue
        skey = key + "_scale"
        if (np.dtype(out[key].dtype) == np.int8 and skey in out
                and dtypes.get(key, f32) != np.int8):
            out[key] = dequantize_leaf(out[key], out[skey],
                                       dtypes.get(key, f32))
            if skey not in template_shapes:
                out.pop(skey)
    for key, shape in template_shapes.items():
        if key in out:
            continue
        prefix, _, base = key.rpartition("/")
        pfx = prefix + "/" if prefix else ""
        if base in LAYOUT_GROUPS:
            part_keys = [pfx + p for p in LAYOUT_GROUPS[base]]
            if all(p in flat for p in part_keys):
                joined = np.concatenate([out[p] for p in part_keys],
                                        axis=-1)
                if joined.shape != tuple(shape):
                    raise ValueError(
                        f"{key}: joined parts have shape {joined.shape} "
                        f"!= template {tuple(shape)} (checkpoint and "
                        f"template disagree on the group's widths)")
                out[key] = joined
                for p in part_keys:
                    out.pop(p, None)
        elif base in _PART_TO_CAT:
            cat, parts = _PART_TO_CAT[base]
            cat_key = pfx + cat
            if cat_key in flat:
                widths = [template_shapes[pfx + p][-1] for p in parts]
                if sum(widths) != flat[cat_key].shape[-1]:
                    raise ValueError(
                        f"{cat_key}: concatenated width "
                        f"{flat[cat_key].shape[-1]} != template parts "
                        f"{widths}")
                off = 0
                for p, w in zip(parts, widths):
                    out[pfx + p] = out[cat_key][..., off:off + w]
                    off += w
                out.pop(cat_key, None)
    for key, dtype in dtypes.items():
        if dtype != np.int8:
            continue
        leaf = out.get(key)
        if leaf is None or np.dtype(leaf.dtype) == np.int8:
            continue                       # absent, or already quantized
        q, s = quantize_leaf(leaf)
        skey = key + "_scale"
        if skey in template_shapes and s.shape != tuple(
                template_shapes[skey]):
            raise ValueError(
                f"{skey}: quantized scales have shape {s.shape} != "
                f"template {tuple(template_shapes[skey])}")
        out[key] = q
        out[skey] = s
    return out


# --------------------------------------------------------------------------
# tensors <-> host arrays
# --------------------------------------------------------------------------


def to_host(leaf) -> np.ndarray:
    """A tensor (or array) -> its host form, a copy (bf16 as ``BF16``)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(BF16)
        return t.numpy()
    return np.array(leaf)


def to_tensor(arr: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """A host array -> a tensor of ``dtype`` on ``device``."""
    arr = np.array(arr, order="C")            # a copy; 0-d stays 0-d
    if arr.dtype == BF16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype)


def _save_npy(f, arr: np.ndarray) -> None:
    if arr.dtype != BF16:
        np.save(f, arr)
        return
    # np.save would write '|V2'; JAX's ml_dtypes bfloat16 writes '<V2'
    np.lib.format.write_array_header_1_0(
        f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
    f.write(arr.tobytes(order="C"))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 keep_period: Optional[int] = None):
        self.directory = directory
        self.keep = keep
        self.keep_period = keep_period
        os.makedirs(directory, exist_ok=True)
        self._save_thread: Optional[threading.Thread] = None
        self._save_error: Optional[BaseException] = None

    # ---- paths ----

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name[5:]))
                except ValueError:
                    continue
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ---- save ----

    def save(self, step: int, tree, *, extra: Optional[dict] = None,
             blocking: bool = True, migrate_to=None):
        """Copy ``tree`` to the host now and write it (from a thread unless
        ``blocking``).  ``migrate_to``: a template tree (anything with
        ``.shape`` and ``.dtype`` a leaf) whose layout and precision the
        checkpoint is written in."""
        self.wait()  # one in-flight save at a time
        host_flat = {k: to_host(v) for k, v in flatten(tree).items()}
        if migrate_to is not None:
            tmpl_flat = flatten(migrate_to)
            host_flat = migrate_layout(
                host_flat,
                {k: tuple(v.shape) for k, v in tmpl_flat.items()},
                {k: v.dtype for k, v in tmpl_flat.items()})
        manifest = {
            "step": step,
            "time": time.time(),
            "extra": extra or {},
            "param_layout": layout_of(host_flat),
            "precision": precision_of(host_flat),
            "leaves": {k: {"shape": list(v.shape),
                           "dtype": dtype_name(v.dtype)}
                       for k, v in host_flat.items()},
        }
        if blocking:
            self._write(step, host_flat, manifest)
        else:
            self._save_thread = threading.Thread(
                target=self._write_guarded, args=(step, host_flat, manifest),
                daemon=True)
            self._save_thread.start()

    def _write_guarded(self, step, host_flat, manifest):
        try:
            self._write(step, host_flat, manifest)
        except BaseException as e:  # surfaced by wait()
            self._save_error = e

    def _write(self, step: int, host_flat, manifest):
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for key, arr in host_flat.items():
            fname = key.replace("/", "__") + ".npy"
            with open(os.path.join(tmp, fname), "wb") as f:
                _save_npy(f, arr)
                f.flush()
                os.fsync(f.fileno())
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)              # the atomic commit point
        self._gc()

    def wait(self):
        """Block until any in-flight async save lands; re-raise its error."""
        if self._save_thread is not None:
            self._save_thread.join()
            self._save_thread = None
        if self._save_error is not None:
            err, self._save_error = self._save_error, None
            raise err

    def _gc(self):
        steps = self.all_steps()
        protect = set(steps[-self.keep:]) if self.keep else set(steps)
        if self.keep_period:
            protect |= {s for s in steps if s % self.keep_period == 0}
        for s in steps:
            if s not in protect:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ---- restore ----

    def manifest(self, step: int) -> dict:
        with open(os.path.join(self._step_dir(step), "manifest.json")) as f:
            return json.load(f)

    def restore(self, step: int, template, *, device=None):
        """Restore into the structure, dtypes and (unless ``device`` is
        given) devices of ``template``, a tree of tensors.  Leaves migrate
        toward the template's layout and precision
        (:func:`migrate_layout`); a partial template (params alone from a
        train checkpoint) reads only what it needs."""
        d = self._step_dir(step)
        tmpl_flat = flatten(template)
        stored = self.manifest(step)["leaves"]
        needed = set(tmpl_flat) & set(stored)
        for key in set(tmpl_flat) - set(stored):
            prefix, _, base = key.rpartition("/")
            pfx = prefix + "/" if prefix else ""
            if base in LAYOUT_GROUPS:
                needed |= {pfx + p for p in LAYOUT_GROUPS[base]} & set(stored)
            elif base in _PART_TO_CAT:
                needed |= {pfx + _PART_TO_CAT[base][0]} & set(stored)
        # an int8 checkpoint's scale siblings ride along even when the
        # template does not name them: dequantization needs them
        for key in list(needed):
            skey = key + "_scale"
            if skey in stored and skey not in tmpl_flat:
                needed.add(skey)
        flat_np = {}
        for key in needed:
            arr = np.load(os.path.join(d, key.replace("/", "__") + ".npy"))
            # by the manifest's dtype: a bf16 file loads as void bytes
            flat_np[key] = arr.view(host_dtype(stored[key]["dtype"]))
        flat_np = migrate_layout(
            flat_np, {k: tuple(v.shape) for k, v in tmpl_flat.items()},
            {k: v.dtype for k, v in tmpl_flat.items()})
        def put(arr, tmpl):
            return to_tensor(arr, tmpl.dtype,
                             device if device is not None else tmpl.device)
        return map_tree(put, unflatten(template, flat_np), template)

