"""Flash attention as a hand-written Hopper kernel.

:func:`flash_attention` replaces the Pallas kernel
``kernels/attention.py::flash_attention`` of the JAX package
(``_flash_kernel``): online-softmax attention ``[B,H,Sq,D] ->
[B,H,Sq,D]`` in q's dtype, causal with ``kv_offset`` (key ``c`` visible
to query ``i`` when ``c <= i + kv_offset``, default ``Skv - Sq``) or
non-causal, masked scores at the finite -1e30, a row with no visible key
divided by 1 (``csrc/flash_attention.cu``, the online-softmax loop of
``csrc/attention_core.cuh`` with an epilogue that stores O).  GQA folds
``h // group`` in the kernel: k and v are never repeated.

Beside the wrapper is its plain PyTorch version
(:func:`flash_attention_plain`).  The wrapper runs the plain version on
CPU tensors; on CUDA tensors it launches the kernel or raises.  Each
launch adds one to ``LAUNCHES["flash_attention"]``
(``kernels/_launch.py``).  The op registers a ``native`` lowering (the
kernel) and a ``library`` lowering, the JAX package's: the dense oracle
``kernels/ref.py::attention``, whose causal mask always aligns the
queries to the end of the keys.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import (REGISTRY, IsaMode, KernelContract, Primitive,
                              validate_contract)
from repro_torch.kernels import ref as _ref
from repro_torch.kernels._launch import (check_device, dtype_code, launch,
                                         stream)

NEG_INF = -1e30
#: the kernel's limits: head width, and rows of (head in group, query)
MAX_HEAD_DIM, BLOCK_ROWS = 128, 64

NATIVE_CONTRACT = KernelContract(
    kernel="flash_attention", mode=IsaMode.NATIVE,
    primitives=frozenset(Primitive),
    native_features=frozenset({"mxu_aligned_tiles", "dimension_semantics",
                               "multi_buffering"}))
validate_contract(NATIVE_CONTRACT)


def _kv_offset(causal: bool, kv_offset: Optional[int], sq: int, skv: int):
    """The diagonal's offset; a non-causal call sees every key."""
    if not causal:
        return skv
    return skv - sq if kv_offset is None else int(kv_offset)


def masked_attention(q, k, v, visible, softmax=None):
    """``softmax(q k^T / sqrt(D)) v`` in f32, keys where ``visible``
    (broadcast to [B,H,Sq,Skv]) is False scored -1e30, in q's dtype; GQA by
    repeating the kv heads.  The plain arithmetic of every attention kernel
    of the port; ``softmax`` (f32 scores -> probabilities over the last
    axis) replaces ``torch.softmax``, as a mode's plain version does."""
    b, h, sq, d = q.shape
    hkv = k.shape[1]
    if h % hkv:
        raise ValueError(f"{h} query heads over {hkv} kv heads")
    kr = k.repeat_interleave(h // hkv, dim=1).float()
    vr = v.repeat_interleave(h // hkv, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * (d ** -0.5)
    s = s.masked_fill(~visible, NEG_INF)
    p = torch.softmax(s, dim=-1) if softmax is None else softmax(s)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vr)
    return o.to(q.dtype)


def causal_visible(sq: int, skv: int, kv_offset: int, device):
    """[Sq, Skv]: key ``c`` visible to query ``i`` when ``c <= i +
    kv_offset``."""
    rows = torch.arange(sq, device=device)[:, None] + kv_offset
    return torch.arange(skv, device=device)[None, :] <= rows


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          kv_offset: Optional[int] = None):
    """The kernel's arithmetic in plain PyTorch: f32 scores, keys past the
    diagonal at -1e30, softmax, ``p @ v``, cast to q's dtype."""
    sq, skv = q.shape[2], k.shape[2]
    return masked_attention(q, k, v, causal_visible(
        sq, skv, _kv_offset(causal, kv_offset, sq, skv), q.device))


def flash_attention_library(q, k, v, *, causal: bool = True,
                            kv_offset: Optional[int] = None):
    """The JAX package's library row: the dense oracle, causal aligned to
    the end of the keys (``kv_offset`` is not read)."""
    del kv_offset
    return _ref.attention(q, k, v, causal=causal)


def attention_rows(h: int, hkv: int, sq: int, d: int) -> int:
    """Query rows per block: the group's heads fold into 64 rows."""
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} > {MAX_HEAD_DIM} is not supported by "
                         f"the kernel")
    if h % hkv or h // hkv > BLOCK_ROWS:
        raise ValueError(f"{h} query heads over {hkv} kv heads")
    return min(sq, max(1, BLOCK_ROWS // (h // hkv)))


def flash_attention(q, k, v, *, causal: bool = True,
                    kv_offset: Optional[int] = None):
    """Online-softmax attention in one kernel.

    q: [B,H,Sq,D]; k, v: [B,Hkv,Skv,D] (GQA in the kernel) -> [B,H,Sq,D]
    in q.dtype.  CPU tensors run the plain version."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal,
                                     kv_offset=kv_offset)
    dev = check_device(q, k, v)
    code = dtype_code(q, k, v)
    b, h, sq, d = q.shape
    if k.dim() != 4 or v.shape != k.shape or k.shape[0] != b \
            or k.shape[-1] != d:
        raise ValueError(f"attention shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    hkv, skv = k.shape[1], k.shape[2]
    bq = attention_rows(h, hkv, sq, d)
    out = torch.empty(b, h, sq, d, dtype=q.dtype, device=dev)
    if out.numel():
        launch("flash_attention", code, q.contiguous().data_ptr(),
               k.contiguous().data_ptr(), v.contiguous().data_ptr(),
               out.data_ptr(), b, h, hkv, sq, skv, d,
               _kv_offset(causal, kv_offset, sq, skv), bq,
               1.0 / math.sqrt(d), stream(dev))
    return out


REGISTRY.register("flash_attention", IsaMode.NATIVE, flash_attention,
                  contract=NATIVE_CONTRACT)
REGISTRY.register("flash_attention", IsaMode.LIBRARY, flash_attention_library)
REGISTRY.declare_fallback(
    "flash_attention", IsaMode.NATIVE, IsaMode.LIBRARY,
    reason="the native kernel is pinned to its target; the dense oracle is "
           "the declared escape")
