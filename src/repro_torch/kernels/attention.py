"""Flash attention as a hand-written Hopper kernel.

:func:`flash_attention` replaces the Pallas kernel
``kernels/attention.py::flash_attention`` of the JAX package
(``_flash_kernel``): online-softmax attention ``[B,H,Sq,D] ->
[B,H,Sq,D]`` in q's dtype, causal with ``kv_offset`` (key ``c`` visible
to query ``i`` when ``c <= i + kv_offset``, default ``Skv - Sq``) or
non-causal, masked scores at the finite -1e30, a row with no visible key
divided by 1 (``csrc/flash_attention.cu``).  GQA folds ``h // group`` in
the kernel: k and v are never repeated.  The library picks one of two
routes and reports it in ``LAST_ROUTE``: bf16 at head width 64 or 128
with 16-byte aligned operands takes the tensor cores ("tc",
``csrc/attention_tc.cuh``'s ``mma.sync`` core, P rounded to bf16 before
P V, with an epilogue that stores O [B,H,Sq,D]); every other call ("fma")
the online-softmax loop of ``csrc/attention_core.cuh`` on the f32 FMA
units, with an epilogue that stores O.

Beside the wrapper is its plain PyTorch version
(:func:`flash_attention_plain`).  The wrapper runs the plain version on
CPU tensors; on CUDA tensors it launches the kernel or raises.  Each
launch adds one to ``LAUNCHES["flash_attention"]``
(``flash_attention_<mode>`` outside native; ``kernels/_launch.py``).  The
op registers the JAX package's lowerings: ``abstract``,
``abstract+shuffle`` and ``native`` (the kernel, ``mode``: the online
softmax's row max and row sum through shared memory alone or through warp
shuffles, and every key block visited, no causal skip, outside native)
and ``library``, the dense oracle ``kernels/ref.py::attention``, whose
causal mask always aligns the queries to the end of the keys.  Like the
JAX package it declares no ``abstract+shuffle -> abstract`` fallback.

:func:`structural_cost` is the JAX package's visited-block model (native's
causal block skip, the online softmax's two cross-lane reductions a block
in scratch round trips or lane shuffles), at the tiles
:func:`resolve_blocks` gives it: the tuning table's, else the JAX
defaults.  Those tiles are the model's; the kernels keep their own.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from repro_torch.core import (REGISTRY, TARGET, Dialect, IsaMode,
                              KernelContract, Primitive, dtype_bytes,
                              register_op_space, tuned_attention_blocks,
                              validate_contract)
from repro_torch.core.shuffle import scratch_tree_bytes, tree_stages
from repro_torch.kernels import ref as _ref
from repro_torch.kernels._launch import (MODE_CODES, check_device,
                                         check_mode, count_name, dtype_code,
                                         launch, stream)

NEG_INF = -1e30
#: the kernel's limits: head width, and rows of (head in group, query)
MAX_HEAD_DIM, BLOCK_ROWS = 128, 64

#: the JAX package's contracts (its kernels/attention.py), field by field
ABSTRACT_CONTRACT = KernelContract(
    kernel="flash_attention", mode=IsaMode.ABSTRACT,
    primitives=frozenset({
        Primitive.LOCKSTEP_GROUP, Primitive.MASKED_DIVERGENCE,
        Primitive.MANAGED_SCRATCHPAD, Primitive.WORKGROUP_BARRIER,
        Primitive.HIERARCHICAL_MEMORY, Primitive.IDENTITY_REGISTERS,
        Primitive.ASYNC_MEMORY, Primitive.REGISTER_OCCUPANCY}))
SHUFFLE_CONTRACT = KernelContract(
    kernel="flash_attention", mode=IsaMode.ABSTRACT_SHUFFLE,
    primitives=ABSTRACT_CONTRACT.primitives | {Primitive.LANE_SHUFFLE})
NATIVE_CONTRACT = KernelContract(
    kernel="flash_attention", mode=IsaMode.NATIVE,
    primitives=frozenset(Primitive),
    native_features=frozenset({"mxu_aligned_tiles", "dimension_semantics",
                               "multi_buffering"}))
for _c in (ABSTRACT_CONTRACT, SHUFFLE_CONTRACT, NATIVE_CONTRACT):
    validate_contract(_c)

#: the JAX kernel's default tiles, the cost model's when the table has none
DEFAULT_BLOCK_Q = 256
DEFAULT_BLOCK_KV = 256
register_op_space("flash_attention", "attention")


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
                          kv_offset: Optional[int] = None,
                          mode: str = "native"):
    """The kernel's arithmetic in plain PyTorch: f32 scores, keys past the
    diagonal at -1e30, softmax (its row max and row sum through ``mode``'s
    cross-lane stage, ``fused.softmax_mode``), ``p @ v``, cast to q's
    dtype."""
    from repro_torch.kernels import fused        # fused imports this module
    sq, skv = q.shape[2], k.shape[2]
    softmax = (None if check_mode(mode) == "native"
               else functools.partial(fused.softmax_mode, mode=mode))
    return masked_attention(q, k, v, causal_visible(
        sq, skv, _kv_offset(causal, kv_offset, sq, skv), q.device),
        softmax=softmax)


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
                    kv_offset: Optional[int] = None, mode: str = "native"):
    """Online-softmax attention in one kernel, its softmax's cross-lane
    stages (and its key walk) in ``mode``, on the tensor cores or the FMA
    units (the route the library picks, ``LAST_ROUTE``).

    q: [B,H,Sq,D]; k, v: [B,Hkv,Skv,D] (GQA in the kernel) -> [B,H,Sq,D]
    in q.dtype.  CPU tensors run the plain version of ``mode``."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal,
                                     kv_offset=kv_offset, mode=mode)
    dev = check_device("flash_attention", q, k, v)
    code = dtype_code(q, k, v)
    b, h, sq, d = q.shape
    if k.dim() != 4 or v.shape != k.shape or k.shape[0] != b \
            or k.shape[-1] != d:
        raise ValueError(f"attention shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    hkv, skv = k.shape[1], k.shape[2]
    bq = attention_rows(h, hkv, sq, d)
    out = torch.empty(b, h, sq, d, dtype=q.dtype, device=dev)
    # bound to names: a copy that .contiguous() makes must outlive the
    # launch, or the allocator may hand its block to the next copy
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if out.numel():
        launch("flash_attention", MODE_CODES[check_mode(mode)], code,
               q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
               h, hkv, sq, skv, d, _kv_offset(causal, kv_offset, sq, skv),
               bq, 1.0 / math.sqrt(d), stream(dev),
               count_as=count_name("flash_attention", mode))
    return out


def resolve_blocks(mode: str, sq: int, skv: int, d: int, block_q=None,
                   block_kv=None, plan_dialect: Optional[str] = None):
    """The modelled (block_q, block_kv): caller-pinned blocks win, then the
    tuning table (the ``plan_dialect`` slice), then the JAX defaults."""
    if block_q is None or block_kv is None:
        tuned = tuned_attention_blocks(mode, sq, skv, d,
                                       dialect=plan_dialect)
        tq, tkv = tuned if tuned else (DEFAULT_BLOCK_Q, DEFAULT_BLOCK_KV)
        block_q = tq if block_q is None else block_q
        block_kv = tkv if block_kv is None else block_kv
    return block_q, block_kv


def structural_cost(b: int, h: int, sq: int, skv: int, d: int,
                    causal: bool, mode: str, block_q: Optional[int] = None,
                    block_kv: Optional[int] = None, dtype=torch.float32,
                    plan_dialect: Optional[str] = None,
                    target: Dialect = TARGET) -> dict:
    """Visited-block accounting + the §VII.C scratch-traffic delta (the
    JAX package's model, trees of ``target``'s wave width).  ``hbm_bytes``
    is the logical stream (q, k, v read once, o written once), the same in
    every mode."""
    lanes = target.W
    block_q, block_kv = resolve_blocks(mode, sq, skv, d, block_q, block_kv,
                                       plan_dialect)
    nq = -(-sq // block_q)
    nk = -(-skv // block_kv)
    total = nq * nk
    if causal and mode == "native":
        offset = skv - sq
        visited = sum(
            1 for qi in range(nq) for ki in range(nk)
            if ki * block_kv <= qi * block_q + block_q - 1 + offset)
    else:
        visited = total
    flops_per_block = 4 * block_q * block_kv * d
    reduces_per_block = 2                       # row-max + row-sum
    if mode == "abstract":
        round_trips = reduces_per_block * tree_stages(lanes)
        scratch_bytes = (b * h * visited * reduces_per_block *
                         scratch_tree_bytes(lanes, rows=block_q))
        shuffles = 0
    elif mode == "abstract+shuffle":
        round_trips = 0
        scratch_bytes = 0
        shuffles = reduces_per_block * tree_stages(lanes)
    else:                                       # native / library
        round_trips = 0
        scratch_bytes = 0
        shuffles = 0
    itemsize = dtype_bytes(dtype)
    return {
        "blocks_total": b * h * total,
        "blocks_visited": b * h * visited,
        "flops": b * h * visited * flops_per_block,
        "flops_dense": b * h * total * flops_per_block,
        "skip_fraction": 1.0 - visited / total,
        "hbm_bytes": b * h * d * (2 * sq + 2 * skv) * itemsize,
        "scratch_round_trips_per_block": round_trips,
        "scratch_bytes_total": scratch_bytes,
        "lane_shuffles_per_block": shuffles,
    }


for _mode, _contract in (("abstract", ABSTRACT_CONTRACT),
                         ("abstract+shuffle", SHUFFLE_CONTRACT)):
    REGISTRY.register("flash_attention", _mode,
                      functools.partial(flash_attention, mode=_mode),
                      contract=_contract,
                      cost=functools.partial(structural_cost, mode=_mode))
REGISTRY.register("flash_attention", IsaMode.NATIVE, flash_attention,
                  contract=NATIVE_CONTRACT,
                  cost=functools.partial(structural_cost, mode="native"))
REGISTRY.register("flash_attention", IsaMode.LIBRARY, flash_attention_library,
                  cost=functools.partial(structural_cost, mode="library"))
REGISTRY.declare_fallback(
    "flash_attention", IsaMode.NATIVE, IsaMode.LIBRARY,
    reason="the native kernel is pinned to its target; the dense oracle is "
           "the declared escape")
