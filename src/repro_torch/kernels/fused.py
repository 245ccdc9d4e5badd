"""The fused lowerings of the serving path, as hand-written Hopper kernels.

Five kernels, each replacing a Pallas kernel of the JAX package's
``kernels/fused.py`` (sources and design notes in ``csrc/``):

- :func:`rmsnorm_matmul`: ``(x * rsqrt(mean(x^2) + eps) * w) @ W``, the
  norm as a GEMM prologue (``csrc/rmsnorm_matmul.cu``); W is ``[D, N]``
  in x's dtype, or the transposed view of an f32 ``[N, D]`` table (a tied
  embedding), read in place;
- :func:`add_rmsnorm`: ``s = x + r`` in f32, returning ``(rmsnorm(s), s)``
  with both in x's dtype, the residual add as the norm's load stage
  (``csrc/add_rmsnorm.cu``);
- :func:`rmsnorm_swiglu`: ``silu(n @ wg) * (n @ wi)`` with ``n`` the norm
  and ``w_cat = [wi|wg]`` (``csrc/rmsnorm_swiglu.cu``);
- :func:`flash_attention_matmul`: ``sum_h softmax(q_h k_h^T / sqrt(D)) v_h
  . wo[h]``, causal with ``kv_offset`` or masked by per-slot ``pos``
  (``csrc/flash_attention_matmul.cu``);
- :func:`paged_attention_matmul`: its decode shape over a paged KV cache,
  gathering pages through ``block_tables`` (``csrc/paged_attention_matmul.cu``).

The int8 twins (``*_q8``) run the same three kernel bodies behind int8
weights with f32 per-output-channel scales (:func:`quantize_weight`), and
the paged form also behind int8 page pools with f32 per-token scale pools:
on the f32 FMA kernels each weight (or key, value) element is widened to
f32 and multiplied by its scale as it is loaded into shared memory, and
the product runs in f32; on the tensor cores (below) the int8 tile is
widened to bf16, exactly, and the scale multiplies the f32 sum.  A
``_q8`` call without ``w_scale`` quantizes its f32/bf16 weight per call, as
the JAX twins do: at decode, :func:`rmsnorm_matmul_q8` does it inside the
decode GEMV (a float head read ``[D, N]`` at x's dtype, or a tied table's
transposed view: each channel's scale by :func:`quantize_weight`'s
arithmetic, then each weight quantized in registers as it streams, no int8
copy written); every other call quantizes first, in PyTorch.
``ExecutionPolicy(precision="int8")`` retargets the three ops onto their
twins in the registry, in every mode.

The modes: :func:`rmsnorm_matmul` (the tied f32 table too),
:func:`add_rmsnorm`, :func:`rmsnorm_swiglu`, :func:`flash_attention_matmul`,
:func:`paged_attention_matmul` and the three int8 twins take ``mode`` in
``abstract | abstract+shuffle | native``, the JAX package's Pallas
lowerings of each op.  A mode changes only the kernel's cross-lane stages: the row moment
of the norms and norm-GEMMs, the online softmax's row max and
row sum (through shared memory alone under ``abstract``, through warp
shuffles under ``abstract+shuffle``), and, as in the JAX package, the
attention's key walk (the abstract modes visit every key block of the
causal and the dense ``pos`` shapes; the paged shape stops at each slot's
frontier in every mode, and needs pages of a multiple of 128 keys outside
``native``).  The plain version of each mode computes those reductions
through the trees of ``core/shuffle.py`` at the port's lane width.

At prefill (more than 16 rows) with bf16 activations, four forms run on
the tensor cores, in every mode:

- :func:`rmsnorm_matmul` with a bf16 weight read ``[D, N]``;
- :func:`rmsnorm_swiglu` and :func:`rmsnorm_swiglu_q8` (a bf16 or int8
  ``w_cat``), the wi and wg products of one output tile in one GEMM, the
  silu gate in its epilogue;
- the causal shape of :func:`flash_attention_matmul` and
  :func:`flash_attention_matmul_q8` (a bf16 or int8 wo, head_dim 64 or
  128).

Each is a prologue (the normalized activation; the attention output O,
from an ``mma.sync`` flash-attention core) written to the workspace in
bf16, then one ``wgmma`` GEMM (``csrc/tc_gemm.cuh``), which widens an
int8 weight's tiles to bf16 in shared memory and scales its columns in
the epilogue.  At decode (at most 16 rows), the four norm-GEMM forms
(:func:`rmsnorm_matmul`, :func:`rmsnorm_swiglu` and their int8 twins, a
weight at x's dtype, bf16 or f32, or int8, read ``[D, N]``, N columns a
multiple of 16 bytes, 16-byte aligned) take the decode GEMV
(``csrc/norm_gemv.cuh``): the normalized rows once a call, then the
weight streamed once (bf16 activations: TMA boxes into ``mma.sync``, the
weight as the 16-row operand; f32: 16-byte ``cp.async`` loads into f32
FMAs), K reduced in a fixed order.  The ``pos`` and paged shapes of
:func:`flash_attention_matmul` and :func:`paged_attention_matmul` and their
int8 twin (one query a slot, at most 16 slots, bf16 or f32, head_dim <=
128 with K/V rows a multiple of 16 bytes, at most 8 heads a group, a wo
the decode GEMV takes, 16-byte aligned operands) take the attention's
decode route (``csrc/attention_decode.cuh``): each slot's keys split
across blocks, each K/V row read once a (slot, group), the splits
combined in split order into O, then ``O @ wo`` on the same decode GEMV.
The C library decides the route alone (its launch entry reports it,
``LAST_ROUTE``); every other form (f32 prefill rows, the tied table,
shapes a route refuses) keeps its f32 FMA kernel.

Beside each wrapper is its plain PyTorch version (``*_plain``).  A wrapper
given CPU tensors runs the plain version; given CUDA tensors it launches its
kernel or raises, never falling back.  Each launch adds one to
``LAUNCHES[<kernel>]``, the counters all kernels share
(``kernels/_launch.py``).  Each op registers its ``abstract``,
``abstract+shuffle`` and ``native`` lowerings (the kernel) and a ``library``
lowering in the registry; a ``_q8`` op counts its launches apart
(``rmsnorm_matmul_q8``, ``rmsnorm_swiglu_q8``,
``flash_attention_matmul_q8``, ``flash_attention_matmul_q8_pos``,
``paged_attention_matmul_q8``), and a non-native mode apart again
(``<kernel shape>_<mode>``, e.g. ``flash_attention_matmul_pos_abstract``,
``paged_attention_matmul_q8_abstract+shuffle``).

The ``structural_cost_*`` functions are the JAX package's cost models of
its fused lowerings (the unfused pair's traffic less what the fusion
keeps out of HBM), evaluated at the JAX tiles on a compile target;
``auto`` ranks the modes by them.  They model the JAX lowerings, not the
Hopper kernels' own tiles.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import (REGISTRY, TARGET, Dialect, IsaMode,
                              KernelContract, Primitive, align_up,
                              dtype_bytes, register_op_space, tuned_plan,
                              validate_contract)
from repro_torch.core.shuffle import (LANES, fold_rows, lane_tree_reduce,
                                      row_reduce_shuffle, scratch_tree_bytes,
                                      scratch_tree_reduce, tree_stages)
from repro_torch.core.tuning import (attention_matmul_bucket, swiglu_bucket,
                                     tuned_entry)
from repro_torch.kernels import attention as _attention
from repro_torch.kernels import gemm as _gemm
from repro_torch.kernels import ref as _ref
from repro_torch.kernels._launch import (  # noqa: F401 (re-exported)
    LAUNCHES, reset_launch_counts)
from repro_torch.kernels._launch import MODE_CODES
from repro_torch.kernels._launch import check_device as _check_device
from repro_torch.kernels._launch import check_mode as _check_mode
from repro_torch.kernels._launch import count_name as _count_name
from repro_torch.kernels._launch import dtype_code as _dtype_code
from repro_torch.kernels._launch import launch as _launch
from repro_torch.kernels._launch import sm_count as _sm_count
from repro_torch.kernels._launch import stream as _stream
from repro_torch.kernels._launch import workspace as _workspace


# --------------------------------------------------------------------------
# Contracts (the JAX package's native contracts, field by field)
# --------------------------------------------------------------------------

_NATIVE_FEATURES = frozenset({"fused_epilogue", "mxu_aligned_tiles",
                              "dimension_semantics", "multi_buffering"})
CONTRACTS = {
    op: KernelContract(kernel=op, mode=IsaMode.NATIVE,
                       primitives=frozenset(Primitive),
                       native_features=_NATIVE_FEATURES)
    for op in ("rmsnorm_matmul", "rmsnorm_swiglu", "flash_attention_matmul")
}
CONTRACTS["add_rmsnorm"] = KernelContract(
    kernel="add_rmsnorm", mode=IsaMode.NATIVE,
    primitives=frozenset(Primitive),
    native_features=frozenset({"fused_epilogue", "dimension_semantics",
                               "multi_buffering"}))
#: the int8 twins spend the same primitive budgets as their f32 ops
QUANT_OPS = ("rmsnorm_matmul_q8", "rmsnorm_swiglu_q8",
             "flash_attention_matmul_q8")
for _op in QUANT_OPS:
    CONTRACTS[_op] = dataclasses.replace(CONTRACTS[_op[:-3]], kernel=_op)
#: the portable budgets of the JAX package: the norm-GEMMs' (_RM_ABSTRACT,
#: _SW_ABSTRACT) and attention's (kernels/attention.py::ABSTRACT_CONTRACT,
#: which flash_attention_matmul spends); abstract+shuffle adds primitive 11
_NORM_GEMM_ABSTRACT = frozenset({
    Primitive.LOCKSTEP_GROUP, Primitive.MANAGED_SCRATCHPAD,
    Primitive.WORKGROUP_BARRIER, Primitive.HIERARCHICAL_MEMORY,
    Primitive.IDENTITY_REGISTERS, Primitive.ASYNC_MEMORY,
    Primitive.REGISTER_OCCUPANCY})
_ATTENTION_ABSTRACT = _NORM_GEMM_ABSTRACT | {Primitive.MASKED_DIVERGENCE}
#: add_rmsnorm's (_AR_ABSTRACT): rmsnorm's budget, no occupancy primitive
_ROW_NORM_ABSTRACT = _NORM_GEMM_ABSTRACT - {Primitive.REGISTER_OCCUPANCY}
#: op -> the primitives of its abstract lowering
_ABSTRACT_PRIMITIVES = {"rmsnorm_matmul": _NORM_GEMM_ABSTRACT,
                        "rmsnorm_swiglu": _NORM_GEMM_ABSTRACT,
                        "flash_attention_matmul": _ATTENTION_ABSTRACT,
                        "add_rmsnorm": _ROW_NORM_ABSTRACT}
#: the int8 twins spend their base op's budgets (the JAX package's _RMQ_*,
#: _SWQ_*, _FAQ_*): dequantizing a resident tile takes no cross-lane step
for _op in QUANT_OPS:
    _ABSTRACT_PRIMITIVES[_op] = _ABSTRACT_PRIMITIVES[_op[:-3]]
MODE_OPS = tuple(_ABSTRACT_PRIMITIVES)
#: (op, mode) -> the contract of its abstract or abstract+shuffle lowering
MODE_CONTRACTS = {}
for _op, _prims in _ABSTRACT_PRIMITIVES.items():
    MODE_CONTRACTS[(_op, "abstract")] = KernelContract(
        kernel=_op, mode=IsaMode.ABSTRACT, primitives=_prims)
    MODE_CONTRACTS[(_op, "abstract+shuffle")] = KernelContract(
        kernel=_op, mode=IsaMode.ABSTRACT_SHUFFLE,
        primitives=_prims | {Primitive.LANE_SHUFFLE})
for _c in (*CONTRACTS.values(), *MODE_CONTRACTS.values()):
    validate_contract(_c)
#: the kernels' lowerings (the registry adds ``library``)
KERNEL_MODES = tuple(MODE_CODES)
#: the JAX package's lane width for the abstract lowerings' row folds: a
#: paged kv block (one page) must be a multiple of it outside native
#: (its kernels/fused.py::_paged_attention_matmul)
PAGE_MULTIPLE = 128

#: the weight-type codes of the norm-GEMM kernels for an int8 weight and
#: for a float weight the int8 twin quantizes in the kernel's stream
#: (csrc/common.cuh: 0 f32, 1 bf16, 2 int8, 3 quantized per call)
_INT8_CODE, _QUANT_CODE = 2, 3


# --------------------------------------------------------------------------
# The int8 scheme (the JAX package's kernels/fused.py::quantize_weight):
# symmetric, per output channel, round half to even
# --------------------------------------------------------------------------


def quantize_weight(w):
    """``w`` [..., K, N] -> (int8 [..., K, N], f32 scales [..., N]): the
    scale is the channel's max |w| / 127 (at least 1e-8), so the extreme
    value maps to exactly +-127.  Leading axes (stacked layers) are
    quantized one slice at a time, so the f32 temporary is one matrix.
    The int8 result is contiguous whatever the strides of ``w`` (a tied
    table's ``embed.t()`` gives a fresh [K, N], as ``jnp`` does)."""
    if w.dim() > 2:
        q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        scale = torch.empty(w.shape[:-2] + w.shape[-1:], dtype=torch.float32,
                            device=w.device)
        for i in range(w.shape[0]):
            q[i], scale[i] = quantize_weight(w[i])
        return q, scale
    scale = weight_scales(w)
    t = w.to(torch.float32, memory_format=torch.contiguous_format,
             copy=True)                          # never w itself
    t.div_(scale.unsqueeze(-2)).round_().clamp_(-127, 127)
    return t.to(torch.int8), scale


def weight_scales(w):
    """The f32 scales [..., N] of :func:`quantize_weight`: the channel's
    max |w| over K in f32, divided by 127 (IEEE division: on the card
    PyTorch divides by a host scalar as a product with its reciprocal,
    which rounds some quotients the other way, so the divisor here is a
    tensor), at least 1e-8."""
    amax = w.abs().amax(dim=-2).float()
    return torch.clamp(amax / amax.new_full((), 127.0), min=1e-8)


def quantize_scales(w):
    """:func:`weight_scales` of a float ``w`` [K, N] (bf16 or f32, N x its
    size a multiple of 16 bytes) or of the transposed view of a contiguous
    f32 [N, K] table (K x 4 a multiple of 16 bytes), 16-byte aligned: on
    the card the quantized decode GEMV's pass 1 alone
    (``csrc/rmsnorm_matmul.cu::uisa_q8_scales``), which gives
    :func:`quantize_weight`'s scales bit for bit.  CPU tensors run
    :func:`weight_scales`."""
    if not w.is_cuda:
        return weight_scales(w)
    dev = _check_device(w)
    trans = not w.is_contiguous()
    if w.dim() != 2 or (trans and not (w.dtype == torch.float32
                                       and w.t().is_contiguous())):
        raise ValueError(f"quantize_scales: a contiguous [K, N] weight or "
                         f"the transposed view of an f32 table, got "
                         f"{w.dtype} {tuple(w.shape)}")
    k, n = w.shape
    out = torch.empty(n, dtype=torch.float32, device=dev)
    _launch("q8_scales", _dtype_code(w), int(trans), w.data_ptr(), k, n,
            out.data_ptr(), _stream(dev))
    return out


def dequantize_weight(q, scale, dtype=torch.float32):
    """Inverse of :func:`quantize_weight`: ``q * scale`` in f32, cast."""
    return (q.float() * scale.unsqueeze(-2)).to(dtype)


def _quantized(w, w_scale):
    """(int8 weight, f32 scales): ``w`` as given, or quantized here."""
    if w_scale is None:
        return quantize_weight(w)
    if w.dtype != torch.int8:
        raise TypeError(f"w_scale given with a {w.dtype} weight, not int8")
    return w, w_scale.float()


# --------------------------------------------------------------------------
# The modes' cross-lane stages, in plain PyTorch
# --------------------------------------------------------------------------


def row_reduce(x, op, mode: str, fill: float):
    """``x`` [..., n] -> [..., 1] through the cross-lane stage of ``mode``
    (abstract or abstract+shuffle) at the port's lane width (32): both fold
    each row to 32 lanes, then abstract+shuffle runs the lane tree
    (``row_reduce_shuffle``) and abstract the halving tree through a
    scratch tensor (``scratch_tree_reduce``).  ``op`` is ``torch.add`` or
    ``torch.maximum``; the row is padded to a multiple of 32 with
    ``fill``, the identity of ``op``."""
    if mode not in ("abstract", "abstract+shuffle"):
        raise ValueError(f"no plain cross-lane tree for mode {mode!r}")
    pad = (-x.shape[-1]) % LANES
    if pad:
        x = F.pad(x, (0, pad), value=fill)
    if mode == "abstract+shuffle":
        return row_reduce_shuffle(x, op)
    acc = fold_rows(x, op).reshape(-1, LANES)
    out = scratch_tree_reduce(acc, torch.empty_like(acc), op)
    return out.reshape(x.shape[:-1] + (1,))


def rmsnorm_mode(x, weight, eps: float, mode: str):
    """The norm with its moment through ``mode``'s cross-lane stage (the
    JAX package's kernels/rmsnorm.py::normalize_block); native is
    ``ref.rmsnorm``.  In x's dtype."""
    if _check_mode(mode) == "native":
        return _ref.rmsnorm(x, weight, eps)
    xf = x.float()
    var = row_reduce(xf * xf, torch.add, mode, 0.0) / x.shape[-1]
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


# --------------------------------------------------------------------------
# The row norms' fold (rmsnorm and add_rmsnorm, csrc/row_norm.cuh)
# --------------------------------------------------------------------------

#: csrc/row_norm.cuh: threads a row and 16-byte slots a thread, at most, on
#: the one-pass routes
ROW_MAX_THREADS, ROW_MAX_SLOTS = 512, 8


def row_norm_plan(d: int, itemsize: int):
    """``(slots a thread, threads a row)`` of the row norms' one-pass routes
    for a row of ``d`` elements of ``itemsize`` bytes, or None where the
    row takes the loop route (the split of ``csrc/row_norm.cuh::
    row_plan``): a slot is 16 bytes, thread t holds slots t + k*T for k
    below the fewest slots (a power of two) that fit the row in
    ``ROW_MAX_THREADS`` threads, T rounded up to whole warps."""
    g = 16 // itemsize
    nslot = -(-d // g)
    nv = 1
    while nv <= ROW_MAX_SLOTS:
        if nv * ROW_MAX_THREADS >= nslot:
            return nv, -(-max(1, -(-nslot // nv)) // 32) * 32
        nv *= 2
    return None


def _fma(a, b, c):
    """fmaf(a, b, c) in f32, through f64 (exact but for a double rounding
    at a tie)."""
    return (a.double() * b.double() + c.double()).float()


def row_norm_sumsq(s, itemsize: int, mode: str):
    """Each row's sum of squares of ``s`` (f32 [..., d]) -> [..., 1], folded
    as the row-norm kernels fold it in ``mode`` for elements of
    ``itemsize`` bytes: on the one-pass routes each thread's slots in
    order by FMA (:func:`row_norm_plan`), then abstract+shuffle and native
    a 32-lane tree a warp and the warps' partials in warp order, abstract
    the halving tree over the row's threads padded to a power of two; on
    the loop route (a mode's only) the 32-lane fold of
    :func:`row_reduce`."""
    d = s.shape[-1]
    plan = row_norm_plan(d, itemsize)
    if plan is None:
        return row_reduce(s * s, torch.add, mode, 0.0)
    nv, threads = plan
    g = 16 // itemsize
    lead = s.shape[:-1]
    share = F.pad(s, (0, nv * threads * g - d)).reshape(
        *lead, nv, threads, g)
    ss = torch.zeros(*lead, threads, dtype=torch.float32, device=s.device)
    for k in range(nv):
        for e in range(g):
            v = share[..., k, :, e]
            ss = _fma(v, v, ss)
    if mode == "abstract":
        p = max(32, 1 << (threads - 1).bit_length())
        tree = F.pad(ss, (0, p - threads)).reshape(-1, p)
        total = scratch_tree_reduce(tree, torch.empty_like(tree))
        return total.reshape(*lead, 1)
    warps = lane_tree_reduce(ss.reshape(*lead, threads // 32, 32))[..., 0]
    total = torch.zeros(*lead, dtype=torch.float32, device=s.device)
    for i in range(threads // 32):
        total = total + warps[..., i]
    return total.unsqueeze(-1)


def row_norm_mode(x, weight, eps: float, mode: str, itemsize=None):
    """The row norms' plain norm (rmsnorm, add_rmsnorm): ``ref.rmsnorm`` for
    native, else the moment folded as the kernel folds it in ``mode``
    (:func:`row_norm_sumsq`, for elements of ``itemsize`` bytes: x's by
    default).  In x's dtype."""
    if _check_mode(mode) == "native":
        return _ref.rmsnorm(x, weight, eps)
    xf = x.float()
    var = row_norm_sumsq(xf, itemsize or x.element_size(), mode) \
        / x.shape[-1]
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


# --------------------------------------------------------------------------
# rmsnorm -> matmul
# --------------------------------------------------------------------------


def rmsnorm_matmul_plain(x, weight, w_proj, *, eps: float = 1e-6,
                         mode: str = "native"):
    """The unfused pair: ``rmsnorm(x, weight) @ w_proj``, the product at
    the wider of the two dtypes (an f32 table beside bf16 activations is
    read at f32, as the kernel reads it), the result in x's dtype; the
    norm's moment through ``mode``'s cross-lane stage."""
    y = rmsnorm_mode(x, weight, eps, mode)
    if w_proj.dtype == y.dtype:
        return torch.matmul(y, w_proj)
    wide = torch.promote_types(y.dtype, w_proj.dtype)
    return torch.matmul(y.to(wide), w_proj.to(wide)).to(x.dtype)


def _norm_gemm(name: str, x, weight, w, n_out: int, eps: float,
               w_scale=None, mode: str = "native", quantize: bool = False):
    """Launch a norm-GEMM kernel.  ``w`` is ``[D, N']`` and contiguous, or,
    for rmsnorm_matmul only, the transposed view of a contiguous f32
    ``[N', D]`` table (read in place, never copied); with ``w_scale``
    ([N'] f32) it is int8, and the launch counts as ``<name>_q8``.  With
    ``quantize`` (rmsnorm_matmul only) ``w`` is a float weight that the
    kernel quantizes per call in its stream (at x's dtype read ``[D, N']``,
    or the f32 table), counted as ``<name>_q8``; where the decode GEMV
    refuses that shape or form, nothing is launched and None is returned.
    Every mode takes every weight; a non-native mode counts as
    ``<count>_<mode>``."""
    _check_mode(mode)
    *lead, d = x.shape
    dev = _check_device(x, weight, w,
                        *([] if w_scale is None else [w_scale]))
    code = _dtype_code(x, weight)
    if weight.shape != (d,) or w.dim() != 2 or w.shape[0] != d:
        raise ValueError(f"{name}: x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)}, w {tuple(w.shape)}")
    table = name == "rmsnorm_matmul" and w.dtype == torch.float32
    if quantize:
        if w.dtype != (torch.float32 if not w.is_contiguous() else x.dtype):
            return None
        w_code = _QUANT_CODE
    elif w_scale is not None:
        if w.dtype != torch.int8 or w_scale.dtype != torch.float32 \
                or w_scale.shape != (w.shape[1],):
            raise ValueError(f"{name}_q8: an int8 [D, N] weight takes f32 "
                             f"[N] scales, got {w.dtype} {tuple(w.shape)} "
                             f"and {w_scale.dtype} {tuple(w_scale.shape)}")
        w_code, table = _INT8_CODE, False
    else:
        w_code = 0 if table else _dtype_code(x, w)
    trans = not w.is_contiguous()
    if trans and not (table and w.t().is_contiguous()):
        if quantize:
            return None
        raise ValueError(f"{name}: the weight must be contiguous [D, N] (or, "
                         f"for rmsnorm_matmul, the transposed view of a "
                         f"contiguous f32 [N, D] table)")
    x2 = x.reshape(-1, d).contiguous()
    rows = x2.shape[0]
    out = torch.empty(rows, n_out, dtype=x.dtype, device=dev)
    if rows == 0:
        return out.reshape(*lead, n_out)
    sms = _sm_count(dev.index if dev.index is not None else 0)
    form = (code, w_code, int(trans))
    size, route = _workspace(name, *form, w.data_ptr(), rows, d, n_out, sms)
    if quantize and route != "gemv":
        return None
    # the inverse RMS per row feeds the fma route alone
    inv = (torch.empty(rows, dtype=torch.float32, device=dev)
           if route == "fma" else None)
    part = torch.empty(max(1, size), dtype=torch.float32, device=dev)
    # every copy the launch reads is bound to a name until it returns
    weight = weight.contiguous()
    w_scale = None if w_scale is None else w_scale.contiguous()
    _launch(name, MODE_CODES[mode], *form, x2.data_ptr(), weight.data_ptr(),
            w.data_ptr(), _ptr(w_scale), out.data_ptr(), _ptr(inv),
            part.data_ptr(), rows, d, n_out, float(eps), sms, _stream(dev),
            count_as=_count_name(
                name + "_q8" if quantize or w_scale is not None else name,
                mode))
    return out.reshape(*lead, n_out)


def rmsnorm_matmul(x, weight, w_proj, *, eps: float = 1e-6,
                   mode: str = "native"):
    """``rmsnorm(x, weight) @ w_proj``, the moment's cross-lane stage in
    ``mode``: one kernel, or, at a bf16 prefill, the normalized rows then
    the ``wgmma`` GEMM, or, at decode, the normalized rows then the GEMV
    (the route the library picks, ``LAST_ROUTE``).

    x: [..., D]; weight: [D]; w_proj: [D, N], contiguous in x's dtype, or
    f32 (contiguous, or the transposed view of an [N, D] table such as a
    tied embedding) -> [..., N] in x.dtype, f32 accumulation.  CPU
    tensors run the plain version of ``mode``."""
    if not x.is_cuda:
        return rmsnorm_matmul_plain(x, weight, w_proj, eps=eps, mode=mode)
    n = w_proj.shape[-1]
    return _norm_gemm("rmsnorm_matmul", x, weight, w_proj, n, eps, mode=mode)


# --------------------------------------------------------------------------
# (x + r) -> rmsnorm
# --------------------------------------------------------------------------


def add_rmsnorm_plain(x, residual, weight, *, eps: float = 1e-6,
                      mode: str = "native"):
    """The kernel's arithmetic: ``s = x + residual`` in f32, stored at
    x.dtype; the norm of the f32 sum (not of the rounded ``s``), its moment
    folded as the kernel folds it in ``mode`` (:func:`row_norm_mode`)."""
    s = x.float() + residual.float()
    normed = row_norm_mode(s, weight, eps, mode, x.element_size())
    return normed.to(x.dtype), s.to(x.dtype)


def add_rmsnorm_library(x, residual, weight, *, eps: float = 1e-6):
    """The JAX package's library row: the add at x.dtype, then the norm of
    the rounded sum.  Equal to :func:`add_rmsnorm_plain` in f32; in bf16
    the two differ by the rounding of the sum the norm reads."""
    s = x + residual
    return _ref.rmsnorm(s, weight, eps), s


def add_rmsnorm(x, residual, weight, *, eps: float = 1e-6,
                mode: str = "native"):
    """``(rmsnorm(x + residual, weight), x + residual)`` in one kernel: each
    row held in registers (``csrc/row_norm.cuh``; the widest rows in two
    passes: the route the library picks, ``LAST_ROUTE``) reads both addends
    once, stores the sum and its norm, the moment's cross-lane stage in
    ``mode``.

    x, residual: [..., D] (same shape and dtype); weight: [D] -> two
    [..., D] tensors in x.dtype.  CPU tensors run the plain version of
    ``mode``."""
    if not x.is_cuda:
        return add_rmsnorm_plain(x, residual, weight, eps=eps, mode=mode)
    dev = _check_device(x, residual, weight)
    code = _dtype_code(x, residual, weight)
    d = x.shape[-1]
    if residual.shape != x.shape or weight.shape != (d,):
        raise ValueError(f"add_rmsnorm: x {tuple(x.shape)}, residual "
                         f"{tuple(residual.shape)}, weight "
                         f"{tuple(weight.shape)}")
    x2 = x.reshape(-1, d).contiguous()
    r2 = residual.reshape(-1, d).contiguous()
    normed, summed = torch.empty_like(x2), torch.empty_like(x2)
    weight = weight.contiguous()
    if x2.shape[0]:
        _launch("add_rmsnorm", MODE_CODES[_check_mode(mode)], code,
                x2.data_ptr(), r2.data_ptr(), weight.data_ptr(),
                normed.data_ptr(), summed.data_ptr(), x2.shape[0], d,
                float(eps), _stream(dev),
                count_as=_count_name("add_rmsnorm", mode))
    return normed.reshape(x.shape), summed.reshape(x.shape)


# --------------------------------------------------------------------------
# rmsnorm -> [wi|wg] swiglu
# --------------------------------------------------------------------------


def rmsnorm_swiglu_plain(x, weight, w_cat, *, eps: float = 1e-6,
                         mode: str = "native"):
    """The unfused pair: ``silu(y @ wg) * (y @ wi)``, ``y = rmsnorm(x)``
    with its moment through ``mode``'s cross-lane stage."""
    y = rmsnorm_mode(x, weight, eps, mode)
    f = w_cat.shape[1] // 2
    hi = torch.matmul(y, w_cat[:, :f].to(y.dtype))
    hg = torch.matmul(y, w_cat[:, f:].to(y.dtype))
    return F.silu(hg) * hi


def rmsnorm_swiglu(x, weight, w_cat, *, eps: float = 1e-6,
                   mode: str = "native"):
    """``silu(y @ wg) * (y @ wi)`` for ``y = rmsnorm(x, weight)``, fused,
    the moment's cross-lane stage in ``mode``: one kernel, or, at a bf16
    prefill, the normalized rows then the ``wgmma`` GEMM with the gate in
    its epilogue, or, at decode, the normalized rows then the GEMV over wi
    and wg (the route the library picks, ``LAST_ROUTE``).

    x: [..., D]; weight: [D]; w_cat: [D, 2F] (contiguous), wi the first F
    columns -> [..., F].  CPU tensors run the plain version of ``mode``."""
    if not x.is_cuda:
        return rmsnorm_swiglu_plain(x, weight, w_cat, eps=eps, mode=mode)
    if w_cat.dim() != 2 or w_cat.shape[1] % 2:
        raise ValueError(f"rmsnorm_swiglu: w_cat {tuple(w_cat.shape)} is "
                         f"not [D, 2F]")
    f = w_cat.shape[1] // 2
    return _norm_gemm("rmsnorm_swiglu", x, weight, w_cat, f, eps, mode=mode)


# --------------------------------------------------------------------------
# The int8 norm-GEMM twins: the same kernels with an int8 weight and [N]
# f32 scales (Bs = float(q) * scale[n] on the tile load)
# --------------------------------------------------------------------------


def rmsnorm_matmul_q8_plain(x, weight, w_proj, w_scale, *,
                            eps: float = 1e-6, mode: str = "native"):
    """The kernel's arithmetic: ``y = rmsnorm(x)`` at x's dtype (its moment
    through ``mode``'s cross-lane stage), the int8 weight times its scales
    in f32, the product in f32, cast to x's dtype."""
    y = rmsnorm_mode(x, weight, eps, mode)
    return torch.matmul(y.float(), dequantize_weight(w_proj, w_scale)
                        ).to(x.dtype)


def rmsnorm_matmul_q8_library(x, weight, w_proj, *, w_scale=None,
                              eps: float = 1e-6):
    """The JAX package's library row: the weight dequantized to x's dtype
    up front, then the unfused pair at x's dtype.  Equal to the plain
    version in f32; in bf16 the two round the weight at other places."""
    w_proj, w_scale = _quantized(w_proj, w_scale)
    return rmsnorm_matmul_plain(
        x, weight, dequantize_weight(w_proj, w_scale, x.dtype), eps=eps)


def rmsnorm_matmul_q8(x, weight, w_proj, *, w_scale=None,
                      eps: float = 1e-6, mode: str = "native"):
    """``rmsnorm(x, weight) @ (w_proj * w_scale)`` in one kernel, the
    moment's cross-lane stage in ``mode``.

    w_proj: int8 [D, N] with f32 ``w_scale`` [N], or a float weight that is
    quantized per call (``w_scale=None``; any strides, e.g. a tied table's
    transposed view) -> [..., N] in x.dtype.  On the card, a float weight
    at decode rows (at x's dtype read [D, N], or the transposed view of an
    f32 table) is quantized inside the decode GEMV, by the same arithmetic
    as :func:`quantize_weight` (pass 1 the scales, then each weight in
    registers as it streams): one call, no int8 copy; any other float
    weight is quantized here first.  CPU tensors run the plain version of
    ``mode``."""
    if x.is_cuda and w_scale is None and w_proj.dtype != torch.int8:
        out = _norm_gemm("rmsnorm_matmul", x, weight, w_proj,
                         w_proj.shape[1], eps, mode=mode, quantize=True)
        if out is not None:
            return out
    w_proj, w_scale = _quantized(w_proj, w_scale)
    if not x.is_cuda:
        return rmsnorm_matmul_q8_plain(x, weight, w_proj, w_scale, eps=eps,
                                       mode=mode)
    return _norm_gemm("rmsnorm_matmul", x, weight, w_proj, w_proj.shape[1],
                      eps, w_scale=w_scale, mode=mode)


def rmsnorm_swiglu_q8_plain(x, weight, w_cat, w_scale, *,
                            eps: float = 1e-6, mode: str = "native"):
    """The kernel's arithmetic: ``y = rmsnorm(x)`` at x's dtype (its moment
    through ``mode``'s cross-lane stage), both products in f32 against the
    dequantized halves (``w_scale`` [2F]: wi reads ``[:F]``, wg ``[F:]``),
    the gate in f32, cast."""
    y = rmsnorm_mode(x, weight, eps, mode).float()
    w = dequantize_weight(w_cat, w_scale)
    f = w.shape[1] // 2
    return (F.silu(y @ w[:, f:]) * (y @ w[:, :f])).to(x.dtype)


def rmsnorm_swiglu_q8_library(x, weight, w_cat, *, w_scale=None,
                              eps: float = 1e-6):
    """The JAX package's library row: dequantize to x's dtype, then the
    unfused pair."""
    w_cat, w_scale = _quantized(w_cat, w_scale)
    return rmsnorm_swiglu_plain(
        x, weight, dequantize_weight(w_cat, w_scale, x.dtype), eps=eps)


def rmsnorm_swiglu_q8(x, weight, w_cat, *, w_scale=None, eps: float = 1e-6,
                      mode: str = "native"):
    """``silu(y @ wg) * (y @ wi)`` against int8 ``w_cat = [wi|wg]`` [D, 2F]
    with f32 ``w_scale`` [2F], in one kernel, or, at a bf16 prefill, on the
    tensor cores as :func:`rmsnorm_swiglu` (a float ``w_cat`` is quantized
    first), the moment's cross-lane stage in ``mode``.  CPU tensors run the
    plain version of ``mode``."""
    w_cat, w_scale = _quantized(w_cat, w_scale)
    if not x.is_cuda:
        return rmsnorm_swiglu_q8_plain(x, weight, w_cat, w_scale, eps=eps,
                                       mode=mode)
    if w_cat.dim() != 2 or w_cat.shape[1] % 2:
        raise ValueError(f"rmsnorm_swiglu_q8: w_cat {tuple(w_cat.shape)} is "
                         f"not [D, 2F]")
    return _norm_gemm("rmsnorm_swiglu", x, weight, w_cat,
                      w_cat.shape[1] // 2, eps, w_scale=w_scale, mode=mode)


# --------------------------------------------------------------------------
# attention -> wo (dense causal / dense pos / paged)
# --------------------------------------------------------------------------


def gather_pages(pages, block_tables):
    """[P,Hkv,ps,D] + [B,maxp] -> the [B,Hkv,maxp*ps,D] logical strip;
    table entries clamp to ``P - 1`` (sentinel and dead entries read a
    real page whose rows sit past every frontier)."""
    tbl = block_tables.clamp(max=pages.shape[0] - 1).long()
    strip = pages[tbl]                       # [B, maxp, Hkv, ps, D]
    b, maxp, hkv, ps, d = strip.shape
    return strip.permute(0, 2, 1, 3, 4).reshape(b, hkv, maxp * ps, d)


def softmax_mode(s, mode: str):
    """Softmax over the last axis with its row max and row sum through
    ``mode``'s cross-lane stage (the JAX package's
    kernels/attention.py::_row_reduce)."""
    p = torch.exp(s - row_reduce(s, torch.maximum, mode, float("-inf")))
    return p / row_reduce(p, torch.add, mode, 0.0)


def _attend(q, k, v, *, causal, kv_offset, pos, block_tables,
            mode: str = "native"):
    """The masked softmax attention every plain attention + wo version
    shares: [B, Sq, H*D] in q's dtype (k/v, or page pools, of any float
    dtype: the softmax runs in f32, its row reductions in ``mode``)."""
    if block_tables is not None:
        k = gather_pages(k, block_tables)
        v = gather_pages(v, block_tables)
        causal = False
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if pos is not None:
        cols = torch.arange(skv, device=q.device)
        visible = (cols[None, :] <= pos[:, None])[:, None, None, :]
    elif causal:
        visible = _attention.causal_visible(
            sq, skv, skv - sq if kv_offset is None else kv_offset, q.device)
    else:
        visible = torch.ones((), dtype=torch.bool, device=q.device)
    softmax = (None if _check_mode(mode) == "native"
               else functools.partial(softmax_mode, mode=mode))
    o = _attention.masked_attention(q, k, v, visible, softmax=softmax)
    return o.transpose(1, 2).reshape(b, sq, h * d)


def flash_attention_matmul_plain(q, k, v, w_out, *, causal: bool = True,
                                 kv_offset: Optional[int] = None, pos=None,
                                 block_tables=None, mode: str = "native"):
    """The unfused pair: masked softmax attention, then ``wo``.

    Causal masks key ``c`` for query ``i`` when ``c > i + kv_offset``
    (default ``Skv - Sq``); ``pos`` masks keys past each slot's frontier;
    masked scores are -1e30.  With ``block_tables``, k/v are page pools
    and the strip is gathered first.  The softmax's row max and row sum
    run through ``mode``'s cross-lane stage."""
    o = _attend(q, k, v, causal=causal, kv_offset=kv_offset, pos=pos,
                block_tables=block_tables, mode=mode)
    return torch.matmul(o, w_out.to(o.dtype))


def _attention_plan(dev, b: int, h: int, hkv: int, sq: int, d: int, n: int):
    """(bq, nsplit) of the tc and fma routes: query rows per block (the
    group's heads fold into 64 rows) and, for the fma route alone, how many
    blocks share N when (q tile, group, slot) blocks alone would leave SMs
    idle.  The decode route splits the keys, and the C library plans that
    split from the shapes and the SM count
    (``csrc/attention_decode.cuh::plan_decode``); none is computed here."""
    bq = _attention.attention_rows(h, hkv, sq, d)
    base = -(-sq // bq) * hkv * b
    sms = _sm_count(dev.index if dev.index is not None else 0)
    nsplit = 1 if base >= sms else max(1, min(-(-2 * sms // base), n // 256))
    return bq, nsplit


def _check_attention(q, k, v, w_out, w_scale, k_scale=None, v_scale=None):
    """Check the shapes and dtypes; returns the kernel's dtype code.  An
    int8 w_out takes f32 [N] scales; int8 k/v pools f32 [P, Hkv, ps, 1]
    scale pools."""
    b, h, sq, d = q.shape
    if k.dim() != 4 or v.shape != k.shape or k.shape[-1] != d \
            or w_out.shape[0] != h * d:
        raise ValueError(f"attention shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, w_out "
                         f"{tuple(w_out.shape)}")
    if not w_out.is_contiguous():
        raise ValueError("w_out must be contiguous")
    same = [q]
    if w_scale is None:
        same.append(w_out)
    elif w_out.dtype != torch.int8 or w_scale.dtype != torch.float32 \
            or w_scale.shape != (w_out.shape[1],):
        raise ValueError(f"an int8 [H*D, N] w_out takes f32 [N] scales, got "
                         f"{w_out.dtype} and {w_scale.dtype} "
                         f"{tuple(w_scale.shape)}")
    if k_scale is None:
        same += [k, v]
    else:
        sshape = k.shape[:3] + (1,)
        for t, sc in ((k, k_scale), (v, v_scale)):
            if t.dtype != torch.int8 or sc.dtype != torch.float32 \
                    or sc.shape != sshape or not sc.is_contiguous():
                raise ValueError(f"int8 page pools {tuple(k.shape)} take "
                                 f"contiguous f32 scale pools {sshape}, got "
                                 f"{t.dtype} and {sc.dtype} "
                                 f"{tuple(sc.shape)}")
    return _dtype_code(*same)


def _int32_vector(t, name: str, shape):
    if t.dtype not in (torch.int32, torch.int64) or tuple(t.shape) != shape:
        raise ValueError(f"{name} must be int32 {shape}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    return t.to(torch.int32).contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


def _dense_attention_matmul(q, k, v, w_out, w_scale, *, causal, kv_offset,
                            pos, mode: str = "native"):
    """Launch the dense attention + wo kernel (int8 wo with ``w_scale``)
    in ``mode``; the library sizes the workspace for the route it takes
    (the f32 group partials; O in bf16 for the tensor cores; O, the decode
    GEMV's partials and the key splits' partials for the decode route)."""
    dev = _check_device(q, k, v, w_out, *(t for t in (pos, w_scale)
                                          if t is not None))
    code = _check_attention(q, k, v, w_out, w_scale)
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if k.shape[0] != b:
        raise ValueError(f"k batch {k.shape[0]} != q batch {b}")
    n = w_out.shape[1]
    if pos is not None:
        pos = _int32_vector(pos, "pos", (b,))
        kv_offset = 0                  # unused: the frontier masks
    elif not causal:
        kv_offset = skv                # every key visible to every query
    elif kv_offset is None:
        kv_offset = skv - sq
    out = torch.empty(b, sq, n, dtype=q.dtype, device=dev)
    # every copy the launch reads is bound to a name until it returns
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    w_scale = None if w_scale is None else w_scale.contiguous()
    sms = _sm_count(dev.index if dev.index is not None else 0)
    size, route = _workspace("flash_attention_matmul", code,
                             int(w_scale is not None), int(pos is not None),
                             q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             w_out.data_ptr(), b, h, hkv, sq, skv, d, n, sms)
    bq, nsplit = ((1, 1) if route == "decode"
                  else _attention_plan(dev, b, h, hkv, sq, d, n))
    part = torch.empty(max(1, size), dtype=torch.float32, device=dev)
    count = _count_name("flash_attention_matmul"
                        + ("" if w_scale is None else "_q8")
                        + ("" if pos is None else "_pos"), mode)
    _launch("flash_attention_matmul", MODE_CODES[mode], code, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), w_out.data_ptr(), _ptr(w_scale),
            _ptr(pos), out.data_ptr(), part.data_ptr(), b, h, hkv, sq, skv, d,
            n, int(kv_offset), bq, nsplit, 1.0 / math.sqrt(d), sms,
            _stream(dev), count_as=count)
    return out


def _paged_attention_matmul(q, k_pages, v_pages, w_out, w_scale, k_scale,
                            v_scale, *, block_tables, pos,
                            mode: str = "native"):
    """Launch the paged attention + wo kernel (int8 wo with ``w_scale``,
    int8 pools with ``k_scale``/``v_scale`` [P, Hkv, ps, 1] f32) in
    ``mode``; the library sizes the workspace for the route it takes (the
    f32 group partials, or, for the decode route, O, the decode GEMV's
    partials and the key splits' partials)."""
    scales = [t for t in (w_scale, k_scale, v_scale) if t is not None]
    dev = _check_device(q, k_pages, v_pages, w_out, block_tables, pos,
                        *scales)
    code = _check_attention(q, k_pages, v_pages, w_out, w_scale, k_scale,
                            v_scale)
    b, h, sq, d = q.shape
    num_pages, hkv, page_size, _ = k_pages.shape
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError(f"block_tables {tuple(block_tables.shape)} is not "
                         f"[{b}, max_pages]")
    maxp = block_tables.shape[1]
    tables = _int32_vector(block_tables, "block_tables", (b, maxp))
    pos = _int32_vector(pos, "pos", (b,))
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("page pools must be contiguous")
    n = w_out.shape[1]
    out = torch.empty(b, sq, n, dtype=q.dtype, device=dev)
    # every copy the launch reads is bound to a name until it returns
    q = q.contiguous()
    w_scale = None if w_scale is None else w_scale.contiguous()
    sms = _sm_count(dev.index if dev.index is not None else 0)
    size, route = _workspace("paged_attention_matmul", code,
                             int(w_scale is not None),
                             int(k_scale is not None), q.data_ptr(),
                             k_pages.data_ptr(), v_pages.data_ptr(),
                             w_out.data_ptr(), b, h, hkv, sq, page_size,
                             maxp, d, n, sms)
    bq, nsplit = ((1, 1) if route == "decode"
                  else _attention_plan(dev, b, h, hkv, sq, d, n))
    part = torch.empty(max(1, size), dtype=torch.float32, device=dev)
    _launch("paged_attention_matmul", MODE_CODES[mode], code, q.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), _ptr(k_scale),
            _ptr(v_scale), w_out.data_ptr(), _ptr(w_scale),
            tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
            part.data_ptr(), b, h, hkv, sq, num_pages, page_size, maxp, d, n,
            bq, nsplit, 1.0 / math.sqrt(d), sms, _stream(dev),
            count_as=_count_name("paged_attention_matmul"
                                 + ("" if w_scale is None else "_q8"), mode))
    return out


def flash_attention_matmul(q, k, v, w_out, *, causal: bool = True,
                           kv_offset: Optional[int] = None, pos=None,
                           block_tables=None, mode: str = "native"):
    """``attention(q, k, v) @ wo``, its softmax's cross-lane stages (and
    its key walk) in ``mode``: one kernel plus a group reduction; for the
    bf16 causal shape at prefill, the tensor-core attention core and the
    ``wgmma`` GEMM; for the ``pos`` shape at one query a slot, the decode
    route (key splits, their combine into O, wo on the decode GEMV): the
    route the library picks, ``LAST_ROUTE``.

    q: [B,H,Sq,D]; k/v: [B,Hkv,Skv,D] (GQA inside the kernel, no repeat);
    w_out: [H*D, N] -> [B,Sq,N].  ``pos`` ([B] int32) is the decode shape;
    ``block_tables`` switches to :func:`paged_attention_matmul`.  CPU
    tensors run the plain version of ``mode``."""
    if block_tables is not None:
        return paged_attention_matmul(q, k, v, w_out,
                                      block_tables=block_tables, pos=pos,
                                      mode=mode)
    if not q.is_cuda:
        return flash_attention_matmul_plain(q, k, v, w_out, causal=causal,
                                            kv_offset=kv_offset, pos=pos,
                                            mode=mode)
    return _dense_attention_matmul(q, k, v, w_out, None, causal=causal,
                                   kv_offset=kv_offset, pos=pos, mode=mode)


def _zero_dead_slots(out, pos):
    """``out`` [B, Sq, N] with the rows of every slot whose ``pos`` is
    negative set to 0: the paged kernels (every route and mode, as the JAX
    kernel's ``skip_dead``) visit no page for such a slot.  The library
    rows keep averaging every key, as the JAX library row does."""
    return torch.where((pos < 0).reshape(-1, 1, 1), out.new_zeros(()), out)


def paged_attention_matmul_plain(q, k_pages, v_pages, w_out, *,
                                 block_tables, pos, mode: str = "native"):
    """Gather the logical strip through the (clamped) table, then the
    dense decode pair of ``mode``; a slot with ``pos < 0`` gets 0."""
    return _zero_dead_slots(flash_attention_matmul_plain(
        q, k_pages, v_pages, w_out, pos=pos, block_tables=block_tables,
        mode=mode), pos)


def check_page_size(page_size: int, mode: str) -> None:
    """The JAX package's rule: outside native the paged lowering folds each
    page's scores into 128-lane rows, so a page holds a multiple of 128
    keys (its kernels/fused.py::_paged_attention_matmul raises the same)."""
    if page_size % PAGE_MULTIPLE != 0 and _check_mode(mode) != "native":
        raise ValueError(
            f"paged decode under mode={mode!r} needs page_size to be a "
            f"multiple of {PAGE_MULTIPLE} (the abstract row reduces fold "
            f"into {PAGE_MULTIPLE}-lane vregs); got page_size={page_size}")


def paged_attention_matmul(q, k_pages, v_pages, w_out, *, block_tables,
                           pos, mode: str = "native"):
    """The paged decode shape of :func:`flash_attention_matmul`.

    k/v pools: [P,Hkv,page_size,D]; block_tables: [B,maxp] int32 (entries
    clamp to P - 1); pos: [B] int32 frontiers -> [B,Sq,N].  The kernel
    reads only pages at or before each slot's frontier, in every mode;
    outside native a page holds a multiple of 128 keys
    (:func:`check_page_size`).  One query a slot takes the decode route
    (``LAST_ROUTE``).  A slot with ``pos < 0`` sees no key and gets 0 on
    every route and in the plain version, as the JAX kernel gives it (the
    library row averages every key)."""
    if pos is None:
        raise ValueError("paged attention needs the per-slot pos frontier")
    check_page_size(k_pages.shape[2], mode)
    if not q.is_cuda:
        return paged_attention_matmul_plain(q, k_pages, v_pages, w_out,
                                            block_tables=block_tables,
                                            pos=pos, mode=mode)
    return _paged_attention_matmul(q, k_pages, v_pages, w_out, None, None,
                                   None, block_tables=block_tables, pos=pos,
                                   mode=mode)


# --------------------------------------------------------------------------
# The int8 attention + wo twin: an int8 wo with [N] scales in every shape,
# and, paged, int8 page pools with [P, Hkv, ps, 1] f32 per-token scales
# loaded through the same clamped table entry
# --------------------------------------------------------------------------


def _dequantize_kv_f32(pages, scale):
    return pages if scale is None else pages.float() * scale


def flash_attention_matmul_q8_plain(q, k, v, w_out, w_scale, *,
                                    causal: bool = True,
                                    kv_offset: Optional[int] = None,
                                    pos=None, block_tables=None,
                                    k_scale=None, v_scale=None,
                                    mode: str = "native"):
    """The kernel's arithmetic: int8 keys and values times their scales in
    f32 (never rounded), the softmax in f32 (its row max and row sum
    through ``mode``'s cross-lane stage), O rounded to q's dtype, the
    product with the dequantized wo in f32, cast to q's dtype; paged, a
    slot with ``pos < 0`` gets 0."""
    o = _attend(q, _dequantize_kv_f32(k, k_scale),
                _dequantize_kv_f32(v, v_scale), causal=causal,
                kv_offset=kv_offset, pos=pos, block_tables=block_tables,
                mode=mode)
    out = torch.matmul(o.float(), dequantize_weight(w_out, w_scale)
                       ).to(q.dtype)
    return out if block_tables is None else _zero_dead_slots(out, pos)


def flash_attention_matmul_q8_library(q, k, v, w_out, *, causal: bool = True,
                                      kv_offset: Optional[int] = None,
                                      pos=None, block_tables=None,
                                      w_scale=None, k_scale=None,
                                      v_scale=None):
    """The JAX package's library row: wo dequantized to q's dtype, int8
    pools dequantized in f32 and the gathered strip cast to q's dtype, then
    the unfused pair."""
    w_out, w_scale = _quantized(w_out, w_scale)
    if block_tables is not None and k_scale is not None:
        k = gather_pages(_dequantize_kv_f32(k, k_scale), block_tables)
        v = gather_pages(_dequantize_kv_f32(v, v_scale), block_tables)
        k, v, block_tables = k.to(q.dtype), v.to(q.dtype), None
    return flash_attention_matmul_plain(
        q, k, v, dequantize_weight(w_out, w_scale, q.dtype), causal=causal,
        kv_offset=kv_offset, pos=pos, block_tables=block_tables)


def flash_attention_matmul_q8(q, k, v, w_out, *, causal: bool = True,
                              kv_offset: Optional[int] = None, pos=None,
                              block_tables=None, w_scale=None, k_scale=None,
                              v_scale=None, mode: str = "native"):
    """``attention(q, k, v) @ (w_out * w_scale)`` in one kernel: causal,
    by ``pos`` frontier, or paged (``block_tables``), the softmax's
    cross-lane stages (and the dense shapes' key walk) in ``mode``; the
    bf16 causal shape at prefill runs on the tensor cores as
    :func:`flash_attention_matmul` (``LAST_ROUTE``).
    w_out: int8 [H*D, N] with f32 ``w_scale`` [N] (a float w_out is
    quantized first).  Only the paged shape takes int8 k/v pools, with f32
    ``k_scale``/``v_scale`` [P, Hkv, ps, 1]; the dense shapes take k/v in
    q's dtype.  Outside native a page holds a multiple of 128 keys
    (:func:`check_page_size`).  CPU tensors run the plain version of
    ``mode``."""
    _check_mode(mode)
    if (k_scale is None) != (v_scale is None):
        raise ValueError("int8 kv needs both k_scale and v_scale")
    if k_scale is not None and block_tables is None:
        raise ValueError("int8 kv scales are a paged-shape operand; the "
                         "dense decode path dequantizes its cache strip up "
                         "front (models/transformer.py)")
    if block_tables is not None:
        if pos is None:
            raise ValueError("paged attention needs the per-slot pos "
                             "frontier")
        check_page_size(k.shape[2], mode)
    w_out, w_scale = _quantized(w_out, w_scale)
    if not q.is_cuda:
        return flash_attention_matmul_q8_plain(
            q, k, v, w_out, w_scale, causal=causal, kv_offset=kv_offset,
            pos=pos, block_tables=block_tables, k_scale=k_scale,
            v_scale=v_scale, mode=mode)
    if block_tables is not None:
        return _paged_attention_matmul(q, k, v, w_out, w_scale, k_scale,
                                       v_scale, block_tables=block_tables,
                                       pos=pos, mode=mode)
    return _dense_attention_matmul(q, k, v, w_out, w_scale, causal=causal,
                                   kv_offset=kv_offset, pos=pos, mode=mode)


# --------------------------------------------------------------------------
# The structural cost models (the JAX package's): each fused op's cost is
# the unfused pair's traffic less what the fusion keeps out of HBM, at the
# tiles of the JAX lowering on the compile target ``target``.  ``auto``
# ranks the modes by them.
# --------------------------------------------------------------------------

#: add_rmsnorm's latency cap (the JAX plan's, mirroring rmsnorm)
_MAX_BLOCK_ROWS = 64
register_op_space("add_rmsnorm", "rowwise", max_block_rows=_MAX_BLOCK_ROWS)
# rmsnorm_matmul's tile is a GEMM tile: it shares the "gemm" tuning space;
# the twins tune apart (their weight tiles are int8)
register_op_space("rmsnorm_swiglu", "swiglu")
register_op_space("flash_attention_matmul", "attention_matmul")
register_op_space("rmsnorm_swiglu_q8", "swiglu")
register_op_space("flash_attention_matmul_q8", "attention_matmul")


def _weight_stream(m: int, n: int, k: int, mode: str, dtype,
                   plan_dialect: Optional[str], target: Dialect):
    """The B-matrix leg of the composed GEMM's stream, as
    ``gemm.structural_cost`` counts it: (bytes, re-reads)."""
    itemsize = dtype_bytes(dtype)
    if mode == "library":
        bm = 512
    else:
        bm, _, _ = _gemm.block_shape_for(mode, m, n, k, dtype, plan_dialect,
                                         target)
    rereads = max(1, -(-m // bm))
    return k * n * itemsize * rereads, rereads


def _q8_weight_stream(rereads: int, k: int, n: int) -> int:
    """int8 weight elements + the f32 per-channel scale row, re-fetched
    once per row-block sweep like the float weight tile they replace."""
    return (k * n * 1 + n * 4) * rereads


def _moment_scratch(mode: str, steps: int, rows: int, lanes: int):
    """The norm prologue's moment stage: (round trips a block, scratch
    bytes) of the abstract tree and its re-stage; zero in other modes."""
    if mode != "abstract":
        return 0, 0
    return (tree_stages(lanes) + 1,
            steps * (scratch_tree_bytes(lanes, rows=rows) + 3 * rows * 4))


def structural_cost_rmsnorm_matmul(rows: int, d: int, n: int, mode: str,
                                   dtype=torch.float32,
                                   plan_dialect: Optional[str] = None,
                                   target: Dialect = TARGET) -> dict:
    """The unfused pair's traffic (``gemm`` + ``rmsnorm`` costs) minus one
    activation round trip, the write and read-back of the normalized
    rows; ``library`` is the pair itself."""
    from repro_torch.kernels import rmsnorm as _rmsnorm
    lanes = target.W
    itemsize = dtype_bytes(dtype)
    g = _gemm.structural_cost(m=rows, n=n, k=d, mode=mode, dtype=dtype,
                              plan_dialect=plan_dialect, target=target)
    r = _rmsnorm.structural_cost(rows=rows, d=d, mode=mode, dtype=dtype,
                                 plan_dialect=plan_dialect, target=target)
    unfused = g["hbm_bytes"] + r["hbm_bytes"]
    saved = 0 if mode == "library" else 2 * rows * d * itemsize
    if mode == "library":
        bm = bn = 512
    else:
        bm, bn, _ = _gemm.block_shape_for(mode, rows, n, d, dtype,
                                          plan_dialect, target)
        bm = min(bm, align_up(rows, 128))
        bn = min(bn, align_up(n, 128))
    steps = -(-rows // bm) * -(-n // bn)
    round_trips, scratch_bytes = _moment_scratch(mode, steps, bm, lanes)
    ws, _ = _weight_stream(rows, n, d, mode, dtype, plan_dialect, target)
    return {
        "hbm_bytes": unfused - saved,
        "hbm_bytes_unfused_pair": unfused,
        "hbm_bytes_saved": saved,
        "weight_stream_bytes": ws,
        "flops": g["flops"],
        "block": (bm, bn),
        "blocks": steps,
        "scratch_round_trips_per_block": round_trips,
        "scratch_bytes_total": scratch_bytes,
        "lane_shuffles_per_block": tree_stages(lanes)
        if mode == "abstract+shuffle" else 0,
        "fused_epilogue": mode != "library",
    }


def structural_cost_rmsnorm_matmul_q8(rows: int, d: int, n: int, mode: str,
                                      dtype=torch.float32,
                                      plan_dialect: Optional[str] = None,
                                      target: Dialect = TARGET) -> dict:
    """The float cost with the weight stream re-priced at int8 + scales,
    off both the fused bytes and the unfused pair."""
    base = structural_cost_rmsnorm_matmul(rows, d, n, mode, dtype,
                                          plan_dialect, target)
    ws_f32, rereads = _weight_stream(rows, n, d, mode, dtype, plan_dialect,
                                     target)
    ws_q8 = _q8_weight_stream(rereads, d, n)
    delta = ws_f32 - ws_q8
    base.update(
        hbm_bytes=base["hbm_bytes"] - delta,
        hbm_bytes_unfused_pair=base["hbm_bytes_unfused_pair"] - delta,
        weight_stream_bytes=ws_q8,
        weight_stream_bytes_f32=ws_f32,
        weight_precision="int8",
    )
    return base


def structural_cost_add_rmsnorm(rows: int, d: int, mode: str,
                                dtype=torch.float32,
                                plan_dialect: Optional[str] = None,
                                target: Dialect = TARGET) -> dict:
    """The read-back leg of the sum's round trip, eliminated: the unfused
    pair (the add's three activation terms + ``rmsnorm``) less one
    ``rows x d`` read."""
    from repro_torch.kernels import rmsnorm as _rmsnorm
    lanes = target.W
    itemsize = dtype_bytes(dtype)
    r = _rmsnorm.structural_cost(rows=rows, d=d, mode=mode, dtype=dtype,
                                 plan_dialect=plan_dialect, target=target)
    unfused = 3 * rows * d * itemsize + r["hbm_bytes"]
    saved = 0 if mode == "library" else rows * d * itemsize
    d_padded = d if mode == "native" else d + ((-d) % lanes)
    plan = tuned_plan("add_rmsnorm", rows, 2 * d_padded * itemsize,
                      mode=mode if mode != "library" else "native",
                      dialect=plan_dialect, max_block_rows=_MAX_BLOCK_ROWS,
                      semantics=("parallel",))
    blocks = plan.grid[0]
    round_trips, scratch_bytes = _moment_scratch(mode, blocks,
                                                 plan.block_rows, lanes)
    return {
        "hbm_bytes": unfused - saved,
        "hbm_bytes_unfused_pair": unfused,
        "hbm_bytes_saved": saved,
        "blocks": blocks,
        "block_rows": plan.block_rows,
        "pipeline_occupancy": plan.occupancy,
        "scratch_round_trips_per_block": round_trips,
        "scratch_bytes_total": scratch_bytes,
        "lane_shuffles_per_block": tree_stages(lanes)
        if mode == "abstract+shuffle" else 0,
        "fused_epilogue": mode != "library",
    }


def resolve_attention_matmul_blocks(mode: str, sq: int, skv: int, d: int,
                                    n: int, block_q=None, block_kv=None,
                                    plan_dialect: Optional[str] = None,
                                    op: str = "flash_attention_matmul",
                                    target: Dialect = TARGET):
    """The modelled (block_q, block_kv): caller-pinned blocks win; then
    ``op``'s own tuning-table entry; then attention's resolution; clamped
    to the problem, and outside native ``block_kv`` a multiple of
    ``target``'s wave width."""
    if block_q is None or block_kv is None:
        entry = tuned_entry(op, mode,
                            attention_matmul_bucket(sq, skv, d, n),
                            dialect=plan_dialect)
        if entry and "block_q" in entry and "block_kv" in entry:
            tq, tkv = int(entry["block_q"]), int(entry["block_kv"])
        else:
            tq, tkv = _attention.resolve_blocks(
                mode, sq, skv, d, plan_dialect=plan_dialect)
        block_q = tq if block_q is None else block_q
        block_kv = tkv if block_kv is None else block_kv
    block_q = min(block_q, align_up(sq, 128))
    block_kv = min(block_kv, align_up(skv, 128))
    if mode != "native":
        block_kv = max(target.W, (block_kv // target.W) * target.W)
    return block_q, block_kv


def structural_cost_flash_attention_matmul(
        b: int, h: int, sq: int, skv: int, d: int, n: int, causal: bool,
        mode: str, block_q=None, block_kv=None, dtype=torch.float32,
        plan_dialect: Optional[str] = None, page_size: Optional[int] = None,
        pages_occupied: Optional[int] = None,
        op: str = "flash_attention_matmul",
        target: Dialect = TARGET) -> dict:
    """The unfused pair's traffic (``flash_attention`` + ``gemm`` at
    ``m = B.S``, ``k = H.D``) minus one ``[B,S,H,D]`` round trip, the
    kernel columns from attention's visited-block model at this
    lowering's tiles.  The paged decode shape (``page_size`` set) streams
    ``pages_occupied`` pages of keys (default: every page of every slot),
    not the capacity."""
    itemsize = dtype_bytes(dtype)
    if page_size is not None:
        return _structural_cost_paged(
            b=b, h=h, sq=sq, skv=skv, d=d, n=n, mode=mode, block_q=block_q,
            dtype=dtype, plan_dialect=plan_dialect, page_size=page_size,
            pages_occupied=pages_occupied, op=op, target=target)
    if mode == "library":
        bq, bkv = 256, 256
    else:
        bq, bkv = resolve_attention_matmul_blocks(
            mode, sq, skv, d, n, block_q, block_kv, plan_dialect, op=op,
            target=target)
    att = _attention.structural_cost(
        b=b, h=h, sq=sq, skv=skv, d=d, causal=causal, mode=mode,
        block_q=bq, block_kv=bkv, dtype=dtype, plan_dialect=plan_dialect,
        target=target)
    g = _gemm.structural_cost(m=b * sq, n=n, k=h * d, mode=mode,
                              dtype=dtype, plan_dialect=plan_dialect,
                              target=target)
    unfused = att["hbm_bytes"] + g["hbm_bytes"]
    saved = 0 if mode == "library" else 2 * b * sq * h * d * itemsize
    ws, _ = _weight_stream(b * sq, n, h * d, mode, dtype, plan_dialect,
                           target)
    return {
        "hbm_bytes": unfused - saved,
        "hbm_bytes_unfused_pair": unfused,
        "hbm_bytes_saved": saved,
        "weight_stream_bytes": ws,
        "flops": att["flops"] + g["flops"],
        "block": (bq, bkv),
        "blocks_visited": att["blocks_visited"],
        "skip_fraction": att["skip_fraction"],
        "scratch_round_trips_per_block":
            att["scratch_round_trips_per_block"],
        "scratch_bytes_total": att["scratch_bytes_total"],
        "lane_shuffles_per_block": att["lane_shuffles_per_block"],
        "fused_epilogue": mode != "library",
    }


def _structural_cost_paged(*, b: int, h: int, sq: int, skv: int, d: int,
                           n: int, mode: str, block_q, dtype,
                           plan_dialect: Optional[str], page_size: int,
                           pages_occupied: Optional[int],
                           op: str = "flash_attention_matmul",
                           target: Dialect = TARGET) -> dict:
    """Occupied-page accounting for the paged decode shape: the kv term
    reads ``pages_occupied . page_size`` rows; capacity (``skv``) shows in
    ``blocks_total`` only."""
    lanes = target.W
    itemsize = dtype_bytes(dtype)
    maxp = -(-skv // page_size)
    total_pages = b * maxp
    if pages_occupied is None:
        pages_occupied = total_pages
    pages_occupied = min(pages_occupied, total_pages)
    if mode == "library":
        bq = 256
    else:
        bq, _ = resolve_attention_matmul_blocks(mode, sq, skv, d, n,
                                                block_q, page_size,
                                                plan_dialect, op=op,
                                                target=target)
    visited = h * pages_occupied        # every head walks live pages only
    reduces_per_block = 2               # row-max + row-sum
    if mode == "abstract":
        round_trips = reduces_per_block * tree_stages(lanes)
        scratch_bytes = (visited * reduces_per_block *
                         scratch_tree_bytes(lanes, rows=bq))
        shuffles = 0
    elif mode == "abstract+shuffle":
        round_trips, scratch_bytes = 0, 0
        shuffles = reduces_per_block * tree_stages(lanes)
    else:                               # native / library
        round_trips, scratch_bytes, shuffles = 0, 0, 0
    kv_stream = 2 * h * d * pages_occupied * page_size * itemsize
    att_hbm = h * d * 2 * b * sq * itemsize + kv_stream
    g = _gemm.structural_cost(m=b * sq, n=n, k=h * d, mode=mode,
                              dtype=dtype, plan_dialect=plan_dialect,
                              target=target)
    unfused = att_hbm + g["hbm_bytes"]
    saved = 0 if mode == "library" else 2 * b * sq * h * d * itemsize
    ws, _ = _weight_stream(b * sq, n, h * d, mode, dtype, plan_dialect,
                           target)
    return {
        "hbm_bytes": unfused - saved,
        "hbm_bytes_unfused_pair": unfused,
        "hbm_bytes_saved": saved,
        "weight_stream_bytes": ws,
        "kv_stream_bytes": kv_stream,
        "flops": visited * 4 * bq * page_size * d + g["flops"],
        "block": (bq, page_size),
        "blocks_visited": visited,
        "blocks_total": h * total_pages,
        "skip_fraction": 1.0 - pages_occupied / total_pages,
        "scratch_round_trips_per_block": round_trips,
        "scratch_bytes_total": scratch_bytes,
        "lane_shuffles_per_block": shuffles,
        "fused_epilogue": mode != "library",
        "page_size": page_size,
        "pages_occupied": pages_occupied,
    }


def structural_cost_flash_attention_matmul_q8(
        b: int, h: int, sq: int, skv: int, d: int, n: int, causal: bool,
        mode: str, block_q=None, block_kv=None, dtype=torch.float32,
        plan_dialect: Optional[str] = None, page_size: Optional[int] = None,
        pages_occupied: Optional[int] = None,
        target: Dialect = TARGET) -> dict:
    """The float model with the wo stream (and, paged, the kv stream)
    re-priced at int8 width plus the f32 scale sideband."""
    base = structural_cost_flash_attention_matmul(
        b, h, sq, skv, d, n, causal, mode, block_q, block_kv, dtype,
        plan_dialect, page_size, pages_occupied,
        op="flash_attention_matmul_q8", target=target)
    ws_f32, rereads = _weight_stream(b * sq, n, h * d, mode, dtype,
                                     plan_dialect, target)
    ws_q8 = _q8_weight_stream(rereads, h * d, n)
    delta = ws_f32 - ws_q8
    if page_size is not None:
        # int8 page rows: 2.d value bytes + two f32 per-token scales
        kv_q8 = (h * base["pages_occupied"] * page_size * (2 * d + 8))
        delta += base["kv_stream_bytes"] - kv_q8
        base["kv_stream_bytes"] = kv_q8
        base["kv_precision"] = "int8"
    base.update(
        hbm_bytes=base["hbm_bytes"] - delta,
        hbm_bytes_unfused_pair=base["hbm_bytes_unfused_pair"] - delta,
        weight_stream_bytes=ws_q8,
        weight_stream_bytes_f32=ws_f32,
        weight_precision="int8",
    )
    return base


def resolve_swiglu_blocks(mode: str, rows: int, d: int, f: int,
                          dtype=torch.float32,
                          plan_dialect: Optional[str] = None,
                          op: str = "rmsnorm_swiglu",
                          target: Dialect = TARGET):
    """The modelled (bm, bn) over ``rows x f``: ``op``'s tuning-table entry,
    then the GEMM rule."""
    entry = tuned_entry(op, mode, swiglu_bucket(rows, d, f),
                        dialect=plan_dialect)
    if entry and "block" in entry:
        bm, bn = entry["block"]
        return int(bm), int(bn)
    bm, bn, _ = _gemm.block_shape_for(mode, rows, f, d, dtype, plan_dialect,
                                      target)
    return bm, bn


def structural_cost_rmsnorm_swiglu(rows: int, d: int, f: int, mode: str,
                                   dtype=torch.float32,
                                   plan_dialect: Optional[str] = None,
                                   op: str = "rmsnorm_swiglu",
                                   target: Dialect = TARGET) -> dict:
    """The unfused pair (``rmsnorm`` + one GEMM against ``[D, 2F]``) minus
    the normalized activation's round trip."""
    from repro_torch.kernels import rmsnorm as _rmsnorm
    lanes = target.W
    itemsize = dtype_bytes(dtype)
    g = _gemm.structural_cost(m=rows, n=2 * f, k=d, mode=mode, dtype=dtype,
                              plan_dialect=plan_dialect, target=target)
    r = _rmsnorm.structural_cost(rows=rows, d=d, mode=mode, dtype=dtype,
                                 plan_dialect=plan_dialect, target=target)
    unfused = g["hbm_bytes"] + r["hbm_bytes"]
    saved = 0 if mode == "library" else 2 * rows * d * itemsize
    if mode == "library":
        bm = bn = 512
    else:
        bm, bn = resolve_swiglu_blocks(mode, rows, d, f, dtype,
                                       plan_dialect, op=op, target=target)
        bm = min(bm, align_up(rows, 128))
        bn = min(bn, align_up(f, 128))
    steps = -(-rows // bm) * -(-f // bn)
    round_trips, scratch_bytes = _moment_scratch(mode, steps, bm, lanes)
    ws, _ = _weight_stream(rows, 2 * f, d, mode, dtype, plan_dialect,
                           target)
    return {
        "hbm_bytes": unfused - saved,
        "hbm_bytes_unfused_pair": unfused,
        "hbm_bytes_saved": saved,
        "weight_stream_bytes": ws,
        "flops": g["flops"],
        "block": (bm, bn),
        "blocks": steps,
        "scratch_round_trips_per_block": round_trips,
        "scratch_bytes_total": scratch_bytes,
        "lane_shuffles_per_block": tree_stages(lanes)
        if mode == "abstract+shuffle" else 0,
        "fused_epilogue": mode != "library",
    }


def structural_cost_rmsnorm_swiglu_q8(rows: int, d: int, f: int, mode: str,
                                      dtype=torch.float32,
                                      plan_dialect: Optional[str] = None,
                                      target: Dialect = TARGET) -> dict:
    """The float model with the ``[wi|wg]`` stream re-priced at int8 width
    (int8 tiles + one f32 scale row), off both the fused bytes and the
    unfused pair."""
    base = structural_cost_rmsnorm_swiglu(rows, d, f, mode, dtype,
                                          plan_dialect,
                                          op="rmsnorm_swiglu_q8",
                                          target=target)
    ws_f32, rereads = _weight_stream(rows, 2 * f, d, mode, dtype,
                                     plan_dialect, target)
    ws_q8 = _q8_weight_stream(rereads, d, 2 * f)
    delta = ws_f32 - ws_q8
    base.update(
        hbm_bytes=base["hbm_bytes"] - delta,
        hbm_bytes_unfused_pair=base["hbm_bytes_unfused_pair"] - delta,
        weight_stream_bytes=ws_q8,
        weight_stream_bytes_f32=ws_f32,
        weight_precision="int8",
    )
    return base


#: op -> its structural cost model
COSTS = {
    "rmsnorm_matmul": structural_cost_rmsnorm_matmul,
    "add_rmsnorm": structural_cost_add_rmsnorm,
    "flash_attention_matmul": structural_cost_flash_attention_matmul,
    "rmsnorm_swiglu": structural_cost_rmsnorm_swiglu,
    "rmsnorm_matmul_q8": structural_cost_rmsnorm_matmul_q8,
    "flash_attention_matmul_q8": structural_cost_flash_attention_matmul_q8,
    "rmsnorm_swiglu_q8": structural_cost_rmsnorm_swiglu_q8,
}


# --------------------------------------------------------------------------
# Registration: native = the kernel, library = the plain version; a native
# request under a foreign dialect takes the declared fallback (warned) on
# CPU operands and raises on CUDA ones.  Every op also registers its
# abstract and abstract+shuffle kernels, and declares abstract+shuffle ->
# abstract, as the JAX package does for its fused ops and their int8 twins.
# --------------------------------------------------------------------------

for _op, _native, _library in (
        ("rmsnorm_matmul", rmsnorm_matmul, rmsnorm_matmul_plain),
        ("add_rmsnorm", add_rmsnorm, add_rmsnorm_library),
        ("rmsnorm_swiglu", rmsnorm_swiglu, rmsnorm_swiglu_plain),
        ("flash_attention_matmul", flash_attention_matmul,
         flash_attention_matmul_plain),
        ("rmsnorm_matmul_q8", rmsnorm_matmul_q8, rmsnorm_matmul_q8_library),
        ("rmsnorm_swiglu_q8", rmsnorm_swiglu_q8, rmsnorm_swiglu_q8_library),
        ("flash_attention_matmul_q8", flash_attention_matmul_q8,
         flash_attention_matmul_q8_library)):
    REGISTRY.register(_op, IsaMode.NATIVE, _native, contract=CONTRACTS[_op],
                      cost=functools.partial(COSTS[_op], mode="native"))
    REGISTRY.register(_op, IsaMode.LIBRARY, _library,
                      cost=functools.partial(COSTS[_op], mode="library"))
    REGISTRY.declare_fallback(
        _op, IsaMode.NATIVE, IsaMode.LIBRARY,
        reason="the fused native kernel is pinned to its target; the "
               "unfused plain pair is the declared escape")
for _op, _kernel in (("rmsnorm_matmul", rmsnorm_matmul),
                     ("rmsnorm_swiglu", rmsnorm_swiglu),
                     ("flash_attention_matmul", flash_attention_matmul),
                     ("add_rmsnorm", add_rmsnorm),
                     ("rmsnorm_matmul_q8", rmsnorm_matmul_q8),
                     ("rmsnorm_swiglu_q8", rmsnorm_swiglu_q8),
                     ("flash_attention_matmul_q8", flash_attention_matmul_q8)):
    for _mode in ("abstract", "abstract+shuffle"):
        REGISTRY.register(_op, _mode, functools.partial(_kernel, mode=_mode),
                          contract=MODE_CONTRACTS[(_op, _mode)],
                          cost=functools.partial(COSTS[_op], mode=_mode))
    REGISTRY.declare_fallback(
        _op, IsaMode.ABSTRACT_SHUFFLE, IsaMode.ABSTRACT,
        reason="no lane shuffle on this dialect; the cross-lane reduction "
               "degrades to the scratch-tree lowering")
# the precision axis: ExecutionPolicy(precision="int8") retargets the f32
# op names onto their twins at select() time, in the policy's mode
for _op in QUANT_OPS:
    REGISTRY.register_precision_variant(_op[:-3], "int8", _op)
