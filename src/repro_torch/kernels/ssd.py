"""The Mamba2 SSD kernels: the chunked prefill scan and the one-token decode
recurrence, as hand-written Hopper kernels.

Two kernels, each replacing a Pallas kernel of the JAX package's
``kernels/ssd.py`` (sources and design notes in ``csrc/``):

- :func:`ssd_scan`: the whole chunked scan, intra-chunk decay-masked
  ``C.B^T`` and ``w.x``, the carried-state term ``C.h`` and the update
  ``h <- exp(total) h + B^T (wS x)``, one block per (batch, head) looping
  over the chunks (``csrc/ssd_scan.cu``).  Its C entry takes one of two
  routes (:func:`scan_route` mirrors the choice): ``tc``, on the tensor
  cores (``csrc/ssd_scan_tc.cu``: bf16 products with f32 sums, the state
  in registers, the update's f32 operand and the state read by ``C.h``
  each split into a bf16 hi + lo pair so the state keeps f32 accuracy),
  for bf16 operands with N and P multiples of 16 and 16-byte aligned rows;
  ``fma``, f32 FMAs with the state in shared memory, for the rest;
- :func:`ssd_decode`: ``h <- exp(dt A) h + dt B (x) x``, ``y = C.h`` for
  every slot and head in one launch (``csrc/ssd_decode.cu``): each block
  stages its (slot, head) state tile in shared memory by bulk copies and
  writes ``h`` back by coalesced stores, the same in every mode
  (:func:`decode_resident_blocks` gives its blocks an SM).

Both take ``mode`` in ``abstract | abstract+shuffle | native``, the JAX
package's Pallas lowerings of each op.  A mode changes only the kernel's
cross-lane stage: the scan's within-chunk prefix sum ``cumsum(dt A)``
(Hillis-Steele stages through shared memory under ``abstract``, warp
shuffles under ``abstract+shuffle``) and the decode's readout over N
(a shared-memory halving tree, or N in lanes and the warp tree; N a power
of two outside ``native``).

Beside each wrapper is its plain PyTorch version (``*_plain``, the JAX
package's ``ssd_scan_reference`` / ``ssd_decode_reference`` in ``native``),
which runs the cross-lane stage of ``mode`` in the kernel's order through
``core/shuffle.py``.  A wrapper given CPU tensors runs the plain version;
given CUDA tensors it launches its kernel or raises.  Each launch adds one
to ``LAUNCHES["ssd_scan"]`` or ``LAUNCHES["ssd_decode"]``
(``<kernel>_<mode>`` outside native; ``kernels/_launch.py``).  Both ops
register the three kernel lowerings with the JAX package's contracts, a
``library`` lowering (the plain version) and, as the JAX package does, the
``abstract+shuffle -> abstract`` fallback (taken for CPU operands only).

The chunk comes from the caller (the model's ``chunk_size``), clamped to
the sequence; ``chunk=None`` resolves it as the JAX package does
(:func:`resolve_chunk`: the tuning table's entry for the op, mode, dialect
and shape bucket, else the first candidate of the Eq. 1 grid).  The JAX
package's ``block_b`` is a TPU tiling knob that does not change results:
the kernel has no counterpart, and :func:`resolve_decode_block` serves the
cost model alone.  ``structural_cost_ssd_scan`` and
``structural_cost_ssd_decode`` are the JAX package's models (the fused
stream against the unfused program's intermediates, the scan's and the
readout's scratch round trips), which ``auto`` ranks the modes by.
"""
from __future__ import annotations

import math
from typing import Optional

import functools

import torch
import torch.nn.functional as F

from repro_torch.core import (REGISTRY, TARGET, Dialect, IsaMode,
                              KernelContract, Primitive, dtype_bytes,
                              validate_contract)
from repro_torch.core.tuning import (active_dialect, register_op_space,
                                     ssd_bucket, ssd_candidates,
                                     ssd_decode_bucket, ssd_decode_candidates,
                                     tuned_entry)
from repro_torch.core.shuffle import (LANES, lane_inclusive_scan,
                                      lane_shuffle_up, row_reduce_shuffle,
                                      scratch_inclusive_scan,
                                      scratch_tree_reduce)
from repro_torch.kernels._launch import (MODE_CODES, check_device,
                                         check_mode, count_name, dtype_code,
                                         entry, launch, stream)

#: shapes the kernels take: state width, head width, positions per chunk
MAX_STATE, MAX_HEAD, MAX_CHUNK = 128, 64, 256
#: the decode's columns a block (``kDecBlockP``): a (slot, head) takes
#: ceil(P / DECODE_BLOCK_P) blocks
DECODE_BLOCK_P = 32
OPS = ("ssd_scan", "ssd_decode")

_NATIVE_FEATURES = frozenset({"fused_epilogue", "mxu_aligned_tiles",
                              "dimension_semantics", "multi_buffering"})
CONTRACTS = {
    op: KernelContract(kernel=op, mode=IsaMode.NATIVE,
                       primitives=frozenset(Primitive),
                       native_features=_NATIVE_FEATURES)
    for op in OPS
}
#: the portable budget of both ops (the JAX package's _SSD_ABSTRACT, which
#: _SSDD_ABSTRACT reuses); abstract+shuffle adds primitive 11
_ABSTRACT_PRIMITIVES = frozenset({
    Primitive.LOCKSTEP_GROUP, Primitive.MASKED_DIVERGENCE,
    Primitive.MANAGED_SCRATCHPAD, Primitive.WORKGROUP_BARRIER,
    Primitive.HIERARCHICAL_MEMORY, Primitive.IDENTITY_REGISTERS,
    Primitive.ASYNC_MEMORY, Primitive.REGISTER_OCCUPANCY})
#: (op, mode) -> the contract of its abstract or abstract+shuffle lowering
MODE_CONTRACTS = {}
for _op in OPS:
    MODE_CONTRACTS[(_op, "abstract")] = KernelContract(
        kernel=_op, mode=IsaMode.ABSTRACT, primitives=_ABSTRACT_PRIMITIVES)
    MODE_CONTRACTS[(_op, "abstract+shuffle")] = KernelContract(
        kernel=_op, mode=IsaMode.ABSTRACT_SHUFFLE,
        primitives=_ABSTRACT_PRIMITIVES | {Primitive.LANE_SHUFFLE})
for _c in (*CONTRACTS.values(), *MODE_CONTRACTS.values()):
    validate_contract(_c)


def resolve_chunk(seq: int, chunk: Optional[int] = None, *,
                  mode: str = "native", p: Optional[int] = None,
                  n: Optional[int] = None,
                  plan_dialect: Optional[str] = None,
                  op: str = "ssd_scan") -> int:
    """The effective chunk length, never longer than the sequence: the
    caller's, else the tuning table's entry for (``op``, ``mode``, the
    ``plan_dialect`` slice (None: the ambient policy's, then TARGET), the
    bucket of ``seq``, ``p``, ``n``), else the first candidate of that
    dialect's grid (the JAX package's precedence)."""
    if chunk is not None:
        return max(1, min(int(chunk), seq))
    if p is None or n is None:
        raise ValueError("a tuned chunk needs the head width p and the "
                         "state width n")
    entry = tuned_entry(op, mode, ssd_bucket(seq, p, n), plan_dialect)
    if entry and "chunk" in entry:
        return max(1, min(int(entry["chunk"]), seq))
    cands = ssd_candidates(seq, p, n, active_dialect(plan_dialect))
    return max(1, min(int(cands[0]["chunk"]), seq))


def resolve_decode_block(mode: str, b: int, p: int, n: int,
                         block_b: Optional[int] = None,
                         plan_dialect: Optional[str] = None,
                         op: str = "ssd_decode") -> int:
    """The modelled decode batch tile, never wider than the batch (the JAX
    package's precedence: explicit, table, first candidate)."""
    if block_b is not None:
        return max(1, min(int(block_b), b))
    entry = tuned_entry(op, mode, ssd_decode_bucket(b, p, n), plan_dialect)
    if entry and "block_b" in entry:
        return max(1, min(int(entry["block_b"]), b))
    cands = ssd_decode_candidates(b, p, n, active_dialect(plan_dialect))
    return max(1, min(int(cands[0]["block_b"]), b))


def _check_state_width(n: int, mode: str) -> None:
    """Outside native the decode readout is a tree over N: a power of two,
    as the JAX package's fused_ssd_decode requires."""
    if check_mode(mode) != "native" and (n < 1 or n & (n - 1)):
        raise ValueError(f"ssd_decode [{mode}] needs a power-of-two state "
                         f"width, got N={n}")


# --------------------------------------------------------------------------
# The modes' cross-lane stages, in plain PyTorch, in the kernels' order
# --------------------------------------------------------------------------


def prefix_sum(dA, mode: str, dim: int = 2):
    """Inclusive cumsum of ``dA`` over ``dim`` (the chunk) through the
    stage of ``mode`` (the JAX package's ``_prefix_sum``): native's
    ``torch.cumsum``; abstract's Hillis-Steele stages through a scratch
    tensor; abstract+shuffle as its kernel scans a chunk of up to
    ``MAX_CHUNK`` positions in one warp: each of the 32 lanes sums its 8
    consecutive positions in order, the lane totals go through the lane
    scan, and each lane adds the total before it."""
    if check_mode(mode) == "native":
        return torch.cumsum(dA, dim=dim)
    v = dA.movedim(dim, -1)
    q = v.shape[-1]
    if mode == "abstract":
        out = scratch_inclusive_scan(v, torch.empty_like(v))
    else:
        per = MAX_CHUNK // LANES
        lanes = F.pad(v, (0, MAX_CHUNK - q)).unflatten(-1, (LANES, per))
        local = [lanes[..., 0]]
        for i in range(1, per):
            local.append(local[-1] + lanes[..., i])
        local = torch.stack(local, dim=-1)
        incl = lane_inclusive_scan(local[..., -1])
        lane = torch.arange(LANES, device=v.device)
        before = torch.where(lane >= 1, lane_shuffle_up(incl, 1),
                             torch.zeros_like(incl))
        out = (before[..., None] + local).flatten(-2)[..., :q]
    return out.movedim(-1, dim)


def readout(C, state, mode: str):
    """``y[..., p] = sum_n C[..., n] state[..., n, p]`` through the stage
    of ``mode``: C [B,G,N], state [B,G,Hg,N,P] -> [B,G,Hg,P].  native: one
    einsum; abstract: the products' halving tree over N through a scratch
    tensor; abstract+shuffle: N in lanes (min(N, 32) of them), each lane
    folding its rows in order, then the lane tree."""
    if check_mode(mode) == "native":
        return torch.einsum("bgn,bghnp->bghp", C, state)
    b, g, hg, n, p = state.shape
    _check_state_width(n, mode)
    u = C[:, :, None, :, None] * state                # [B,G,Hg,N,P]
    if mode == "abstract":
        rows = u.movedim(3, 0).reshape(n, -1)
        return scratch_tree_reduce(rows, torch.empty_like(rows),
                                   axis=0).reshape(b, g, hg, p)
    return row_reduce_shuffle(u.transpose(-1, -2),
                              lanes=min(n, LANES))[..., 0]


# --------------------------------------------------------------------------
# Plain versions (the JAX package's references, op for op)
# --------------------------------------------------------------------------


def ssd_scan_plain(x, dt, A, B_mat, C_mat, initial_state=None, *,
                   chunk: Optional[int], mode: str = "native",
                   state_hook=None):
    """Chunked SSD in f32, chunk by chunk, the prefix sum through
    ``mode``'s stage (:func:`prefix_sum`).

    x [B,L,H,P]; dt [B,L,H] (positive); A [H] (negative); B_mat, C_mat
    [B,L,G,N]; initial_state [B,G,Hg,N,P] or None (zeros).  Returns y
    [B,L,H,P] in x's dtype and the final state f32 [B,G,Hg,N,P].  A tail
    shorter than the chunk is zero-padded; its zero dt kills it.
    ``state_hook``, if given, is applied to the carried state after each
    chunk's update (models/ssd.py places it on a mesh with it)."""
    b, l, h, p = x.shape
    g, n = B_mat.shape[2], B_mat.shape[3]
    hg = h // g
    q = resolve_chunk(l, chunk, mode=mode, p=p, n=n)
    pad = (-l) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_mat = F.pad(B_mat, (0, 0, 0, 0, 0, pad))
        C_mat = F.pad(C_mat, (0, 0, 0, 0, 0, pad))
    lp = l + pad
    nc = lp // q
    xf = x.float().reshape(b, nc, q, g, hg, p)
    dtf = dt.float().reshape(b, nc, q, g, hg)
    Bf = B_mat.float().reshape(b, nc, q, g, n)
    Cf = C_mat.float().reshape(b, nc, q, g, n)
    dA = dtf * A.float().reshape(g, hg)              # [B,nc,Q,G,Hg] (<= 0)
    ldec = prefix_sum(dA, mode)                       # inclusive in a chunk
    if initial_state is None:
        state = torch.zeros(b, g, hg, n, p, dtype=torch.float32,
                            device=x.device)
    else:
        state = initial_state.float()
    causal = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    ys = []
    for c in range(nc):
        xq, dtq, ldq = xf[:, c], dtf[:, c], ldec[:, c]
        Bq, Cq = Bf[:, c], Cf[:, c]
        # intra-chunk (the quadratic, attention-like form)
        gts = torch.einsum("bqgn,bsgn->bgqs", Cq, Bq)  # [B,G,Qt,Qs]
        diff = ldq[:, :, None] - ldq[:, None]          # [B,Qt,Qs,G,Hg]
        decay = torch.exp(torch.where(causal[None, :, :, None, None], diff,
                                      float("-inf")))
        w = decay * gts.permute(0, 2, 3, 1)[..., None] * dtq[:, None]
        y = torch.einsum("bqsgh,bsghp->bqghp", w, xq)
        # the carried state's contribution
        y = y + torch.einsum("bqgn,bghnp->bqghp", Cq, state) \
            * torch.exp(ldq)[..., None]
        # the state update
        total = ldq[:, -1]                             # [B,G,Hg]
        wS = dtq * torch.exp(total[:, None] - ldq)     # [B,Q,G,Hg]
        s_c = torch.einsum("bsgn,bsgh,bsghp->bghnp", Bq, wS, xq)
        state = torch.exp(total)[..., None, None] * state + s_c
        if state_hook is not None:
            state = state_hook(state)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(b, lp, h, p)[:, :l]
    return y.to(x.dtype), state


def ssd_decode_plain(state, x_t, dt_t, A, B_t, C_t, *, out=None,
                     mode: str = "native"):
    """One-token recurrence in f32, the readout through ``mode``'s stage
    (:func:`readout`).

    state [B,G,Hg,N,P]; x_t [B,H,P]; dt_t [B,H]; A [H]; B_t, C_t [B,G,N].
    Returns (new state f32 [B,G,Hg,N,P], y [B,H,P] in x_t's dtype).  With
    ``out`` the new state is copied into it (it may be ``state``) and
    ``out`` is returned."""
    b, g, hg, n, p = state.shape
    xf = x_t.float().reshape(b, g, hg, p)
    dtf = dt_t.float().reshape(b, g, hg)
    da = torch.exp(dtf * A.float().reshape(g, hg))   # [B,G,Hg]
    upd = torch.einsum("bgn,bgh,bghp->bghnp", B_t.float(), dtf, xf)
    new = da[..., None, None] * state.float() + upd
    y = readout(C_t.float(), new, mode)
    if out is not None:
        out.copy_(new)
        new = out
    return new, y.reshape(b, g * hg, p).to(x_t.dtype)


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------


def _row_strides(t: torch.Tensor):
    """(tensor, batch stride, position stride) of a [B, L, a, b] or [B, a, b]
    operand: the kernels index the trailing two dims as one contiguous row
    (slices of the model's projection qualify), and a copy makes them so
    otherwise."""
    if t.stride(-1) != 1 or t.stride(-2) != t.shape[-1]:
        t = t.contiguous()
    return t, t.stride(0), (t.stride(1) if t.dim() == 4 else 0)


def _check_ssd_widths(n: int, p: int, h: int, g: int) -> None:
    if n > MAX_STATE or p > MAX_HEAD:
        raise ValueError(f"ssd kernels take N <= {MAX_STATE} and P <= "
                         f"{MAX_HEAD}, got N={n}, P={p}")
    if g < 1 or h % g:
        raise ValueError(f"{h} heads over {g} groups")


def scan_route(x, B_mat, C_mat) -> str:
    """The route :func:`ssd_scan`'s C entry takes for these operands, as
    the wrapper hands them over (``csrc/ssd_scan_tc.cu::scan_tc_route``):
    ``"tc"`` for bf16 with N and P multiples of 16 and every base and row
    stride 16-byte aligned, else ``"fma"``.  A mirror for the tests: the C
    entry decides, and the wrapper does not ask."""
    n, p = B_mat.shape[-1], x.shape[-1]
    if x.dtype != torch.bfloat16 or n % 16 or p % 16:
        return "fma"
    for t in (x, B_mat, C_mat):
        t, sb, sl = _row_strides(t)
        if t.data_ptr() % 16 or sb % 8 or sl % 8:
            return "fma"
    return "tc"


def ssd_scan(x, dt, A, B_mat, C_mat, initial_state=None, *,
             chunk: Optional[int], mode: str = "native"):
    """The chunked SSD scan in one kernel, its prefix sum in ``mode`` (same
    contract as :func:`ssd_scan_plain`), on the route the C entry picks
    (:func:`scan_route`).  CPU tensors run the plain version of ``mode``."""
    if not x.is_cuda:
        return ssd_scan_plain(x, dt, A, B_mat, C_mat, initial_state,
                              chunk=chunk, mode=mode)
    b, l, h, p = x.shape
    if B_mat.dim() != 4 or B_mat.shape != C_mat.shape \
            or B_mat.shape[:2] != (b, l) or tuple(dt.shape) != (b, l, h) \
            or tuple(A.shape) != (h,):
        raise ValueError(f"ssd_scan shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B_mat.shape)}, C {tuple(C_mat.shape)}")
    g, n = B_mat.shape[2], B_mat.shape[3]
    _check_ssd_widths(n, p, h, g)
    q = resolve_chunk(l, chunk, mode=mode, p=p, n=n)
    if q > MAX_CHUNK:
        raise ValueError(f"ssd_scan takes chunks of at most {MAX_CHUNK} "
                         f"positions, got {q}")
    extra = [] if initial_state is None else [initial_state]
    dev = check_device("ssd_scan", x, dt, A, B_mat, C_mat, *extra)
    code = dtype_code(x, B_mat, C_mat)
    x, sxb, sxl = _row_strides(x)
    B_mat, sbb, sbl = _row_strides(B_mat)
    C_mat, scb, scl = _row_strides(C_mat)
    dt = dt.float().contiguous()
    A = A.float().contiguous()
    hg = h // g
    if initial_state is not None:
        if tuple(initial_state.shape) != (b, g, hg, n, p):
            raise ValueError(f"initial_state {tuple(initial_state.shape)} is "
                             f"not {(b, g, hg, n, p)}")
        initial_state = initial_state.float().contiguous()
    y = torch.empty(b, l, h, p, dtype=x.dtype, device=dev)
    hf = torch.empty(b, g, hg, n, p, dtype=torch.float32, device=dev)
    launch("ssd_scan", MODE_CODES[check_mode(mode)], code, x.data_ptr(),
           dt.data_ptr(), A.data_ptr(), B_mat.data_ptr(), C_mat.data_ptr(),
           None if initial_state is None else initial_state.data_ptr(),
           y.data_ptr(), hf.data_ptr(), b, l, h, g, n, p, q, sxb, sxl, sbb,
           sbl, scb, scl, stream(dev), count_as=count_name("ssd_scan", mode))
    return y, hf


def ssd_decode(state, x_t, dt_t, A, B_t, C_t, *, out=None,
               mode: str = "native"):
    """The batched one-token recurrence in one kernel, its readout in
    ``mode`` (same contract as :func:`ssd_decode_plain`).  With ``out``
    (f32, contiguous, the state's shape; it may be ``state`` itself) the
    kernel writes the new state there in place.  CPU tensors run the plain
    version of ``mode``."""
    if not state.is_cuda:
        return ssd_decode_plain(state, x_t, dt_t, A, B_t, C_t, out=out,
                                mode=mode)
    b, g, hg, n, p = state.shape
    h = g * hg
    if tuple(x_t.shape) != (b, h, p) or tuple(dt_t.shape) != (b, h) \
            or tuple(A.shape) != (h,) or tuple(B_t.shape) != (b, g, n) \
            or B_t.shape != C_t.shape:
        raise ValueError(f"ssd_decode shapes state {tuple(state.shape)}, x "
                         f"{tuple(x_t.shape)}, dt {tuple(dt_t.shape)}, A "
                         f"{tuple(A.shape)}, B {tuple(B_t.shape)}, C "
                         f"{tuple(C_t.shape)}")
    _check_ssd_widths(n, p, h, g)
    _check_state_width(n, mode)
    if p % 4:
        raise ValueError(f"ssd_decode takes P a multiple of 4, got {p}")
    dev = check_device("ssd_decode", state, x_t, dt_t, A, B_t, C_t,
                       *([] if out is None else [out]))
    code = dtype_code(x_t, B_t, C_t)
    if state.dtype != torch.float32 or not state.is_contiguous():
        state = state.float().contiguous()
    if out is None:
        out = torch.empty_like(state)
    elif out.dtype != torch.float32 or not out.is_contiguous() \
            or out.shape != state.shape:
        raise ValueError("out must be a contiguous f32 tensor of the "
                         "state's shape")
    for t in (state, out):
        if t.data_ptr() % 16:
            raise ValueError("the state must be 16-byte aligned")
    x_t, sxb, _ = _row_strides(x_t)
    B_t, sbb, _ = _row_strides(B_t)
    C_t, scb, _ = _row_strides(C_t)
    dt_t = dt_t.float().contiguous()
    A = A.float().contiguous()
    y = torch.empty(b, h, p, dtype=x_t.dtype, device=dev)
    launch("ssd_decode", MODE_CODES[mode], code, state.data_ptr(),
           out.data_ptr(), x_t.data_ptr(), dt_t.data_ptr(), A.data_ptr(),
           B_t.data_ptr(), C_t.data_ptr(), y.data_ptr(), b, h, g, n, p, sxb,
           sbb, scb, stream(dev), count_as=count_name("ssd_decode", mode))
    return out, y


def decode_resident_blocks(mode: str, dtype: torch.dtype, n: int,
                           p: int) -> int:
    """The blocks of :func:`ssd_decode`'s ``mode`` kernel (x, B and C in
    ``dtype``) at state width ``n`` x ``p`` resident on one SM of the
    current card (one block a slot and head)."""
    _check_state_width(n, mode)
    code = dtype_code(torch.empty(0, dtype=dtype))
    blocks = entry("ssd_decode_resident")(MODE_CODES[mode], code, n, p)
    if blocks < 0:
        raise ValueError(f"ssd_decode [{mode}] takes no state of {n} x {p}")
    return blocks


# --------------------------------------------------------------------------
# The structural cost models (the JAX package's)
# --------------------------------------------------------------------------


def _scan_stages(q: int) -> int:
    """Hillis-Steele doubling stages of a ``q``-wide inclusive scan."""
    return int(math.ceil(math.log2(q))) if q > 1 else 0


def _scan_scratch_bytes(q: int, itemsize: int = 4) -> int:
    """Scratch traffic of one abstract prefix scan: stage ``k`` stores the
    full ``q`` row and reloads ``q - 2^k`` shifted lanes."""
    return sum((q + (q - (1 << k))) * itemsize
               for k in range(_scan_stages(q)))


def structural_cost_ssd_scan(b: int, seq: int, h: int, p: int, g: int,
                             n: int, mode: str,
                             chunk: Optional[int] = None,
                             dtype=torch.float32,
                             plan_dialect: Optional[str] = None,
                             target: Dialect = TARGET) -> dict:
    """Fused stream traffic against the unfused chunk program's six-dot
    sum (the JAX package's model): the fused scan keeps every per-chunk
    intermediate (scores, decay weights and rows, the carried state) out
    of HBM; the scratch columns count the decay prefix scan alone.  The
    model reads no parameter of ``target`` (accepted for a uniform
    signature)."""
    del target
    q = resolve_chunk(seq, chunk, mode=mode, p=p, n=n,
                      plan_dialect=plan_dialect)
    nc = -(-seq // q)
    lp = nc * q
    hg = max(1, h // g)
    itemsize = dtype_bytes(dtype)
    f32 = 4
    # fused operand/result stream (read x/dt/B/C/A/h0 once, write y + hf)
    io = (b * lp * h * p * itemsize                   # x read
          + b * lp * h * itemsize                     # dt read
          + 2 * b * lp * g * n * itemsize             # B + C reads
          + h * f32                                   # A
          + b * h * n * p * f32                       # h0 read
          + b * lp * h * p * itemsize                 # y write
          + b * h * n * p * f32)                      # final state write
    # per-chunk intermediates the unfused six-dot program materializes
    inter = (b * nc * g * q * q * f32                 # scores
             + b * nc * q * q * g * hg * f32          # decay weights w
             + 2 * b * nc * q * g * hg * f32          # ldec + wS rows
             + b * nc * q * g * hg * p * f32          # C.h contribution
             + b * nc * g * hg * n * p * f32          # s_c per chunk
             + b * nc * g * hg * n * p * f32)         # carried state trip
    pair = io + 2 * inter                             # write + read back
    saved = 0 if mode == "library" else 2 * inter
    flops = b * h * nc * (2 * q * q * n               # C.B^T
                          + 2 * q * q * p             # w.x
                          + 2 * q * n * p             # C.h
                          + 2 * q * n * p)            # B^T.(wS.x)
    stages = _scan_stages(q)
    if mode == "abstract":
        round_trips = stages
        scratch_bytes = b * h * nc * _scan_scratch_bytes(q)
        shuffles = 0
    elif mode == "abstract+shuffle":
        round_trips = 0
        scratch_bytes = 0
        shuffles = stages
    else:                                             # native / library
        round_trips = 0
        scratch_bytes = 0
        shuffles = 0
    return {
        "hbm_bytes": pair - saved,
        "hbm_bytes_unfused_pair": pair,
        "hbm_bytes_saved": saved,
        "flops": flops,
        "chunk": q,
        "n_chunks": nc,
        "blocks_visited": b * h * nc,
        "state_bytes_resident": n * p * f32,
        "scratch_round_trips_per_block": round_trips,
        "scratch_bytes_total": scratch_bytes,
        "lane_shuffles_per_block": shuffles,
        "fused_epilogue": mode != "library",
    }


def structural_cost_ssd_decode(b: int, h: int, p: int, g: int, n: int,
                               mode: str,
                               block_b: Optional[int] = None,
                               dtype=torch.float32,
                               plan_dialect: Optional[str] = None,
                               target: Dialect = TARGET) -> dict:
    """Fused decode-tick traffic against the unfused einsum trio's round
    trip of the state-sized update tensor (the JAX package's model); the
    scratch columns count the cross-lane ``C.h`` readout, a log2(N) tree a
    slot.  The model reads no parameter of ``target``."""
    del target
    bb = resolve_decode_block(mode, b, p, n, block_b, plan_dialect)
    itemsize = dtype_bytes(dtype)
    f32 = 4
    io = (b * h * p * itemsize                        # x_t read
          + b * h * itemsize                          # dt read
          + h * f32                                   # A
          + 2 * b * g * n * itemsize                  # B_t + C_t reads
          + b * h * n * p * f32                       # state read (cache)
          + b * h * n * p * f32                       # state write (cache)
          + b * h * p * itemsize)                     # y write
    inter = (b * h * n * p * f32                      # dt.B(x)x update
             + b * h * f32)                           # exp(dt.A) decay row
    pair = io + 2 * inter                             # write + read back
    saved = 0 if mode == "library" else 2 * inter
    flops = b * h * (2 * n * p                        # decay scale + add
                     + 2 * n * p                      # rank-1 update
                     + 2 * n * p)                     # C.h contraction
    stages = _scan_stages(n)
    blocks = -(-b // bb) * h
    if mode == "abstract":
        round_trips = bb * stages
        # per tree: stage k reads two (n >> k, P) slices and writes one
        per_tree = p * sum(3 * (n >> k) * f32
                           for k in range(1, stages + 1))
        scratch_bytes = blocks * bb * per_tree
        shuffles = 0
    elif mode == "abstract+shuffle":
        round_trips = 0
        scratch_bytes = 0
        shuffles = bb * stages
    else:                                             # native / library
        round_trips = 0
        scratch_bytes = 0
        shuffles = 0
    return {
        "hbm_bytes": pair - saved,
        "hbm_bytes_unfused_pair": pair,
        "hbm_bytes_saved": saved,
        "flops": flops,
        "block_b": bb,
        "blocks_visited": blocks,
        "state_bytes_resident": bb * n * p * f32,
        "scratch_round_trips_per_block": round_trips,
        "scratch_bytes_total": scratch_bytes,
        "lane_shuffles_per_block": shuffles,
        "fused_epilogue": mode != "library",
    }


register_op_space("ssd_scan", "ssd")
register_op_space("ssd_decode", "ssd_decode")
COSTS = {"ssd_scan": structural_cost_ssd_scan,
         "ssd_decode": structural_cost_ssd_decode}


# --------------------------------------------------------------------------
# Registration: each mode = its kernel, library = the plain version; a native
# request under a foreign dialect takes the declared fallback (warned) on
# CPU operands and raises on CUDA ones, and so does an abstract+shuffle
# request under a dialect without lane shuffles (-> abstract), as in the
# JAX package.
# --------------------------------------------------------------------------

for _op, _kernel, _plain, _native_reason, _shuffle_reason in (
        ("ssd_scan", ssd_scan, ssd_scan_plain,
         "the fused native chunk scan is pinned to its target; the plain "
         "chunk path is the declared escape",
         "no lane shuffle: the decay prefix scan stages through the "
         "scratch scan instead"),
        ("ssd_decode", ssd_decode, ssd_decode_plain,
         "the batched native decode recurrence is pinned to its target; "
         "the plain einsum trio is the declared escape",
         "no lane shuffle: the C.h readout reduces through the scratch "
         "tree instead")):
    for _mode in ("abstract", "abstract+shuffle"):
        REGISTRY.register(_op, _mode, functools.partial(_kernel, mode=_mode),
                          contract=MODE_CONTRACTS[(_op, _mode)],
                          cost=functools.partial(COSTS[_op], mode=_mode))
    REGISTRY.register(_op, IsaMode.NATIVE, _kernel, contract=CONTRACTS[_op],
                      cost=functools.partial(COSTS[_op], mode="native"))
    REGISTRY.register(_op, IsaMode.LIBRARY, _plain,
                      cost=functools.partial(COSTS[_op], mode="library"))
    REGISTRY.declare_fallback(_op, IsaMode.ABSTRACT_SHUFFLE, IsaMode.ABSTRACT,
                              reason=_shuffle_reason)
    REGISTRY.declare_fallback(_op, IsaMode.NATIVE, IsaMode.LIBRARY,
                              reason=_native_reason)
