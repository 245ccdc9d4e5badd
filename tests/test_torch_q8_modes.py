"""The abstract and abstract+shuffle lowerings of the port's three int8
twins (rmsnorm_matmul_q8, rmsnorm_swiglu_q8, flash_attention_matmul_q8 in
its causal, ``pos`` and paged shapes), against the JAX package's q8
lowerings of the same mode in interpret mode, on the same int8 operands
(weights with f32 per-channel scales, page pools with f32 per-token
scales) made from a numpy seed; their registry rows, contracts, declared
fallback and the int8 precision's retarget in each mode; and the repair of
``quantize_weight`` for a transposed (tied) table.

Tolerance: f32 at ``TOLERANCES["f32"]`` (both sides dequantize the same
int8 bytes in f32; the port's plain version of a mode folds rows to 32
lanes where the JAX kernel folds to 128, so the sums run in other
orders).  bf16: rtol = 2^-6 and atol = 2^-6 x max|reference row|, each
output row on its own scale: the port rounds the normalized row (and the
attention output before wo) to bf16 as its kernels do, where the JAX
kernel keeps them in f32, and both round the output."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from conftest import tolerance_for
from repro.core.registry import REGISTRY as REF_REGISTRY
from repro.core.registry import ExecutionPolicy as RefPolicy
from repro.kernels import fused as ref_fused

from repro_torch.core import REGISTRY, ExecutionPolicy, IsaMode
from repro_torch.core.registry import LoweringFallbackWarning, \
    UnsupportedLowering
from repro_torch.kernels import fused, ops
from repro_torch.kernels.fused import LAUNCHES

TOL = tolerance_for("f32")
BF16_TOL = 2.0 ** -6
MODES = ("abstract", "abstract+shuffle")
DTYPES = ("f32", "bf16")


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _q8(rng, *shape, scale=1.0):
    """(int8 weight, f32 [N] scales) through the JAX package's scheme."""
    q, s = ref_fused.quantize_weight(jnp.asarray(_np(rng, *shape,
                                                     scale=scale)))
    return np.array(q), np.array(s)


def _kv8(rng, *shape):
    """int8 page pool values and f32 per-token scales [..., 1]."""
    q = rng.integers(-127, 128, shape).astype(np.int8)
    s = (0.02 + 0.02 * rng.random(shape[:-1] + (1,))).astype(np.float32)
    return q, s


def _jax(a, dt):
    if dt == "bf16" and a.dtype == np.float32:
        return jnp.asarray(a.astype(ml_dtypes.bfloat16))
    return jnp.asarray(a)


def _torch(a, dt):
    """``a`` as a tensor; f32 data (never the int8 operands) in bf16."""
    t = torch.from_numpy(a)
    return t.bfloat16() if dt == "bf16" and t.dtype == torch.float32 else t


def _close(got, want, dt):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    if dt == "f32":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        # each output row on its own scale, so that a row of small values
        # (a late causal query) cannot hide under a large row's tolerance
        row = np.abs(want).max(axis=-1, keepdims=True)
        row = np.where(row > 0, row, 1.0)
        np.testing.assert_allclose(got / row, want / row, rtol=BF16_TOL,
                                   atol=BF16_TOL)


# ---------------------------------------------------------------------------
# the norm-GEMM twins
# ---------------------------------------------------------------------------

# rows not a multiple of 4 (37, 1), a ragged D (100: the JAX side pads D to
# 128 under these modes), a prefill-sized row count
NORM_SHAPES = [(8, 256, 384), (37, 100, 200), (1, 64, 96), (130, 512, 128)]


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("rows,d,n", NORM_SHAPES)
def test_rmsnorm_matmul_q8_matches_jax_mode(rows, d, n, mode, dt):
    rng = np.random.default_rng(rows * d + n)
    x, w = _np(rng, rows, d), 1.0 + _np(rng, d, scale=0.1)
    wq, ws = _q8(rng, d, n, scale=d ** -0.5)
    want = ref_fused.rmsnorm_matmul_q8(
        _jax(x, dt), _jax(w, dt), jnp.asarray(wq), w_scale=jnp.asarray(ws),
        mode=mode, interpret=True)
    tx, tw, tq = (_torch(a, dt) for a in (x, w, wq))
    ts = torch.from_numpy(ws)
    for got in (fused.rmsnorm_matmul_q8(tx, tw, tq, w_scale=ts, mode=mode),
                fused.rmsnorm_matmul_q8_plain(tx, tw, tq, ts, mode=mode),
                ops.fused_rmsnorm_matmul(tx, tw, tq, w_scale=ts, policy=(
                    ExecutionPolicy(mode=mode, precision="int8")))):
        assert got.shape == (rows, n) and got.dtype == tx.dtype
        _close(got, want, dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("rows,d,f", [(8, 256, 192), (37, 100, 64)])
def test_rmsnorm_swiglu_q8_matches_jax_mode(rows, d, f, mode, dt):
    rng = np.random.default_rng(rows + d + f)
    x, w = _np(rng, 2, rows, d), 1.0 + _np(rng, d, scale=0.1)
    cq, cs = _q8(rng, d, 2 * f, scale=d ** -0.5)
    want = ref_fused.rmsnorm_swiglu_q8(
        _jax(x, dt), _jax(w, dt), jnp.asarray(cq), w_scale=jnp.asarray(cs),
        mode=mode, interpret=True)
    tx, tw, tq = (_torch(a, dt) for a in (x, w, cq))
    ts = torch.from_numpy(cs)
    for got in (fused.rmsnorm_swiglu_q8(tx, tw, tq, w_scale=ts, mode=mode),
                ops.fused_rmsnorm_swiglu(tx, tw, tq, w_scale=ts, policy=(
                    ExecutionPolicy(mode=mode, precision="int8")))):
        assert got.shape == (2, rows, f)
        _close(got, want, dt)


@pytest.mark.parametrize("mode", MODES)
def test_a_float_weight_is_quantized_by_the_twin_as_in_jax(mode):
    """A float weight reaching a q8 twin (the head under the int8 policy)
    is quantized there, on both sides: the same int8 bytes, so f32
    parity."""
    rng = np.random.default_rng(6)
    x, w = _np(rng, 8, 64), 1.0 + _np(rng, 64, scale=0.1)
    table = _np(rng, 101, 64, scale=0.05)
    want = ref_fused.rmsnorm_matmul_q8(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(table).T, mode=mode,
                                       interpret=True)
    got = fused.rmsnorm_matmul_q8(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(table).t(), mode=mode)
    _close(got, want, "f32")


# ---------------------------------------------------------------------------
# attention + int8 wo: causal, pos, paged over int8 pools
# ---------------------------------------------------------------------------

ATTN_CASES = [
    # b, h, hkv, sq, skv, d, n, kv_offset
    (1, 4, 2, 40, 40, 16, 64, None),         # partial tiles, square
    (2, 4, 1, 8, 200, 32, 48, 150),          # kv_offset, group 4
    (1, 6, 2, 70, 70, 64, 96, None),         # group 3 at D 64, two key tiles
]


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("b,h,hkv,sq,skv,d,n,kv_offset", ATTN_CASES)
def test_causal_attention_matmul_q8_matches_jax_mode(b, h, hkv, sq, skv, d,
                                                     n, kv_offset, mode, dt):
    rng = np.random.default_rng(sq + skv + d)
    q, k, v = (_np(rng, b, h, sq, d), _np(rng, b, hkv, skv, d),
               _np(rng, b, hkv, skv, d))
    wq, ws = _q8(rng, h * d, n, scale=(h * d) ** -0.5)
    want = ref_fused.flash_attention_matmul_q8(
        _jax(q, dt), _jax(k, dt), _jax(v, dt), jnp.asarray(wq),
        w_scale=jnp.asarray(ws), causal=True, kv_offset=kv_offset,
        mode=mode, interpret=True)
    tq, tk, tv, twq = (_torch(a, dt) for a in (q, k, v, wq))
    tws = torch.from_numpy(ws)
    for got in (fused.flash_attention_matmul_q8(
                    tq, tk, tv, twq, w_scale=tws, kv_offset=kv_offset,
                    mode=mode),
                ops.fused_flash_attention_matmul(
                    tq, tk, tv, twq, w_scale=tws, kv_offset=kv_offset,
                    policy=ExecutionPolicy(mode=mode, precision="int8"))):
        assert got.shape == (b, sq, n) and got.dtype == tq.dtype
        _close(got, want, dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("mode", MODES)
def test_pos_attention_matmul_q8_matches_jax_mode(mode, dt):
    rng = np.random.default_rng(9)
    b, h, hkv, skv, d, n = 3, 4, 2, 72, 16, 64
    q, k, v = (_np(rng, b, h, 1, d), _np(rng, b, hkv, skv, d),
               _np(rng, b, hkv, skv, d))
    wq, ws = _q8(rng, h * d, n, scale=(h * d) ** -0.5)
    pos = np.array([5, 71, 0], np.int32)
    want = ref_fused.flash_attention_matmul_q8(
        _jax(q, dt), _jax(k, dt), _jax(v, dt), jnp.asarray(wq),
        w_scale=jnp.asarray(ws), pos=jnp.asarray(pos), mode=mode,
        interpret=True)
    got = fused.flash_attention_matmul_q8(
        *(_torch(a, dt) for a in (q, k, v, wq)), w_scale=torch.from_numpy(ws),
        pos=torch.from_numpy(pos), mode=mode)
    _close(got, want, dt)


def _paged_case(rng, page_size=128, d=16, h=4, hkv=2):
    """int8 pools at ``page_size`` keys a page: slot 0 spans two pages,
    slot 1 one, then a sentinel entry (``num_pages``, clamped onto a real
    page whose rows lie past its frontier); slot 2 shares slot 0's first
    page."""
    b, n, num_pages, maxp = 3, 64, 5, 3
    q = _np(rng, b, h, 1, d)
    (kq, ks), (vq, vs) = (_kv8(rng, num_pages, hkv, page_size, d)
                          for _ in range(2))
    wq, ws = _q8(rng, h * d, n, scale=(h * d) ** -0.5)
    tables = np.array([[3, 1, num_pages], [4, num_pages, num_pages],
                       [3, 0, 2]], np.int32)
    pos = np.array([page_size + 9, 17, 2 * page_size + 100], np.int32)
    return (q, kq, vq, wq), (ks, vs, ws), tables, pos


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("d,h,hkv", [(16, 4, 2), (64, 6, 2)])
def test_paged_attention_matmul_q8_matches_jax_mode(mode, dt, d, h, hkv):
    (q, kq, vq, wq), (ks, vs, ws), tables, pos = _paged_case(
        np.random.default_rng(12 + d), d=d, h=h, hkv=hkv)
    want = ref_fused.flash_attention_matmul_q8(
        _jax(q, dt), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(wq),
        w_scale=jnp.asarray(ws), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs), pos=jnp.asarray(pos),
        block_tables=jnp.asarray(tables), mode=mode, interpret=True)
    tq, tkq, tvq, twq = (_torch(a, dt) for a in (q, kq, vq, wq))
    kwargs = dict(w_scale=torch.from_numpy(ws), k_scale=torch.from_numpy(ks),
                  v_scale=torch.from_numpy(vs),
                  block_tables=torch.from_numpy(tables),
                  pos=torch.from_numpy(pos))
    for got in (fused.flash_attention_matmul_q8(tq, tkq, tvq, twq, mode=mode,
                                                **kwargs),
                ops.fused_flash_attention_matmul(
                    tq, tkq, tvq, twq, policy=ExecutionPolicy(
                        mode=mode, precision="int8"), **kwargs)):
        assert got.shape == (3, 1, 64)
        _close(got, want, dt)


@pytest.mark.parametrize("mode", MODES)
def test_int8_page_size_not_a_multiple_of_128_raises_on_both_sides(mode):
    (q, kq, vq, wq), (ks, vs, ws), tables, pos = _paged_case(
        np.random.default_rng(2), 64)
    with pytest.raises(ValueError, match="multiple of 128"):
        ref_fused.flash_attention_matmul_q8(
            jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
            jnp.asarray(wq), w_scale=jnp.asarray(ws),
            k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
            pos=jnp.asarray(pos), block_tables=jnp.asarray(tables),
            mode=mode, interpret=True)
    args = [torch.from_numpy(a) for a in (q, kq, vq, wq)]
    kwargs = dict(w_scale=torch.from_numpy(ws), k_scale=torch.from_numpy(ks),
                  v_scale=torch.from_numpy(vs),
                  block_tables=torch.from_numpy(tables),
                  pos=torch.from_numpy(pos))
    with pytest.raises(ValueError, match="multiple of 128"):
        fused.flash_attention_matmul_q8(*args, mode=mode, **kwargs)
    # native takes any page size
    fused.flash_attention_matmul_q8(*args, **kwargs)


def test_cpu_operands_launch_nothing_and_library_is_no_kernel_mode():
    before = dict(LAUNCHES)
    x = torch.ones(2, 64)
    wq, ws = fused.quantize_weight(torch.ones(64, 32))
    fused.rmsnorm_matmul_q8(x, torch.ones(64), wq, w_scale=ws,
                            mode="abstract")
    assert LAUNCHES == before
    for kernel in (fused.rmsnorm_matmul_q8, fused.rmsnorm_swiglu_q8):
        with pytest.raises(ValueError, match="mode must be"):
            kernel(x, torch.ones(64), wq, w_scale=ws, mode="library")
    for mode in MODES:
        assert LAUNCHES[f"paged_attention_matmul_q8_{mode}"] == \
            before[f"paged_attention_matmul_q8_{mode}"]


# ---------------------------------------------------------------------------
# registry rows, contracts, fallback, the precision retarget
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", fused.QUANT_OPS)
def test_q8_mode_rows_and_contracts_match_jax(op):
    assert REGISTRY.modes(op) == ("abstract", "abstract+shuffle", "native",
                                  "library")
    for mode in MODES:
        low = REGISTRY.select(op, ExecutionPolicy(mode=mode))
        want = REF_REGISTRY.select(op, RefPolicy(mode=mode))
        assert low.op == want.op == op
        assert low.mode is IsaMode(mode) and low.target is None
        assert low.impl.keywords == {"mode": mode}
        assert {p.name for p in low.contract.primitives} == \
            {p.name for p in want.contract.primitives}
        assert low.contract.primitives == REGISTRY.select(
            op[:-3], ExecutionPolicy(mode=mode)).contract.primitives
        assert not low.contract.native_features


@pytest.mark.parametrize("mode", MODES + ("native", "library"))
@pytest.mark.parametrize("base", ["rmsnorm_matmul", "rmsnorm_swiglu",
                                  "flash_attention_matmul"])
def test_int8_precision_selects_the_twin_in_every_mode(base, mode):
    low = REGISTRY.select(base, ExecutionPolicy(mode=mode, precision="int8"))
    want = REF_REGISTRY.select(base, RefPolicy(mode=mode, precision="int8"))
    assert low.op == want.op == base + "_q8"
    assert low.mode is IsaMode(mode) and want.mode.value == mode
    if mode in MODES:
        assert low.impl.keywords == {"mode": mode}


@pytest.mark.parametrize("base", ["rmsnorm_matmul", "rmsnorm_swiglu",
                                  "flash_attention_matmul"])
def test_q8_shuffle_falls_back_to_abstract_without_shuffles(base):
    pol = ExecutionPolicy(mode="abstract+shuffle", dialect="uisa-universal10",
                          precision="int8")
    with pytest.warns(LoweringFallbackWarning):
        low = REGISTRY.select(base, pol, device="cpu")
    assert low.op == base + "_q8" and low.mode is IsaMode.ABSTRACT
    with pytest.warns(Warning):
        want = REF_REGISTRY.select(base, RefPolicy(
            mode="abstract+shuffle", dialect="uisa-universal10",
            precision="int8"))
    assert want.op == base + "_q8" and want.mode.value == "abstract"
    with pytest.raises(UnsupportedLowering, match="on the card"):
        REGISTRY.select(base, pol, device=torch.device("cuda", 0))


# ---------------------------------------------------------------------------
# the repair: quantize_weight of a transposed table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_weight_of_a_transposed_table_is_contiguous_and_jax_equal(
        dtype):
    """A tied table's ``embed.t()`` quantizes into a fresh contiguous int8
    [D, V], bit-equal (with equal scales) to the JAX package's
    quantize_weight of ``embed.T``; the float table is left as it was."""
    table = _np(np.random.default_rng(7), 50, 16, scale=0.3)
    if dtype == "bf16":
        table = table.astype(ml_dtypes.bfloat16).astype(np.float32)
    t = _torch(table, dtype)
    keep = t.clone()
    q, s = fused.quantize_weight(t.t())
    assert q.dtype == torch.int8 and q.shape == (16, 50)
    assert q.is_contiguous() and q.stride() == (50, 1)
    want_q, want_s = ref_fused.quantize_weight(_jax(table, dtype).T)
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))
    assert torch.equal(t, keep)
    # the stacked form and an already contiguous weight are unchanged
    stacked = torch.from_numpy(_np(np.random.default_rng(8), 3, 16, 24))
    sq, ss = fused.quantize_weight(stacked.transpose(1, 2))
    for i in range(3):
        qi, si = fused.quantize_weight(stacked[i].t().contiguous())
        assert torch.equal(sq[i], qi) and torch.equal(ss[i], si)
    assert sq.is_contiguous()
