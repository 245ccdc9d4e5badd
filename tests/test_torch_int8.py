"""The int8 forms of the port's kernels (their plain versions, which the
wrappers run on CPU tensors), the int8 scheme, the quantized cache writes,
the precision axis of the registry and the scale-dtype rule of
``params_from_numpy``, against the JAX package in f32.

Both sides read the same int8 bytes and f32 scales, so the comparison is
at ``TOLERANCES[None]``.  The JAX side runs each Pallas kernel as its own
tests do: ``mode="native"`` in interpret mode, and ``mode="library"``."""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from conftest import tolerance_for
from repro.kernels import fused as ref_fused
from repro.models import attention as ref_attention
from repro.models import build_model as ref_build
from repro.models import common as ref_common
from repro.models.config import ModelConfig as RefModelConfig
from repro.models.config import MoEConfig as RefMoEConfig
from repro.models.config import ParallelConfig as RefPar

from repro_torch.core import (REGISTRY, ExecutionPolicy, LoweringRegistry,
                              UnsupportedLowering)
from repro_torch.core.registry import LoweringFallbackWarning
from repro_torch.kernels import fused, ops
from repro_torch.models import attention, common
from repro_torch.models.convert import params_from_numpy

TOL = tolerance_for(None)
INT8 = ExecutionPolicy(mode="native", precision="int8")


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _check(got, want, mask=None):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    if mask is not None:
        got, want = got[mask], want[mask]
    np.testing.assert_allclose(got, want, **TOL)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _qw(rng, *shape, scale=0.1):
    """An f32 weight and its int8 form through the JAX package's scheme."""
    w = _np(rng, *shape, scale=scale)
    q, s = ref_fused.quantize_weight(jnp.asarray(w))
    return w, np.array(q), np.array(s)


# ---------------------------------------------------------------------------
# the int8 scheme
# ---------------------------------------------------------------------------


def _ties():
    """A weight whose value / scale lands on .5: the column max is 127
    (scale 1.0), the other rows run -3.5, -2.5, ..., 2.5."""
    w = np.zeros((8, 6), np.float32)
    w[0] = 127.0
    w[1:] = np.arange(-3.5, 3.5, dtype=np.float32)[:, None]
    return w


@pytest.mark.parametrize("case", ["f32", "bf16", "stacked", "ties"])
def test_quantize_weight_is_bit_equal_to_jax(case):
    rng = np.random.default_rng(1)
    if case == "ties":
        w = _ties()
    elif case == "stacked":
        w = _np(rng, 3, 64, 40, scale=0.3)
    else:
        w = _np(rng, 96, 72, scale=0.3)
    if case == "bf16":
        w = w.astype(ml_dtypes.bfloat16)
        tw = torch.from_numpy(w.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        tw = torch.from_numpy(w)
    want_q, want_s = ref_fused.quantize_weight(jnp.asarray(w))
    q, s = fused.quantize_weight(tw)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(
        fused.dequantize_weight(q, s).numpy(),
        np.asarray(ref_fused.dequantize_weight(want_q, want_s)))
    if case == "ties":                 # round half to even in both
        assert sorted(set(q.numpy()[1:, 0].tolist())) == [-4, -2, 0, 2]


def test_quantize_kv_is_bit_equal_to_jax():
    rng = np.random.default_rng(2)
    x = _np(rng, 2, 3, 7, 16)
    x[0, 0, 2] = 0.0                                  # scale floor 1e-8
    x[1, 1, 3] = np.arange(-7.5, 8.5, dtype=np.float32) * (127 / 8.5)
    want_q, want_s = ref_attention.quantize_kv(jnp.asarray(x))
    q, s = attention.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(
        attention.dequantize_kv(q, s, torch.float32).numpy(),
        np.asarray(ref_attention.dequantize_kv(want_q, want_s, jnp.float32)))


def _ref_tree(cfg, fused_layout=True):
    par = RefPar(remat="none", fuse_epilogues=fused_layout)
    return ref_build(cfg, par).init_params(jax.random.PRNGKey(0))


@pytest.mark.parametrize("family", ["dense", "moe_shared"])
def test_quantize_params_is_bit_equal_to_jax(family):
    """The port's quantize_params on the same f32 tree gives the JAX
    package's int8 bytes and scales leaf for leaf (the MoE shared expert's
    wig too); unquantized leaves are untouched."""
    moe = (RefMoEConfig(num_experts=4, top_k=2, shared_experts=1)
           if family == "moe_shared" else None)
    cfg = RefModelConfig(name="q", family="moe" if moe else "dense",
                         num_layers=2, d_model=32, num_heads=4,
                         num_kv_heads=2, d_ff=48, vocab_size=64, moe=moe,
                         dtype="float32")
    ref_params = _ref_tree(cfg)
    want = jax.tree.map(np.asarray, ref_common.quantize_params(ref_params))
    got = common.quantize_params(params_from_numpy(
        jax.tree.map(np.asarray, ref_params), "cpu"))
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_got = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), got))[0])
    assert flat_got.keys() == flat_want.keys()
    for path, leaf in flat_want.items():
        assert flat_got[path].dtype == leaf.dtype, path
        np.testing.assert_array_equal(flat_got[path], leaf, err_msg=str(path))
    scales = [jax.tree_util.keystr(p) for p in flat_want
              if jax.tree_util.keystr(p).endswith("_scale']")]
    assert len(scales) == 3
    if moe:
        assert want["blocks"]["moe"]["shared"]["wig"].dtype == np.int8


def test_params_from_numpy_keeps_scales_f32():
    """A dtype given to params_from_numpy casts the float leaves, but the
    scales of a quantized tree (``*_scale``, ``*_scale_pages``) stay f32:
    in bf16 they would lose 16 bits of every channel's scale."""
    rng = np.random.default_rng(3)
    tree = {"blocks": {"attn": {"wo": np.zeros((4, 4), np.int8),
                                "wo_scale": _np(rng, 4) + 1.0},
                       "ln1": {"scale": np.ones(4, np.float32)}},
            "k_scale_pages": _np(rng, 2, 1, 4, 1),
            "embed": _np(rng, 8, 4)}
    got = params_from_numpy(tree, "cpu", torch.bfloat16)
    assert got["blocks"]["attn"]["wo"].dtype == torch.int8
    assert got["blocks"]["attn"]["wo_scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["blocks"]["attn"]["wo_scale"].numpy(),
                                  tree["blocks"]["attn"]["wo_scale"])
    assert got["k_scale_pages"].dtype == torch.float32
    assert got["blocks"]["ln1"]["scale"].dtype == torch.bfloat16
    assert got["embed"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the q8 kernels' plain versions against the JAX kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows", [1, 5, 13])
def test_rmsnorm_matmul_q8(rows):
    rng = np.random.default_rng(rows)
    x, w = _np(rng, rows, 64), _np(rng, 64)
    W, Wq, s = _qw(rng, 64, 200)
    got = fused.rmsnorm_matmul_q8(*_t(x, w, Wq), w_scale=torch.from_numpy(s))
    plain = fused.rmsnorm_matmul_q8_plain(*_t(x, w, Wq, s))
    on_the_fly = fused.rmsnorm_matmul_q8(*_t(x, w, W))
    for mode in ("native", "library"):
        want = ref_fused.rmsnorm_matmul_q8(x, w, Wq, w_scale=s, mode=mode,
                                           interpret=True)
        _check(got, want)
        _check(plain, want)
        _check(on_the_fly, want)
        _check(fused.rmsnorm_matmul_q8_library(
            *_t(x, w, Wq), w_scale=torch.from_numpy(s)), want)


@pytest.mark.parametrize("rows", [1, 7])
def test_rmsnorm_swiglu_q8(rows):
    rng = np.random.default_rng(10 + rows)
    x, w = _np(rng, 2, rows, 64), _np(rng, 64)
    _, wq, s = _qw(rng, 64, 2 * 72)
    got = fused.rmsnorm_swiglu_q8(*_t(x, w, wq), w_scale=torch.from_numpy(s))
    for mode in ("native", "library"):
        want = ref_fused.rmsnorm_swiglu_q8(x, w, wq, w_scale=s, mode=mode,
                                           interpret=True)
        _check(got, want)
        _check(fused.rmsnorm_swiglu_q8_library(
            *_t(x, w, wq), w_scale=torch.from_numpy(s)), want)


@pytest.mark.parametrize("b,h,hkv,sq,skv,kv_offset", [
    (2, 4, 2, 8, 8, None),       # GQA, square causal
    (1, 4, 1, 5, 12, None),      # queries aligned to the end of the keys
    (1, 2, 2, 5, 12, 4),         # explicit kv_offset
])
def test_flash_attention_matmul_q8_causal(b, h, hkv, sq, skv, kv_offset):
    rng = np.random.default_rng(sq * skv)
    d, n = 16, 200
    q, k, v = _np(rng, b, h, sq, d), _np(rng, b, hkv, skv, d), \
        _np(rng, b, hkv, skv, d)
    _, woq, s = _qw(rng, h * d, n, scale=0.2)
    got = fused.flash_attention_matmul_q8(*_t(q, k, v, woq),
                                          kv_offset=kv_offset,
                                          w_scale=torch.from_numpy(s))
    want = ref_fused.flash_attention_matmul_q8(
        q, k, v, woq, kv_offset=kv_offset, w_scale=s, mode="native",
        interpret=True)
    _check(got, want)
    if kv_offset is None:      # the library row always aligns to the end
        _check(got, ref_fused.flash_attention_matmul_q8(
            q, k, v, woq, w_scale=s, mode="library"))


def test_flash_attention_matmul_q8_pos():
    rng = np.random.default_rng(3)
    b, h, hkv, skv, d, n = 4, 4, 2, 20, 16, 136
    q, k, v = _np(rng, b, h, 1, d), _np(rng, b, hkv, skv, d), \
        _np(rng, b, hkv, skv, d)
    _, woq, s = _qw(rng, h * d, n, scale=0.2)
    pos = np.array([0, 9, 19, 5], np.int32)
    got = fused.flash_attention_matmul_q8(*_t(q, k, v, woq),
                                          pos=torch.from_numpy(pos),
                                          w_scale=torch.from_numpy(s))
    for mode in ("native", "library"):
        _check(got, ref_fused.flash_attention_matmul_q8(
            q, k, v, woq, pos=pos, w_scale=s, mode=mode, interpret=True))


def _paged_q8_case(rng, page_size=4):
    b, h, hkv, d, n, num_pages, maxp = 3, 4, 2, 16, 136, 6, 3
    q = _np(rng, b, h, 1, d)
    kq, ks = (np.asarray(a) for a in ref_attention.quantize_kv(
        jnp.asarray(_np(rng, num_pages, hkv, page_size, d))))
    vq, vs = (np.asarray(a) for a in ref_attention.quantize_kv(
        jnp.asarray(_np(rng, num_pages, hkv, page_size, d))))
    _, woq, s = _qw(rng, h * d, n, scale=0.2)
    tables = np.array([[4, 1, 0],       # live through its last page
                       [2, 5, num_pages],   # sentinel past the frontier
                       [3, 0, 5]], np.int32)   # dead entries past pos
    pos = np.array([11, 6, 2], np.int32)
    return q, kq, ks, vq, vs, woq, s, tables, pos


@pytest.mark.parametrize("kv", ["int8", "f32"])
def test_paged_attention_matmul_q8(kv):
    """int8 pools with their scale pools, and f32 pools beside an int8 wo;
    the f32 op under the int8 policy goes to the q8 row through ops."""
    q, kq, ks, vq, vs, woq, s, tables, pos = \
        _paged_q8_case(np.random.default_rng(5))
    if kv == "f32":
        kq, vq = kq * ks, vq * vs
        ks = vs = None
    scales = dict(k_scale=None if ks is None else torch.from_numpy(ks),
                  v_scale=None if vs is None else torch.from_numpy(vs),
                  w_scale=torch.from_numpy(s))
    tq = _t(q, kq, vq, woq)
    got = fused.flash_attention_matmul_q8(
        *tq, block_tables=torch.from_numpy(tables), pos=torch.from_numpy(pos),
        **scales)
    via_ops = ops.fused_flash_attention_matmul(
        *tq, block_tables=torch.from_numpy(tables), pos=torch.from_numpy(pos),
        policy=INT8, **scales)
    lib = fused.flash_attention_matmul_q8_library(
        *tq, block_tables=torch.from_numpy(tables), pos=torch.from_numpy(pos),
        **scales)
    for mode in ("native", "library"):
        want = ref_fused.flash_attention_matmul_q8(
            q, kq, vq, woq, block_tables=tables, pos=pos, w_scale=s,
            k_scale=ks, v_scale=vs, mode=mode, interpret=True)
        _check(got, want)
        _check(via_ops, want)
        _check(lib, want)


def test_q8_attention_refuses_dense_kv_scales():
    rng = np.random.default_rng(6)
    q, k = _t(_np(rng, 1, 2, 3, 8), _np(rng, 1, 2, 3, 8))
    w = torch.zeros(16, 8, dtype=torch.int8)
    with pytest.raises(ValueError, match="paged-shape"):
        fused.flash_attention_matmul_q8(q, k, k, w, w_scale=torch.ones(8),
                                        k_scale=torch.ones(1, 2, 3, 1),
                                        v_scale=torch.ones(1, 2, 3, 1))


# ---------------------------------------------------------------------------
# the quantized cache writes
# ---------------------------------------------------------------------------


def test_update_paged_cache_int8_drops_through_the_same_entry():
    """Values and scales go through one table entry: slot 0 writes page 3
    row 1, slot 1 is reaped (sentinel), slot 2 runs past its table's end,
    slot 3 writes page 1 row 0; dropped rows of both land on the trash
    page."""
    rng = np.random.default_rng(7)
    num_pages, hkv, ps, d = 5, 2, 4, 8
    pq = rng.integers(-127, 128, (num_pages, hkv, ps, d)).astype(np.int8)
    psc = np.full((num_pages, hkv, ps, 1), 1e-8, np.float32)
    new = _np(rng, 4, hkv, 1, d)
    tables = np.array([[0, 3], [num_pages, num_pages], [2, 4], [1, 2]],
                      np.int32)
    pos = np.array([5, 6, 9, 0], np.int32)
    want_q, want_s = ref_attention.update_paged_cache_int8(
        jnp.asarray(pq), jnp.asarray(psc), new, tables, pos)
    pool_q = torch.from_numpy(np.concatenate(
        [pq, np.zeros((1, hkv, ps, d), np.int8)]))
    pool_s = torch.from_numpy(np.concatenate(
        [psc, np.zeros((1, hkv, ps, 1), np.float32)]))
    attention.update_paged_cache_int8(pool_q, pool_s, *_t(new, tables, pos))
    np.testing.assert_array_equal(pool_q[:num_pages].numpy(),
                                  np.asarray(want_q))
    np.testing.assert_array_equal(pool_s[:num_pages].numpy(),
                                  np.asarray(want_s))
    assert not np.array_equal(np.asarray(want_q), pq)
    assert (pool_s[num_pages] > 1e-8).any()         # the dropped rows


@pytest.mark.parametrize("pos", [[0, 3], [7, 8], [-1, 2]])
def test_update_cache_int8(pos):
    rng = np.random.default_rng(8)
    b, hkv, s, d = 2, 2, 8, 8
    cq = rng.integers(-127, 128, (b, hkv, s, d)).astype(np.int8)
    cs = np.full((b, hkv, s, 1), 1e-8, np.float32)
    new = _np(rng, b, hkv, 1, d)
    pos = np.array(pos, np.int32)
    want_q, want_s = ref_attention.update_cache_int8(cq, cs, new, pos)
    got_q, got_s = attention.update_cache_int8(
        *_t(cq.copy(), cs.copy(), new, pos))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


# ---------------------------------------------------------------------------
# the precision axis of the registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["rmsnorm_matmul", "rmsnorm_swiglu",
                                "flash_attention_matmul"])
def test_int8_policy_selects_the_q8_rows(op):
    assert REGISTRY.precision_variant(op, "int8") == op + "_q8"
    assert REGISTRY.precision_variant(op, "f32") is None
    assert REGISTRY.precision_variant(op, None) is None
    native = REGISTRY.select(op, INT8, device="cpu")
    assert native.op == op + "_q8" and native.impl is getattr(fused,
                                                              op + "_q8")
    library = REGISTRY.select(
        op, ExecutionPolicy(mode="library", precision="int8"), device="cpu")
    assert library.op == op + "_q8"
    assert library.impl is getattr(fused, op + "_q8_library")
    # an op without a variant (a norm) runs its own rows
    assert REGISTRY.select("rmsnorm", INT8, device="cpu").op == "rmsnorm"


def test_q8_fallback_is_declared_and_refused_on_the_card():
    pol = ExecutionPolicy(mode="native", dialect="nvidia-ada-sm89",
                          precision="int8")
    with pytest.raises(UnsupportedLowering, match="on the card"):
        REGISTRY.select("rmsnorm_matmul", pol,
                        device=torch.device("cuda", 0))
    with pytest.warns(LoweringFallbackWarning):
        low = REGISTRY.select("rmsnorm_matmul", pol, device="cpu")
    assert low.impl is fused.rmsnorm_matmul_q8_library


def test_precision_without_a_declared_variant_raises():
    """A precision no op declares keeps the base row, as in the JAX
    package; declaring a variant still checks its names."""
    reg = LoweringRegistry()
    low = reg.register("rmsnorm_matmul", "library",
                       fused.rmsnorm_matmul_plain)
    assert reg.select("rmsnorm_matmul", ExecutionPolicy(
        mode="library", precision="int8")) is low
    with pytest.raises(ValueError, match="quantized precision"):
        reg.register_precision_variant("rmsnorm_matmul", "f32",
                                       "rmsnorm_matmul")
    with pytest.raises(UnsupportedLowering, match="unknown op"):
        reg.register_precision_variant("rmsnorm_matmul", "int8",
                                       "rmsnorm_matmul_q8")


def test_ops_keep_operands_coherent_under_either_precision():
    """An int8 weight with its scale, selected by an f32 policy, is
    dequantized to x's dtype first (the JAX shim's rule); a float weight
    under the int8 policy is quantized by the q8 row."""
    rng = np.random.default_rng(9)
    x, w = _np(rng, 3, 64), _np(rng, 64)
    W, Wq, s = _qw(rng, 64, 96)
    with warnings.catch_warnings():
        warnings.simplefilter("error", LoweringFallbackWarning)
        f32 = ops.fused_rmsnorm_matmul(*_t(x, w, Wq), mode="native",
                                       w_scale=torch.from_numpy(s))
        q8 = ops.fused_rmsnorm_matmul(*_t(x, w, W), policy=INT8)
    _check(f32, ref_fused.rmsnorm_matmul(
        x, w, ref_fused.dequantize_weight(Wq, s), mode="native",
        interpret=True))
    _check(q8, ref_fused.rmsnorm_matmul_q8(x, w, Wq, w_scale=s,
                                           mode="native", interpret=True))


def test_q8_contracts_match_the_f32_ops():
    for op in fused.QUANT_OPS:
        c, base = fused.CONTRACTS[op], fused.CONTRACTS[op[:-3]]
        assert c.kernel == op
        assert dataclasses.replace(c, kernel=base.kernel) == base
        assert REGISTRY.modes(op) == ("abstract", "abstract+shuffle",
                                      "native", "library")
        for mode in ("abstract", "abstract+shuffle"):
            assert fused.MODE_CONTRACTS[(op, mode)] == dataclasses.replace(
                fused.MODE_CONTRACTS[(op[:-3], mode)], kernel=op)
