"""The abstract and abstract+shuffle lowerings of the port's four model-path
kernels (rmsnorm_matmul, rmsnorm_swiglu, flash_attention_matmul in its
causal and ``pos`` shapes, paged_attention_matmul), against the JAX
package's Pallas lowerings of the same mode in interpret mode, and their
registry rows, contracts and declared fallback.

The same numpy inputs go to both sides, in f32, at ``TOLERANCES["f32"]``:
both compute in f32, the port's plain version of a mode folds each row to
32 lanes before its tree (the warp), the JAX kernel to 128 (the vreg), so
the sums run in other orders.  The shapes cover a ragged D (the JAX side
pads D to 128 under these modes), partial query and key tiles,
``kv_offset``, the ``pos`` shape and the paged shape at 128-key pages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tolerance_for
from repro.core.registry import REGISTRY as REF_REGISTRY
from repro.core.registry import ExecutionPolicy as RefPolicy
from repro.kernels import fused as ref_fused

from repro_torch.core import REGISTRY, ExecutionPolicy, IsaMode
from repro_torch.core import shuffle
from repro_torch.core.registry import LoweringFallbackWarning, \
    UnsupportedLowering
from repro_torch.kernels import fused, ops
from repro_torch.kernels.fused import LAUNCHES

TOL = tolerance_for("f32")
MODES = ("abstract", "abstract+shuffle")


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# the plain cross-lane stages of each mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("width", [32, 100, 4096])
def test_row_reduce_matches_the_library_reduction(mode, width):
    x = torch.from_numpy(_np(np.random.default_rng(width), 3, 5, width))
    np.testing.assert_allclose(
        fused.row_reduce(x, torch.add, mode, 0.0).numpy(),
        x.sum(-1, keepdim=True).numpy(), rtol=1e-5, atol=1e-4)
    assert torch.equal(fused.row_reduce(x, torch.maximum, mode, -np.inf),
                       x.amax(-1, keepdim=True))


def test_row_reduce_runs_each_modes_tree(monkeypatch):
    """abstract goes through the scratch tree and not the lane tree,
    abstract+shuffle the other way round."""
    calls = []
    for name in ("scratch_tree_reduce", "row_reduce_shuffle"):
        real = getattr(fused, name)
        monkeypatch.setattr(fused, name, lambda *a, _n=name, _r=real, **k:
                            calls.append(_n) or _r(*a, **k))
    x = torch.ones(2, 64)
    fused.row_reduce(x, torch.add, "abstract", 0.0)
    fused.row_reduce(x, torch.add, "abstract+shuffle", 0.0)
    assert calls == ["scratch_tree_reduce", "row_reduce_shuffle"]
    for mode in ("native", "library"):
        with pytest.raises(ValueError, match="no plain cross-lane tree"):
            fused.row_reduce(x, torch.add, mode, 0.0)
    assert shuffle.LANES == 32


# ---------------------------------------------------------------------------
# the norm-GEMMs
# ---------------------------------------------------------------------------

NORM_SHAPES = [(8, 256, 384), (37, 100, 200), (1, 64, 96), (130, 512, 128)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("rows,d,n", NORM_SHAPES)
def test_rmsnorm_matmul_matches_jax_mode(rows, d, n, mode):
    rng = np.random.default_rng(rows * d + n)
    (jx, jw, jp), (tx, tw, tp) = _both(
        _np(rng, rows, d), 1.0 + _np(rng, d, scale=0.1),
        _np(rng, d, n, scale=d ** -0.5))
    want = ref_fused.rmsnorm_matmul(jx, jw, jp, mode=mode, interpret=True)
    for got in (fused.rmsnorm_matmul(tx, tw, tp, mode=mode),
                fused.rmsnorm_matmul_plain(tx, tw, tp, mode=mode),
                ops.fused_rmsnorm_matmul(tx, tw, tp, mode=mode)):
        assert got.shape == (rows, n) and got.dtype == torch.float32
        _close(got, want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("rows,d,f", [(8, 256, 192), (37, 100, 64)])
def test_rmsnorm_swiglu_matches_jax_mode(rows, d, f, mode):
    rng = np.random.default_rng(rows + d + f)
    (jx, jw, jc), (tx, tw, tc) = _both(
        _np(rng, 2, rows, d), 1.0 + _np(rng, d, scale=0.1),
        _np(rng, d, 2 * f, scale=d ** -0.5))
    want = ref_fused.rmsnorm_swiglu(jx, jw, jc, mode=mode, interpret=True)
    for got in (fused.rmsnorm_swiglu(tx, tw, tc, mode=mode),
                ops.fused_rmsnorm_swiglu(tx, tw, tc, mode=mode)):
        assert got.shape == (2, rows, f)
        _close(got, want)


@pytest.mark.parametrize("mode", MODES)
def test_bf16_modes_round_the_normalized_row_as_native(mode):
    """In bf16 every mode's plain version rounds the normalized row to
    bf16 before the product, as the kernels do; the modes differ from
    native by the order of the moment's sum only."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(_np(rng, 8, 300)).bfloat16()
    w = torch.from_numpy(1.0 + _np(rng, 300, scale=0.1)).bfloat16()
    W = torch.from_numpy(_np(rng, 300, 64, scale=0.05)).bfloat16()
    got = fused.rmsnorm_matmul(x, w, W, mode=mode).float()
    want = fused.rmsnorm_matmul(x, w, W).float()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2 ** -6,
                               atol=2 ** -6)


# ---------------------------------------------------------------------------
# attention + wo: causal, pos, paged
# ---------------------------------------------------------------------------

ATTN_CASES = [
    # b, h, hkv, sq, skv, d, n, kv_offset
    (1, 4, 2, 40, 40, 16, 64, None),         # partial tiles, square
    (2, 4, 1, 8, 200, 32, 48, 150),          # kv_offset, group 4
    (1, 6, 2, 130, 130, 64, 96, None),       # several 64-key tiles
]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("b,h,hkv,sq,skv,d,n,kv_offset", ATTN_CASES)
def test_causal_attention_matmul_matches_jax_mode(b, h, hkv, sq, skv, d, n,
                                                  kv_offset, mode):
    rng = np.random.default_rng(sq + skv + d)
    (jq, jk, jv, jw), (tq, tk, tv, tw) = _both(
        _np(rng, b, h, sq, d), _np(rng, b, hkv, skv, d),
        _np(rng, b, hkv, skv, d), _np(rng, h * d, n, scale=(h * d) ** -0.5))
    want = ref_fused.flash_attention_matmul(
        jq, jk, jv, jw, causal=True, kv_offset=kv_offset, mode=mode,
        interpret=True)
    for got in (fused.flash_attention_matmul(tq, tk, tv, tw,
                                             kv_offset=kv_offset, mode=mode),
                ops.fused_flash_attention_matmul(tq, tk, tv, tw,
                                                 kv_offset=kv_offset,
                                                 mode=mode)):
        assert got.shape == (b, sq, n)
        _close(got, want)


@pytest.mark.parametrize("mode", MODES)
def test_pos_attention_matmul_matches_jax_mode(mode):
    rng = np.random.default_rng(9)
    b, h, hkv, skv, d, n = 3, 4, 2, 72, 16, 64
    (jq, jk, jv, jw), (tq, tk, tv, tw) = _both(
        _np(rng, b, h, 1, d), _np(rng, b, hkv, skv, d),
        _np(rng, b, hkv, skv, d), _np(rng, h * d, n, scale=(h * d) ** -0.5))
    pos = np.array([5, 71, 0], np.int32)
    want = ref_fused.flash_attention_matmul(
        jq, jk, jv, jw, pos=jnp.asarray(pos), mode=mode, interpret=True)
    got = fused.flash_attention_matmul(tq, tk, tv, tw,
                                       pos=torch.from_numpy(pos), mode=mode)
    _close(got, want)


def _paged_case(rng, page_size=128):
    b, h, hkv, d, n, num_pages, maxp = 3, 4, 2, 16, 64, 5, 3
    arrays = (_np(rng, b, h, 1, d), _np(rng, num_pages, hkv, page_size, d),
              _np(rng, num_pages, hkv, page_size, d),
              _np(rng, h * d, n, scale=(h * d) ** -0.5))
    # slot 0 spans two pages, slot 1 one (then sentinels), slot 2 shares
    # slot 0's first page
    tables = np.array([[3, 1, num_pages], [4, num_pages, num_pages],
                       [3, 0, 2]], np.int32)
    pos = np.array([page_size + 9, 17, 2 * page_size + 100], np.int32)
    return arrays, tables, pos


@pytest.mark.parametrize("mode", MODES)
def test_paged_attention_matmul_matches_jax_mode(mode):
    (q, kp, vp, wo), tables, pos = _paged_case(np.random.default_rng(12))
    (jq, jk, jv, jw), (tq, tk, tv, tw) = _both(q, kp, vp, wo)
    want = ref_fused.flash_attention_matmul(
        jq, jk, jv, jw, pos=jnp.asarray(pos), mode=mode,
        block_tables=jnp.asarray(tables), interpret=True)
    kwargs = dict(block_tables=torch.from_numpy(tables),
                  pos=torch.from_numpy(pos), mode=mode)
    for got in (fused.paged_attention_matmul(tq, tk, tv, tw, **kwargs),
                fused.flash_attention_matmul(tq, tk, tv, tw, **kwargs),
                ops.fused_flash_attention_matmul(tq, tk, tv, tw, **kwargs)):
        _close(got, want)


@pytest.mark.parametrize("mode", MODES)
def test_page_size_not_a_multiple_of_128_raises_on_both_sides(mode):
    (q, kp, vp, wo), tables, pos = _paged_case(np.random.default_rng(2), 64)
    (jq, jk, jv, jw), (tq, tk, tv, tw) = _both(q, kp, vp, wo)
    with pytest.raises(ValueError, match="multiple of 128"):
        ref_fused.flash_attention_matmul(
            jq, jk, jv, jw, pos=jnp.asarray(pos), mode=mode,
            block_tables=jnp.asarray(tables), interpret=True)
    with pytest.raises(ValueError, match="multiple of 128"):
        fused.paged_attention_matmul(
            tq, tk, tv, tw, block_tables=torch.from_numpy(tables),
            pos=torch.from_numpy(pos), mode=mode)
    # native takes any page size
    fused.paged_attention_matmul(tq, tk, tv, tw,
                                 block_tables=torch.from_numpy(tables),
                                 pos=torch.from_numpy(pos))


def test_cpu_operands_launch_nothing():
    before = dict(LAUNCHES)
    x = torch.ones(2, 64)
    fused.rmsnorm_matmul(x, torch.ones(64), torch.ones(64, 32),
                         mode="abstract")
    assert LAUNCHES == before


# ---------------------------------------------------------------------------
# registry rows, contracts, fallback, refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", fused.MODE_OPS)
def test_mode_rows_and_contracts_match_jax(op):
    assert REGISTRY.modes(op) == ("abstract", "abstract+shuffle", "native",
                                  "library")
    for mode in MODES:
        low = REGISTRY.select(op, ExecutionPolicy(mode=mode))
        want = REF_REGISTRY.select(op, RefPolicy(mode=mode))
        assert low.mode is IsaMode(mode) and low.target is None
        assert low.impl.keywords == {"mode": mode}
        assert {p.name for p in low.contract.primitives} == \
            {p.name for p in want.contract.primitives}
        assert not low.contract.native_features


@pytest.mark.parametrize("op", fused.MODE_OPS)
def test_shuffle_falls_back_to_abstract_without_shuffles(op):
    pol = ExecutionPolicy(mode="abstract+shuffle", dialect="uisa-universal10")
    with pytest.warns(LoweringFallbackWarning):
        low = REGISTRY.select(op, pol, device="cpu")
    assert low.mode is IsaMode.ABSTRACT
    with pytest.warns(Warning):
        want = REF_REGISTRY.select(op, RefPolicy(
            mode="abstract+shuffle", dialect="uisa-universal10"))
    assert want.mode.value == "abstract"
    with pytest.raises(UnsupportedLowering, match="on the card"):
        REGISTRY.select(op, pol, device=torch.device("cuda", 0))


def test_unsupported_forms_under_a_mode_are_refused_by_name():
    """Every weight form runs under every mode: the tied f32 table read
    transposed (the rest of B.3) and the int8 weight of the q8 twins (B.8):
    on CPU tensors as its mode's plain version, and past the wrapper's
    mode checks to the device check.  What is refused by name is a mode
    that is not a kernel lowering; the int8 policy selects the twin's row
    in the mode asked for."""
    x = torch.ones(8, 64)
    table = torch.from_numpy(_np(np.random.default_rng(3), 101, 64))
    w = torch.from_numpy(1.0 + _np(np.random.default_rng(4), 64, scale=0.1))
    wq, ws = fused.quantize_weight(torch.from_numpy(
        _np(np.random.default_rng(5), 64, 32)))
    for mode in MODES:
        for xx, ww in ((x, w), (x.bfloat16(), w.bfloat16())):
            got = fused.rmsnorm_matmul(xx, ww, table.t(), mode=mode)
            assert got.shape == (8, 101) and got.dtype == xx.dtype
            assert torch.equal(got, fused.rmsnorm_matmul_plain(
                xx, ww, table.t(), mode=mode))
            with pytest.raises(ValueError, match="must be on"):
                fused._norm_gemm("rmsnorm_matmul", xx, ww, table.t(), 101,
                                 1e-6, mode=mode)
        got = fused.rmsnorm_swiglu_q8(x, w, wq, w_scale=ws, mode=mode)
        assert got.shape == (8, 16)
        assert torch.equal(got, fused.rmsnorm_swiglu_q8_plain(
            x, w, wq, ws, mode=mode))
        with pytest.raises(ValueError, match="must be on"):
            fused._norm_gemm("rmsnorm_swiglu", x, w, wq, 16, 1e-6,
                             w_scale=ws, mode=mode)
        low = REGISTRY.select("rmsnorm_matmul", ExecutionPolicy(
            mode=mode, precision="int8"))
        assert low.op == "rmsnorm_matmul_q8" and low.mode is IsaMode(mode)
    for kernel in (fused.rmsnorm_matmul, fused.rmsnorm_matmul_q8):
        with pytest.raises(ValueError, match="mode must be"):
            kernel(x, torch.ones(64), torch.ones(64, 8), mode="library")
