"""The abstract and abstract+shuffle lowerings of granite-moe-3b-a800m's four
kernels (rmsnorm, add_rmsnorm, flash_attention, and rmsnorm_matmul against
the tied f32 table) against the JAX package's Pallas lowerings of the same
mode in interpret mode, and the registry rows, contracts and declared
fallbacks of the three ops that gained their modes.

The same numpy inputs go to both sides, in f32, at ``TOLERANCES["f32"]``:
both compute in f32, the port's plain version of a mode folds each row to
32 lanes before its tree (the warp), the JAX kernel to 128 (the vreg), so
the sums run in other orders.  add_rmsnorm's sum is one f32 add, rounded
once, and must be bit-equal in every mode.  The shapes cover a ragged D
(the JAX side pads D to 128 under these modes), row counts that are not a
multiple of 4 (the kernel's rows per block), GQA group 3 with a partial
query tile (21 queries x 3 heads per 64-row block), ``kv_offset``, the
non-causal call, and an odd vocabulary for the tied head."""
import functools

import numpy as np
import pytest
import torch

from repro.core.registry import REGISTRY as REF_REGISTRY
from repro.core.registry import ExecutionPolicy as RefPolicy
from repro.kernels import attention as ref_attention
from repro.kernels import fused as ref_fused
from repro.kernels import rmsnorm as ref_rmsnorm
from test_torch_modes import MODES, _both, _close, _np

from repro_torch.core import REGISTRY, ExecutionPolicy, IsaMode
from repro_torch.core.registry import LoweringFallbackWarning, \
    UnsupportedLowering
from repro_torch.kernels import attention, fused, ops, rmsnorm
from repro_torch.kernels.fused import LAUNCHES

OPS = ("rmsnorm", "add_rmsnorm", "flash_attention")


# ---------------------------------------------------------------------------
# the row norms
# ---------------------------------------------------------------------------

NORM_SHAPES = [(8, 384), (5, 100), (3, 1003), (37, 256)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("rows,d", NORM_SHAPES)
def test_rmsnorm_matches_jax_mode(rows, d, mode):
    rng = np.random.default_rng(rows * d)
    (jx, jw), (tx, tw) = _both(_np(rng, rows, d),
                               1.0 + _np(rng, d, scale=0.1))
    want = ref_rmsnorm.rmsnorm(jx, jw, mode=mode, interpret=True)
    for got in (rmsnorm.rmsnorm(tx, tw, mode=mode),
                rmsnorm.rmsnorm_plain(tx, tw, mode=mode),
                ops.rmsnorm(tx, tw, mode=mode)):
        assert got.shape == (rows, d) and got.dtype == torch.float32
        _close(got, want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("rows,d", NORM_SHAPES)
def test_add_rmsnorm_matches_jax_mode(rows, d, mode):
    rng = np.random.default_rng(rows + d)
    (jx, jr, jw), (tx, tr, tw) = _both(
        _np(rng, 2, rows, d), _np(rng, 2, rows, d, scale=0.5),
        1.0 + _np(rng, d, scale=0.1))
    want_n, want_s = ref_fused.add_rmsnorm(jx, jr, jw, mode=mode,
                                           interpret=True)
    for got_n, got_s in (fused.add_rmsnorm(tx, tr, tw, mode=mode),
                         fused.add_rmsnorm_plain(tx, tr, tw, mode=mode),
                         ops.fused_add_rmsnorm(tx, tr, tw, mode=mode)):
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
        _close(got_n, want_n)


@pytest.mark.parametrize("mode", MODES)
def test_bf16_row_norms_differ_from_native_by_the_sum_order_only(mode):
    """In bf16 a mode's norm rounds the same f32 values once, as native
    does: at most one bf16 step apart; the stored sum is bit-equal."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(_np(rng, 6, 300)).bfloat16()
    r = torch.from_numpy(_np(rng, 6, 300, scale=0.5)).bfloat16()
    w = torch.from_numpy(1.0 + _np(rng, 300, scale=0.1)).bfloat16()
    step = dict(rtol=2 ** -7, atol=2 ** -7)
    torch.testing.assert_close(rmsnorm.rmsnorm(x, w, mode=mode).float(),
                               rmsnorm.rmsnorm(x, w).float(), **step)
    got_n, got_s = fused.add_rmsnorm(x, r, w, mode=mode)
    want_n, want_s = fused.add_rmsnorm(x, r, w)
    assert torch.equal(got_s, want_s)
    torch.testing.assert_close(got_n.float(), want_n.float(), **step)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

ATTN_CASES = [
    # b, h, hkv, sq, skv, d, causal, kv_offset
    (1, 6, 2, 40, 40, 64, True, None),       # group 3, partial query tile
    (1, 6, 2, 130, 130, 16, True, None),     # several 64-key tiles
    (2, 4, 1, 8, 200, 32, True, 150),        # kv_offset, group 4
    (1, 6, 2, 9, 70, 16, False, None),       # non-causal, padded kv tail
]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("b,h,hkv,sq,skv,d,causal,kv_offset", ATTN_CASES)
def test_flash_attention_matches_jax_mode(b, h, hkv, sq, skv, d, causal,
                                          kv_offset, mode):
    rng = np.random.default_rng(sq * skv + h)
    (jq, jk, jv), (tq, tk, tv) = _both(
        _np(rng, b, h, sq, d), _np(rng, b, hkv, skv, d),
        _np(rng, b, hkv, skv, d))
    want = ref_attention.flash_attention(jq, jk, jv, causal=causal,
                                         kv_offset=kv_offset, mode=mode,
                                         interpret=True)
    for got in (attention.flash_attention(tq, tk, tv, causal=causal,
                                          kv_offset=kv_offset, mode=mode),
                ops.flash_attention(tq, tk, tv, causal=causal,
                                    kv_offset=kv_offset, mode=mode)):
        assert got.shape == (b, h, sq, d) and got.dtype == torch.float32
        _close(got, want)


def test_mode_softmax_runs_each_modes_tree(monkeypatch):
    """flash_attention's plain version under a mode takes its softmax's row
    max and row sum through that mode's tree, native through
    ``torch.softmax``."""
    calls = []
    real = fused.row_reduce
    monkeypatch.setattr(fused, "row_reduce", lambda *a, **k:
                        calls.append(a[2]) or real(*a, **k))
    q = torch.ones(1, 2, 3, 8)
    for mode in ("native",) + MODES:
        attention.flash_attention(q, q, q, mode=mode)
    assert calls == ["abstract"] * 2 + ["abstract+shuffle"] * 2
    with pytest.raises(ValueError, match="mode must be"):
        attention.flash_attention(q, q, q, mode="library")


# ---------------------------------------------------------------------------
# the tied head: rmsnorm_matmul against the transposed f32 table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("rows", [1, 8, 37])
def test_tied_head_matches_jax_mode(rows, mode):
    rng = np.random.default_rng(rows)
    x, w = _np(rng, rows, 64), 1.0 + _np(rng, 64, scale=0.1)
    table = _np(rng, 515, 64, scale=0.02)
    want = ref_fused.rmsnorm_matmul(x, w, table.T, mode=mode,
                                    interpret=True)
    tx, tw, tt = map(torch.from_numpy, (x, w, table))
    for got in (fused.rmsnorm_matmul(tx, tw, tt.t(), mode=mode),
                ops.fused_rmsnorm_matmul(tx, tw, tt.t(), mode=mode)):
        assert got.shape == (rows, 515)
        _close(got, want)
    # bf16 activations beside the f32 table: the normalized row rounded to
    # bf16, the product read at f32, the result in bf16
    bx, bw = tx.bfloat16(), tw.bfloat16()
    got = fused.rmsnorm_matmul(bx, bw, tt.t(), mode=mode)
    y = fused.rmsnorm_mode(bx, bw, 1e-6, mode).float()
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, (y @ tt.t()).bfloat16(), rtol=0, atol=0)


def test_cpu_operands_launch_nothing():
    before = dict(LAUNCHES)
    x = torch.ones(3, 64)
    for mode in MODES:
        rmsnorm.rmsnorm(x, torch.ones(64), mode=mode)
        fused.add_rmsnorm(x, x, torch.ones(64), mode=mode)
        attention.flash_attention(x[None, None], x[None, None],
                                  x[None, None], mode=mode)
        fused.rmsnorm_matmul(x, torch.ones(64), torch.ones(9, 64).t(),
                             mode=mode)
    assert LAUNCHES == before
    assert all(f"{k}_{m}" in LAUNCHES for k in OPS for m in MODES)


# ---------------------------------------------------------------------------
# registry rows, contracts, fallbacks
# ---------------------------------------------------------------------------

_WRAPPERS = {"rmsnorm": rmsnorm.rmsnorm, "add_rmsnorm": fused.add_rmsnorm,
             "flash_attention": attention.flash_attention}


@pytest.mark.parametrize("op", OPS)
def test_mode_rows_and_contracts_match_jax(op):
    assert REGISTRY.modes(op) == REF_REGISTRY.modes(op) == (
        "abstract", "abstract+shuffle", "native", "library")
    for mode in MODES:
        low = REGISTRY.select(op, ExecutionPolicy(mode=mode))
        want = REF_REGISTRY.select(op, RefPolicy(mode=mode))
        assert low.mode is IsaMode(mode) and low.target is None
        assert isinstance(low.impl, functools.partial)
        assert low.impl.func is _WRAPPERS[op]
        assert low.impl.keywords == {"mode": mode}
        assert low.contract.kernel == want.contract.kernel == op
        assert low.contract.mode.value == want.contract.mode.value == mode
        assert {p.name for p in low.contract.primitives} == \
            {p.name for p in want.contract.primitives}
        assert low.contract.native_features == \
            want.contract.native_features == frozenset()


@pytest.mark.parametrize("op", OPS)
def test_shuffle_fallback_is_declared_where_jax_declares_it(op):
    """Without lane shuffles abstract+shuffle degrades to abstract for
    add_rmsnorm (a fused op of the JAX package) and raises for rmsnorm and
    flash_attention, on both sides; on the card no fallback is taken."""
    pol = ExecutionPolicy(mode="abstract+shuffle", dialect="uisa-universal10")
    ref_pol = RefPolicy(mode="abstract+shuffle", dialect="uisa-universal10")
    if op == "add_rmsnorm":
        with pytest.warns(LoweringFallbackWarning):
            low = REGISTRY.select(op, pol, device="cpu")
        with pytest.warns(Warning):
            want = REF_REGISTRY.select(op, ref_pol)
        assert low.mode is IsaMode.ABSTRACT
        assert want.mode.value == "abstract"
    else:
        with pytest.raises(UnsupportedLowering, match="no fallback"):
            REGISTRY.select(op, pol, device="cpu")
        with pytest.raises(RuntimeError, match="no fallback"):
            REF_REGISTRY.select(op, ref_pol)
    with pytest.raises(UnsupportedLowering,
                       match="on the card" if op == "add_rmsnorm"
                       else "no fallback"):
        REGISTRY.select(op, pol, device=torch.device("cuda", 0))
