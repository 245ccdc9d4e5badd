"""The port's rmsnorm, add_rmsnorm and flash_attention (the plain versions
their wrappers run on CPU tensors), the tied-head shape of rmsnorm_matmul,
and their registry rows, against the JAX package.

The same numpy inputs go to both sides; the JAX side runs its Pallas
kernels in interpret mode (``mode="native"``), as its own tests do, and its
``library`` rows.  Tolerance: ``TOLERANCES["f32"]`` in f32 (both sides
compute in f32, in other orders).  In bf16 both sides compute the same f32
values and round once, so an output may land one bf16 step away
(``TOL_BF16_OUT``, 2^-8 relative); add_rmsnorm's sum is one f32 add
rounded once, and must be bit-equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tolerance_for
from repro.core.registry import REGISTRY as REF_REGISTRY
from repro.kernels import attention as ref_attention
from repro.kernels import fused as ref_fused
from repro.kernels import ops as ref_ops
from repro.kernels import rmsnorm as ref_rmsnorm

from repro_torch.core import REGISTRY, ExecutionPolicy
from repro_torch.kernels import attention, fused, ops, ref, rmsnorm

TOL = tolerance_for("f32")
TOL_BF16_OUT = dict(rtol=2 ** -7, atol=2 ** -7)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _pair(arr, dt):
    jdt, tdt = DTYPES[dt]
    return jnp.asarray(arr).astype(jdt), torch.from_numpy(arr).to(tdt)


def _check(got, want, dt="f32"):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    np.testing.assert_allclose(got, want,
                               **(TOL if dt == "f32" else TOL_BF16_OUT))


def _exact(got, want):
    np.testing.assert_array_equal(
        got.detach().float().numpy(),
        np.asarray(jnp.asarray(want).astype(jnp.float32)))


# ---------------------------------------------------------------------------
# rmsnorm and add_rmsnorm
# ---------------------------------------------------------------------------

SHAPES = [(1, 1536), (8, 1536), (300, 1536), (8, 1003)]


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("rows,d", SHAPES)
def test_rmsnorm_matches_jax_native(rows, d, dt):
    rng = np.random.default_rng(rows * d)
    (jx, tx), (jw, tw) = _pair(_np(rng, rows, d), dt), \
        _pair(1.0 + _np(rng, d, scale=0.1), dt)
    want = ref_rmsnorm.rmsnorm(jx, jw, mode="native", interpret=True)
    for got in (rmsnorm.rmsnorm_plain(tx, tw), rmsnorm.rmsnorm(tx, tw),
                ops.rmsnorm(tx, tw, mode="native")):
        assert got.dtype == tx.dtype and got.shape == tx.shape
        _check(got, want, dt)
    _check(ops.rmsnorm(tx, tw, mode="library"),
           ref_ops.rmsnorm(jx, jw, mode="library"), dt)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("rows,d", SHAPES)
def test_add_rmsnorm_matches_jax_native(rows, d, dt):
    rng = np.random.default_rng(rows + d)
    jx, tx = _pair(_np(rng, 2, rows, d), dt)
    jr, tr = _pair(_np(rng, 2, rows, d, scale=0.5), dt)
    jw, tw = _pair(1.0 + _np(rng, d, scale=0.1), dt)
    normed, summed = ref_fused.add_rmsnorm(jx, jr, jw, mode="native",
                                           interpret=True)
    for got_n, got_s in (fused.add_rmsnorm_plain(tx, tr, tw),
                         fused.add_rmsnorm(tx, tr, tw),
                         ops.fused_add_rmsnorm(tx, tr, tw, mode="native")):
        assert got_n.dtype == got_s.dtype == tx.dtype
        _exact(got_s, summed)                  # one f32 add, rounded once
        _check(got_n, normed, dt)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_add_rmsnorm_library_row_matches_jax_library(dt):
    """The library row adds at the working dtype and norms the rounded sum,
    as the JAX library row does; in f32 it equals the kernel's plain
    version, in bf16 the two differ by the rounding of the sum."""
    rng = np.random.default_rng(11)
    jx, tx = _pair(_np(rng, 300, 1536), dt)
    jr, tr = _pair(_np(rng, 300, 1536, scale=0.5), dt)
    jw, tw = _pair(1.0 + _np(rng, 1536, scale=0.1), dt)
    want_n, want_s = ref_ops.fused_add_rmsnorm(jx, jr, jw, mode="library")
    got_n, got_s = ops.fused_add_rmsnorm(tx, tr, tw, mode="library")
    _exact(got_s, want_s)
    _check(got_n, want_n, dt)
    plain_n, _ = fused.add_rmsnorm_plain(tx, tr, tw)
    if dt == "f32":
        _check(plain_n, got_n)
    else:
        assert not torch.equal(plain_n, got_n)


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

ATTN_CASES = [
    # b, h, hkv, sq, skv, d, causal, kv_offset
    (1, 6, 2, 40, 40, 64, True, None),        # GQA group 3, D 64, square
    (2, 4, 4, 5, 12, 16, True, None),         # queries at the end of the keys
    (1, 4, 2, 5, 12, 16, True, 4),            # a given kv_offset
    (1, 4, 1, 9, 70, 32, False, None),        # non-causal, padded kv tail
    (2, 2, 2, 130, 130, 16, True, None),      # two 128-row q blocks
]


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("b,h,hkv,sq,skv,d,causal,kv_offset", ATTN_CASES)
def test_flash_attention_matches_jax_native(b, h, hkv, sq, skv, d, causal,
                                            kv_offset, dt):
    rng = np.random.default_rng(sq * skv + h)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(_np(rng, b, n, s, d), dt)
        for n, s in ((h, sq), (hkv, skv), (hkv, skv)))
    want = ref_attention.flash_attention(jq, jk, jv, causal=causal,
                                         kv_offset=kv_offset, mode="native",
                                         interpret=True)
    for got in (attention.flash_attention_plain(tq, tk, tv, causal=causal,
                                                kv_offset=kv_offset),
                attention.flash_attention(tq, tk, tv, causal=causal,
                                          kv_offset=kv_offset),
                ops.flash_attention(tq, tk, tv, causal=causal,
                                    kv_offset=kv_offset, mode="native")):
        assert got.dtype == tq.dtype and got.shape == tq.shape
        _check(got, want, dt)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_library_row_matches_jax_library(causal):
    rng = np.random.default_rng(5)
    q, k, v = _np(rng, 2, 6, 7, 16), _np(rng, 2, 2, 11, 16), \
        _np(rng, 2, 2, 11, 16)
    want = ref_ops.flash_attention(q, k, v, causal=causal, kv_offset=1,
                                   mode="library")
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal, kv_offset=1, mode="library")
    _check(got, want)                  # the library row reads no kv_offset
    _check(got, ref.attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal))


# ---------------------------------------------------------------------------
# rmsnorm_matmul against a tied f32 table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows", [1, 8])
def test_rmsnorm_matmul_reads_a_tied_table(rows):
    """The head of a tied model: the f32 [N, D] embedding, passed as its
    transposed view, odd N."""
    rng = np.random.default_rng(rows)
    x, w = _np(rng, rows, 64), 1.0 + _np(rng, 64, scale=0.1)
    table = _np(rng, 515, 64, scale=0.02)
    want = ref_fused.rmsnorm_matmul(x, w, table.T, mode="native",
                                    interpret=True)
    tx, tw, tt = map(torch.from_numpy, (x, w, table))
    for got in (fused.rmsnorm_matmul(tx, tw, tt.t()),
                ops.fused_rmsnorm_matmul(tx, tw, tt.t(), mode="native")):
        _check(got, want)
    # bf16 activations beside the f32 table: the norm rounded to bf16, the
    # product read at f32, the result in bf16
    bx, bw = tx.bfloat16(), tw.bfloat16()
    got = fused.rmsnorm_matmul(bx, bw, tt.t())
    assert got.dtype == torch.bfloat16
    y = ref.rmsnorm(bx, bw).float()
    torch.testing.assert_close(got, (y @ tt.t()).bfloat16(), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# registry rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op,contract,ref_module", [
    ("rmsnorm", rmsnorm.NATIVE_CONTRACT, ref_rmsnorm),
    ("flash_attention", attention.NATIVE_CONTRACT, ref_attention)])
def test_native_contracts_match_jax(op, contract, ref_module):
    ref_contract = ref_module.NATIVE_CONTRACT
    assert {p.name for p in contract.primitives} == \
        {p.name for p in ref_contract.primitives}
    assert contract.native_features == ref_contract.native_features
    assert REGISTRY.modes(op) == REF_REGISTRY.modes(op) == (
        "abstract", "abstract+shuffle", "native", "library")


@pytest.mark.parametrize("op,native,plain,library", [
    ("rmsnorm", rmsnorm.rmsnorm, rmsnorm.rmsnorm_plain,
     rmsnorm.rmsnorm_plain),
    ("add_rmsnorm", fused.add_rmsnorm, fused.add_rmsnorm_plain,
     fused.add_rmsnorm_library),
    ("flash_attention", attention.flash_attention,
     attention.flash_attention_plain, attention.flash_attention_library)])
def test_rows_select_kernel_and_library(op, native, plain, library):
    """native on CPU operands is the wrapper (which runs the plain version);
    library is the JAX package's library row."""
    assert REGISTRY.select(op, ExecutionPolicy(mode="native"),
                           device="cpu").impl is native
    assert REGISTRY.select(op, ExecutionPolicy(mode="library"),
                           device="cpu").impl is library
    rng = np.random.default_rng(2)
    if op == "flash_attention":
        args = [torch.from_numpy(_np(rng, 1, 2, 5, 8)) for _ in range(3)]
    elif op == "add_rmsnorm":
        args = [torch.from_numpy(_np(rng, 3, 40)) for _ in range(2)] + [
            torch.from_numpy(1.0 + _np(rng, 40, scale=0.1))]
    else:
        args = [torch.from_numpy(_np(rng, 3, 40)),
                torch.from_numpy(1.0 + _np(rng, 40, scale=0.1))]
    got, want = native(*args), plain(*args)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)
    if op == "rmsnorm":
        assert torch.equal(library(*args), ref.rmsnorm(*args))
