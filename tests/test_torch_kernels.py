"""The port's four kernels (their plain versions, which the wrappers run on
CPU tensors) and the cache helpers against the JAX package, in f32 at
``TOLERANCES["f32"]``.  The JAX side runs each Pallas kernel as its own
tests do: ``mode="native"`` in interpret mode, and ``mode="library"``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tolerance_for
from repro.kernels import fused as ref_fused
from repro.models import attention as ref_attention
from repro.models import common as ref_common

from repro_torch.kernels import fused, ops
from repro_torch.models import attention, common

TOL = tolerance_for("f32")


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _check(got, want, mask=None):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    if mask is not None:
        got, want = got[mask], want[mask]
    np.testing.assert_allclose(got, want, **TOL)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("rows", [1, 5, 13])
def test_rmsnorm_matmul(rows):
    rng = np.random.default_rng(rows)
    x, w, W = _np(rng, rows, 64), _np(rng, 64), _np(rng, 64, 200, scale=0.1)
    for mode in ("native", "library"):
        want = ref_fused.rmsnorm_matmul(x, w, W, mode=mode, interpret=True)
        _check(fused.rmsnorm_matmul(*_t(x, w, W)), want)
        _check(fused.rmsnorm_matmul_plain(*_t(x, w, W)), want)
        _check(ops.fused_rmsnorm_matmul(*_t(x, w, W), mode=mode), want)


@pytest.mark.parametrize("rows", [1, 7])
def test_rmsnorm_swiglu(rows):
    rng = np.random.default_rng(10 + rows)
    x, w, wc = _np(rng, 2, rows, 64), _np(rng, 64), _np(rng, 64, 2 * 72,
                                                         scale=0.1)
    for mode in ("native", "library"):
        want = ref_fused.rmsnorm_swiglu(x, w, wc, mode=mode, interpret=True)
        _check(fused.rmsnorm_swiglu(*_t(x, w, wc)), want)
        _check(ops.fused_rmsnorm_swiglu(*_t(x, w, wc), mode=mode), want)


@pytest.mark.parametrize("b,h,hkv,sq,skv,kv_offset", [
    (2, 4, 2, 8, 8, None),       # GQA, square causal
    (1, 4, 1, 5, 12, None),      # queries aligned to the end of the keys
    (1, 2, 2, 5, 12, 4),         # explicit kv_offset
])
def test_flash_attention_matmul_causal(b, h, hkv, sq, skv, kv_offset):
    rng = np.random.default_rng(sq * skv)
    d, n = 16, 200                                    # N not a 128 multiple
    q, k, v = _np(rng, b, h, sq, d), _np(rng, b, hkv, skv, d), \
        _np(rng, b, hkv, skv, d)
    wo = _np(rng, h * d, n, scale=0.2)
    got = fused.flash_attention_matmul(*_t(q, k, v, wo), kv_offset=kv_offset)
    want = ref_fused.flash_attention_matmul(q, k, v, wo, kv_offset=kv_offset,
                                            mode="native", interpret=True)
    _check(got, want)
    if kv_offset is None:      # the library row always aligns to the end
        _check(got, ref_fused.flash_attention_matmul(q, k, v, wo,
                                                     mode="library"))


def test_flash_attention_matmul_pos_with_fully_masked_row():
    rng = np.random.default_rng(3)
    b, h, hkv, skv, d, n = 4, 4, 2, 20, 16, 136
    q, k, v = _np(rng, b, h, 1, d), _np(rng, b, hkv, skv, d), \
        _np(rng, b, hkv, skv, d)
    wo = _np(rng, h * d, n, scale=0.2)
    pos = np.array([0, 9, 19, -1], np.int32)          # slot 3 sees no key
    got = fused.flash_attention_matmul(*_t(q, k, v, wo),
                                       pos=torch.from_numpy(pos))
    lib = ref_fused.flash_attention_matmul(q, k, v, wo, pos=pos,
                                           mode="library")
    _check(got, lib)              # a fully masked row averages all keys
    nat = ref_fused.flash_attention_matmul(q, k, v, wo, pos=pos,
                                           mode="native", interpret=True)
    _check(got, nat, mask=np.s_[:3])   # native pads keys: rows with a key


def _paged_case(rng, page_size=4):
    b, h, hkv, d, n, num_pages, maxp = 3, 4, 2, 16, 136, 6, 3
    q = _np(rng, b, h, 1, d)
    kp, vp = _np(rng, num_pages, hkv, page_size, d), \
        _np(rng, num_pages, hkv, page_size, d)
    wo = _np(rng, h * d, n, scale=0.2)
    tables = np.array([[4, 1, 0],       # live through its last page
                       [2, 5, num_pages],   # sentinel past the frontier
                       [3, 0, 5]], np.int32)   # dead entries past pos
    pos = np.array([11, 6, 2], np.int32)
    return q, kp, vp, wo, tables, pos


def test_paged_attention_matmul():
    q, kp, vp, wo, tables, pos = _paged_case(np.random.default_rng(5))
    got = fused.paged_attention_matmul(*_t(q, kp, vp, wo),
                                       block_tables=torch.from_numpy(tables),
                                       pos=torch.from_numpy(pos))
    via_ops = ops.fused_flash_attention_matmul(
        *_t(q, kp, vp, wo), block_tables=torch.from_numpy(tables),
        pos=torch.from_numpy(pos))
    for mode in ("native", "library"):
        want = ref_fused.flash_attention_matmul(
            q, kp, vp, wo, block_tables=tables, pos=pos, mode=mode,
            interpret=True)
        _check(got, want)
        _check(via_ops, want)


def test_paged_gather_and_decode_attention():
    q, kp, vp, _, tables, pos = _paged_case(np.random.default_rng(6))
    _check(attention.gather_paged_kv(*_t(kp, tables)),
           ref_attention.gather_paged_kv(kp, tables))
    _check(attention.paged_decode_attention(*_t(q, kp, vp, tables, pos)),
           ref_attention.paged_decode_attention(q, kp, vp, tables, pos))


def test_update_paged_cache_drops_sentinel_and_out_of_table_writes():
    rng = np.random.default_rng(7)
    num_pages, hkv, ps, d = 5, 2, 4, 8
    pages = _np(rng, num_pages, hkv, ps, d)
    new = _np(rng, 4, hkv, 1, d)
    tables = np.array([[0, 3], [num_pages, num_pages], [2, 4], [1, 2]],
                      np.int32)
    # slot 0 writes page 3 row 1; slot 1 is reaped (sentinel); slot 2 runs
    # past its table's end; slot 3 writes page 1 row 0
    pos = np.array([5, 6, 9, 0], np.int32)
    want = ref_attention.update_paged_cache(jnp.asarray(pages), new, tables,
                                            pos)
    trash = np.zeros((1, hkv, ps, d), np.float32)
    pool = torch.from_numpy(np.concatenate([pages, trash]))
    attention.update_paged_cache(pool, *_t(new, tables, pos))
    _check(pool[:num_pages], want)
    assert not np.array_equal(np.asarray(want), pages)   # writes happened


@pytest.mark.parametrize("pos", [[0, 3], [7, 8], [-1, 2]])
def test_update_cache_and_decode_attention(pos):
    rng = np.random.default_rng(8)
    b, hkv, s, d = 2, 2, 8, 8
    cache, new = _np(rng, b, hkv, s, d), _np(rng, b, hkv, 1, d)
    pos = np.array(pos, np.int32)
    want = ref_attention.update_cache(cache, new, pos)
    got = attention.update_cache(*_t(cache.copy(), new, pos))
    _check(got, want)
    q = _np(rng, b, 4, 1, d)
    ok = pos >= 0
    _check(attention.decode_attention(*_t(q), got, got, torch.from_numpy(pos)),
           ref_attention.decode_attention(q, want, want, pos), mask=ok)


def test_apply_rope():
    rng = np.random.default_rng(9)
    x = _np(rng, 2, 3, 5, 16)
    positions = np.arange(5, dtype=np.int32)[None].repeat(2, 0) + 3
    _check(common.apply_rope(torch.from_numpy(x),
                             torch.from_numpy(positions)[:, None, :], 1e4),
           ref_common.apply_rope(x, jnp.asarray(positions)[:, None, :], 1e4))
