"""The Table V slice on the CPU: the port's gemm, reduce_sum and histogram
(the plain versions their wrappers run on CPU tensors) against the JAX
package's in every mode it registers, the lane functions of both
``core/shuffle.py`` modules against each other at widths 32 (a Hopper
warp) and 128 (a TPU vreg), and the registry rows.

The same numpy inputs go to both sides; the JAX side runs its Pallas
kernels in interpret mode, as ``tests/test_kernels.py`` does.  Tolerance:
``TOLERANCES["f32"]`` (both sides accumulate in f32, in other orders);
counts and lane exchanges are exact; a bf16 output is stated below."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tolerance_for
from repro.core import shuffle as ref_shuffle
from repro.core.registry import REGISTRY as REF_REGISTRY
from repro.kernels import gemm as ref_gemm
from repro.kernels import histogram as ref_histogram
from repro.kernels import ops as ref_ops
from repro.kernels import reduction as ref_reduction

from repro_torch.core import REGISTRY, ExecutionPolicy, shuffle
from repro_torch.core.registry import LoweringFallbackWarning
from repro_torch.kernels import gemm, histogram, ops, reduction

TOL = tolerance_for("f32")
#: a bf16 output is one rounding of f32 values that the two sides sum in
#: other orders, so they may land one bf16 step apart (2^-8 relative)
TOL_BF16_OUT = dict(rtol=2 ** -7, atol=2 ** -7)
MODES = ("abstract", "abstract+shuffle", "native", "library")
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16),
          "int32": (np.int32, jnp.int32, torch.int32)}


def _pair(arr: np.ndarray, dt: str):
    """The same values as a JAX array and a torch tensor of ``dt``."""
    _, jdt, tdt = DTYPES[dt]
    return jnp.asarray(arr).astype(jdt), torch.from_numpy(arr).to(tdt)


# ---------------------------------------------------------------------------
# reduction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("n", [128, 999, 70001])
def test_reduce_sum_matches_jax(n, dt, mode):
    rng = np.random.default_rng(n)
    arr = (rng.integers(-5, 5, n) if dt == "int32"
           else rng.standard_normal(n)).astype(DTYPES[dt][0])
    jx, tx = _pair(arr, dt)
    want = ref_ops.reduce_sum(jx, mode=mode)
    got = ops.reduce_sum(tx, mode=mode)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", reduction.MODES)
def test_reduce_sum_plain_small_tile(mode):
    """The benchmark's second tile (2 elements per thread, so a second pass
    over 137 partials) sums the same."""
    arr = np.random.default_rng(3).standard_normal(70001).astype(np.float32)
    want = ref_ops.reduce_sum(jnp.asarray(arr), mode=mode)
    got = reduction.reduce_sum_plain(torch.from_numpy(arr), mode=mode,
                                     tile=2 * reduction.THREADS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", reduction.MODES)
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("n", [(1 << 16) + 1, (1 << 18) + 5])
def test_reduce_sum_plain_small_tile_matches_jax(n, dt, mode):
    """Row 10d's definition (tile 512, 2 elements a thread, a second pass
    over the partials) at ragged n above 2^16, every dtype, against the
    JAX ``reduce_sum`` of the same mode."""
    rng = np.random.default_rng(n + len(dt))
    arr = (rng.integers(-5, 5, n) if dt == "int32"
           else rng.standard_normal(n)).astype(DTYPES[dt][0])
    jx, tx = _pair(arr, dt)
    want = ref_ops.reduce_sum(jx, mode=mode)
    got = reduction.reduce_sum_plain(tx, mode=mode,
                                     tile=reduction.SMALL_TILE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _emulate_small_tile(x: np.ndarray, mode: str) -> np.float32:
    """The persistent route's arithmetic in numpy f32, element by element:
    thread t of a tile adds its elements t and t + 256 to 0; the block's
    tree (abstract: halving stages over 256 values; otherwise a 32-lane
    butterfly read at lane 0, then one over the 8 warp sums); thread t of
    the second pass folds partials t, t + 256, ... in order; the tree."""
    f = np.float32

    def tree(v):
        v = v.astype(np.float32)
        if mode == "abstract":
            w = 128
            while w >= 1:
                v = v.copy()
                v[:w] = v[:w] + v[w:2 * w]
                w //= 2
            return v[0]
        warps = []
        for wv in v.reshape(8, 32):
            for o in (16, 8, 4, 2, 1):
                wv = wv + wv[np.arange(32) ^ o]
            warps.append(wv[0])
        wv = np.array(warps, np.float32)
        for o in (4, 2, 1):
            wv = wv + wv[np.arange(8) ^ o]
        return wv[0]

    def block(vals, per):
        acc = np.zeros(256, np.float32)
        for i in range(per):
            acc = acc + vals[i * 256:(i + 1) * 256]
        return tree(acc)

    xf = x.astype(np.float32)
    tiles = -(-xf.size // 512)
    xf = np.concatenate([xf, np.zeros(tiles * 512 - xf.size, np.float32)])
    parts = np.array([block(xf[i * 512:(i + 1) * 512], 2)
                      for i in range(tiles)], np.float32)
    if tiles == 1:
        return f(parts[0])
    per = -(-tiles // 256)
    parts = np.concatenate([parts, np.zeros(per * 256 - tiles, np.float32)])
    return f(block(parts, per))


@pytest.mark.parametrize("mode", reduction.MODES)
@pytest.mark.parametrize("n", [1, 512, 999, 70001])
def test_reduce_sum_plain_small_tile_is_the_kernel_order(n, mode):
    """The plain version at tile 512 is the persistent route's order, bit
    for bit (the card test holds the kernel to it bitwise)."""
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32) * 3
    got = reduction.reduce_sum_plain(torch.from_numpy(x), mode=mode,
                                     tile=reduction.SMALL_TILE)
    want = _emulate_small_tile(x, mode)
    assert got.numpy().tobytes() == np.float32(want).tobytes()


def test_reduce_sum_launch_params_name_the_route():
    n = 1 << 24
    for mode in reduction.MODES:
        tile = reduction.launch_params(mode, n)
        assert tile["route"] == "tile" and tile["grid"] == 256
        assert tile["passes"] == 2
        small = reduction.launch_params(mode, n, reduction.SMALL_TILE)
        assert small["route"] == "persistent"
        assert small["grid"] == "resident blocks"       # no card here
        assert small["passes"] == 2
        assert small["per_thread"] == 2
    one = reduction.launch_params("abstract", 300, reduction.SMALL_TILE)
    assert one["second_pass"] is None and one["passes"] == 1


def test_reduce_sum_empty_and_shaped():
    assert float(ops.reduce_sum(torch.zeros(0))) == 0.0
    arr = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    for mode in reduction.MODES:
        assert float(ops.reduce_sum(torch.from_numpy(arr), mode=mode)) == 276.0


# ---------------------------------------------------------------------------
# histogram
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("bins", [100, 256])
@pytest.mark.parametrize("spread", ["in_range", "out_of_range"])
def test_histogram_matches_jax(spread, bins, mode):
    rng = np.random.default_rng(bins)
    lo, hi = (0, bins) if spread == "in_range" else (-50, bins + 50)
    arr = rng.integers(lo, hi, 5001).astype(np.int32)
    want = np.asarray(ref_ops.histogram(jnp.asarray(arr), bins, mode=mode))
    got = ops.histogram(torch.from_numpy(arr), bins, mode=mode)
    assert got.dtype == torch.int32 and got.shape == (bins,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == arr.size


def test_histogram_plain_private_copies_sum_to_the_clipped_counts():
    """The plain version in every mode gives the clipped counts, which
    every mode's private copies sum to, across three tiles (a ragged last
    one)."""
    n = histogram.TILE + 4461
    arr = np.random.default_rng(5).integers(-9, 300, n).astype(np.int32)
    want = np.bincount(np.clip(arr, 0, 255), minlength=256)
    for mode in histogram.MODES:
        got = histogram.histogram_plain(torch.from_numpy(arr), 256, mode=mode)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["two_tiles", "one_bin"])
def test_histogram_abstract_shuffle_plain_matches_jax_and_library(case):
    """The abstract+shuffle plain version (the clipped counts) against
    the JAX package's abstract+shuffle kernel and library row, across two
    tiles (a ragged second one) and with every value in one bin; its
    shared memory as the kernel sizes it: a warp's 8-bit lane counts and
    int32 sums over the bins rounded up to 4."""
    n = histogram.TILE + 1461
    rng = np.random.default_rng(6)
    arr = (np.full(n, 7, np.int32) if case == "one_bin"
           else rng.integers(-9, 300, n).astype(np.int32))
    got = histogram.histogram_plain(torch.from_numpy(arr), 256,
                                    mode="abstract+shuffle")
    for mode in ("abstract+shuffle", "library"):
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(ref_ops.histogram(jnp.asarray(arr), 256,
                                                      mode=mode)))
    np.testing.assert_array_equal(
        got.numpy(), ops.histogram(torch.from_numpy(arr), 256,
                                   mode="library").numpy())
    assert histogram.max_bins("abstract+shuffle") == 232448 // 1152 * 4
    assert histogram.launch_params("abstract+shuffle", n, 256) == dict(
        grid="resident blocks", block=256, tile=histogram.TILE,
        private_histograms=256, smem_bytes=64 * 8 * (32 + 4) * 4,
        loads="one value, 16 a thread in flight (ld.global.cs)",
        flush_tiles=15)


# ---------------------------------------------------------------------------
# gemm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["abstract", "native", "library"])
@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", [(100, 130, 50), (1, 128, 257),
                                   (33, 257, 129)])
def test_matmul_matches_jax(m, k, n, out, mode):
    rng = np.random.default_rng(m * n + k)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    jdt, tdt, tol = ((jnp.float32, torch.float32, TOL) if out == "f32"
                     else (jnp.bfloat16, torch.bfloat16, TOL_BF16_OUT))
    want = ref_ops.matmul(a, b, mode=mode, out_dtype=jdt)
    got = ops.matmul(torch.from_numpy(a), torch.from_numpy(b), mode=mode,
                     out_dtype=tdt)
    assert got.dtype == tdt and got.shape == (m, n)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("mode", gemm.MODES)
def test_matmul_bf16_operands(mode):
    """bf16 operands accumulate in f32 on both sides."""
    rng = np.random.default_rng(9)
    a = rng.standard_normal((40, 70)).astype(np.float32)
    b = rng.standard_normal((70, 30)).astype(np.float32)
    want = ref_ops.matmul(jnp.asarray(a, jnp.bfloat16),
                          jnp.asarray(b, jnp.bfloat16), mode=mode)
    got = ops.matmul(torch.from_numpy(a).bfloat16(),
                     torch.from_numpy(b).bfloat16(), mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_matmul_abstract_shuffle_takes_the_recorded_fallback():
    """Both packages declare gemm [abstract+shuffle] -> [abstract]: warned
    and recorded on CPU operands (the card raises: tests/test_torch_gpu.py)."""
    rng = np.random.default_rng(2)
    a = rng.standard_normal((20, 33)).astype(np.float32)
    b = rng.standard_normal((33, 17)).astype(np.float32)
    with pytest.warns(Warning):
        want = ref_ops.matmul(a, b, mode="abstract+shuffle")
    before = len(REGISTRY.fallback_events)
    with pytest.warns(LoweringFallbackWarning, match="abstract"):
        got = ops.matmul(torch.from_numpy(a), torch.from_numpy(b),
                         mode="abstract+shuffle")
    assert len(REGISTRY.fallback_events) == min(before + 1,
                                                REGISTRY.EVENT_LOG_MAXLEN)
    event = REGISTRY.fallback_events[-1]
    assert (event.op, event.requested, event.used) == (
        "gemm", "abstract+shuffle", "abstract")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gemm_tiles_are_derived_from_the_target():
    """abstract: the scratchpad budget alone (square, a multiple of the
    wave width); native: aligned to the queried matrix unit."""
    assert gemm.abstract_block_shape() == (64, 64, 64)
    assert gemm.native_block_shape() == (128, 128, 32)
    ab = ref_gemm.abstract_block_shape()
    assert ab[0] == ab[1] == ab[2]     # the JAX rule: square, from the budget


# ---------------------------------------------------------------------------
# lane functions, both packages, at a warp's width and a vreg's
# ---------------------------------------------------------------------------


def _lanes(width: int, rows: int = 3, seed: int = 0):
    arr = np.random.default_rng(seed + width).standard_normal(
        (rows, width)).astype(np.float32)
    return arr, jnp.asarray(arr), torch.from_numpy(arr)


@pytest.mark.parametrize("width", [32, 128])
def test_lane_exchanges_match(width):
    _, jx, tx = _lanes(width)
    for delta in (1, 3, width // 2, width - 1):
        np.testing.assert_array_equal(
            shuffle.lane_shuffle_down(tx, delta).numpy(),
            np.asarray(ref_shuffle.lane_shuffle_down(jx, delta)))
        np.testing.assert_array_equal(
            shuffle.lane_shuffle_up(tx, delta).numpy(),
            np.asarray(ref_shuffle.lane_shuffle_up(jx, delta)))
    for mask in (1, 2, width // 4, width // 2):
        np.testing.assert_array_equal(
            shuffle.lane_shuffle_xor(tx, mask).numpy(),
            np.asarray(ref_shuffle.lane_shuffle_xor(jx, mask)))
    # along axis 0 too
    np.testing.assert_array_equal(
        shuffle.lane_shuffle_down(tx.T.contiguous(), 5, axis=0).numpy(),
        np.asarray(ref_shuffle.lane_shuffle_down(jx.T, 5, axis=0)))
    for bad in (0, 3, width, -2):
        with pytest.raises(ValueError):
            shuffle.lane_shuffle_xor(tx, bad)


@pytest.mark.parametrize("width", [32, 128])
def test_lane_trees_match(width):
    _, jx, tx = _lanes(width, seed=1)
    np.testing.assert_allclose(shuffle.lane_tree_reduce(tx).numpy(),
                               np.asarray(ref_shuffle.lane_tree_reduce(jx)),
                               **TOL)
    np.testing.assert_array_equal(
        shuffle.lane_tree_reduce(tx, torch.maximum).numpy(),
        np.asarray(ref_shuffle.lane_tree_reduce(jx, jnp.maximum)))
    with pytest.raises(ValueError):
        shuffle.lane_tree_reduce(torch.zeros(1, width - 8))
    # folds of a row of three groups, then the tree
    _, jr, tr = _lanes(3 * width, seed=2)
    np.testing.assert_allclose(
        shuffle.fold_rows(tr, lanes=width).numpy(),
        np.asarray(ref_shuffle.fold_rows(jr, lanes=width)), **TOL)
    np.testing.assert_allclose(
        shuffle.row_reduce_shuffle(tr, lanes=width).numpy(),
        np.asarray(ref_shuffle.row_reduce_shuffle(jr, lanes=width)), **TOL)
    np.testing.assert_array_equal(
        shuffle.row_reduce_shuffle(tr, torch.maximum, lanes=width).numpy(),
        np.asarray(ref_shuffle.row_reduce_shuffle(jr, jnp.maximum,
                                                  lanes=width)))


@pytest.mark.parametrize("width", [32, 128])
@pytest.mark.parametrize("axis", [-1, 0])
def test_scratch_tree_matches(width, axis):
    """The JAX tree writes through a ref; a numpy array stands in for it
    outside a kernel.  The port's takes a preallocated tensor."""
    arr, _, tx = _lanes(width, rows=width if axis == 0 else 4, seed=3)
    if axis == 0:
        arr, tx = arr[:, :8].copy(), tx[:, :8].contiguous()
    want = ref_shuffle.scratch_tree_reduce(arr, np.empty_like(arr), axis=axis)
    got = shuffle.scratch_tree_reduce(tx, torch.empty_like(tx), axis=axis)
    assert tuple(got.shape) == np.asarray(want).shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(),
                               arr.sum(axis=axis, keepdims=True), **TOL)
    with pytest.raises(ValueError):
        shuffle.scratch_tree_reduce(tx, torch.empty(2, 2), axis=axis)


@pytest.mark.parametrize("width", [8, 32, 128, 256])
def test_cost_vocabulary_matches(width):
    assert shuffle.tree_stages(width) == ref_shuffle.tree_stages(width)
    for rows, itemsize in ((1, 4), (3, 2)):
        assert shuffle.scratch_tree_bytes(width, rows, itemsize) == \
            ref_shuffle.scratch_tree_bytes(width, rows, itemsize)
    assert shuffle.tree_stages() == 5          # one Hopper warp
    assert ref_shuffle.tree_stages() == 7      # one TPU vreg


# ---------------------------------------------------------------------------
# registry rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op,module,ref_module", [
    ("gemm", gemm, ref_gemm), ("reduction", reduction, ref_reduction),
    ("histogram", histogram, ref_histogram)])
def test_rows_and_contracts_match_jax(op, module, ref_module):
    assert REGISTRY.modes(op) == REF_REGISTRY.modes(op)
    for mode, contract in module.CONTRACTS.items():
        ref_contract = getattr(ref_module, {
            "abstract": "ABSTRACT_CONTRACT",
            "abstract+shuffle": "SHUFFLE_CONTRACT",
            "native": "NATIVE_CONTRACT"}[mode])
        assert {p.name for p in contract.primitives} == \
            {p.name for p in ref_contract.primitives}
        assert contract.native_features == ref_contract.native_features
    for mode in REGISTRY.modes(op):
        low = REGISTRY.select(op, ExecutionPolicy(mode=mode), device="cpu")
        assert low.mode.value == mode


def test_histogram_abstract_shuffle_row_runs_its_plain_version_on_cpu():
    """Registered in both packages; on CPU operands the port's row is the
    plain version, without a fallback (on the card it is the kernel)."""
    arr = np.random.default_rng(4).integers(-3, 140, 777).astype(np.int32)
    with warnings.catch_warnings():
        warnings.simplefilter("error", LoweringFallbackWarning)
        got = ops.histogram(torch.from_numpy(arr), 128,
                            mode="abstract+shuffle")
    want = ref_ops.histogram(jnp.asarray(arr), 128, mode="abstract+shuffle")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
