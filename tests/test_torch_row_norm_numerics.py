"""The row norms' one-pass arithmetic, emulated on the CPU
(``csrc/row_norm.cuh`` runs only on the card).

On the one-pass routes rmsnorm and add_rmsnorm hold each row in
registers.  A row is cut into 16-byte slots (8 bf16 or 4 f32 elements);
thread t of the row's T threads holds slots t + k*T for k < NV
(``fused.row_norm_plan``) and folds the squares of its elements in that
order, one FMA each; then native and abstract+shuffle run the xor
butterfly in each warp and add the warps' sums in warp order, and abstract
sends the T partials, padded with zeros to a power of two, through a
halving tree.  add_rmsnorm's sum is x + r in f32, rounded once.  This file
emulates that element by element in numpy, apart from the port's plain
versions, and holds it:

- against the JAX package's Pallas kernels ``rmsnorm`` and
  ``add_rmsnorm`` in f32, in interpret mode as the JAX package's own
  tests run them, in native, abstract and abstract+shuffle, at
  ``TOLERANCES["f32"]`` (only the order of the sums differs), the sum of
  add_rmsnorm bit for bit;
- against the port's plain versions in bf16 (the kernels' working dtype
  on the served paths), within ``chip_smoke.py`` phase 3's two tolerances
  (in every output row max|err| <= 2e-2 x max|plain row|, relative RMS
  <= 1e-2), the sum bit for bit;
- bit for bit against the plain versions' own fold of the moment
  (``fused.row_norm_sumsq``, which the modes' plain versions use).

Shapes: 8, 300 and 512 rows of 1536, 2560 and 5120 (granite-moe's and
mamba2's widths), the ragged 1539 and 7 rows; inputs from numpy with a
seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tolerance_for
from repro.kernels import fused as ref_fused
from repro.kernels import rmsnorm as ref_rmsnorm

from repro_torch.kernels import fused, rmsnorm

TOL_ROW, TOL_RMS = 2e-2, 1e-2          # chip_smoke.py phase 3
MODES = ("native", "abstract", "abstract+shuffle")
KERNELS = ("rmsnorm", "add_rmsnorm")
EPS = 1e-6
SHAPES = ([(m, d) for m in (8, 300, 512) for d in (1536, 2560, 5120)]
          + [(300, 1539), (7, 1536)])


def sumsq_emulation(s, itemsize: int, mode: str):
    """Each row's sum of squares of ``s`` (f32 [rows, d]) as the kernel of
    ``mode`` folds it for elements of ``itemsize`` bytes: [rows] f32."""
    rows, d = s.shape
    nv, threads = fused.row_norm_plan(d, itemsize)
    g = 16 // itemsize
    # thread t's elements in its fold order: slot t + k*T, then the slot
    order = np.array([[(t + k * threads) * g + e for k in range(nv)
                       for e in range(g)] for t in range(threads)])
    padded = np.zeros((rows, nv * threads * g), np.float32)
    padded[:, :d] = s
    vals = padded[:, order]                       # [rows, T, NV * G]
    ss = np.zeros((rows, threads), np.float32)
    for j in range(vals.shape[-1]):
        v = vals[:, :, j].astype(np.float64)      # fmaf: rounded once
        ss = (v * v + ss.astype(np.float64)).astype(np.float32)
    if mode == "abstract":
        p = 32
        while p < threads:
            p *= 2
        tree = np.zeros((rows, p), np.float32)
        tree[:, :threads] = ss
        h = p // 2
        while h >= 1:
            tree[:, :h] = tree[:, :h] + tree[:, h:2 * h]
            h //= 2
        return tree[:, 0]
    lanes = ss.reshape(rows, threads // 32, 32)
    for o in (16, 8, 4, 2, 1):                    # the xor butterfly
        lanes = lanes + lanes[..., np.arange(32) ^ o]
    total = np.zeros(rows, np.float32)
    for i in range(threads // 32):                # the warps in order
        total = total + lanes[:, i, 0]
    return total


def norm_emulation(x, w, itemsize: int, mode: str, r=None):
    """(out, sum) in f32 from f32 numpy inputs: the sum x + r, its moment
    by :func:`sumsq_emulation`, then s * rsqrt(moment / D + eps) * w."""
    s = x if r is None else (x + r).astype(np.float32)
    ss = sumsq_emulation(s, itemsize, mode)
    inv = (np.float32(1.0) / np.sqrt(ss / np.float32(x.shape[1])
                                     + np.float32(EPS))).astype(np.float32)
    return (s * inv[:, None]) * w, s


def _inputs(rows, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, d)).astype(np.float32)
    r = (0.5 * rng.standard_normal((rows, d))).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    return x, r, w


def _phase3_errors(out, ref):
    """(max over rows of max|err row| / max|plain row|, relative RMS), as
    chip_smoke.py's compare."""
    o, r = out.float(), ref.float()
    row = ((o - r).abs().amax(1) / r.abs().amax(1).clamp_min(1e-30)).max()
    rms = torch.linalg.vector_norm(o - r) / torch.linalg.vector_norm(r)
    return float(row), float(rms)


@pytest.mark.parametrize("d,itemsize,plan", [
    (1536, 2, (1, 192)), (2560, 2, (1, 320)), (5120, 2, (2, 320)),
    (1539, 2, (1, 224)), (1536, 4, (1, 384)), (5120, 4, (4, 320)),
    (64, 2, (1, 32)), (700, 4, (1, 192)), (32768, 2, (8, 512)),
    (16384, 4, (8, 512)), (32776, 2, None), (16388, 4, None)])
def test_row_norm_plan(d, itemsize, plan):
    """The split row_plan gives: the fewest slots a thread (a power of two)
    within 512 threads a row, whole warps, the widest rows on the loop
    route (None)."""
    assert fused.row_norm_plan(d, itemsize) == plan


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("rows,d", SHAPES)
def test_emulation_matches_jax_kernel_in_f32(rows, d, kernel, mode):
    x, r, w = _inputs(rows, d, rows + d)
    if kernel == "rmsnorm":
        want = np.asarray(ref_rmsnorm.rmsnorm(
            jnp.asarray(x), jnp.asarray(w), eps=EPS, mode=mode,
            interpret=True))
        got, _ = norm_emulation(x, w, 4, mode)
    else:
        want, want_s = (np.asarray(a) for a in ref_fused.add_rmsnorm(
            jnp.asarray(x), jnp.asarray(r), jnp.asarray(w), eps=EPS,
            mode=mode, interpret=True))
        got, s = norm_emulation(x, w, 4, mode, r=r)
        np.testing.assert_array_equal(s, want_s)
    assert got.shape == want.shape == (rows, d)
    np.testing.assert_allclose(got, want, **tolerance_for("f32"))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("rows,d", SHAPES)
def test_emulation_fits_phase3_tolerances_in_bf16(rows, d, kernel, mode):
    """bf16 operands: the emulation over their f32 values (the bf16
    split, 8 elements a slot), rounded to bf16 once, against the port's
    plain version of the mode; the sum bit for bit."""
    x, r, w = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(rows, d, rows + d + 1))
    xf, rf, wf = (a.float().numpy() for a in (x, r, w))
    if kernel == "rmsnorm":
        got, _ = norm_emulation(xf, wf, 2, mode)
        want = rmsnorm.rmsnorm_plain(x, w, eps=EPS, mode=mode)
    else:
        got, s = norm_emulation(xf, wf, 2, mode, r=rf)
        want, want_s = fused.add_rmsnorm_plain(x, r, w, eps=EPS, mode=mode)
        assert torch.equal(torch.from_numpy(s).to(torch.bfloat16), want_s)
    got = torch.from_numpy(got).to(torch.bfloat16)
    assert want.dtype == torch.bfloat16 and want.shape == got.shape
    row, rms = _phase3_errors(got, want)
    assert row <= TOL_ROW and rms <= TOL_RMS, (row, rms)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("rows,d", [(8, 1536), (300, 1539), (7, 5120),
                                    (33, 64), (5, 700)])
def test_plain_fold_is_the_kernel_fold(rows, d, itemsize, mode):
    """The plain versions' moment (``fused.row_norm_sumsq``, vectorized:
    the rotate tree's lane 0 for the butterfly, ``scratch_tree_reduce`` for
    abstract's tree) equals the element-by-element emulation bit for bit;
    native's fold is abstract+shuffle's."""
    x, _, _ = _inputs(rows, d, 3 * rows + d)
    want = sumsq_emulation(x, itemsize, mode)
    got = fused.row_norm_sumsq(torch.from_numpy(x), itemsize, mode)
    assert got.shape == (rows, 1)
    np.testing.assert_array_equal(got[:, 0].numpy(), want)
    if mode == "abstract+shuffle":
        np.testing.assert_array_equal(
            sumsq_emulation(x, itemsize, "native"), want)
