"""The arithmetic of the norm-GEMMs' decode route, emulated in plain PyTorch
on the CPU (``csrc/norm_gemv.cuh`` runs only on the card).

At decode (at most 16 rows) rmsnorm_matmul, rmsnorm_swiglu and their int8
twins write the normalized row x_n rounded to the working dtype (its moment
through the mode's cross-lane stage, the only stage a mode changes), then
sum x_n against W in f32 (each product exact: a bf16 or int8 weight widened
to f32 times a value of at most 24 significant bits), one K chunk a block:
the chunk's sum is a partial, and the partials are added in split order.
The int8 column scales multiply the whole sum, and swiglu stores
``silu(hg) * hi`` of the same column of wi and wg, computed in f32, rounded
once.  The emulation is held against:

- the JAX package's Pallas kernels ``rmsnorm_matmul``, ``rmsnorm_swiglu``,
  ``rmsnorm_matmul_q8`` and ``rmsnorm_swiglu_q8`` in f32, in interpret mode
  as the JAX package's own tests run them, in every mode, at M = 1, 5, 8
  and 16 rows of D 64-256 and N 48-272, with K whole and split into chunks
  (one not dividing K), at ``TOLERANCES["f32"]`` (2e-4: in f32 the
  roundings are exact, so only the order of the sums differs, and, for
  int8, where the scale is applied: JAX scales the tile before its dot);
- the port's plain versions in bf16 at the same shapes and at granite-8b's
  D of 4096 (K split in six, as the card splits qkv), within
  ``chip_smoke.py`` phase 3's two tolerances (in every output row max|err|
  <= 2e-2 x max|plain row|, and relative RMS <= 1e-2).

The int8 widening (a byte into the float 2^23, a subtraction) is emulated
bit by bit over all 256 values.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from conftest import tolerance_for
from repro.kernels import fused as ref_fused

from repro_torch.kernels import fused

TOL_ROW, TOL_RMS = 2e-2, 1e-2          # chip_smoke.py phase 3
MODES = ("native", "abstract", "abstract+shuffle")
KINDS = ("matmul", "swiglu", "matmul_q8", "swiglu_q8")


def gemv_emulation(x, weight, w, *, w_scale=None, swiglu=False,
                   k_chunk=None, eps: float = 1e-6, mode: str = "native"):
    """[..., N] (swiglu: [..., F]) in x's dtype, by the decode route: x_n
    rounded to x's dtype, f32 sums of each ``k_chunk`` rows of K (all of K
    by default) added in split order, the int8 column scales on the whole
    sum, then the gate."""
    xn = fused.rmsnorm_mode(x, weight, eps, mode).float()
    wf = w.float()                      # bf16 and int8 widen exactly
    k = wf.shape[0]
    step = k if k_chunk is None else k_chunk
    total = None
    for k0 in range(0, k, step):
        part = xn[..., k0:k0 + step] @ wf[k0:k0 + step]
        total = part if total is None else total + part
    if w_scale is not None:
        total = total * w_scale
    if swiglu:
        f = wf.shape[1] // 2
        total = F.silu(total[..., f:]) * total[..., :f]
    return total.to(x.dtype)


def widen_i8_emulation(q):
    """csrc/norm_gemv.cuh::gemv_widen<int8_t> bit by bit: int8 ``q`` -> the
    f32 values the kernel sums."""
    u = (q.astype(np.int16).astype(np.uint8) ^ np.uint8(0x80)).astype(
        np.uint32)
    f = (np.uint32(0x4B000000) | u).view(np.float32)
    return f - np.float32(8388736.0)


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _inputs(kind, m, d, n, seed):
    """(x, weight, W, w_scale or None) as numpy, W [d, n] (swiglu: [d, 2n])
    quantized by the port's int8 scheme for a ``_q8`` kind."""
    rng = np.random.default_rng(seed)
    cols = 2 * n if kind.startswith("swiglu") else n
    x, w = _np(rng, m, d), 1.0 + _np(rng, d, scale=0.1)
    big = _np(rng, d, cols, scale=d ** -0.5)
    if not kind.endswith("q8"):
        return x, w, big, None
    wq, ws = fused.quantize_weight(torch.from_numpy(big))
    return x, w, wq.numpy(), ws.numpy()


def _jax(kind, x, w, big, ws, mode):
    args = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(big))
    kw = dict(mode=mode, interpret=True)
    if ws is not None:
        kw["w_scale"] = jnp.asarray(ws)
    fn = {"matmul": ref_fused.rmsnorm_matmul,
          "swiglu": ref_fused.rmsnorm_swiglu,
          "matmul_q8": ref_fused.rmsnorm_matmul_q8,
          "swiglu_q8": ref_fused.rmsnorm_swiglu_q8}[kind]
    return np.asarray(fn(*args, **kw))


def _plain(kind, x, w, big, ws, mode):
    return {"matmul": lambda: fused.rmsnorm_matmul_plain(x, w, big,
                                                         mode=mode),
            "swiglu": lambda: fused.rmsnorm_swiglu_plain(x, w, big,
                                                         mode=mode),
            "matmul_q8": lambda: fused.rmsnorm_matmul_q8_plain(
                x, w, big, ws, mode=mode),
            "swiglu_q8": lambda: fused.rmsnorm_swiglu_q8_plain(
                x, w, big, ws, mode=mode)}[kind]()


def _phase3_errors(out, ref):
    """(max over rows of max|err row| / max|plain row|, relative RMS), as
    chip_smoke.py's compare."""
    o = out.float().reshape(-1, out.shape[-1])
    r = ref.float().reshape(-1, ref.shape[-1])
    row = ((o - r).abs().amax(1) / r.abs().amax(1).clamp_min(1e-30)).max()
    rms = torch.linalg.vector_norm(o - r) / torch.linalg.vector_norm(r)
    return float(row), float(rms)


# (m, d, n, k_chunk): M 1, 5, 8 and 16; K whole, split evenly, and split
# into chunks that leave a short last one
SHAPES = [(1, 64, 48, None), (5, 256, 272, 64), (8, 128, 96, 48),
          (16, 192, 160, 80)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m,d,n,k_chunk", SHAPES)
def test_gemv_emulation_matches_jax_kernel_in_f32(m, d, n, k_chunk, kind,
                                                  mode):
    x, w, big, ws = _inputs(kind, m, d, n, m + d + n)
    want = _jax(kind, x, w, big, ws, mode)
    got = gemv_emulation(
        *map(torch.from_numpy, (x, w, big)), mode=mode, k_chunk=k_chunk,
        swiglu=kind.startswith("swiglu"),
        w_scale=None if ws is None else torch.from_numpy(ws))
    assert got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, **tolerance_for("f32"))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m,d,n,k_chunk", SHAPES + [(8, 4096, 256, 704)])
def test_gemv_route_fits_phase3_tolerances(m, d, n, k_chunk, kind, mode):
    x, w, big, ws = _inputs(kind, m, d, n, m + d + n + 1)
    x, w, big = (torch.from_numpy(a) for a in (x, w, big))
    x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    if ws is None:
        big = big.to(torch.bfloat16)
    else:
        ws = torch.from_numpy(ws)
    got = gemv_emulation(x, w, big, w_scale=ws, k_chunk=k_chunk, mode=mode,
                         swiglu=kind.startswith("swiglu"))
    want = _plain(kind, x, w, big, ws, mode)
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == want.shape == (m, n)
    assert torch.isfinite(got.float()).all()
    row, rms = _phase3_errors(got, want)
    assert row <= TOL_ROW and rms <= TOL_RMS, (row, rms)


def test_split_order_is_the_sum_of_chunk_partials():
    """The split sums are added in split order: in f32, three chunks of a
    row summed (p0 + p1) + p2 equal the emulation bit for bit."""
    rng = np.random.default_rng(3)
    x, w = _np(rng, 4, 96), 1.0 + _np(rng, 96, scale=0.1)
    big = _np(rng, 96, 40, scale=96 ** -0.5)
    x, w, big = map(torch.from_numpy, (x, w, big))
    xn = fused.rmsnorm_mode(x, w, 1e-6, "native")
    parts = [xn[:, k:k + 32] @ big[k:k + 32] for k in (0, 32, 64)]
    want = (parts[0] + parts[1]) + parts[2]
    got = gemv_emulation(x, w, big, k_chunk=32)
    assert torch.equal(got, want)


def test_int8_widening_is_exact_for_every_value():
    q = np.arange(-128, 128, dtype=np.int8)
    np.testing.assert_array_equal(widen_i8_emulation(q),
                                  q.astype(np.float32))


# ---------------------------------------------------------------------------
# the transposed-table form (the tied head): each thread owns one table
# row's outputs and sums its K chunk in order with f32 FMAs of x_n (exact
# in f32) and the f32 table; the chunks' partials are added in split order
# ---------------------------------------------------------------------------


def gemv_t_emulation(x, weight, table, *, k_chunk=None, eps: float = 1e-6,
                     mode: str = "native"):
    """x [M, K] against the f32 [N, K] table by norm_gemv_t_kernel's order:
    x_n rounded to x's dtype; for each ``k_chunk`` of K, an f32 sum over k
    in order, each step one FMA (rounded once: the product of x_n and an
    f32 value is exact in float64, and so is its sum with an f32
    accumulator); the chunks' sums added in split order; cast to x's
    dtype."""
    xn = fused.rmsnorm_mode(x, weight, eps, mode).double()
    e = table.double()
    k = e.shape[1]
    step = k if k_chunk is None else k_chunk
    total = None
    for k0 in range(0, k, step):
        acc = torch.zeros(xn.shape[0], e.shape[0], dtype=torch.float32)
        for kk in range(k0, min(k, k0 + step)):
            acc = (acc.double() + xn[:, kk:kk + 1] * e[:, kk][None, :]
                   ).float()
        total = acc if total is None else total + acc
    return total.to(x.dtype)


def _tied_inputs(m, d, n, seed):
    rng = np.random.default_rng(seed)
    return (_np(rng, m, d), 1.0 + _np(rng, d, scale=0.1),
            _np(rng, n, d, scale=0.02))


# M 1, 8 and 16 at K 512, N 520: K whole, in the card's 384-wide chunks
# (one short last chunk) and in four of 128
TIED = [(m, k_chunk) for m in (1, 8, 16) for k_chunk in (None, 384, 128)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m,k_chunk", TIED)
def test_gemv_t_emulation_matches_jax_kernel_in_f32(m, k_chunk, mode):
    """Against the JAX ``rmsnorm_matmul`` on the table's transpose (the tied
    head as the JAX model passes it), in f32, interpret mode."""
    x, w, table = _tied_inputs(m, 512, 520, m + 7)
    want = np.asarray(ref_fused.rmsnorm_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(table).T, mode=mode,
        interpret=True))
    got = gemv_t_emulation(*map(torch.from_numpy, (x, w, table)),
                           k_chunk=k_chunk, mode=mode)
    assert got.shape == want.shape == (m, 520)
    np.testing.assert_allclose(got.numpy(), want, **tolerance_for("f32"))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m,k_chunk", TIED)
def test_gemv_t_route_fits_phase3_tolerances_in_bf16(m, k_chunk, mode):
    """bf16 activations beside the f32 table (granite-moe's head): the
    emulation against the port's plain version (x_n rounded to bf16, the
    product in f32), within chip_smoke.py phase 3's tolerances."""
    x, w, table = _tied_inputs(m, 512, 520, m + 11)
    tx = torch.from_numpy(x).bfloat16()
    tw = torch.from_numpy(w).bfloat16()
    tt = torch.from_numpy(table)
    got = gemv_t_emulation(tx, tw, tt, k_chunk=k_chunk, mode=mode)
    plain = fused.rmsnorm_matmul_plain(tx, tw, tt.t(), mode=mode)
    assert got.dtype == plain.dtype == torch.bfloat16
    row, rms = _phase3_errors(got, plain)
    assert row <= TOL_ROW and rms <= TOL_RMS, (row, rms)
