"""The arithmetic of the int8 twin's float heads, quantized per call inside
the decode GEMV (``csrc/norm_gemv.cuh``: ``q8_scales_kernel``,
``gemv_quant``; ``csrc/norm_gemv_t.cuh``: ``q8_scales_t_kernel``), held
on the CPU against the JAX package's ``quantize_weight`` and
``rmsnorm_matmul_q8(..., w_scale=None)``.

- The scheme on the edge channels the kernels must reproduce bit for bit:
  a channel of zeros (scale 1e-8, q = 0), a channel whose max is
  subnormal, a channel whose largest magnitude is negative, and ties at .5
  of the scale (round half to even), in both layouts the heads take: a
  bf16 ``[K, N]`` head (granite-8b's ``lm_head``) and the transposed view
  of an f32 ``[V, K]`` table (granite-moe's tied head; V odd, K at the
  reduced width).  Exact.
- The kernels' quantizer, emulated step by step in f32 (the reciprocal
  ``RN(1/s)``, two FMA corrections, the clamp, rint by adding and taking
  away 1.5 x 2^23): the quotient is IEEE's ``RN(w / s)`` and q is
  ``clip(round(w / s), -127, 127)``, over every finite bf16 weight and
  random f32 weights at scales from the 1e-8 floor up.  Exact.
- ``rmsnorm_matmul_q8`` with a float weight, on the CPU (the plain
  version after ``quantize_weight``), against JAX in every mode: the bf16
  and f32 ``[K, N]`` head and the bf16 activations beside the f32 table
  (f32 activations with the table are
  ``test_torch_q8_modes.py::test_a_float_weight_is_quantized_by_the_twin_as_in_jax``).
  f32 at ``TOLERANCES["f32"]``; bf16 rtol = atol = 2^-6 of each row's
  largest reference value (the port rounds the normalized row to bf16 as
  its kernels do)."""
import re
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from conftest import tolerance_for
from repro.kernels import fused as ref_fused

from repro_torch.kernels import _build, fused

TOL = tolerance_for("f32")
BF16_TOL = 2.0 ** -6
MODES = ("native", "abstract", "abstract+shuffle")
#: granite-moe-3b-a800m-reduced's width; an odd vocabulary like the full
#: model's 49155
K_REDUCED, V_ODD = 64, 515
MAGIC = np.float32(12582912.0)                  # 1.5 x 2^23
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
NORM_GEMV, NORM_GEMV_T, NORM_GEMV_Q = (
    CSRC / "norm_gemv.cuh", CSRC / "norm_gemv_t.cuh", CSRC / "norm_gemv_q.cuh")

f32 = np.float32


def _bf16(a):
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)


def _to_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# the kernels' quantizer, step by step in f32
# ---------------------------------------------------------------------------


def fma32(a, b, c):
    """fmaf(a, b, c) exactly: the f64 product of two f32 is exact, TwoSum
    keeps the add's error, which decides a sum that lands midway between
    two f32."""
    a, b, c = (np.asarray(v, f32).astype(np.float64) for v in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    t = s.astype(f32)
    lo = np.nextafter(t, f32(-np.inf))
    hi = np.nextafter(t, f32(np.inf))
    t = np.where((s == (t.astype(np.float64) + lo) / 2) & (e < 0), lo, t)
    return np.where((s == (t.astype(np.float64) + hi) / 2) & (e > 0), hi, t)


def kernel_quotient(w, s):
    """``gemv_quant``'s quotient: q0 = RN(w * RN(1/s)), then two
    corrections q = RN(q + RN(w - s q) * y), each by one FMA."""
    w, s = np.asarray(w, f32), np.asarray(s, f32)
    y = (f32(1) / s).astype(f32)
    q = (w * y).astype(f32)
    for _ in range(2):
        q = fma32(fma32(-s, q, w), y, q)
    return q


def kernel_quantize(w, s):
    """``gemv_quant``: the quotient clamped to [-127, 127], then rint as
    (v + 1.5 2^23) - 1.5 2^23 in f32."""
    q = np.clip(kernel_quotient(w, s), f32(-127), f32(127)).astype(f32)
    return ((q + MAGIC).astype(f32) - MAGIC).astype(f32)


def kernel_scales(w_kn):
    """The passes 1: the channel's max |w| over K in f32 (as integer bits:
    the same value), over 127 by IEEE division, at least 1e-8."""
    amax = np.abs(np.asarray(w_kn, f32)).max(axis=0)
    return np.maximum((amax / f32(127)).astype(f32), f32(1e-8))


def test_the_emulation_mirrors_the_kernel_source():
    """gemv_quant in the source is the emulated sequence: one product by
    the reciprocal, two FMA corrections, the clamp, the 1.5 x 2^23 rint;
    the reciprocal is __frcp_rn and the scales divide by 127 with
    __fdiv_rn."""
    src = NORM_GEMV.read_text()
    body = re.search(r"float gemv_quant\(float w, float s, float y\) \{"
                     r"(.*?)\n\}", src, re.S).group(1)
    steps = [ln.strip() for ln in body.strip().splitlines()]
    assert steps == ["float q = __fmul_rn(w, y);",
                     "q = fmaf(fmaf(-s, q, w), y, q);",
                     "q = fmaf(fmaf(-s, q, w), y, q);",
                     "q = fminf(fmaxf(q, -127.f), 127.f);",
                     "return __fsub_rn(__fadd_rn(q, 12582912.f), "
                     "12582912.f);"]
    for recip in ("qy[c] = __frcp_rn(qs[c]);",            # the FMA form
                  "qy[g][j] = __frcp_rn(qs[g][j]);"):     # the mma form
        assert recip in src
    assert "fmaxf(__fdiv_rn(__uint_as_float(a), 127.f), 1e-8f)" in src
    assert "qy = __frcp_rn(qs);" in NORM_GEMV_T.read_text()
    strip = NORM_GEMV_Q.read_text()              # the strip kernel's
    assert "rc[tid] = __frcp_rn(s);" in strip
    assert "fmaxf(__fdiv_rn(__uint_as_float(a), 127.f), 1e-8f)" in strip
    assert "use_fast_math" not in " ".join(_build.NVCC_FLAGS)


def _ieee_q(w, s):
    return np.clip(np.round((np.asarray(w, f32) / s).astype(f32)), -127, 127)


@pytest.mark.parametrize("weights", ["every_bf16", "random_f32", "floor"])
def test_the_kernel_quantizer_is_ieee_division_then_rint(weights):
    """Over every channel scale drawn, the emulated kernel quotient equals
    the IEEE quotient wherever |w / s| >= 1/4 (below, both round to 0), and
    q equals clip(round(w / s), -127, 127) everywhere."""
    rng = np.random.default_rng(11)
    if weights == "every_bf16":
        w = (np.arange(1 << 16, dtype=np.uint32) << 16).view(f32)
        w = w[np.isfinite(w)]
        amaxes = np.abs(w)[rng.integers(0, w.size, 48)]
    elif weights == "random_f32":
        amaxes = (np.abs(rng.standard_normal(24))
                  * 10.0 ** rng.integers(-30, 30, 24)).astype(f32)
    else:                                        # scales at the 1e-8 floor
        amaxes = np.array([0.0, 1e-40, 1e-10, 1.2e-6, 1.27e-6], f32)
    checked = 0
    for am in amaxes:
        s = kernel_scales(np.array([[am]], f32))[0]
        if weights == "every_bf16":
            ww = w[np.abs(w) <= am]
        else:
            ww = (rng.uniform(-1, 1, 20000) * am).astype(f32)
            ww = np.concatenate([ww, np.array([am, -am], f32)])
        quot = kernel_quotient(ww, s)
        ref = (ww / s).astype(f32)
        big = np.abs(ref) >= 0.25
        np.testing.assert_array_equal(quot[big], ref[big])
        np.testing.assert_array_equal(kernel_quantize(ww, s), _ieee_q(ww, s))
        checked += ww.size
    assert checked > 0


# ---------------------------------------------------------------------------
# the scheme on the edge channels, in the heads' two layouts
# ---------------------------------------------------------------------------


def _edge_weight(case, k, n):
    """A [k, n] f32 weight whose channel 1 is the case's edge: all zeros;
    a subnormal max; the largest magnitude negative; values on .5 of the
    scale (max 127, so scale 1: -3.5, ..., 2.5 round to even)."""
    rng = np.random.default_rng(12)
    w = (rng.standard_normal((k, n)) * 0.05).astype(f32)
    col = np.zeros(k, f32)
    if case == "zeros":
        pass
    elif case == "subnormal":
        col = (rng.uniform(-1, 1, k) * 2.0 ** -128).astype(f32)
        col[3] = f32(2.0 ** -127)
    elif case == "negative":
        col = (rng.standard_normal(k) * 0.1).astype(f32)
        col[5] = f32(-3.0)
    else:                                        # ties
        col[0] = 127.0
        halves = np.arange(-3.5, 3.5, dtype=f32)
        col[1:1 + halves.size] = halves
    w[:, 1] = col
    return w


@pytest.mark.parametrize("case", ["zeros", "subnormal", "negative", "ties"])
@pytest.mark.parametrize("layout", ["kn_bf16", "table_f32"])
def test_quantize_weight_of_an_edge_channel_is_bit_equal_to_jax(layout,
                                                                 case):
    """``quantize_weight`` (what the CPU runs and the card tests hold the
    kernels to), ``weight_scales`` and the emulated kernel passes against
    the JAX package's ``quantize_weight``: int8 and scales bit for bit."""
    if layout == "kn_bf16":
        w = _bf16(_edge_weight(case, 96, 48))
        tw, jw = _to_torch(w), jnp.asarray(w)
    else:
        table = np.ascontiguousarray(_edge_weight(case, K_REDUCED, V_ODD).T)
        tw, jw = _to_torch(table).t(), jnp.asarray(table).T
        w = table.T
    want_q, want_s = (np.asarray(a) for a in ref_fused.quantize_weight(jw))
    q, s = fused.quantize_weight(tw)
    np.testing.assert_array_equal(q.numpy(), want_q)
    np.testing.assert_array_equal(s.numpy(), want_s)
    np.testing.assert_array_equal(fused.weight_scales(tw).numpy(), want_s)
    np.testing.assert_array_equal(fused.quantize_scales(tw).numpy(), want_s)
    ks = kernel_scales(np.asarray(w, f32))
    np.testing.assert_array_equal(ks, want_s)
    np.testing.assert_array_equal(
        kernel_quantize(np.asarray(w, f32), ks[None, :]).astype(np.int8),
        want_q)
    edge = want_q[:, 1]
    if case in ("zeros", "subnormal"):
        assert want_s[1] == f32(1e-8) and not edge.any()
    elif case == "negative":
        assert edge[5] == -127 and want_s[1] == (f32(3.0) / f32(127))
    else:                                        # round half to even
        assert want_s[1] == 1.0
        assert edge[1:8].tolist() == [-4, -2, -2, 0, 0, 2, 2]


# ---------------------------------------------------------------------------
# rmsnorm_matmul_q8 with a float weight, against JAX in every mode
# ---------------------------------------------------------------------------

# (layout, dtype); the f32 table is test_torch_q8_modes.py's
HEAD_FORMS = [("kn", "bf16"), ("kn", "f32"), ("table", "bf16")]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layout,dt", HEAD_FORMS)
def test_rmsnorm_matmul_q8_of_a_float_head_matches_jax(layout, dt, mode):
    """x [8, 64] (decode rows) against a float head the twin quantizes per
    call: W [64, 96] at x's dtype, or the transposed f32 table [515, 64]
    beside bf16 x; the port's CPU path is the plain version after
    ``quantize_weight``, the JAX side its Pallas kernel in interpret mode
    after its ``quantize_weight``."""
    rng = np.random.default_rng(13)
    x = (rng.standard_normal((8, K_REDUCED))).astype(f32)
    w = (1.0 + 0.1 * rng.standard_normal(K_REDUCED)).astype(f32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    if dt == "bf16":
        jx, jw = jx.astype(jnp.bfloat16), jw.astype(jnp.bfloat16)
        tx, tw = tx.bfloat16(), tw.bfloat16()
    if layout == "kn":
        head = (rng.standard_normal((K_REDUCED, 96)) * 0.125).astype(f32)
        jh, th = jnp.asarray(head), torch.from_numpy(head)
        if dt == "bf16":
            jh, th = jh.astype(jnp.bfloat16), th.bfloat16()
    else:
        table = (rng.standard_normal((V_ODD, K_REDUCED)) * 0.05).astype(f32)
        jh, th = jnp.asarray(table).T, torch.from_numpy(table).t()
    want = np.asarray(ref_fused.rmsnorm_matmul_q8(
        jx, jw, jh, mode=mode, interpret=True), np.float32)
    got = fused.rmsnorm_matmul_q8(tx, tw, th, mode=mode)
    assert got.dtype == tx.dtype and got.shape == want.shape
    got = got.float().numpy()
    if dt == "f32":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        row = np.abs(want).max(axis=-1, keepdims=True)
        np.testing.assert_allclose(got / row, want / row, rtol=BF16_TOL,
                                   atol=BF16_TOL)
