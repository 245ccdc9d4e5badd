"""The 3xTF32 arithmetic of the port's gemm kernels, on the CPU.

``csrc/gemm.cu`` splits every f32 element into two TF32 halves (``hi =
rna(x)``, ``lo = rna(x - hi)``) and takes each product as ``lo.hi +
hi.lo + hi.hi`` on the tensor cores.  :func:`gemm.gemm_plain` repeats
that on tensors; these tests hold the split to hand-made bit patterns and
to its 2^-22 reconstruction bound, and the plain version in both modes to
the JAX ``gemm`` (Pallas in interpret mode, at ``TOL``: both accumulate in
f32, in other orders) and to the float64 product at Table V's
``check_gemm`` tolerances (relative RMS <= 1e-5, row-relative <= 1e-4).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tolerance_for
from repro.kernels import ops as ref_ops

from repro_torch.benchmarks import tablev
from repro_torch.kernels import gemm

TOL = tolerance_for("f32")


def _f32(bits):
    return torch.tensor(bits, dtype=torch.int64).to(torch.int32).view(
        torch.float32)


def _bits(x):
    return [b & 0xFFFFFFFF for b in x.view(torch.int32).tolist()]


# (input bits, TF32 bits): the 13 low mantissa bits go, rounded to
# nearest, ties away from zero
ROUNDINGS = [
    (0x3F800000, 0x3F800000),     # 1.0: exact
    (0x3F800FFF, 0x3F800000),     # below half an ulp: down
    (0x3F801000, 0x3F802000),     # a tie: away from zero
    (0xBF801000, 0xBF802000),     # the negative tie: away from zero too
    (0x3F801001, 0x3F802000),     # above half: up
    (0x3F802FFF, 0x3F802000),     # just below the next tie: down
    (0x3F803000, 0x3F804000),     # a tie with an odd kept bit: away
    (0x3FFFF000, 0x40000000),     # the carry into the exponent
    (0xC07FEFFF, 0xC07FE000),     # negative, below the tie
    (0x00000000, 0x00000000),     # zero
    (0x80000000, 0x80000000),     # negative zero
    (0x7F7FE000, 0x7F7FE000),     # the largest TF32 value: exact
]


@pytest.mark.parametrize("x,want", ROUNDINGS,
                         ids=[f"{x:08x}" for x, _ in ROUNDINGS])
def test_round_tf32_bit_patterns(x, want):
    got = gemm.round_tf32(_f32([x]))
    assert _bits(got) == [want]


def test_round_tf32_keeps_bf16_values():
    """bf16 values have 7 mantissa bits: TF32 keeps them exactly, so a
    bf16 operand's low half is 0."""
    gen = torch.Generator().manual_seed(0)
    x = (torch.randn(4096, generator=gen) * 100).bfloat16()
    x = torch.cat([x, torch.tensor([1.0, -2.5, 3.0e38, 1.0e-38],
                                   dtype=torch.bfloat16)])
    hi, lo = gemm.split_tf32(x)
    assert torch.equal(hi, x.float())
    assert not lo.any()


@pytest.mark.parametrize("scale", [1e-20, 1.0, 1e30])
def test_split_reconstructs_f32(scale):
    """hi and lo are TF32 values and hi + lo keeps x to within 2^-21 of
    it (the bound is 2^-22: lo's own rounding)."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(1 << 16, generator=gen) * scale
    hi, lo = gemm.split_tf32(x)
    for half in (hi, lo):
        assert not (half.view(torch.int32) & 0x1FFF).any()
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs()).max()
    assert float(rel) <= 2.0 ** -21
    assert float(((hi.double() - x.double()).abs()
                  / x.double().abs()).max()) <= 2.0 ** -11


@pytest.mark.parametrize("mode", gemm.MODES)
def test_plain_sums_each_k_tile_apart(mode):
    """Each K tile of the mode (native 32, abstract 64) sums lo.hi, hi.lo
    and hi.hi, in that order, from zero; the tile sums are added to the
    accumulator in order, the last tile partial."""
    gen = torch.Generator().manual_seed(3)
    a = torch.randn(9, 150, generator=gen)
    b = torch.randn(150, 7, generator=gen)
    ah, al = gemm.split_tf32(a)
    bh, bl = gemm.split_tf32(b)
    bk = gemm.block_shape(mode)[2]
    want = torch.zeros(9, 7)
    for k0 in range(0, 150, bk):
        ks = slice(k0, k0 + bk)
        part = al[:, ks] @ bh[ks]
        part += ah[:, ks] @ bl[ks]
        part += ah[:, ks] @ bh[ks]
        want += part
    got = gemm.gemm_plain(a, b, mode=mode)
    assert torch.equal(got, want)
    # not 1xTF32 (hi.hi alone): two orders of magnitude closer to float64
    ref = a.double() @ b.double()
    assert float((got.double() - ref).abs().max()) < \
        float(((ah @ bh).double() - ref).abs().max()) / 100


@pytest.mark.parametrize("mode", gemm.MODES)
@pytest.mark.parametrize("m,k,n", [(100, 130, 50), (33, 257, 129),
                                   (64, 96, 128)])
def test_plain_matches_jax_gemm(m, k, n, mode):
    rng = np.random.default_rng(m + 3 * k + n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    want = ref_ops.matmul(jnp.asarray(a), jnp.asarray(b), mode=mode)
    got = gemm.gemm_plain(torch.from_numpy(a), torch.from_numpy(b),
                          mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", gemm.MODES)
@pytest.mark.parametrize("m,k,n", [(64, 4096, 96), (129, 333, 257),
                                   (257, 129, 333), (333, 257, 129),
                                   (1, 1, 1)])
def test_plain_meets_check_gemm(m, k, n, mode):
    """Against the float64 product at Table V's tolerances, at the long-K
    shape and the ragged ones; bf16 operands too (exact in TF32)."""
    gen = torch.Generator().manual_seed(m * k + n)
    a = torch.randn(m, k, generator=gen)
    b = torch.randn(k, n, generator=gen)
    what = f"gemm_plain [{mode}] {m}x{k}x{n}"
    tablev.check_gemm(gemm.gemm_plain(a, b, mode=mode),
                      a.double() @ b.double(), what)
    ab, bb = a.bfloat16(), b.bfloat16()
    tablev.check_gemm(gemm.gemm_plain(ab, bb, mode=mode),
                      ab.double() @ bb.double(), what + " bf16")


def test_plain_error_is_that_of_an_f32_product():
    """The split keeps the plain version's relative RMS within a small
    factor of a plain f32 product's on the same inputs."""
    gen = torch.Generator().manual_seed(5)
    a = torch.randn(64, 4096, generator=gen)
    b = torch.randn(4096, 96, generator=gen)
    ref = a.double() @ b.double()
    f32 = tablev.gemm_rms(a @ b, ref)
    for mode in gemm.MODES:
        got = tablev.gemm_rms(gemm.gemm_plain(a, b, mode=mode), ref)
        assert got <= tablev.GEMM_TOL_RMS
        assert got <= 4 * f32, (mode, got, f32)


def test_launch_params_describe_the_tensor_core_launch():
    n = 4096
    nat = gemm.launch_params("native", n, n, n)
    assert nat["grid"] == [32, 32] and nat["block"] == 256
    assert nat["tile"] == [128, 128, 32] and nat["stages"] == 4
    assert nat["smem_bytes"] == 1024 + 4 * 33792 + 2 * 16384 + 4 * 8
    ab = gemm.launch_params("abstract", n, n, n)
    assert ab["grid"] == [64, 64] and ab["block"] == 128
    assert ab["tile"] == [64, 64, 64] and ab["stages"] == 2
    assert ab["smem_bytes"] == 2 * (64 * 68 + 64 * 72) * 4


def test_tablev_bound_is_the_tensor_core_bound():
    """3 x 2 N^3 TF32 operations at 495 TFLOP/s: 0.83 ms at 4096^3."""
    case = next(c for c in tablev.cases(dict(a=torch.zeros(1, 1),
                                             b=torch.zeros(1, 1), x=None,
                                             x_off=None, v=None, hot=None,
                                             v_off=None))
                if c["kernel"] == "gemm")
    ms, by = tablev.bound_ms(case["bytes"], case["flops"], case["peak"])
    assert by == "operations"
    assert ms == pytest.approx(3 * 2 * 4096 ** 3 / 495e12 * 1e3)
    assert 0.83 <= ms <= 0.84


# ROADMAP C.1: values the rounded split cannot hold.  |x| at or above
# 0x7f7ff000 rounds hi up to inf; an inf gives x - hi = NaN; a NaN whose
# top mantissa bits are all set (the card's own 0x7fffffff) rounds hi to
# -0.  lo = x - hi is truncated, not rounded, so each of these leaves hi
# inf or lo NaN: every product that reads one is not finite, and the
# kernel (and the plain version) sums such an output again in f32.
FLT_MAX = float(np.finfo(np.float32).max)
SPECIAL = [0x7F7FFFFF, 0xFF7FFFFF, 0x7F7FF000, 0x7F800000, 0xFF800000,
           0x7FC00000, 0x7FFFFFFF, 0xFFFFFFFF]


@pytest.mark.parametrize("x", SPECIAL, ids=[f"{x:08x}" for x in SPECIAL])
def test_split_of_values_past_the_rounded_split(x):
    h, l = gemm.split_tf32(_f32([x]))
    assert not (torch.isfinite(h).item() and torch.isfinite(l).item())
    for half in (h, l):                  # still TF32 values
        assert not (half.view(torch.int32) & 0x1FFF).any() or \
            torch.isnan(half).item()


def test_split_below_the_largest_rounded_value():
    """The largest |x| whose hi still rounds to a finite value splits as
    any other: hi + lo within 2^-21 of x, both TF32."""
    for bits in (0x7F7FEFFF, 0xFF7FEFFF, 0x7F7FE000):
        x = _f32([bits])
        h, l = gemm.split_tf32(x)
        assert torch.isfinite(h).item() and torch.isfinite(l).item()
        assert abs(float(h.double() + l.double() - x.double())) <= \
            2.0 ** -21 * abs(float(x.double()))


def _c1_operands(case):
    """(A, B) of one C.1 case: rows of A near FLT_MAX against a (scaled)
    permutation, so that f32 itself neither overflows nor cancels; or a
    non-finite value in A, B or both against random nonzero values."""
    rng = np.random.default_rng(len(case))
    m, k, n = 9, 40, 11
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    b[np.abs(b) < 1e-3] = 1.0          # no zero meets an inf by chance
    if case in ("flt_max", "flt_max_permuted"):
        a[:4] = FLT_MAX
        a[4, :] = -FLT_MAX
        a[5, :] = np.float32(3.4020e38)
        b = np.eye(k, n, dtype=np.float32)
        if case == "flt_max_permuted":
            b = (b[rng.permutation(k)] * np.float32(-0.5)).astype(np.float32)
    elif case == "inf_in_a":
        a[1, 7] = np.inf
        a[3, 30] = -np.inf
    elif case == "inf_in_b":
        b[12, 2] = np.inf
        b[33, 9] = -np.inf
    elif case == "inf_meets_inf":
        a[2, 5] = np.inf
        b[5, 4] = -np.inf
    elif case == "inf_meets_zero":
        a[6, 21] = np.inf
        b[21, 3] = 0.0
    elif case == "nan":
        a[0, 0] = np.nan
        b[39, 10] = np.nan
    return a, b


C1_CASES = ["flt_max", "flt_max_permuted", "inf_in_a", "inf_in_b",
            "inf_meets_inf", "inf_meets_zero", "nan"]


@pytest.mark.parametrize("mode", gemm.MODES)
@pytest.mark.parametrize("case", C1_CASES)
def test_plain_matches_jax_gemm_past_the_rounded_split(case, mode):
    """f32's finite value, inf or NaN, element for element, as the JAX
    ``gemm`` (interpret mode) gives it."""
    a, b = _c1_operands(case)
    want = np.asarray(ref_ops.matmul(jnp.asarray(a), jnp.asarray(b),
                                     mode=mode))
    got = gemm.gemm_plain(torch.from_numpy(a), torch.from_numpy(b),
                          mode=mode).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.isposinf(got), np.isposinf(want))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    assert fin.any() or case == "nan"
    np.testing.assert_allclose(got[fin], want[fin], **TOL)
