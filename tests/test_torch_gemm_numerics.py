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
