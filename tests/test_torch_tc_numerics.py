"""The arithmetic of the tensor-core routes, emulated in plain PyTorch on
the CPU (``csrc/attention_tc.cuh`` + ``csrc/tc_gemm.cuh`` run only on the
card).

flash_attention_matmul's route walks 64-key tiles with an online softmax
in f32 (running max from -1e30, scores past the diagonal at -1e30, the row
sum of the f32 probabilities), rounds P to the working dtype before P.V
(f32 sums), stores O = acc / l rounded to the working dtype, and then takes
one ``O @ wo`` product over all heads, with no per-group partials; with an
int8 wo (flash_attention_matmul_q8) the GEMM widens wo's tiles to bf16,
which is exact, sums in f32 and multiplies each column by its scale in the
epilogue.  rmsnorm_swiglu's route writes the normalized row rounded to the
working dtype, sums it against the wi and wg columns (an int8 w_cat
widened to bf16) in f32, scales the columns in the epilogue (int8), and
stores ``silu(hg) * hi`` computed in f32, rounded once.  Plain
``flash_attention``'s route is the same attention core storing O
[B, H, Sq, D] (causal, with a given ``kv_offset``, or non-causal), and
rmsnorm_matmul_q8's is the normalized row rounded to the working dtype
against the int8 weight widened to bf16, f32 sums, the column scales in the
epilogue.  Each emulation is held against:

- the JAX package's Pallas kernel in f32 (``flash_attention_matmul``,
  ``flash_attention_matmul_q8``, ``rmsnorm_swiglu``, ``rmsnorm_swiglu_q8``,
  ``flash_attention`` at 24/8 heads of 64 and 32/8 of 128, 300 and 512
  tokens, its abstract modes at 300; ``rmsnorm_matmul_q8`` in every mode
  at 300 and 512 rows of 4096 -> 6144),
  in interpret mode as its own tests run it, at ``TOLERANCES["f32"]`` (in
  f32 the roundings are exact, so only the order of the sums differs, and,
  for int8, where the scale is applied: JAX scales the tile before its
  dot);
- the port's plain version in bf16 at granite-8b's shapes (32/8 heads of
  128, 128-300 tokens, wo [4096, 4096]; D 4096 with a narrower F, 300 and
  512 rows, a ragged last column tile) and granite-moe's (24/8 of 64, wo
  [1536, 1536]), within ``chip_smoke.py`` phase 3's two tolerances (in
  every output row max|err| <= 2e-2 x max|plain row|, and relative RMS
  <= 1e-2), before any card time is spent; plain flash_attention's and
  rmsnorm_matmul_q8's routes against the plain version of every mode,
  since their tc route serves each.

The attention cases cover the causal mask at ``kv_offset`` 0 and above
(Sq < Skv, and an offset other than Skv - Sq) and ragged last query and
key tiles.  The kernel's int8 -> bf16 widening (``widen_i8x4``: a byte
placed in the float 2^23, a subtraction, the upper half) is emulated bit
by bit over all 256 values.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tolerance_for
from repro.kernels import attention as ref_attention
from repro.kernels import fused as ref_fused

from repro_torch.kernels import attention, fused

KV_TILE = 64
NEG = -1e30
TOL_ROW, TOL_RMS = 2e-2, 1e-2          # chip_smoke.py phase 3


def tc_attention_emulation(q, k, v, *, causal=True, kv_offset=None):
    """O [B, H, Sq, D] in q's dtype, by the arithmetic of the tensor-core
    attention core (``csrc/attention_tc.cuh``), which plain
    ``flash_attention`` stores as it is; a non-causal call sees every key
    (``kv_offset = Skv``, as the wrapper passes it)."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    off = (skv if not causal else skv - sq if kv_offset is None
           else kv_offset)
    kf = k.repeat_interleave(h // hkv, dim=1).float()
    vf = v.repeat_interleave(h // hkv, dim=1).float()
    qf = q.float()
    m = torch.full((b, h, sq, 1), NEG)
    l = torch.zeros(b, h, sq, 1)
    acc = torch.zeros(b, h, sq, d)
    rows = torch.arange(sq)[:, None] + off
    for kv0 in range(0, skv, KV_TILE):
        kv1 = min(skv, kv0 + KV_TILE)        # keys past Skv weigh nothing
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, kv0:kv1]) * d ** -0.5
        s = s.masked_fill(torch.arange(kv0, kv1)[None, :] > rows, NEG)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(q.dtype).float(), vf[:, :, kv0:kv1])
        m = m_new
    return (acc / torch.where(l == 0, torch.ones_like(l), l)).to(q.dtype)


def tc_route_emulation(q, k, v, wo, *, kv_offset=None, w_scale=None):
    """[B, Sq, N] in q's dtype, by flash_attention_matmul's tensor-core
    route: the attention core's O as [B, Sq, H*D], then one ``O @ wo``; an
    int8 ``wo`` takes its [N] f32 ``w_scale`` on the f32 sums."""
    b, h, sq, d = q.shape
    o = tc_attention_emulation(q, k, v, kv_offset=kv_offset)
    o = o.transpose(1, 2).reshape(b, sq, h * d)
    return _scaled_sums(o, wo, w_scale).to(q.dtype)


def _widened(w):
    """The GEMM's B tile: bf16 as it is, int8 widened to bf16 (exact)."""
    return (w.to(torch.bfloat16) if w.dtype == torch.int8 else w).float()


def _scaled_sums(a, w, w_scale):
    """f32 sums of ``a`` (rounded already) against the widened ``w``, each
    column times its scale after the sum (int8)."""
    out = a.float() @ _widened(w)
    return out if w_scale is None else out * w_scale


def q8_norm_gemm_emulation(x, weight, w_proj, w_scale, *,
                           eps: float = 1e-6, mode: str = "native"):
    """[..., N] in x's dtype, by rmsnorm_matmul_q8's tensor-core route: the
    normalized row rounded to x's dtype (its moment through ``mode``'s
    cross-lane stage), f32 sums against the int8 weight widened to bf16,
    each column times its scale after the sum, rounded."""
    y = fused.rmsnorm_mode(x, weight, eps, mode)
    return _scaled_sums(y, w_proj, w_scale).to(x.dtype)


def swiglu_route_emulation(x, weight, w_cat, *, w_scale=None,
                           eps: float = 1e-6, mode: str = "native"):
    """[..., F] in x's dtype, by rmsnorm_swiglu's tensor-core route: the
    normalized row rounded to x's dtype (its moment through ``mode``'s
    cross-lane stage), f32 sums against wi and wg (int8 widened to bf16,
    the scales [2F] on the sums), ``silu(hg) * hi`` in f32, rounded."""
    y = fused.rmsnorm_mode(x, weight, eps, mode)
    f = w_cat.shape[1] // 2
    si, sg = (None, None) if w_scale is None else (w_scale[:f], w_scale[f:])
    hi = _scaled_sums(y, w_cat[:, :f], si)
    hg = _scaled_sums(y, w_cat[:, f:], sg)
    return (torch.nn.functional.silu(hg) * hi).to(x.dtype)


def widen_i8x4_emulation(q):
    """csrc/tc_gemm.cuh::widen_i8x4 bit by bit: int8 ``q`` -> the bf16 bits
    (uint16) the kernel writes."""
    u = (q.astype(np.int16).astype(np.uint8) ^ np.uint8(0x80)).astype(
        np.uint32)
    f = (np.uint32(0x4B000000) | u).view(np.float32) - np.float32(8388736.0)
    return (f.view(np.uint32) >> np.uint32(16)).astype(np.uint16)


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _inputs(seed, b, h, hkv, sq, skv, d, n):
    rng = np.random.default_rng(seed)
    return (_np(rng, b, h, sq, d), _np(rng, b, hkv, skv, d),
            _np(rng, b, hkv, skv, d),
            _np(rng, h * d, n, scale=(h * d) ** -0.5))


def _phase3_errors(out, ref):
    """(max over rows of max|err row| / max|plain row|, relative RMS), as
    chip_smoke.py's compare."""
    o = out.float().reshape(-1, out.shape[-1])
    r = ref.float().reshape(-1, ref.shape[-1])
    row = ((o - r).abs().amax(1) / r.abs().amax(1).clamp_min(1e-30)).max()
    rms = torch.linalg.vector_norm(o - r) / torch.linalg.vector_norm(r)
    return float(row), float(rms)


@pytest.mark.parametrize("b,h,hkv,sq,skv,d,n,kv_offset", [
    (1, 8, 2, 130, 130, 64, 96, None),      # ragged last query and key tiles
    (1, 4, 1, 70, 150, 128, 64, None),      # kv_offset = Skv - Sq = 80
    (2, 6, 2, 40, 100, 64, 72, 33),         # an offset other than Skv - Sq
    (1, 6, 2, 64, 64, 64, 40, 0),
])
def test_emulation_matches_jax_kernel_in_f32(b, h, hkv, sq, skv, d, n,
                                             kv_offset):
    q, k, v, wo = _inputs(sq + skv + d, b, h, hkv, sq, skv, d, n)
    want = ref_fused.flash_attention_matmul(
        *map(jnp.asarray, (q, k, v, wo)), causal=True, kv_offset=kv_offset,
        interpret=True)
    got = tc_route_emulation(*map(torch.from_numpy, (q, k, v, wo)),
                             kv_offset=kv_offset)
    assert got.shape == (b, sq, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **tolerance_for("f32"))


@pytest.mark.parametrize("h,hkv,d,sq,skv,kv_offset", [
    (32, 8, 128, 128, 128, None),           # granite-8b, one full tile set
    (32, 8, 128, 300, 300, None),           # ragged last tiles
    (32, 8, 128, 100, 230, None),           # kv_offset 130, Sq < Skv
    (32, 8, 128, 150, 200, 21),             # kv_offset not Skv - Sq
    (24, 8, 64, 300, 300, None),            # granite-moe, group 3
    (24, 8, 64, 128, 200, 72),
])
def test_bf16_probabilities_fit_phase3_tolerances(h, hkv, d, sq, skv,
                                                  kv_offset):
    n = h * d
    arrays = _inputs(h + sq + skv, 1, h, hkv, sq, skv, d, n)
    q, k, v, wo = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    got = tc_route_emulation(q, k, v, wo, kv_offset=kv_offset)
    want = fused.flash_attention_matmul_plain(q, k, v, wo,
                                              kv_offset=kv_offset)
    assert got.dtype == want.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()
    row, rms = _phase3_errors(got, want)
    assert row <= TOL_ROW and rms <= TOL_RMS, (row, rms)


def test_widen_i8x4_is_exact_for_every_int8():
    q = np.arange(-128, 128, dtype=np.int8)
    bits = widen_i8x4_emulation(q)
    want = torch.from_numpy(q).to(torch.bfloat16).view(torch.int16).numpy()
    np.testing.assert_array_equal(bits, want.view(np.uint16))
    back = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    np.testing.assert_array_equal(back.float().numpy(), q.astype(np.float32))


def _quantized_np(w):
    """The port's int8 scheme on a numpy weight: (int8, f32 scales)."""
    wq, ws = fused.quantize_weight(torch.from_numpy(w))
    return wq.numpy(), ws.numpy()


@pytest.mark.parametrize("rows,d,f,q8,mode", [
    (40, 256, 96, False, "native"),
    (40, 256, 96, True, "native"),
    (70, 128, 200, False, "native"),         # ragged column tile
    (70, 128, 208, True, "native"),
    (33, 256, 96, False, "abstract"),
    (33, 256, 96, True, "abstract+shuffle"),
])
def test_swiglu_emulation_matches_jax_kernel_in_f32(rows, d, f, q8, mode):
    rng = np.random.default_rng(rows + d + f)
    x, w = _np(rng, rows, d), 1.0 + _np(rng, d, scale=0.1)
    w_cat = _np(rng, d, 2 * f, scale=d ** -0.5)
    w_scale = None
    if q8:
        w_cat, w_scale = _quantized_np(w_cat)
        want = ref_fused.rmsnorm_swiglu_q8(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(w_cat),
            w_scale=jnp.asarray(w_scale), mode=mode, interpret=True)
    else:
        want = ref_fused.rmsnorm_swiglu(jnp.asarray(x), jnp.asarray(w),
                                        jnp.asarray(w_cat), mode=mode,
                                        interpret=True)
    got = swiglu_route_emulation(
        *map(torch.from_numpy, (x, w, w_cat)), mode=mode,
        w_scale=None if w_scale is None else torch.from_numpy(w_scale))
    assert got.shape == (rows, f)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **tolerance_for("f32"))


@pytest.mark.parametrize("b,h,hkv,sq,skv,d,n,kv_offset", [
    (1, 8, 2, 130, 130, 64, 96, None),
    (2, 6, 2, 40, 100, 64, 80, 33),
    (1, 4, 1, 70, 150, 128, 64, None),
])
def test_q8_attention_emulation_matches_jax_kernel_in_f32(b, h, hkv, sq, skv,
                                                         d, n, kv_offset):
    q, k, v, wo = _inputs(sq + skv + n, b, h, hkv, sq, skv, d, n)
    woq, wos = _quantized_np(wo)
    want = ref_fused.flash_attention_matmul_q8(
        *map(jnp.asarray, (q, k, v, woq)), w_scale=jnp.asarray(wos),
        causal=True, kv_offset=kv_offset, interpret=True)
    got = tc_route_emulation(*map(torch.from_numpy, (q, k, v, woq)),
                             kv_offset=kv_offset,
                             w_scale=torch.from_numpy(wos))
    assert got.shape == (b, sq, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **tolerance_for("f32"))


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("rows,f", [
    (300, 512),                             # granite-8b's D, narrower F
    (512, 512),                             # full row tiles
    (300, 1040),                            # a ragged last column tile
])
def test_swiglu_route_fits_phase3_tolerances(rows, f, q8):
    d = 4096
    rng = np.random.default_rng(rows + f)
    x = torch.from_numpy(_np(rng, rows, d)).to(torch.bfloat16)
    w = torch.from_numpy(1.0 + _np(rng, d, scale=0.1)).to(torch.bfloat16)
    w_cat = torch.from_numpy(_np(rng, d, 2 * f, scale=d ** -0.5)).to(
        torch.bfloat16)
    if q8:
        wq, ws = fused.quantize_weight(w_cat)
        got = swiglu_route_emulation(x, w, wq, w_scale=ws)
        want = fused.rmsnorm_swiglu_q8_plain(x, w, wq, ws)
    else:
        got = swiglu_route_emulation(x, w, w_cat)
        want = fused.rmsnorm_swiglu_plain(x, w, w_cat)
    assert got.dtype == want.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()
    row, rms = _phase3_errors(got, want)
    assert row <= TOL_ROW and rms <= TOL_RMS, (row, rms)


@pytest.mark.parametrize("h,hkv,d,sq,skv,kv_offset", [
    (32, 8, 128, 300, 300, None),           # granite-8b, ragged last tiles
    (32, 8, 128, 128, 200, 72),
    (24, 8, 64, 300, 300, None),            # granite-moe, group 3
    (24, 8, 64, 128, 200, 72),
])
def test_q8_attention_route_fits_phase3_tolerances(h, hkv, d, sq, skv,
                                                   kv_offset):
    n = h * d
    arrays = _inputs(h + sq + skv + 1, 1, h, hkv, sq, skv, d, n)
    q, k, v, wo = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    woq, wos = fused.quantize_weight(wo)
    got = tc_route_emulation(q, k, v, woq, kv_offset=kv_offset, w_scale=wos)
    want = fused.flash_attention_matmul_q8_plain(q, k, v, woq, wos,
                                                 kv_offset=kv_offset)
    assert got.dtype == want.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()
    row, rms = _phase3_errors(got, want)
    assert row <= TOL_ROW and rms <= TOL_RMS, (row, rms)


# plain flash_attention's route (the attention core storing O [B,H,Sq,D])
# and rmsnorm_matmul_q8's (norm_rows_kernel, then the int8 tc_gemm)

ATTENTION_SHAPES = [                        # (h, hkv, d, sq, skv, causal,
    (24, 8, 64, 512, 512, True, None),      #  kv_offset): granite-moe
    (24, 8, 64, 300, 300, True, None),      # ragged last tiles, bq 21
    (24, 8, 64, 300, 300, False, None),     # non-causal
    (24, 8, 64, 128, 200, True, 40),        # kv_offset not Skv - Sq
    (32, 8, 128, 512, 512, True, None),     # granite-8b's heads
    (32, 8, 128, 300, 300, True, None),
    (32, 8, 128, 300, 300, False, None),
    (32, 8, 128, 150, 200, True, 21),
]
MODES = ("native", "abstract", "abstract+shuffle")


@pytest.mark.parametrize("h,hkv,d,sq,skv,causal,kv_offset", ATTENTION_SHAPES)
def test_attention_core_matches_jax_flash_attention_in_f32(
        h, hkv, d, sq, skv, causal, kv_offset):
    q, k, v, _ = _inputs(h + sq + skv + d, 1, h, hkv, sq, skv, d, 8)
    want = ref_attention.flash_attention(
        *map(jnp.asarray, (q, k, v)), causal=causal, kv_offset=kv_offset,
        interpret=True)
    got = tc_attention_emulation(*map(torch.from_numpy, (q, k, v)),
                                 causal=causal, kv_offset=kv_offset)
    assert got.shape == (1, h, sq, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **tolerance_for("f32"))


@pytest.mark.parametrize("mode", MODES[1:])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_core_matches_jax_modes_in_f32(mode, causal):
    """The JAX lowering's abstract modes change the row reductions' order
    and walk every key tile, yet in f32 they agree with the core, which
    takes no mode: this holds the JAX side's invariance across modes that
    the card's tc route relies on, not code of the port that reads a mode
    (the bf16 comparison with each mode's plain version is below)."""
    q, k, v, _ = _inputs(7, 1, 24, 8, 300, 300, 64, 8)
    want = ref_attention.flash_attention(
        *map(jnp.asarray, (q, k, v)), causal=causal, mode=mode,
        interpret=True)
    got = tc_attention_emulation(*map(torch.from_numpy, (q, k, v)),
                                 causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **tolerance_for("f32"))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("h,hkv,d,sq,skv,causal,kv_offset", ATTENTION_SHAPES)
def test_attention_core_fits_phase3_tolerances(h, hkv, d, sq, skv, causal,
                                               kv_offset, mode):
    arrays = _inputs(h + sq + skv + 2, 1, h, hkv, sq, skv, d, 8)[:3]
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    got = tc_attention_emulation(q, k, v, causal=causal, kv_offset=kv_offset)
    want = attention.flash_attention_plain(q, k, v, causal=causal,
                                           kv_offset=kv_offset, mode=mode)
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == want.shape == (1, h, sq, d)
    assert torch.isfinite(got.float()).all()
    row, rms = _phase3_errors(got, want)
    assert row <= TOL_ROW and rms <= TOL_RMS, (row, rms)


def _q8_norm_inputs(rows, d, n):
    rng = np.random.default_rng(rows + d + n)
    x, w = _np(rng, rows, d), 1.0 + _np(rng, d, scale=0.1)
    wq, ws = _quantized_np(_np(rng, d, n, scale=d ** -0.5))
    return x, w, wq, ws


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("rows", [300, 512])
def test_q8_norm_gemm_emulation_matches_jax_kernel_in_f32(rows, mode):
    x, w, wq, ws = _q8_norm_inputs(rows, 4096, 6144)
    want = ref_fused.rmsnorm_matmul_q8(
        *map(jnp.asarray, (x, w, wq)), w_scale=jnp.asarray(ws), mode=mode,
        interpret=True)
    got = q8_norm_gemm_emulation(*map(torch.from_numpy, (x, w, wq, ws)),
                                 mode=mode)
    assert got.shape == (rows, 6144)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **tolerance_for("f32"))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("rows", [300, 512])
def test_q8_norm_gemm_route_fits_phase3_tolerances(rows, mode):
    x, w, wq, ws = _q8_norm_inputs(rows, 4096, 6144)
    x, w = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w))
    wq, ws = torch.from_numpy(wq), torch.from_numpy(ws)
    got = q8_norm_gemm_emulation(x, w, wq, ws, mode=mode)
    want = fused.rmsnorm_matmul_q8_plain(x, w, wq, ws, mode=mode)
    assert got.dtype == want.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()
    row, rms = _phase3_errors(got, want)
    assert row <= TOL_ROW and rms <= TOL_RMS, (row, rms)
