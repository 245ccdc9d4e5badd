"""The arithmetic of flash_attention_matmul's tensor-core route, emulated in
plain PyTorch on the CPU (``csrc/attention_tc.cuh`` + ``csrc/tc_gemm.cuh``
run only on the card).

The route walks 64-key tiles with an online softmax in f32 (running max
from -1e30, scores past the diagonal at -1e30, the row sum of the f32
probabilities), rounds P to the working dtype before P.V (f32 sums),
stores O = acc / l rounded to the working dtype, and then takes one
``O @ wo`` product over all heads, with no per-group partials.  The
emulation is held against:

- the JAX package's Pallas ``flash_attention_matmul`` in f32, in interpret
  mode as its own tests run it, at ``TOLERANCES["f32"]`` (in f32 the
  rounding of P is exact, so only the order of the sums differs);
- the port's plain version in bf16 at granite-8b's head shape (32/8 heads
  of 128, 128-300 tokens, wo [4096, 4096]) and granite-moe's (24/8 of 64,
  wo [1536, 1536]), within ``chip_smoke.py`` phase 3's two tolerances (in
  every output row max|err| <= 2e-2 x max|plain row|, and relative RMS
  <= 1e-2): rounding P to bf16 fits them before any card time is spent.

The cases cover the causal mask at ``kv_offset`` 0 and above (Sq < Skv,
and an offset other than Skv - Sq) and ragged last query and key tiles.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tolerance_for
from repro.kernels import fused as ref_fused

from repro_torch.kernels import fused

KV_TILE = 64
NEG = -1e30
TOL_ROW, TOL_RMS = 2e-2, 1e-2          # chip_smoke.py phase 3


def tc_route_emulation(q, k, v, wo, *, kv_offset=None):
    """[B, Sq, N] in q's dtype, by the tensor-core route's arithmetic."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    off = skv - sq if kv_offset is None else kv_offset
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
    o = (acc / torch.where(l == 0, torch.ones_like(l), l)).to(q.dtype)
    o = o.transpose(1, 2).reshape(b, sq, h * d)
    return (o.float() @ wo.float()).to(q.dtype)


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
