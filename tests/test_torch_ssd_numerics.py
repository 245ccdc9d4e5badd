"""The ssd_scan tc route's arithmetic, emulated on the CPU
(``csrc/ssd_scan_tc.cu`` runs only on the card).

On the tc route a chunk's products run on the tensor cores: bf16 operands,
f32 sums.  C.B^T and C.h take bf16 x, B and C as they are, so their
products are exact.  Three operands are f32 values and are rounded on
the way in:

- w = exp(ld_t - ld_s) (C_t . B_s) dt_s, the A operand of w.x: split into
  a bf16 hi + lo pair (two products) where ``kTcScanWSplit`` is true, else
  rounded to bf16, as the attention's tc route rounds P;
- the state h, the B operand of C.h: split hi + lo, written once a chunk;
- B_s wS_s (wS_s = dt_s exp(ld_last - ld_s)), the A operand of the state
  update: split hi + lo.  Rounded to bf16 alone it misses the card test's
  state tolerance (shown below), which is why the split is there.

The state itself stays f32 (the update's accumulator), and the prefix sum
ld is the fma route's (``scan_prefix``; here ``ssd.prefix_sum``, the
plain version's stage of each mode).  This file emulates that chunk by
chunk in f32 (the tensor cores' sums in another f32 order) and holds it:

- against the JAX package's Pallas kernel ``fused_ssd_scan`` in f32 (the
  inputs bf16 values), in interpret mode as the JAX package's own tests run
  it, in native, abstract and abstract+shuffle, at
  ``TOLERANCES["f32_accum"]`` (as ``tests/test_torch_ssd.py`` holds the
  plain version);
- against the port's plain version ``ssd_scan_plain`` in bf16 at the card
  test's tolerances (``tests/test_torch_gpu.py``: y at 2e-2, the f32
  state at 1e-4, each rtol with atol = tol x max|plain|) and at
  ``chip_smoke.py``'s (in every row max|err| <= 2e-2 x max|plain row|,
  relative RMS <= 1e-2), with w split and with w rounded.

``ssd.scan_route``, the mirror of the C entry's choice, is held on its
edges.  Shapes: reduced widths and rows 12 and 12d of PERF.md (80 heads of
64, N 128, chunk 256; 512 tokens, and 300 from an initial state); inputs
from numpy with a seed.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from conftest import tolerance_for
from repro.kernels import ops as ref_ops

from repro_torch.kernels import ssd

ACCUM = tolerance_for("f32_accum")
TOL = {"f32": 1e-4, "bf16": 2e-2}        # tests/test_torch_gpu.py
TOL_ROW, TOL_RMS = 2e-2, 1e-2            # chip_smoke.py phase 3
MODES = ("native", "abstract", "abstract+shuffle")
SOURCE = (Path(ssd.__file__).resolve().parents[1] / "csrc"
          / "ssd_scan_tc.cu")
#: b, l, h, p, g, n, chunk, initial state
SHAPES = {
    "reduced_g2": (2, 37, 4, 16, 2, 16, 16, True),
    "reduced_n32": (1, 100, 6, 32, 3, 32, 32, False),
    "row12": (1, 512, 80, 64, 1, 128, 256, False),
    "row12d": (1, 300, 80, 64, 1, 128, 256, True),
}
FULL = ("row12", "row12d")


def built_w_split() -> bool:
    """Whether the built kernel splits w (``kTcScanWSplit``)."""
    m = re.search(r"constexpr bool kTcScanWSplit = (true|false);",
                  SOURCE.read_text())
    assert m, "kTcScanWSplit not found in ssd_scan_tc.cu"
    return m.group(1) == "true"


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _split(t):
    """(hi, lo): t rounded to bf16, and the rest rounded to bf16."""
    hi = _bf16(t)
    return hi, _bf16(t - hi)


def tc_scan_emulation(x, dt, A, Bm, Cm, h0, chunk, mode, *, w_split,
                      operand_split=True):
    """The tc route's y [B,L,H,P] (f32, before the output's rounding) and
    final state f32 [B,G,Hg,N,P], chunk by chunk, rounding where the kernel
    rounds.  x, B and C hold bf16 values (any float dtype)."""
    b, l, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    hg = h // g
    q = ssd.resolve_chunk(l, chunk)
    pad = (-l) % q
    xf, dtf = x.float(), dt.float()
    Bf, Cf = Bm.float(), Cm.float()
    if pad:
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        Bf = F.pad(Bf, (0, 0, 0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, 0, 0, pad))
    nc = (l + pad) // q
    xf = xf.reshape(b, nc, q, g, hg, p)
    dtf = dtf.reshape(b, nc, q, g, hg)
    Bf, Cf = Bf.reshape(b, nc, q, g, n), Cf.reshape(b, nc, q, g, n)
    ld = ssd.prefix_sum(dtf * A.float().reshape(g, hg), mode)
    state = (torch.zeros(b, g, hg, n, p) if h0 is None else h0.float())
    has_state = h0 is not None
    causal = torch.tril(torch.ones(q, q, dtype=torch.bool))
    ys = []
    for c in range(nc):
        xq, dtq, ldq, Bq, Cq = xf[:, c], dtf[:, c], ld[:, c], Bf[:, c], \
            Cf[:, c]
        # S = C.B^T: bf16 products, exact in f32
        S = torch.einsum("bqgn,bsgn->bgqs", Cq, Bq).permute(0, 2, 3, 1)
        diff = ldq[:, :, None] - ldq[:, None]           # [B,Qt,Qs,G,Hg]
        decay = torch.exp(torch.where(causal[None, :, :, None, None], diff,
                                      float("-inf")))
        w = decay * S[..., None] * dtq[:, None]
        w_parts = _split(w) if w_split else (_bf16(w),)
        y = sum(torch.einsum("bqsgh,bsghp->bqghp", wp, xq) for wp in w_parts)
        if has_state:
            ch = sum(torch.einsum("bqgn,bghnp->bqghp", Cq, hp)
                     for hp in _split(state))
            y = ch * torch.exp(ldq)[..., None] + y
        total = ldq[:, -1]                              # [B,G,Hg]
        wS = dtq * torch.exp(total[:, None] - ldq)      # [B,Q,G,Hg]
        v = Bq[:, :, :, None, :] * wS[..., None]        # [B,Q,G,Hg,N]
        v_parts = _split(v) if operand_split else (_bf16(v),)
        s_c = sum(torch.einsum("bsghn,bsghp->bghnp", vp, xq)
                  for vp in v_parts)
        state = torch.exp(total)[..., None, None] * state + s_c
        has_state = True
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(b, nc * q, h, p)[:, :l]
    return y, state


def _inputs(seed, b, l, h, p, g, n, init):
    """bf16-representable f32 x, B, C (the model's magnitudes: C.B O(1)),
    dt = softplus(.) > 0, A < 0, h0 f32."""
    rng = np.random.default_rng(seed)

    def bf(a):
        return _bf16(torch.from_numpy(a.astype(np.float32))).numpy()
    x = bf(rng.standard_normal((b, l, h, p)))
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)) - 2.0)
                  ).astype(np.float32)
    A = -np.exp(rng.uniform(0.0, np.log(16.0), h)).astype(np.float32)
    Bm = bf(rng.standard_normal((b, l, g, n)) * n ** -0.25)
    Cm = bf(rng.standard_normal((b, l, g, n)) * n ** -0.25)
    h0 = (rng.standard_normal((b, g, h // g, n, p)).astype(np.float32)
          if init else None)
    return x, dt, A, Bm, Cm, h0


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _close(out, ref, tol):
    """tests/test_torch_gpu.py's check: rtol = tol, atol = tol x max|ref|."""
    ref = ref.float()
    torch.testing.assert_close(out.float(), ref, rtol=tol,
                               atol=tol * float(ref.abs().max()) + 1e-6)


def _row_rms(out, ref):
    """chip_smoke.compare's row-relative and relative RMS errors."""
    o = out.float().reshape(-1, out.shape[-1])
    r = ref.float().reshape(-1, ref.shape[-1])
    d = (o - r).abs()
    row = float((d.amax(dim=1) / r.abs().amax(dim=1).clamp_min(1e-30)).max())
    rms = float(torch.linalg.vector_norm(o - r)
                / torch.linalg.vector_norm(r).clamp_min(1e-30))
    return row, rms


def test_the_source_sets_the_w_split_flag():
    assert isinstance(built_w_split(), bool)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_emulation_matches_jax_kernel_in_f32(shape, mode):
    b, l, h, p, g, n, chunk, init = SHAPES[shape]
    x, dt, A, Bm, Cm, h0 = _inputs(l + n, b, l, h, p, g, n, init)
    y, state = tc_scan_emulation(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm),
                                 _t(h0), chunk, mode, w_split=built_w_split())
    y_j, state_j = ref_ops.fused_ssd_scan(
        jnp.asarray(x), jnp.asarray(dt), jnp.asarray(A), jnp.asarray(Bm),
        jnp.asarray(Cm), chunk=chunk, mode=mode,
        initial_state=None if h0 is None else jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **ACCUM)
    np.testing.assert_allclose(state.numpy(), np.asarray(state_j), **ACCUM)


@pytest.mark.parametrize("w_split", [True, False], ids=["w_split",
                                                         "w_rounded"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_emulation_matches_plain_in_bf16(shape, mode, w_split):
    b, l, h, p, g, n, chunk, init = SHAPES[shape]
    x, dt, A, Bm, Cm, h0 = _inputs(l + n + 1, b, l, h, p, g, n, init)
    bf = torch.bfloat16
    xb, Bb, Cb = _t(x).to(bf), _t(Bm).to(bf), _t(Cm).to(bf)
    y_ref, state_ref = ssd.ssd_scan_plain(xb, _t(dt), _t(A), Bb, Cb,
                                          _t(h0), chunk=chunk, mode=mode)
    y, state = tc_scan_emulation(xb, _t(dt), _t(A), Bb, Cb, _t(h0), chunk,
                                 mode, w_split=w_split)
    y = y.to(bf)
    _close(y, y_ref, TOL["bf16"])
    _close(state, state_ref, TOL["f32"])
    for out, ref in ((y, y_ref), (state, state_ref)):
        row, rms = _row_rms(out, ref)
        assert row <= TOL_ROW and rms <= TOL_RMS, (row, rms)


@pytest.mark.parametrize("shape", FULL)
def test_update_operand_rounded_to_bf16_misses_the_state_tolerance(shape):
    """The update's f32 operand B wS as one bf16 value moves the final state
    about 2e-3 of its max: twenty times the card test's 1e-4.  As a hi + lo
    pair it stays well inside."""
    b, l, h, p, g, n, chunk, init = SHAPES[shape]
    x, dt, A, Bm, Cm, h0 = _inputs(l + n + 2, b, l, h, p, g, n, init)
    args = (_t(x), _t(dt), _t(A), _t(Bm), _t(Cm), _t(h0), chunk, "native")
    _, ref = ssd.ssd_scan_plain(*args[:6], chunk=chunk)
    _, split = tc_scan_emulation(*args, w_split=built_w_split())
    _, rounded = tc_scan_emulation(*args, w_split=built_w_split(),
                                   operand_split=False)
    scale = float(ref.abs().max())
    err_split = float((split - ref).abs().max()) / scale
    err_rounded = float((rounded - ref).abs().max()) / scale
    assert err_split < 0.1 * TOL["f32"], err_split
    assert err_rounded > 5 * TOL["f32"], err_rounded
    _close(split, ref, TOL["f32"])
    with pytest.raises(AssertionError):
        _close(rounded, ref, TOL["f32"])


def _projection(l, h, p, n, offset=0, extra=0):
    """x, B and C as the model slices them out of one [1, L, H*P + 2N]
    projection (``models/ssd.py``), ``offset`` elements into each row,
    ``extra`` more elements a row."""
    width = h * p + 2 * n + offset + extra
    xbc = torch.zeros(1, l, width, dtype=torch.bfloat16)
    o = offset
    return (xbc[..., o:o + h * p].reshape(1, l, h, p),
            xbc[..., o + h * p:o + h * p + n].reshape(1, l, 1, n),
            xbc[..., o + h * p + n:o + h * p + 2 * n].reshape(1, l, 1, n))


def _contiguous(l, h, p, g, n, dtype=torch.bfloat16):
    return (torch.zeros(1, l, h, p, dtype=dtype),
            torch.zeros(1, l, g, n, dtype=dtype),
            torch.zeros(1, l, g, n, dtype=dtype))


def _offset_by_one(t):
    """``t``'s values one element into a larger buffer: its base 2 bytes off
    16, its rows as they were."""
    buf = torch.zeros(t.numel() + 1, dtype=t.dtype)
    return buf[1:].view(t.shape)


@pytest.mark.parametrize("case,want", [
    ("mamba2_contiguous", "tc"),
    ("mamba2_projection_slices", "tc"),
    ("reduced_widths", "tc"),
    ("f32", "fma"),
    ("n_off_grid", "fma"),
    ("p_off_grid", "fma"),
    ("x_base_off_16_bytes", "fma"),
    ("b_base_off_16_bytes", "fma"),
    ("c_base_off_16_bytes", "fma"),
    ("projection_shifted_by_one", "fma"),
    ("projection_row_off_16_bytes", "fma"),
])
def test_scan_route_edges(case, want):
    x, B, C = {
        "mamba2_contiguous": lambda: _contiguous(64, 80, 64, 1, 128),
        "mamba2_projection_slices": lambda: _projection(64, 80, 64, 128),
        "reduced_widths": lambda: _contiguous(37, 4, 16, 2, 16),
        "f32": lambda: _contiguous(64, 80, 64, 1, 128, torch.float32),
        "n_off_grid": lambda: _contiguous(64, 4, 16, 1, 24),
        "p_off_grid": lambda: _contiguous(64, 4, 20, 1, 16),
        "x_base_off_16_bytes": lambda: (
            lambda x, B, C: (_offset_by_one(x), B, C))(
                *_contiguous(64, 4, 16, 1, 16)),
        "b_base_off_16_bytes": lambda: (
            lambda x, B, C: (x, _offset_by_one(B), C))(
                *_contiguous(64, 4, 16, 1, 16)),
        "c_base_off_16_bytes": lambda: (
            lambda x, B, C: (x, B, _offset_by_one(C)))(
                *_contiguous(64, 4, 16, 1, 16)),
        "projection_shifted_by_one": lambda: _projection(64, 4, 16, 16,
                                                         offset=1),
        "projection_row_off_16_bytes": lambda: _projection(64, 4, 16, 16,
                                                           extra=4),
    }[case]()
    assert ssd.scan_route(x, B, C) == want
