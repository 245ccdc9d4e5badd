"""The arithmetic of the attention + wo kernels' decode route, emulated in
plain PyTorch on the CPU (``csrc/attention_decode.cuh`` runs only on the
card).

At decode (one query a slot, a ``pos`` frontier, dense or paged) the route
splits each slot's keys into chunks of whole 64-key tiles (dense) or whole
pages (paged).  Each split walks its keys a tile at a time with the online
softmax in f32 (scores ``q . k / sqrt(D)``, keys past the frontier at
-1e30 where the walk visits them, keys past the walk weighing nothing; the
tile's row max and row sum through the mode's cross-lane stage) and keeps
(m, l, acc).  The splits the slot's walk reaches combine in split order,
``O = sum e_s acc_s / sum e_s l_s`` with ``e_s = exp(m_s - max m)`` (l == 0
-> 1), rounded to the working dtype; then ``O @ wo`` on the decode GEMV:
f32 sums of each K chunk, added in split order, an int8 wo's column scale
on the whole sum.  The walk is attn_group_kernel's: the dense shape under
the abstract modes walks every key, native stops at the frontier (a slot
with ``pos < 0`` averages all keys), the paged shape stops at the frontier
in every mode (a slot with ``pos < 0`` gets 0, as the JAX kernel's
skip_dead gives it).  Int8 pools are widened and multiplied by their
per-token scales in f32, never rounded.  The emulation is held against:

- the JAX package's Pallas kernels ``flash_attention_matmul(pos=...)``,
  its paged path through ``block_tables`` and
  ``flash_attention_matmul_q8`` (int8 wo, int8 pools) in f32, in
  interpret mode as the JAX package's own tests run them, in every mode,
  at ``TOLERANCES["f32"]`` (2e-4: in f32 only the order of the sums
  differs, and, for int8, where the scales apply);
- the port's plain versions in bf16 at granite-8b's widths (32/8 heads of
  128, 8 slots of a 576-key cache, wo [4096, 4096]), granite-moe's (24/8
  of 64) and mistral-large-123b's heads (96/8 of 128, wo's N cut to 512),
  within ``chip_smoke.py`` phase 3's two tolerances.

Groups of 9 to 16 heads run the kernels of group bound GM 16 (512
threads, a warp a head, as the GM 8 kernels): the emulation is the same
for every group.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tolerance_for
from repro.kernels import fused as ref_fused

from repro_torch.kernels import fused
from repro_torch.models.attention import quantize_kv

TOL_ROW, TOL_RMS = 2e-2, 1e-2          # chip_smoke.py phase 3
MODES = ("native", "abstract", "abstract+shuffle")
KT = 64                                # keys a tile
SPLITS_PER_SM, MAX_SPLITS = 4, 64      # csrc/attention_decode.cuh


def plan_chunk(b, hkv, keys, unit, sms=132):
    """csrc/attention_decode.cuh::plan_decode's keys a split: whole units
    (a tile, or a page), about four blocks an SM."""
    units = -(-keys // unit)
    s = max(1, min(-(-SPLITS_PER_SM * sms // (b * hkv)), units, MAX_SPLITS))
    return -(-units // s) * unit


def walk_end(pos, skv, paged, mode):
    """The keys [0, end) each slot's walk visits."""
    p = pos.long()
    if paged:
        return torch.where(p < 0, 0, torch.clamp(p + 1, max=skv))
    if mode != "native":
        return torch.full_like(p, skv)
    return torch.where(p < 0, skv, torch.clamp(p + 1, max=skv))


def _reduce(x, op, mode, fill):
    """A tile's row max or row sum, [..., 64] -> [..., 1], through the
    mode's cross-lane stage."""
    if mode == "native":
        return (x.amax(-1, keepdim=True) if op is torch.maximum
                else x.sum(-1, keepdim=True))
    return fused.row_reduce(x, op, mode, fill)


def gemv(xn, w, w_scale=None, k_chunk=None):
    """x_n [M, K] @ w [K, N] in f32, K chunks added in order, the scales on
    the whole sum."""
    wf = w.float()
    k = wf.shape[0]
    step = k if k_chunk is None else k_chunk
    total = None
    for k0 in range(0, k, step):
        part = xn.float()[:, k0:k0 + step] @ wf[k0:k0 + step]
        total = part if total is None else total + part
    return total if w_scale is None else total * w_scale


def decode_emulation(q, k, v, w_out, *, pos, chunk, block_tables=None,
                     w_scale=None, k_scale=None, v_scale=None,
                     k_chunk=None, mode="native"):
    """[B, 1, N] in q's dtype by the decode route (module docstring);
    ``chunk`` keys a split (a multiple of 64, or of the page size)."""
    paged = block_tables is not None
    if paged:
        k = fused.gather_pages(fused._dequantize_kv_f32(k, k_scale),
                               block_tables)
        v = fused.gather_pages(fused._dequantize_kv_f32(v, v_scale),
                               block_tables)
    kf, vf = k.float(), v.float()
    b, h, _, d = q.shape
    hkv, skv = kf.shape[1], kf.shape[2]
    g = h // hkv
    qf = q.float().reshape(b, hkv, g, d)
    pad = (-skv) % KT
    kf = torch.nn.functional.pad(kf, (0, 0, 0, pad))
    vf = torch.nn.functional.pad(vf, (0, 0, 0, pad))
    end = walk_end(pos, skv, paged, mode)
    p4 = pos.long()[:, None, None, None]
    ms, ls, accs, live = [], [], [], []
    for k0 in range(0, skv, chunk):
        k1 = torch.clamp(end, max=k0 + chunk)[:, None, None, None]
        m = torch.full((b, hkv, g, 1), -1e30)
        l = torch.zeros(b, hkv, g, 1)
        acc = torch.zeros(b, hkv, g, d)
        for t0 in range(k0, min(k0 + chunk, skv), KT):
            cols = torch.arange(t0, t0 + KT)
            kt, vt = kf[:, :, t0:t0 + KT], vf[:, :, t0:t0 + KT]
            sc = torch.einsum("bjgd,bjkd->bjgk", qf, kt) * d ** -0.5
            sc = torch.where(cols > p4, torch.tensor(-1e30), sc)
            sc = torch.where(cols >= k1, torch.tensor(-float("inf")), sc)
            m_new = torch.maximum(m, _reduce(sc, torch.maximum, mode,
                                             -float("inf")))
            p = torch.exp(sc - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + _reduce(p, torch.add, mode, 0.0)
            acc = acc * corr + torch.einsum("bjgk,bjkd->bjgd", p, vt)
            m = m_new
        ms.append(m)
        ls.append(l)
        accs.append(acc)
        live.append((k0 < end)[:, None, None, None])
    big = torch.full_like(ms[0], -float("inf"))
    for m, on in zip(ms, live):
        big = torch.where(on, torch.maximum(big, m), big)
    big = torch.where(torch.isinf(big), torch.zeros_like(big), big)
    L = torch.zeros_like(ls[0])
    A = torch.zeros_like(accs[0])
    for m, l, acc, on in zip(ms, ls, accs, live):      # split order
        e = torch.where(on, torch.exp(m - big), torch.zeros_like(m))
        L = L + e * l
        A = A + e * acc
    o = (A / torch.where(L == 0, torch.ones_like(L), L)).to(q.dtype)
    out = gemv(o.reshape(b, h * d), w_out, w_scale, k_chunk)
    return out.to(q.dtype)[:, None, :]


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _phase3_errors(out, ref):
    """(max over rows of max|err row| / max|plain row|, relative RMS), as
    chip_smoke.py's compare."""
    o = out.float().reshape(-1, out.shape[-1])
    r = ref.float().reshape(-1, ref.shape[-1])
    row = ((o - r).abs().amax(1) / r.abs().amax(1).clamp_min(1e-30)).max()
    rms = torch.linalg.vector_norm(o - r) / torch.linalg.vector_norm(r)
    return float(row), float(rms)


def _jax(q, k, v, wo, mode, **kw):
    kw = {name: jnp.asarray(t) for name, t in kw.items() if t is not None}
    fn = (ref_fused.flash_attention_matmul_q8 if "w_scale" in kw
          else ref_fused.flash_attention_matmul)
    return np.asarray(fn(*map(jnp.asarray, (q, k, v, wo)), mode=mode,
                         interpret=True, **kw))


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


# (h, hkv, d, n, skv, pos, chunk): G 3 at D 64, G 4 at D 128, G 2 at the
# reduced configs' D 16, G 12 (mistral-large-123b's group, the GM 16
# kernels) at D 16.  Frontiers: 191 and 63 end the walk on a split
# boundary (the next split empty under native), 5 leaves the later split
# past the frontier, 199 the last key of 200 and chunks of 192 and 128 do
# not divide the keys, -1 masks every key: the walk averages all Skv keys,
# where JAX's kernel averages its padded key blocks, so such a case keeps
# Skv a multiple of 128.
DENSE = [(6, 2, 64, 96, 256, (191, 255, -1), 192),
         (8, 2, 128, 48, 200, (5, 127, 199), 128),
         (4, 2, 16, 64, 128, (-1, 63, 127), 64),
         (24, 2, 16, 32, 128, (-1, 63, 127), 64)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("h,hkv,d,n,skv,pos,chunk", DENSE)
def test_dense_pos_emulation_matches_jax_kernel_in_f32(h, hkv, d, n, skv,
                                                       pos, chunk, q8, mode):
    rng = np.random.default_rng(h * d + skv)
    b = len(pos)
    q, k, v = _np(rng, b, h, 1, d), _np(rng, b, hkv, skv, d), \
        _np(rng, b, hkv, skv, d)
    wo = _np(rng, h * d, n, scale=(h * d) ** -0.5)
    ws = None
    if q8:
        wq, s = fused.quantize_weight(torch.from_numpy(wo))
        wo, ws = wq.numpy(), s.numpy()
    pos = np.asarray(pos, np.int32)
    want = _jax(q, k, v, wo, mode, pos=pos, w_scale=ws)
    got = decode_emulation(*map(_t, (q, k, v, wo)), pos=_t(pos), chunk=chunk,
                           w_scale=_t(ws), k_chunk=h * d // 2, mode=mode)
    assert got.shape == want.shape == (b, 1, n)
    np.testing.assert_allclose(got.numpy(), want, **tolerance_for("f32"))


def _paged(rng, b, h, hkv, d, ps, maxp, num_pages, kv8):
    """q, pools and a table with a sentinel entry (``num_pages``, clamped
    to the last page) on slot 1 past its frontier."""
    q = _np(rng, b, h, 1, d)
    kp, vp = _np(rng, num_pages, hkv, ps, d), _np(rng, num_pages, hkv, ps, d)
    ks = vs = None
    if kv8:
        (kq, ks), (vq, vs) = quantize_kv(torch.from_numpy(kp)), \
            quantize_kv(torch.from_numpy(vp))
        kp, ks, vp, vs = kq.numpy(), ks.numpy(), vq.numpy(), vs.numpy()
    tables = rng.permutation(num_pages)[:b * maxp].reshape(b, maxp)
    tables = np.asarray(tables, np.int32)
    tables[1, -1] = num_pages
    return q, kp, vp, ks, vs, tables


# (h, hkv, d, n, ps, maxp, pos, pages a split, modes): pages of 64 (native
# alone: the abstract modes need 128) and of 128; groups 4, 3, 2, then 12
# and 16 (the GM 16 kernels).
# Frontiers: a page
# boundary (127 with two pages a split: the second split's first key is
# 128), a split past the frontier, -1 (no key: 0), the last key.
PAGED = [(8, 2, 128, 48, 64, 5, (127, 70, -1, 319), 2, ("native",)),
         (6, 2, 64, 96, 128, 3, (255, 10, -1, 383), 1, MODES),
         (4, 2, 16, 64, 128, 2, (127, 5, 255, -1), 1, MODES),
         (24, 2, 16, 32, 128, 2, (127, 5, 255, -1), 1, MODES),
         (32, 2, 16, 32, 128, 2, (127, 5, 255, -1), 1, MODES)]


@pytest.mark.parametrize("kind", ["float", "q8_wo", "q8_kv"])
@pytest.mark.parametrize("h,hkv,d,n,ps,maxp,pos,per,modes", PAGED)
def test_paged_emulation_matches_jax_kernel_in_f32(h, hkv, d, n, ps, maxp,
                                                   pos, per, modes, kind):
    rng = np.random.default_rng(h * d + ps)
    b = len(pos)
    q, kp, vp, ks, vs, tables = _paged(rng, b, h, hkv, d, ps, maxp,
                                       b * maxp + 1, kind == "q8_kv")
    wo = _np(rng, h * d, n, scale=(h * d) ** -0.5)
    ws = None
    if kind != "float":
        wq, s = fused.quantize_weight(torch.from_numpy(wo))
        wo, ws = wq.numpy(), s.numpy()
    pos = np.asarray(pos, np.int32)
    for mode in modes:
        want = _jax(q, kp, vp, wo, mode, pos=pos, block_tables=tables,
                    w_scale=ws, k_scale=ks, v_scale=vs)
        got = decode_emulation(*map(_t, (q, kp, vp, wo)), pos=_t(pos),
                               chunk=per * ps, block_tables=_t(tables),
                               w_scale=_t(ws), k_scale=_t(ks),
                               v_scale=_t(vs), mode=mode)
        assert got.shape == want.shape == (b, 1, n)
        np.testing.assert_allclose(got.numpy(), want, **tolerance_for("f32"))
        assert not got[2 if pos[2] < 0 else 3].any()    # pos < 0: zero


# ROADMAP C.2: the paged plain versions, which the CPU runs for every
# route (and which the card's fma route follows), against the JAX kernel:
# a slot with pos < 0 gets 0 there too, in every mode and int8 form, while
# the library row keeps averaging every key.
@pytest.mark.parametrize("kind", ["float", "q8_wo", "q8_kv"])
@pytest.mark.parametrize("ps,modes", [(64, ("native",)), (128, MODES)])
def test_paged_plain_slot_below_zero_matches_jax_kernel(ps, modes, kind):
    rng = np.random.default_rng(ps + len(kind))
    b, h, hkv, d, n, maxp = 4, 6, 2, 64, 40, 3
    q, kp, vp, ks, vs, tables = _paged(rng, b, h, hkv, d, ps, maxp,
                                       b * maxp + 1, kind == "q8_kv")
    wo = _np(rng, h * d, n, scale=(h * d) ** -0.5)
    ws = None
    if kind != "float":
        wq, s = fused.quantize_weight(torch.from_numpy(wo))
        wo, ws = wq.numpy(), s.numpy()
    pos = np.asarray((ps + 3, -1, 2 * ps - 1, -7), np.int32)
    for mode in modes:
        want = _jax(q, kp, vp, wo, mode, pos=pos, block_tables=tables,
                    w_scale=ws, k_scale=ks, v_scale=vs)
        if kind == "float":
            got = fused.flash_attention_matmul(
                *map(_t, (q, kp, vp, wo)), block_tables=_t(tables),
                pos=_t(pos), mode=mode)
        else:
            got = fused.flash_attention_matmul_q8(
                *map(_t, (q, kp, vp, wo)), block_tables=_t(tables),
                pos=_t(pos), w_scale=_t(ws), k_scale=_t(ks), v_scale=_t(vs),
                mode=mode)
        assert not want[[1, 3]].any()
        assert not got[[1, 3]].any()
        np.testing.assert_allclose(got.numpy(), want, **tolerance_for("f32"))
    if kind == "float":
        lib = fused.flash_attention_matmul_plain(
            *map(_t, (q, kp, vp, wo)), block_tables=_t(tables), pos=_t(pos))
        assert lib[[1, 3]].abs().amax() > 0         # the library averages


def test_split_partials_combine_to_one_walk():
    """Splitting the keys changes only the order of the sums: in f32 every
    chunk gives the single walk's output within 1e-6."""
    rng = np.random.default_rng(11)
    b, h, hkv, d, n, skv = 3, 8, 2, 64, 40, 300
    q, k, v = (torch.from_numpy(_np(rng, *s)) for s in
               ((b, h, 1, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    wo = torch.from_numpy(_np(rng, h * d, n, scale=(h * d) ** -0.5))
    pos = torch.tensor([64, 299, 17], dtype=torch.int32)
    whole = decode_emulation(q, k, v, wo, pos=pos, chunk=320)
    for chunk in (64, 128, 192):
        got = decode_emulation(q, k, v, wo, pos=pos, chunk=chunk)
        torch.testing.assert_close(got, whole, rtol=1e-6, atol=1e-6)


def test_plan_splits_granite_decode():
    """The split plan at granite-8b's decode (8 slots, 8 kv groups, 132
    SMs): 9 splits of one tile of a 576-key cache, one page of 64 or 128."""
    assert plan_chunk(8, 8, 576, KT) == 64
    assert plan_chunk(8, 8, 9 * 64, 64) == 64
    assert plan_chunk(8, 8, 5 * 128, 128) == 128
    assert plan_chunk(2, 2, 32, 8) == 8
    assert plan_chunk(1, 8, 32768, KT) == 512


def test_plan_splits_large_decode():
    """mistral-large-123b's decode (8 slots, 8 kv groups of 12 heads, 132
    SMs): the plan takes no G, so its splits are granite-8b's (9 of one
    page of 64 or 128, or one tile of the 576-key cache); its partials
    hold 12 heads a (slot, group, split), 1.5 times granite-8b's."""
    assert plan_chunk(8, 8, 9 * 64, 64) == 64
    assert plan_chunk(8, 8, 5 * 128, 128) == 128
    assert plan_chunk(8, 8, 576, KT) == 64
    splits = -(-576 // plan_chunk(8, 8, 576, KT))
    assert splits == 9
    words = {g: 8 * 8 * splits * g * (128 + 2) for g in (4, 12)}
    assert words[12] == 3 * words[4] == 898560


# bf16 at the served widths: (h, hkv, d, n), granite-8b and granite-moe;
# mistral-large-123b's 96/8 heads of 128 with wo's N cut to 512
SERVED = [(32, 8, 128, 4096), (24, 8, 64, 1536), (96, 8, 128, 512)]


def _served_inputs(h, hkv, d, n, seed, pages=None, kv8=False):
    g = torch.Generator().manual_seed(seed)
    bf = torch.bfloat16
    b, max_len = 8, 576

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(bf)
    rng = np.random.default_rng(seed)
    pos = torch.from_numpy(rng.integers(128, max_len - 32, b).astype(
        np.int32))
    q, wo = rand(b, h, 1, d), rand(h * d, n, scale=(h * d) ** -0.5)
    if pages is None:
        return q, rand(b, hkv, max_len, d), rand(b, hkv, max_len, d), wo, \
            pos, None, None, None
    maxp = -(-max_len // pages)
    kp, vp = rand(b * maxp, hkv, pages, d), rand(b * maxp, hkv, pages, d)
    ks = vs = None
    if kv8:
        (kp, ks), (vp, vs) = quantize_kv(kp), quantize_kv(vp)
    tables = torch.from_numpy(rng.permutation(b * maxp).astype(np.int32)
                              .reshape(b, maxp))
    return q, kp, vp, wo, pos, tables, ks, vs


# every form in every mode, but pages of 64 in native alone (outside native
# a page holds a multiple of 128 keys)
FORMS = [(form, mode) for form in ("pos", "pos_q8", "paged64", "paged128",
                                   "paged128_q8")
         for mode in MODES if form != "paged64" or mode == "native"]


@pytest.mark.parametrize("form,mode", FORMS)
@pytest.mark.parametrize("h,hkv,d,n", SERVED)
def test_decode_route_fits_phase3_tolerances(h, hkv, d, n, form, mode):
    pages = {"paged64": 64, "paged128": 128, "paged128_q8": 128}.get(form)
    q, k, v, wo, pos, tables, ks, vs = _served_inputs(
        h, hkv, d, n, h + d + (pages or 0), pages, kv8=form == "paged128_q8")
    ws = None
    if form.endswith("q8"):
        wo, ws = fused.quantize_weight(wo)
    b = q.shape[0]
    chunk = plan_chunk(b, hkv, k.shape[2] if pages is None
                       else tables.shape[1] * pages, pages or KT)
    got = decode_emulation(q, k, v, wo, pos=pos, chunk=chunk,
                           block_tables=tables, w_scale=ws, k_scale=ks,
                           v_scale=vs, k_chunk=h * d // 4, mode=mode)
    if ws is None:
        want = fused.flash_attention_matmul_plain(
            q, k, v, wo, pos=pos, block_tables=tables, mode=mode)
    else:
        want = fused.flash_attention_matmul_q8_plain(
            q, k, v, wo, ws, pos=pos, block_tables=tables, k_scale=ks,
            v_scale=vs, mode=mode)
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == want.shape == (b, 1, n)
    assert torch.isfinite(got.float()).all()
    row, rms = _phase3_errors(got, want)
    assert row <= TOL_ROW and rms <= TOL_RMS, (row, rms)
