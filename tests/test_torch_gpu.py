"""The port's hand-written CUDA kernels on the card (skipped without one).

Each kernel is held against its plain PyTorch version on the same CUDA
inputs, in f32 and bf16.  Tolerances: f32 differs only in summation order
(rtol 1e-4, atol 1e-4 x max|plain|); bf16 rounds its output (and the
attention output before wo) once, where the plain version may round in
other places (rtol 2e-2, atol 2e-2 x max|plain|).  The SSD kernels keep
their state in f32 in both dtypes.

Run on a machine with the card (``--noconftest``: tests/conftest.py
imports JAX, which the port does not need):
``PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import fused, gemm, histogram, ops, reduction, ssd
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig, ParallelConfig, SSMConfig
from repro_torch.serve import BatchedEngine, Request, ServeConfig

pytestmark = pytest.mark.gpu

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
TOL = {"f32": 1e-4, "bf16": 2e-2}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(gen, shape, dtype, dev, scale=1.0):
    t = torch.randn(shape, generator=gen, dtype=torch.float32) * scale
    return t.to(dev).to(dtype)


def _close(out, ref, tol_name):
    tol = TOL[tol_name]
    ref = ref.float()
    torch.testing.assert_close(out.float(), ref, rtol=tol,
                               atol=tol * float(ref.abs().max()) + 1e-6)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("rows,d,n", [(1, 256, 320), (8, 4096, 6144),
                                      (100, 512, 200), (8, 256, 50000),
                                      (300, 4096, 6144), (520, 512, 6000)])
def test_rmsnorm_matmul_matches_plain(cuda, dt, rows, d, n):
    gen = torch.Generator().manual_seed(rows + n)
    dtype = DTYPES[dt]
    x = _rand(gen, (rows, d), dtype, cuda)
    w = _rand(gen, (d,), dtype, cuda)
    W = _rand(gen, (d, n), dtype, cuda, d ** -0.5)
    before = fused.LAUNCHES["rmsnorm_matmul"]
    out = fused.rmsnorm_matmul(x, w, W)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["rmsnorm_matmul"] == before + 1
    _close(out, fused.rmsnorm_matmul_plain(x, w, W), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("rows,d,f", [(3, 256, 96), (8, 4096, 1024),
                                      (70, 512, 330), (300, 512, 7000)])
def test_rmsnorm_swiglu_matches_plain(cuda, dt, rows, d, f):
    gen = torch.Generator().manual_seed(rows + f)
    dtype = DTYPES[dt]
    x = _rand(gen, (rows, d), dtype, cuda)
    w = _rand(gen, (d,), dtype, cuda)
    w_cat = _rand(gen, (d, 2 * f), dtype, cuda, d ** -0.5)
    out = fused.rmsnorm_swiglu(x, w, w_cat)
    torch.cuda.synchronize()
    _close(out, fused.rmsnorm_swiglu_plain(x, w, w_cat), dt)


def _attn_inputs(gen, dtype, dev, b, h, hkv, sq, skv, d, n):
    q = _rand(gen, (b, h, sq, d), dtype, dev)
    k = _rand(gen, (b, hkv, skv, d), dtype, dev)
    v = _rand(gen, (b, hkv, skv, d), dtype, dev)
    wo = _rand(gen, (h * d, n), dtype, dev, (h * d) ** -0.5)
    return q, k, v, wo


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,h,hkv,sq,skv,d,n,kv_offset", [
    (1, 8, 2, 100, 100, 64, 200, None),
    (2, 4, 4, 37, 70, 128, 96, None),
    (1, 32, 8, 130, 130, 128, 256, None),
    (1, 32, 8, 300, 300, 128, 512, None),
    (2, 4, 1, 20, 50, 32, 64, 10),
])
def test_flash_attention_matmul_causal(cuda, dt, b, h, hkv, sq, skv, d, n,
                                       kv_offset):
    gen = torch.Generator().manual_seed(sq * skv)
    q, k, v, wo = _attn_inputs(gen, DTYPES[dt], cuda, b, h, hkv, sq, skv,
                               d, n)
    out = fused.flash_attention_matmul(q, k, v, wo, kv_offset=kv_offset)
    torch.cuda.synchronize()
    _close(out, fused.flash_attention_matmul_plain(q, k, v, wo,
                                                   kv_offset=kv_offset), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_attention_matmul_pos(cuda, dt):
    gen = torch.Generator().manual_seed(7)
    q, k, v, wo = _attn_inputs(gen, DTYPES[dt], cuda, 4, 8, 2, 1, 200, 128,
                               300)
    pos = torch.tensor([0, 77, 199, -1], dtype=torch.int32, device=cuda)
    before = fused.LAUNCHES["flash_attention_matmul_pos"]
    out = fused.flash_attention_matmul(q, k, v, wo, pos=pos)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["flash_attention_matmul_pos"] == before + 1
    _close(out, fused.flash_attention_matmul_plain(q, k, v, wo, pos=pos), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("page_size", [16, 64])
def test_paged_attention_matmul(cuda, dt, page_size):
    gen = torch.Generator().manual_seed(page_size)
    dtype = DTYPES[dt]
    b, h, hkv, d, n, num_pages, maxp = 4, 8, 2, 128, 256, 12, 5
    q = _rand(gen, (b, h, 1, d), dtype, cuda)
    kp = _rand(gen, (num_pages, hkv, page_size, d), dtype, cuda)
    vp = _rand(gen, (num_pages, hkv, page_size, d), dtype, cuda)
    wo = _rand(gen, (h * d, n), dtype, cuda, (h * d) ** -0.5)
    rng = np.random.default_rng(page_size)
    tables = rng.permutation(num_pages)[:b * maxp].reshape(b, maxp) \
        if num_pages >= b * maxp else rng.integers(0, num_pages, (b, maxp))
    tables = np.asarray(tables, np.int32)
    tables[1, 2:] = num_pages                 # sentinel entries past pos
    pos = np.array([maxp * page_size - 1, page_size + 3, 0,
                    2 * page_size], np.int32)
    tables = torch.from_numpy(tables).to(cuda)
    pos = torch.from_numpy(pos).to(cuda)
    out = fused.paged_attention_matmul(q, kp, vp, wo, block_tables=tables,
                                       pos=pos)
    torch.cuda.synchronize()
    _close(out, fused.paged_attention_matmul_plain(
        q, kp, vp, wo, block_tables=tables, pos=pos), dt)


def test_wrappers_raise_instead_of_falling_back(cuda):
    x = torch.randn(4, 64, device=cuda)
    w = torch.ones(64, device=cuda)
    with pytest.raises(TypeError):
        fused.rmsnorm_matmul(x.half(), w.half(), torch.randn(64, 32, device=cuda).half())
    with pytest.raises(ValueError):
        fused.rmsnorm_matmul(x, w, torch.randn(32, 64, device=cuda))
    with pytest.raises(ValueError):
        fused.rmsnorm_matmul(x, w.cpu(), torch.randn(64, 32, device=cuda))
    with pytest.raises(ValueError):
        fused.rmsnorm_swiglu(x, w, torch.randn(64, 33, device=cuda))
    with pytest.raises(ValueError):
        fused.rmsnorm_matmul(x, w, torch.randn(32, 64, device=cuda).t())
    q = torch.randn(1, 4, 3, 256, device=cuda)
    with pytest.raises(ValueError):
        fused.flash_attention_matmul(q, q, q, torch.randn(1024, 8, device=cuda))
    with pytest.raises(TypeError):
        fused.flash_attention_matmul(q[..., :64], q[..., :64].double(),
                                     q[..., :64], torch.randn(256, 8, device=cuda))
    qs = q[..., :64].contiguous()
    with pytest.raises(ValueError):            # pos left on the host
        fused.flash_attention_matmul(qs, qs, qs, torch.randn(256, 8, device=cuda),
                                     pos=torch.zeros(1, dtype=torch.int32))


def test_foreign_dialect_raises_on_the_card(cuda):
    from repro_torch.core import ExecutionPolicy, UnsupportedLowering
    from repro_torch.kernels import ops
    pol = ExecutionPolicy(mode="native", dialect="nvidia-ada-sm89")
    x = torch.randn(4, 64, device=cuda)
    w = torch.ones(64, device=cuda)
    with pytest.raises(UnsupportedLowering, match="on the card"):
        ops.fused_rmsnorm_matmul(x, w, torch.randn(64, 32, device=cuda),
                                 policy=pol)
    q = torch.randn(1, 4, 3, 64, device=cuda)
    with pytest.raises(UnsupportedLowering, match="on the card"):
        ops.fused_flash_attention_matmul(q, q, q,
                                         torch.randn(256, 8, device=cuda),
                                         policy=pol)


def test_engine_tick_makes_no_host_sync(cuda):
    cfg = ModelConfig(name="t", family="dense", num_layers=2, d_model=64,
                      num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
                      dtype="bfloat16")
    model = build_model(cfg, ParallelConfig(fuse_epilogues=True,
                                            use_pallas_attn=True),
                        device=cuda)
    params = model.init_params(0)
    eng = BatchedEngine(model, params, ServeConfig(
        batch_slots=2, max_seq_len=64, eos_id=-1, page_size=16))
    eng.add_request(Request(rid=0, prompt=[3, 5, 7, 9], max_new_tokens=40))
    eng.step()                                  # warm-up outside the guard
    torch.cuda.synchronize()
    fused.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(5):
            eng.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    eng.sync()
    assert len(eng.slots[0].generated) == 7
    assert fused.LAUNCHES["paged_attention_matmul"] == 5 * cfg.num_layers
    assert fused.LAUNCHES["rmsnorm_swiglu"] == 5 * cfg.num_layers


def _ssd_inputs(gen, dtype, dev, b, l, h, p, g, n):
    """Inputs shaped like the model's: dt = softplus(.) > 0, A < 0, B and C
    scaled so that C.B is O(1) at any N."""
    x = _rand(gen, (b, l, h, p), dtype, dev)
    dt = torch.nn.functional.softplus(
        torch.randn((b, l, h), generator=gen) - 3.0).to(dev)
    A = -torch.exp(torch.rand((h,), generator=gen) * 2.77).to(dev)
    B = _rand(gen, (b, l, g, n), dtype, dev, n ** -0.25)
    C = _rand(gen, (b, l, g, n), dtype, dev, n ** -0.25)
    return x, dt, A, B, C


@pytest.mark.parametrize("dt_name", ["f32", "bf16"])
@pytest.mark.parametrize("b,l,h,p,g,n,chunk,init", [
    (1, 512, 80, 64, 1, 128, 256, False),    # mamba2-2.7b prefill
    (1, 300, 80, 64, 1, 128, 256, False),    # partial last chunk
    (1, 128, 80, 64, 1, 128, 256, True),     # chunk clamped to L, h0
    (2, 37, 4, 16, 2, 16, 16, True),         # reduced widths, G = 2
    (3, 70, 6, 20, 3, 12, 32, False),        # widths off the 4-grid
])
def test_ssd_scan_matches_plain(cuda, dt_name, b, l, h, p, g, n, chunk,
                                init):
    gen = torch.Generator().manual_seed(l * h + n)
    x, dt, A, B, C = _ssd_inputs(gen, DTYPES[dt_name], cuda, b, l, h, p, g, n)
    h0 = (torch.randn((b, g, h // g, n, p), generator=gen).to(cuda)
          if init else None)
    before = fused.LAUNCHES["ssd_scan"]
    y, state = ssd.ssd_scan(x, dt, A, B, C, h0, chunk=chunk)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["ssd_scan"] == before + 1
    y_ref, state_ref = ssd.ssd_scan_plain(x, dt, A, B, C, h0, chunk=chunk)
    assert y.dtype == x.dtype and state.dtype == torch.float32
    _close(y, y_ref, dt_name)
    _close(state, state_ref, "f32")


def test_ssd_scan_takes_strided_projection_slices(cuda):
    """The model hands the kernel x, B and C as slices of one projection
    (row stride conv_dim); the kernel reads them in place."""
    gen = torch.Generator().manual_seed(3)
    b, l, h, p, n = 2, 50, 4, 16, 16
    xbc = _rand(gen, (b, l, h * p + 2 * n), torch.bfloat16, cuda, 0.5)
    x = xbc[..., :h * p].reshape(b, l, h, p)
    B = xbc[..., h * p:h * p + n].reshape(b, l, 1, n)
    C = xbc[..., h * p + n:].reshape(b, l, 1, n)
    _, dt, A, _, _ = _ssd_inputs(gen, torch.bfloat16, cuda, b, l, h, p, 1, n)
    y, state = ssd.ssd_scan(x, dt, A, B, C, chunk=16)
    y_ref, state_ref = ssd.ssd_scan_plain(x, dt, A, B, C, chunk=16)
    _close(y, y_ref, "bf16")
    _close(state, state_ref, "f32")


@pytest.mark.parametrize("dt_name", ["f32", "bf16"])
@pytest.mark.parametrize("b,h,p,g,n", [(8, 80, 64, 1, 128),
                                       (5, 80, 64, 1, 128),
                                       (3, 4, 16, 2, 16)])
def test_ssd_decode_matches_plain(cuda, dt_name, b, h, p, g, n):
    gen = torch.Generator().manual_seed(b * h + n)
    x, dt, A, B, C = _ssd_inputs(gen, DTYPES[dt_name], cuda, b, 1, h, p, g, n)
    x, dt, B, C = x[:, 0], dt[:, 0], B[:, 0], C[:, 0]
    state = torch.randn((b, g, h // g, n, p), generator=gen).to(cuda)
    before = fused.LAUNCHES["ssd_decode"]
    new, y = ssd.ssd_decode(state, x, dt, A, B, C)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["ssd_decode"] == before + 1
    new_ref, y_ref = ssd.ssd_decode_plain(state, x, dt, A, B, C)
    _close(y, y_ref, dt_name)
    _close(new, new_ref, "f32")
    # in place: the kernel writes the new state over the old one
    same, y2 = ssd.ssd_decode(state, x, dt, A, B, C, out=state)
    torch.cuda.synchronize()
    assert same is state
    _close(state, new_ref, "f32")
    _close(y2, y_ref, dt_name)


def test_ssd_wrappers_raise_instead_of_falling_back(cuda):
    gen = torch.Generator().manual_seed(0)
    x, dt, A, B, C = _ssd_inputs(gen, torch.float32, cuda, 1, 8, 2, 16, 1,
                                 16)
    with pytest.raises(ValueError):           # N past the kernel's width
        ssd.ssd_scan(x, dt, A, torch.zeros(1, 8, 1, 256, device=cuda),
                     torch.zeros(1, 8, 1, 256, device=cuda), chunk=8)
    with pytest.raises(ValueError):           # chunk past 256 positions
        big = _ssd_inputs(gen, torch.float32, cuda, 1, 600, 2, 16, 1, 16)
        ssd.ssd_scan(*big, chunk=512)
    with pytest.raises(TypeError):            # B in another dtype than x
        ssd.ssd_scan(x, dt, A, B.bfloat16(), C, chunk=8)
    with pytest.raises(NotImplementedError):  # the tuned chunk is A.8
        ssd.ssd_scan(x, dt, A, B, C, chunk=None)
    state = torch.zeros(1, 1, 2, 16, 16, device=cuda)
    with pytest.raises(ValueError):           # dt left on the host
        ssd.ssd_decode(state, x[:, 0], dt[:, 0].cpu(), A, B[:, 0], C[:, 0])
    with pytest.raises(ValueError):           # P not a multiple of 4
        ssd.ssd_decode(torch.zeros(1, 1, 2, 16, 18, device=cuda),
                       torch.zeros(1, 2, 18, device=cuda), dt[:, 0], A,
                       B[:, 0], C[:, 0])


def test_ssd_foreign_dialect_raises_on_the_card(cuda):
    from repro_torch.core import ExecutionPolicy, UnsupportedLowering
    from repro_torch.kernels import ops
    pol = ExecutionPolicy(mode="native", dialect="nvidia-ada-sm89")
    gen = torch.Generator().manual_seed(0)
    x, dt, A, B, C = _ssd_inputs(gen, torch.float32, cuda, 1, 8, 2, 16, 1,
                                 16)
    with pytest.raises(UnsupportedLowering, match="on the card"):
        ops.fused_ssd_scan(x, dt, A, B, C, chunk=8, policy=pol)
    state = torch.zeros(1, 1, 2, 16, 16, device=cuda)
    with pytest.raises(UnsupportedLowering, match="on the card"):
        ops.fused_ssd_decode(state, x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0],
                             policy=pol)


def test_mamba_tick_makes_no_host_sync(cuda):
    cfg = ModelConfig(name="t", family="ssm", num_layers=2, d_model=64,
                      num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=256,
                      dtype="bfloat16", subquadratic=True, tie_embeddings=True,
                      ssm=SSMConfig(state_dim=16, head_dim=16, chunk_size=8))
    model = build_model(cfg, ParallelConfig(fuse_epilogues=True),
                        device=cuda)
    params = model.init_params(0)
    eng = BatchedEngine(model, params, ServeConfig(
        batch_slots=2, max_seq_len=64, eos_id=-1))
    fused.reset_launch_counts()
    eng.add_request(Request(rid=0, prompt=[3, 5, 7, 9], max_new_tokens=40))
    assert fused.LAUNCHES["ssd_scan"] == cfg.num_layers
    eng.step()                                  # warm-up outside the guard
    torch.cuda.synchronize()
    fused.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(5):
            eng.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    eng.sync()
    assert len(eng.slots[0].generated) == 7
    assert fused.LAUNCHES["ssd_decode"] == 5 * cfg.num_layers


# ---------------------------------------------------------------------------
# Table V: gemm, reduction and histogram in every kernel mode.  Reduction:
# |kernel - float64 sum| <= 1e-5 sum|x| (f32 summation bound), and within
# the same of the plain version; histogram: exact; gemm against the float64
# product: relative RMS <= 1e-5 and in every row max|err| <= 1e-4 max|row|
# (f32 out), and within one bf16 step of the plain version (bf16 out).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", reduction.MODES)
@pytest.mark.parametrize("dt", ["f32", "bf16", "int32"])
@pytest.mark.parametrize("n", [1, 999, 70001, 300001])
def test_reduce_sum_matches_plain(cuda, mode, dt, n):
    gen = torch.Generator().manual_seed(n)
    x = torch.randn(n, generator=gen) * 4
    x = (x.to(torch.int32) if dt == "int32" else x.to(DTYPES[dt])).to(cuda)
    tol = 1e-5 * float(x.double().abs().sum()) + 1e-6
    key = f"reduction_{mode}"
    for tile in (reduction.TILE, 2 * reduction.THREADS):
        before = fused.LAUNCHES[key]
        got = reduction.reduce_sum_kernel(x, mode, tile)
        torch.cuda.synchronize()
        assert fused.LAUNCHES[key] == before + 1
        assert got.dtype == torch.float32 and got.shape == ()
        assert abs(float(got) - float(x.double().sum())) <= tol
        want = reduction.reduce_sum_plain(x, mode=mode, tile=tile)
        assert abs(float(got) - float(want)) <= tol


def test_reduce_sum_unaligned_slice_and_empty(cuda):
    x = torch.randn(70003, device=cuda)[3:]        # off 16 bytes
    for mode in reduction.MODES:
        got = ops.reduce_sum(x, mode=mode)
        assert abs(float(got) - float(x.double().sum())) <= \
            1e-5 * float(x.double().abs().sum())
        assert float(ops.reduce_sum(torch.zeros(0, device=cuda),
                                    mode=mode)) == 0.0


@pytest.mark.parametrize("mode", histogram.KERNEL_MODES)
@pytest.mark.parametrize("bins", [1, 100, 256, 5000])
@pytest.mark.parametrize("n", [1, 5001, 70001])
def test_histogram_matches_plain(cuda, mode, bins, n):
    gen = torch.Generator().manual_seed(bins + n)
    v = torch.randint(-50, bins + 50, (n,), generator=gen,
                      dtype=torch.int32).to(cuda)
    key = f"histogram_{mode}"
    before = fused.LAUNCHES[key]
    got = histogram.histogram(v, bins, mode=mode)
    torch.cuda.synchronize()
    assert fused.LAUNCHES[key] == before + 1
    assert got.dtype == torch.int32 and got.shape == (bins,)
    assert torch.equal(got, histogram.histogram_plain(v, bins, mode=mode))
    assert int(got.sum()) == n


def test_histogram_one_bin_and_odd_inputs(cuda):
    hot = torch.full((300001,), 7, dtype=torch.int32, device=cuda)
    sliced = torch.randint(0, 256, (70004,), dtype=torch.int32,
                           device=cuda)[1:]                # off 16 bytes
    int64 = torch.randint(-5, 300, (999,), device=cuda)    # cast to int32
    for mode in histogram.KERNEL_MODES:
        for v in (hot, sliced, int64):
            assert torch.equal(ops.histogram(v, 256, mode=mode),
                               histogram.histogram_plain(v, 256, mode=mode))


@pytest.mark.parametrize("mode", gemm.MODES)
@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (300, 129, 200),
                                   (300, 200, 129), (128, 256, 128),
                                   (517, 1000, 333), (64, 4096, 96)])
def test_gemm_matches_plain(cuda, mode, m, k, n):
    gen = torch.Generator().manual_seed(m + 7 * k + n)
    a = torch.randn(m, k, generator=gen).to(cuda)
    b = torch.randn(k, n, generator=gen).to(cuda)
    ref64 = a.double() @ b.double()
    key = f"gemm_{mode}"
    before = fused.LAUNCHES[key]
    got = gemm.gemm(a, b, mode=mode)
    torch.cuda.synchronize()
    assert fused.LAUNCHES[key] == before + 1
    for out in (got, gemm.gemm_plain(a, b, mode=mode)):
        diff = out.double() - ref64
        assert float(diff.norm() / ref64.norm()) <= 1e-5
        assert float((diff.abs().amax(1) / ref64.abs().amax(1)).max()) <= 1e-4
    # bf16 output: one rounding of nearly equal f32 values
    got16 = gemm.gemm(a, b, mode=mode, out_dtype=torch.bfloat16)
    want16 = gemm.gemm_plain(a, b, mode=mode, out_dtype=torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    torch.testing.assert_close(got16.float(), want16.float(), rtol=2 ** -7,
                               atol=2 ** -7 * float(want16.float().abs().max()))


def test_gemm_takes_bf16_and_strided_operands(cuda):
    gen = torch.Generator().manual_seed(3)
    a = torch.randn(70, 90, generator=gen).to(cuda)
    b = torch.randn(30, 90, generator=gen).to(cuda).t()    # a transposed view
    for mode in gemm.MODES:
        _close(gemm.gemm(a, b, mode=mode), gemm.gemm_plain(a, b, mode=mode),
               "f32")
        ab, bb = a.bfloat16(), b.bfloat16()
        _close(gemm.gemm(ab, bb, mode=mode),
               gemm.gemm_plain(ab, bb, mode=mode), "f32")


def test_tablev_shuffle_rows_refuse_the_card(cuda):
    """gemm [abstract+shuffle] would take its declared fallback: refused on
    the card; histogram [abstract+shuffle] has no kernel yet (ROADMAP B10b)."""
    from repro_torch.core import UnsupportedLowering
    a = torch.randn(8, 8, device=cuda)
    with pytest.raises(UnsupportedLowering, match="on the card"):
        ops.matmul(a, a, mode="abstract+shuffle")
    with pytest.raises(NotImplementedError, match="B10b"):
        ops.histogram(torch.zeros(8, dtype=torch.int32, device=cuda), 16,
                      mode="abstract+shuffle")


def test_tablev_wrappers_raise_instead_of_falling_back(cuda):
    x = torch.randn(64, device=cuda)
    with pytest.raises(TypeError):
        reduction.reduce_sum(x.double())
    with pytest.raises(ValueError):
        reduction.reduce_sum_kernel(x, "native", tile=12)
    with pytest.raises(TypeError):
        histogram.histogram(x, 16)
    with pytest.raises(ValueError):
        histogram.histogram(x.int(), histogram.max_bins("native") + 1)
    with pytest.raises(ValueError):
        gemm.gemm(torch.randn(4, 5, device=cuda), torch.randn(4, 5,
                                                                device=cuda))
    with pytest.raises(ValueError):                      # B left on the host
        gemm.gemm(torch.randn(4, 5, device=cuda), torch.randn(5, 3))
    with pytest.raises(TypeError):
        gemm.gemm(torch.randn(4, 5, device=cuda).double(),
                  torch.randn(5, 3, device=cuda).double())
