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

from repro_torch.benchmarks import tablev
from repro_torch.kernels import (attention, fused, gemm, histogram, ops,
                                 reduction, rmsnorm, ssd)
from repro_torch.kernels._launch import LAST_ROUTE
from repro_torch.models import build_model
from repro_torch.models.config import (ModelConfig, MoEConfig, ParallelConfig,
                                       SSMConfig)
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


# ---------------------------------------------------------------------------
# the int8 twins: int8 weights (and paged pools) beside f32 scales
# ---------------------------------------------------------------------------


def _q8(w):
    return fused.quantize_weight(w)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("rows,d,n", [(1, 256, 320), (8, 4096, 6144),
                                      (100, 512, 200), (300, 4096, 6144),
                                      (520, 512, 6000)])
def test_rmsnorm_matmul_q8_matches_plain(cuda, dt, rows, d, n):
    gen = torch.Generator().manual_seed(rows + n)
    dtype = DTYPES[dt]
    x = _rand(gen, (rows, d), dtype, cuda)
    w = _rand(gen, (d,), dtype, cuda)
    W, s = _q8(_rand(gen, (d, n), torch.float32, cuda, d ** -0.5))
    before = dict(fused.LAUNCHES)
    out = fused.rmsnorm_matmul_q8(x, w, W, w_scale=s)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["rmsnorm_matmul_q8"] == \
        before["rmsnorm_matmul_q8"] + 1
    assert fused.LAUNCHES["rmsnorm_matmul"] == before["rmsnorm_matmul"]
    _close(out, fused.rmsnorm_matmul_q8_plain(x, w, W, s), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("rows,d,f", [(3, 256, 96), (8, 4096, 1024),
                                      (70, 512, 330), (300, 512, 7000)])
def test_rmsnorm_swiglu_q8_matches_plain(cuda, dt, rows, d, f):
    gen = torch.Generator().manual_seed(rows + f)
    dtype = DTYPES[dt]
    x = _rand(gen, (rows, d), dtype, cuda)
    w = _rand(gen, (d,), dtype, cuda)
    w_cat, s = _q8(_rand(gen, (d, 2 * f), torch.float32, cuda, d ** -0.5))
    before = fused.LAUNCHES["rmsnorm_swiglu_q8"]
    out = fused.rmsnorm_swiglu_q8(x, w, w_cat, w_scale=s)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["rmsnorm_swiglu_q8"] == before + 1
    _close(out, fused.rmsnorm_swiglu_q8_plain(x, w, w_cat, s), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,h,hkv,sq,skv,d,n", [
    (1, 8, 2, 100, 100, 64, 200), (1, 32, 8, 300, 300, 128, 512)])
def test_flash_attention_matmul_q8_causal_and_pos(cuda, dt, b, h, hkv, sq,
                                                  skv, d, n):
    gen = torch.Generator().manual_seed(sq * skv + 1)
    q, k, v, wo = _attn_inputs(gen, DTYPES[dt], cuda, b, h, hkv, sq, skv,
                               d, n)
    woq, s = _q8(wo)
    before = dict(fused.LAUNCHES)
    out = fused.flash_attention_matmul_q8(q, k, v, woq, w_scale=s)
    torch.cuda.synchronize()
    _close(out, fused.flash_attention_matmul_q8_plain(q, k, v, woq, s), dt)
    qd, kd, vd, _ = _attn_inputs(gen, DTYPES[dt], cuda, 4, h, hkv, 1, skv,
                                 d, n)
    pos = torch.tensor([0, skv // 3, skv - 1, -1], dtype=torch.int32,
                       device=cuda)
    out = fused.flash_attention_matmul_q8(qd, kd, vd, woq, w_scale=s, pos=pos)
    torch.cuda.synchronize()
    _close(out, fused.flash_attention_matmul_q8_plain(qd, kd, vd, woq, s,
                                                      pos=pos), dt)
    for name in ("flash_attention_matmul_q8", "flash_attention_matmul_q8_pos"):
        assert fused.LAUNCHES[name] == before[name] + 1
    assert fused.LAUNCHES["flash_attention_matmul"] == \
        before["flash_attention_matmul"]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("kv", ["int8", "float"])
@pytest.mark.parametrize("page_size", [16, 64])
def test_paged_attention_matmul_q8(cuda, dt, kv, page_size):
    """int8 pools and scale pools read through the clamped table entry
    (sentinels past pos, a trash page past P) beside an int8 wo; and pools
    at the working dtype beside an int8 wo."""
    from repro_torch.models.attention import quantize_kv
    gen = torch.Generator().manual_seed(page_size + 5)
    dtype = DTYPES[dt]
    b, h, hkv, d, n, num_pages, maxp = 4, 8, 2, 128, 256, 12, 5
    q = _rand(gen, (b, h, 1, d), dtype, cuda)
    kp = _rand(gen, (num_pages, hkv, page_size, d), dtype, cuda)
    vp = _rand(gen, (num_pages, hkv, page_size, d), dtype, cuda)
    ks = vs = None
    if kv == "int8":
        (kp, ks), (vp, vs) = quantize_kv(kp), quantize_kv(vp)
    woq, s = _q8(_rand(gen, (h * d, n), torch.float32, cuda,
                       (h * d) ** -0.5))
    rng = np.random.default_rng(page_size)
    tables = np.asarray(rng.integers(0, num_pages, (b, maxp)), np.int32)
    tables[1, 2:] = num_pages                 # sentinel entries past pos
    pos = np.array([maxp * page_size - 1, page_size + 3, 0,
                    2 * page_size], np.int32)
    tables = torch.from_numpy(tables).to(cuda)
    pos = torch.from_numpy(pos).to(cuda)
    before = fused.LAUNCHES["paged_attention_matmul_q8"]
    out = fused.flash_attention_matmul_q8(q, kp, vp, woq, w_scale=s,
                                          k_scale=ks, v_scale=vs,
                                          block_tables=tables, pos=pos)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["paged_attention_matmul_q8"] == before + 1
    _close(out, fused.flash_attention_matmul_q8_plain(
        q, kp, vp, woq, s, block_tables=tables, pos=pos, k_scale=ks,
        v_scale=vs), dt)


def test_q8_wrappers_raise_instead_of_falling_back(cuda):
    from repro_torch.core import ExecutionPolicy, UnsupportedLowering
    x = torch.randn(4, 64, device=cuda)
    w = torch.ones(64, device=cuda)
    W, s = _q8(torch.randn(64, 32, device=cuda))
    with pytest.raises(ValueError):            # scales left on the host
        fused.rmsnorm_matmul_q8(x, w, W, w_scale=s.cpu())
    with pytest.raises(ValueError):            # scales of the wrong width
        fused.rmsnorm_matmul_q8(x, w, W, w_scale=s[:16])
    with pytest.raises(TypeError):             # a scale for a float weight
        fused.rmsnorm_swiglu_q8(x, w, W.float(), w_scale=s)
    q = torch.randn(1, 4, 1, 64, device=cuda)
    kp, ks = fused.quantize_weight(torch.randn(3, 2, 8, 64, device=cuda))
    with pytest.raises(ValueError):            # scale pools of another shape
        fused.flash_attention_matmul_q8(
            q, kp, kp, torch.randn(256, 8, device=cuda), k_scale=ks,
            v_scale=ks, block_tables=torch.zeros(1, 2, dtype=torch.int32,
                                                 device=cuda),
            pos=torch.zeros(1, dtype=torch.int32, device=cuda))
    pol = ExecutionPolicy(mode="native", dialect="nvidia-ada-sm89",
                          precision="int8")
    with pytest.raises(UnsupportedLowering, match="on the card"):
        ops.fused_rmsnorm_matmul(x, w, W, w_scale=s, policy=pol)


def test_int8_engine_tick_makes_no_host_sync(cuda):
    """The int8 path (int8 weights, int8 paged cache) in bf16: one tick
    launches only the q8 kernels and the head's, with host syncs
    forbidden."""
    from repro_torch.models import common
    cfg = ModelConfig(name="t", family="dense", num_layers=2, d_model=64,
                      num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
                      dtype="bfloat16")
    model = build_model(cfg, ParallelConfig(
        fuse_epilogues=True, use_pallas_attn=True, weight_precision="int8",
        kv_cache_int8=True), device=cuda)
    params = common.quantize_params(model.init_params(0))
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
    launched = {k: v for k, v in fused.LAUNCHES.items() if v}
    assert launched == {"rmsnorm_matmul_q8": 5 * (cfg.num_layers + 1),
                        "rmsnorm_swiglu_q8": 5 * cfg.num_layers,
                        "paged_attention_matmul_q8": 5 * cfg.num_layers}


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
    with pytest.raises(ValueError):            # strided: neither [D, N] nor
        fused.rmsnorm_matmul(x, w, torch.randn(64, 64, device=cuda)[:, ::2])
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


#: the scan's cases: bf16 ones on the 16-grid take the tc route
#: (csrc/ssd_scan_tc.cuh), f32 and widths off the grid the fma route
SSD_SCAN_CASES = [
    (1, 512, 80, 64, 1, 128, 256, False),    # mamba2-2.7b prefill
    (1, 300, 80, 64, 1, 128, 256, False),    # partial last chunk
    (1, 128, 80, 64, 1, 128, 256, True),     # chunk clamped to L, h0
    (2, 37, 4, 16, 2, 16, 16, True),         # reduced widths, G = 2
    (3, 70, 6, 20, 3, 12, 32, False),        # widths off the 4-grid
    (1, 300, 8, 64, 2, 128, 256, True),      # G = 2 at N 128, P 64, h0
    (2, 200, 4, 64, 1, 128, 128, False),     # Q 128, a tail of 72
]


def _scan_route_of(dt_name, p, n):
    return "tc" if dt_name == "bf16" and p % 16 == 0 and n % 16 == 0 \
        else "fma"


@pytest.mark.parametrize("dt_name", ["f32", "bf16"])
@pytest.mark.parametrize("b,l,h,p,g,n,chunk,init", SSD_SCAN_CASES)
def test_ssd_scan_matches_plain(cuda, dt_name, b, l, h, p, g, n, chunk,
                                init):
    gen = torch.Generator().manual_seed(l * h + n)
    x, dt, A, B, C = _ssd_inputs(gen, DTYPES[dt_name], cuda, b, l, h, p, g, n)
    h0 = (torch.randn((b, g, h // g, n, p), generator=gen).to(cuda)
          if init else None)
    before = fused.LAUNCHES["ssd_scan"]
    LAST_ROUTE.clear()
    y, state = ssd.ssd_scan(x, dt, A, B, C, h0, chunk=chunk)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["ssd_scan"] == before + 1
    assert LAST_ROUTE == {"ssd_scan": _scan_route_of(dt_name, p, n)}
    assert ssd.scan_route(x, B, C) == LAST_ROUTE["ssd_scan"]
    y_ref, state_ref = ssd.ssd_scan_plain(x, dt, A, B, C, h0, chunk=chunk)
    assert y.dtype == x.dtype and state.dtype == torch.float32
    _close(y, y_ref, dt_name)
    _close(state, state_ref, "f32")


@pytest.mark.parametrize("operand", ["x", "B", "C"])
def test_ssd_scan_unaligned_operand_takes_fma(cuda, operand):
    """One operand one element off a 16-byte boundary: the fma route, on
    the same mamba2 widths that otherwise take tc."""
    gen = torch.Generator().manual_seed(7)
    b, l, h, p, g, n = 1, 300, 8, 64, 1, 128
    x, dt, A, B, C = _ssd_inputs(gen, torch.bfloat16, cuda, b, l, h, p, g, n)
    ops_ = {"x": x, "B": B, "C": C}
    t = ops_[operand]
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
    ops_[operand] = buf[1:].view(t.shape).copy_(t)
    x, B, C = ops_["x"], ops_["B"], ops_["C"]
    LAST_ROUTE.clear()
    y, state = ssd.ssd_scan(x, dt, A, B, C, chunk=256)
    torch.cuda.synchronize()
    assert LAST_ROUTE == {"ssd_scan": "fma"} and \
        ssd.scan_route(x, B, C) == "fma"
    y_ref, state_ref = ssd.ssd_scan_plain(x, dt, A, B, C, chunk=256)
    _close(y, y_ref, "bf16")
    _close(state, state_ref, "f32")


@pytest.mark.parametrize("mode", ["native", "abstract", "abstract+shuffle"])
def test_ssd_scan_routes_share_the_prefix_sum(cuda, mode):
    """The tc route's prefix sum is the fma route's, bit for bit: with B = 0
    the state is h0 times exp(total) chunk after chunk on both routes (no
    product adds anything), so the two final states are equal bit for bit
    only where every chunk's total ld is.  The same bf16 operands take tc,
    and fma with x one element off a 16-byte boundary."""
    gen = torch.Generator().manual_seed(11)
    b, l, h, p, g, n = 1, 600, 8, 64, 1, 128    # chunks of 256, 256 and 88
    x, dt, A, B, C = _ssd_inputs(gen, torch.bfloat16, cuda, b, l, h, p, g, n)
    B = torch.zeros_like(B)
    h0 = torch.randn((b, g, h // g, n, p), generator=gen).to(cuda)
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    x_off = buf[1:].view(x.shape).copy_(x)
    counter = "ssd_scan" if mode == "native" else f"ssd_scan_{mode}"
    states = {}
    for ops in (x, x_off):
        LAST_ROUTE.clear()
        _, state = ssd.ssd_scan(ops, dt, A, B, C, h0, chunk=256, mode=mode)
        torch.cuda.synchronize()
        states[LAST_ROUTE[counter]] = state
    assert set(states) == {"tc", "fma"}
    assert torch.equal(states["tc"], states["fma"])


@pytest.mark.parametrize("b,l,h,p,n,chunk", [(2, 50, 4, 16, 16, 16),
                                             (1, 300, 80, 64, 128, 256)])
def test_ssd_scan_takes_strided_projection_slices(cuda, b, l, h, p, n,
                                                  chunk):
    """The model hands the kernel x, B and C as slices of one projection
    (row stride conv_dim: 5376 at mamba2's widths, B and C at 5120 and
    5248); the kernel reads them in place, on the tc route."""
    gen = torch.Generator().manual_seed(3)
    xbc = _rand(gen, (b, l, h * p + 2 * n), torch.bfloat16, cuda, 0.5)
    x = xbc[..., :h * p].reshape(b, l, h, p)
    B = xbc[..., h * p:h * p + n].reshape(b, l, 1, n)
    C = xbc[..., h * p + n:].reshape(b, l, 1, n)
    _, dt, A, _, _ = _ssd_inputs(gen, torch.bfloat16, cuda, b, l, h, p, 1, n)
    LAST_ROUTE.clear()
    y, state = ssd.ssd_scan(x, dt, A, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert LAST_ROUTE == {"ssd_scan": "tc"}
    y_ref, state_ref = ssd.ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
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
    # chunk=None resolves the tuned chunk (no longer a refusal): it runs
    # the kernel at that chunk, equal to an explicit call at it
    q = ssd.resolve_chunk(8, None, mode="native", p=16, n=16)
    y0, h0 = ssd.ssd_scan(x, dt, A, B, C, chunk=None)
    y1, h1 = ssd.ssd_scan(x, dt, A, B, C, chunk=q)
    assert torch.equal(y0, y1) and torch.equal(h0, h1)
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


@pytest.mark.parametrize("mode", histogram.MODES)
@pytest.mark.parametrize("bins", [1, 100, 256, 5000])
@pytest.mark.parametrize("n", [1, 5001, 70001])
def test_histogram_matches_plain(cuda, mode, bins, n):
    # abstract+shuffle's lane columns hold at most 804 bins: its largest
    bins = min(bins, histogram.max_bins(mode))
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
    for mode in histogram.MODES:
        for v in (hot, sliced, int64):
            assert torch.equal(ops.histogram(v, 256, mode=mode),
                               histogram.histogram_plain(v, 256, mode=mode))


@pytest.mark.parametrize("mode", histogram.MODES)
@pytest.mark.parametrize("log2_n", [24, 26])
def test_histogram_one_bin_exact_past_the_lane_counts(cuda, mode, log2_n):
    """2^24 and 2^26 values in one bin, exact in every mode.  At 2^26 each
    of abstract+shuffle's lanes counts more than 255 values of the bin, so
    its flushes between tiles are what keep the 8-bit counts exact."""
    n = 1 << log2_n
    v = torch.full((n,), 200, dtype=torch.int32, device=cuda)
    got = histogram.histogram(v, 256, mode=mode)
    want = torch.zeros(256, dtype=torch.int32, device=cuda)
    want[200] = n
    assert torch.equal(got, want)
    grid = histogram.launch_params(mode, n, 256, v)["grid"]
    tiles = n // histogram.TILE
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert sms <= grid <= tiles
    if mode == "abstract+shuffle" and log2_n == 26:
        assert -(-tiles // grid) * histogram.LOADS > 255


@pytest.mark.parametrize("mode", histogram.MODES)
def test_histogram_at_the_most_bins(cuda, mode):
    bins = histogram.max_bins(mode)
    gen = torch.Generator().manual_seed(bins)
    v = torch.randint(-5, bins + 5, (300001,), generator=gen,
                      dtype=torch.int32).to(cuda)
    got = histogram.histogram(v, bins, mode=mode)
    tablev.check_histogram(got, v, bins, f"histogram [{mode}] {bins} bins")
    assert torch.equal(got, histogram.histogram_plain(v, bins, mode=mode))


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


@pytest.mark.parametrize("mode", gemm.MODES)
def test_gemm_2048_error_beside_sgemm(cuda, mode, record_property):
    """At 2048^3 the 3xTF32 kernel stays within Table V's float64
    tolerances; its relative RMS error is recorded beside cuBLAS SGEMM's
    (``torch.matmul``, TF32 off) on the same inputs."""
    assert not torch.backends.cuda.matmul.allow_tf32
    gen = torch.Generator(device=cuda).manual_seed(2048)
    a = torch.randn(2048, 2048, generator=gen, device=cuda)
    b = torch.randn(2048, 2048, generator=gen, device=cuda)
    ref64 = a.double() @ b.double()
    got = gemm.gemm(a, b, mode=mode)
    tablev.check_gemm(got, ref64, f"gemm [{mode}] 2048^3")
    rms, sgemm = tablev.gemm_rms(got, ref64), tablev.gemm_rms(a @ b, ref64)
    record_property("rel_rms", rms)
    record_property("sgemm_rel_rms", sgemm)
    print(f"gemm [{mode}] 2048^3: relative RMS {rms:.4g}, torch.matmul "
          f"{sgemm:.4g}, ratio {rms / sgemm:.3f}")


@pytest.mark.parametrize("mode", gemm.MODES)
def test_gemm_base_off_16_bytes_takes_the_4_byte_copies(cuda, mode):
    """A base 4 bytes past a 16-byte boundary takes the 4-byte cp.async
    path (aligned operands the 16-byte one) and stays right."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    m, k, n = 200, 256, 192
    a = torch.randn(m * k + 1, generator=gen, device=cuda)[1:].view(m, k)
    b = torch.randn(k, n, generator=gen, device=cuda)
    assert a.data_ptr() % 16 == 4
    assert gemm.copy_bytes(a, b) == 4
    assert gemm.copy_bytes(a.clone(), b) == 16
    got = gemm.gemm(a, b, mode=mode)
    tablev.check_gemm(got, a.double() @ b.double(), f"gemm [{mode}] off 4")
    _close(got, gemm.gemm_plain(a, b, mode=mode), "f32")


def test_tablev_shuffle_rows_refuse_the_card(cuda):
    """gemm [abstract+shuffle] would take its declared fallback: refused on
    the card; histogram [abstract+shuffle] launches its own kernel."""
    from repro_torch.core import UnsupportedLowering
    a = torch.randn(8, 8, device=cuda)
    with pytest.raises(UnsupportedLowering, match="on the card"):
        ops.matmul(a, a, mode="abstract+shuffle")
    before = fused.LAUNCHES["histogram_abstract+shuffle"]
    got = ops.histogram(torch.arange(40, dtype=torch.int32, device=cuda), 16,
                        mode="abstract+shuffle")
    torch.cuda.synchronize()
    assert fused.LAUNCHES["histogram_abstract+shuffle"] == before + 1
    assert got.tolist() == [1] * 15 + [25]
    with pytest.raises(ValueError):
        histogram.histogram(a.int(), histogram.max_bins("abstract+shuffle")
                            + 1, mode="abstract+shuffle")


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



# ---------------------------------------------------------------------------
# granite-moe-3b-a800m's kernels: rmsnorm, add_rmsnorm, flash_attention, the
# tied-head rmsnorm_matmul, and the attention + wo kernels at head_dim 64
# ---------------------------------------------------------------------------

NORM_SHAPES = [(1, 1536), (8, 1536), (300, 1536), (512, 1536), (7, 1003),
               (33, 64), (5, 4100)]


def _unaligned(t):
    """The same values at a base 2 bytes off 16 (a contiguous view)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,h,hkv,sq,skv,d,causal,kv_offset", [
    (1, 24, 8, 512, 512, 64, True, None),      # granite-moe prefill
    (1, 24, 8, 300, 300, 64, True, None),      # partial q and key tiles
    (1, 24, 8, 300, 300, 64, False, None),     # non-causal, partial tail
    (2, 4, 4, 37, 70, 128, True, None),
    (2, 4, 1, 20, 50, 32, True, 10),           # a given kv_offset
    (1, 8, 2, 1, 77, 64, True, None),          # one query
    (3, 6, 2, 65, 65, 16, False, None),
])
def test_flash_attention_matches_plain(cuda, dt, b, h, hkv, sq, skv, d,
                                       causal, kv_offset):
    gen = torch.Generator().manual_seed(sq * skv + h)
    q = _rand(gen, (b, h, sq, d), DTYPES[dt], cuda)
    k = _rand(gen, (b, hkv, skv, d), DTYPES[dt], cuda)
    v = _rand(gen, (b, hkv, skv, d), DTYPES[dt], cuda)
    before = fused.LAUNCHES["flash_attention"]
    out = attention.flash_attention(q, k, v, causal=causal,
                                    kv_offset=kv_offset)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["flash_attention"] == before + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    _close(out, attention.flash_attention_plain(q, k, v, causal=causal,
                                                kv_offset=kv_offset), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("rows,d,n", [(8, 1536, 49155), (1, 1536, 49155),
                                      (300, 64, 515), (3, 100, 77)])
def test_rmsnorm_matmul_reads_a_tied_f32_table(cuda, dt, rows, d, n):
    """The tied head: the f32 [N, D] embedding as its transposed view,
    read in place, beside bf16 or f32 activations; odd N."""
    gen = torch.Generator().manual_seed(rows + n)
    x = _rand(gen, (rows, d), DTYPES[dt], cuda)
    w = 1.0 + _rand(gen, (d,), DTYPES[dt], cuda, 0.1)
    table = _rand(gen, (n, d), torch.float32, cuda, 0.02)
    before = fused.LAUNCHES["rmsnorm_matmul"]
    out = fused.rmsnorm_matmul(x, w, table.t())
    torch.cuda.synchronize()
    assert fused.LAUNCHES["rmsnorm_matmul"] == before + 1
    assert out.dtype == x.dtype and out.shape == (rows, n)
    _close(out, fused.rmsnorm_matmul_plain(x, w, table.t()), dt)
    if dt == "bf16":                           # an f32 [D, N] weight too
        W = table.t().contiguous()
        _close(fused.rmsnorm_matmul(x, w, W),
               fused.rmsnorm_matmul_plain(x, w, W), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("sq", [512, 300, 1])
def test_attention_matmul_at_group_3_head_dim_64(cuda, dt, sq):
    """granite-moe's widths: 24 query heads over 8 kv heads of 64 (21
    queries x 3 heads per block), wo [1536, 1536]; dense causal, and the
    paged decode shape."""
    gen = torch.Generator().manual_seed(sq)
    q, k, v, wo = _attn_inputs(gen, DTYPES[dt], cuda, 1, 24, 8, sq, sq, 64,
                               1536)
    _close(fused.flash_attention_matmul(q, k, v, wo),
           fused.flash_attention_matmul_plain(q, k, v, wo), dt)
    b, ps, maxp = 8, 64, 9
    qd = _rand(gen, (b, 24, 1, 64), DTYPES[dt], cuda)
    kp = _rand(gen, (b * maxp, 8, ps, 64), DTYPES[dt], cuda)
    vp = _rand(gen, (b * maxp, 8, ps, 64), DTYPES[dt], cuda)
    tables = torch.randperm(b * maxp, generator=gen).to(torch.int32).reshape(
        b, maxp).to(cuda)
    pos = torch.randint(0, maxp * ps, (b,), generator=gen,
                        dtype=torch.int32).to(cuda)
    _close(fused.paged_attention_matmul(qd, kp, vp, wo, block_tables=tables,
                                        pos=pos),
           fused.paged_attention_matmul_plain(qd, kp, vp, wo,
                                              block_tables=tables, pos=pos),
           dt)


def test_norm_and_attention_wrappers_raise(cuda):
    x = torch.randn(4, 64, device=cuda)
    w = torch.ones(64, device=cuda)
    with pytest.raises(ValueError):                     # weight on the host
        rmsnorm.rmsnorm(x, w.cpu())
    with pytest.raises(ValueError):
        rmsnorm.rmsnorm(x, torch.ones(63, device=cuda))
    with pytest.raises(TypeError):
        rmsnorm.rmsnorm(x.half(), w.half())
    with pytest.raises(TypeError):                      # mixed dtypes
        fused.add_rmsnorm(x, x.bfloat16(), w)
    with pytest.raises(ValueError):
        fused.add_rmsnorm(x, x[:3], w)
    with pytest.raises(ValueError):
        fused.add_rmsnorm(x, x.cpu(), w)
    with pytest.raises(ValueError):                     # a bf16 table
        fused.rmsnorm_matmul(x.bfloat16(), w.bfloat16(),
                             torch.randn(32, 64, device=cuda).bfloat16().t())
    with pytest.raises(TypeError):                      # f32 beside bf16
        fused.rmsnorm_swiglu(x.bfloat16(), w.bfloat16(),
                             torch.randn(64, 64, device=cuda))
    q = torch.randn(1, 4, 3, 64, device=cuda)
    with pytest.raises(ValueError):                     # head_dim > 128
        attention.flash_attention(torch.randn(1, 4, 3, 256, device=cuda),
                                  torch.randn(1, 4, 3, 256, device=cuda),
                                  torch.randn(1, 4, 3, 256, device=cuda))
    with pytest.raises(ValueError):                     # 4 heads over 3
        attention.flash_attention(q, q[:, :3], q[:, :3])
    with pytest.raises(ValueError):
        attention.flash_attention(q, q.cpu(), q)
    with pytest.raises(ValueError):                     # k and v differ
        attention.flash_attention(q, q, q[:, :, :2])


@pytest.mark.parametrize("policy", ["P1", "P2"])
def test_moe_tick_makes_no_host_sync(cuda, policy):
    """A small granite-moe-shaped model (router-only MoE, tied head) under
    the fused and the unfused kernel policy: five ticks with host syncs
    forbidden, and each tick's launches as the path prescribes."""
    par = {"P1": dict(fuse_epilogues=True, use_pallas_attn=True),
           "P2": dict(use_pallas_attn=True, isa_mode="native")}[policy]
    cfg = ModelConfig(name="m", family="moe", num_layers=2, d_model=64,
                      num_heads=6, num_kv_heads=2, head_dim=16, d_ff=32,
                      vocab_size=257, tie_embeddings=True,
                      moe=MoEConfig(num_experts=8, top_k=4, group_size=64),
                      dtype="bfloat16")
    model = build_model(cfg, ParallelConfig(**par), device=cuda)
    params = model.init_params(0)
    eng = BatchedEngine(model, params, ServeConfig(
        batch_slots=2, max_seq_len=128, eos_id=-1, page_size=16))
    fused.reset_launch_counts()
    eng.add_request(Request(rid=0, prompt=list(range(3, 80)),
                            max_new_tokens=40))
    torch.cuda.synchronize()
    if policy == "P1":
        assert fused.LAUNCHES["add_rmsnorm"] == cfg.num_layers
        assert fused.LAUNCHES["flash_attention_matmul"] == cfg.num_layers
    else:
        assert fused.LAUNCHES["rmsnorm"] == 2 * cfg.num_layers + 1
        assert fused.LAUNCHES["flash_attention"] == cfg.num_layers
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
    per_tick = ({"rmsnorm_matmul": cfg.num_layers + 1,
                 "add_rmsnorm": cfg.num_layers,
                 "paged_attention_matmul": cfg.num_layers}
                if policy == "P1" else {"rmsnorm": 2 * cfg.num_layers + 1})
    assert {k: v for k, v in fused.LAUNCHES.items() if v} == \
        {k: 5 * v for k, v in per_tick.items()}


# ---------------------------------------------------------------------------
# the abstract and abstract+shuffle lowerings of the model-path kernels
# ---------------------------------------------------------------------------

MODES = ("abstract", "abstract+shuffle")


def _launched_only(counter, run):
    """Run ``run`` and check that it launched ``counter`` once and no other
    kernel (a non-native mode never counts as native)."""
    fused.reset_launch_counts()
    out = run()
    torch.cuda.synchronize()
    assert {k: v for k, v in fused.LAUNCHES.items() if v} == {counter: 1}
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("rows,d,n", [(1, 256, 320), (8, 4096, 6144),
                                      (100, 500, 200), (300, 4096, 6144),
                                      (520, 512, 6000)])
def test_rmsnorm_matmul_modes_match_plain(cuda, mode, dt, rows, d, n):
    gen = torch.Generator().manual_seed(rows + n)
    dtype = DTYPES[dt]
    x = _rand(gen, (rows, d), dtype, cuda)
    w = _rand(gen, (d,), dtype, cuda)
    W = _rand(gen, (d, n), dtype, cuda, d ** -0.5)
    out = _launched_only(f"rmsnorm_matmul_{mode}",
                         lambda: fused.rmsnorm_matmul(x, w, W, mode=mode))
    _close(out, fused.rmsnorm_matmul_plain(x, w, W, mode=mode), dt)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("rows,d,f", [(3, 256, 96), (8, 4096, 1024),
                                      (300, 512, 7000)])
def test_rmsnorm_swiglu_modes_match_plain(cuda, mode, dt, rows, d, f):
    gen = torch.Generator().manual_seed(rows + f)
    dtype = DTYPES[dt]
    x = _rand(gen, (rows, d), dtype, cuda)
    w = _rand(gen, (d,), dtype, cuda)
    w_cat = _rand(gen, (d, 2 * f), dtype, cuda, d ** -0.5)
    out = _launched_only(f"rmsnorm_swiglu_{mode}",
                         lambda: fused.rmsnorm_swiglu(x, w, w_cat, mode=mode))
    _close(out, fused.rmsnorm_swiglu_plain(x, w, w_cat, mode=mode), dt)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,h,hkv,sq,skv,d,n,kv_offset", [
    (1, 8, 2, 100, 100, 64, 200, None),
    (1, 32, 8, 300, 300, 128, 512, None),
    (2, 4, 1, 20, 50, 32, 64, 10),
])
def test_flash_attention_matmul_causal_modes(cuda, mode, dt, b, h, hkv, sq,
                                             skv, d, n, kv_offset):
    gen = torch.Generator().manual_seed(sq * skv)
    q, k, v, wo = _attn_inputs(gen, DTYPES[dt], cuda, b, h, hkv, sq, skv,
                               d, n)
    out = _launched_only(
        f"flash_attention_matmul_{mode}",
        lambda: fused.flash_attention_matmul(q, k, v, wo,
                                             kv_offset=kv_offset, mode=mode))
    _close(out, fused.flash_attention_matmul_plain(
        q, k, v, wo, kv_offset=kv_offset, mode=mode), dt)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_attention_matmul_pos_modes(cuda, mode, dt):
    gen = torch.Generator().manual_seed(7)
    q, k, v, wo = _attn_inputs(gen, DTYPES[dt], cuda, 4, 8, 2, 1, 200, 128,
                               300)
    pos = torch.tensor([0, 77, 199, -1], dtype=torch.int32, device=cuda)
    out = _launched_only(
        f"flash_attention_matmul_pos_{mode}",
        lambda: fused.flash_attention_matmul(q, k, v, wo, pos=pos, mode=mode))
    _close(out, fused.flash_attention_matmul_plain(q, k, v, wo, pos=pos,
                                                   mode=mode), dt)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("d", [64, 128])
def test_paged_attention_matmul_modes(cuda, mode, dt, d):
    gen = torch.Generator().manual_seed(d)
    dtype = DTYPES[dt]
    page_size, b, h, hkv, n, num_pages, maxp = 128, 4, 8, 2, 256, 13, 3
    q = _rand(gen, (b, h, 1, d), dtype, cuda)
    kp = _rand(gen, (num_pages, hkv, page_size, d), dtype, cuda)
    vp = _rand(gen, (num_pages, hkv, page_size, d), dtype, cuda)
    wo = _rand(gen, (h * d, n), dtype, cuda, (h * d) ** -0.5)
    tables = np.random.default_rng(d).permutation(num_pages)[:b * maxp] \
        .reshape(b, maxp).astype(np.int32)
    tables[1, 1:] = num_pages                 # sentinel entries past pos
    tables = torch.from_numpy(tables).to(cuda)
    pos = torch.tensor([3 * page_size - 1, 100, 0, page_size + 5],
                       dtype=torch.int32, device=cuda)
    out = _launched_only(
        f"paged_attention_matmul_{mode}",
        lambda: fused.paged_attention_matmul(q, kp, vp, wo,
                                             block_tables=tables, pos=pos,
                                             mode=mode))
    _close(out, fused.paged_attention_matmul_plain(
        q, kp, vp, wo, block_tables=tables, pos=pos, mode=mode), dt)


def test_mode_wrappers_refuse_what_has_no_kernel(cuda):
    """The int8 forms run under every mode (each launching its mode's q8
    counter); what is refused is a page size that is not a multiple of
    128, the JAX package's refusal, in the f32 and the int8 forms."""
    x = torch.randn(8, 64, device=cuda, dtype=torch.bfloat16)
    w = torch.ones(64, device=cuda, dtype=torch.bfloat16)
    wq, ws = fused.quantize_weight(torch.randn(64, 32, device=cuda))
    for mode in MODES:
        out = _launched_only(
            f"rmsnorm_matmul_q8_{mode}",
            lambda: fused._norm_gemm("rmsnorm_matmul", x, w, wq, 32, 1e-6,
                                     w_scale=ws, mode=mode))
        _close(out, fused.rmsnorm_matmul_q8_plain(x, w, wq, ws, mode=mode),
               "bf16")
    fused.reset_launch_counts()
    q = torch.randn(2, 4, 1, 64, device=cuda)
    kp = torch.randn(3, 2, 64, 64, device=cuda)
    tables = torch.zeros(2, 1, dtype=torch.int32, device=cuda)
    pos = torch.zeros(2, dtype=torch.int32, device=cuda)
    wo = torch.randn(256, 8, device=cuda)
    with pytest.raises(ValueError, match="multiple of 128"):
        fused.paged_attention_matmul(q, kp, kp, wo, block_tables=tables,
                                     pos=pos, mode="abstract")
    from repro_torch.models.attention import quantize_kv
    kq, ks = quantize_kv(kp)
    with pytest.raises(ValueError, match="multiple of 128"):
        fused.flash_attention_matmul_q8(q, kq, kq, wo, k_scale=ks,
                                        v_scale=ks, block_tables=tables,
                                        pos=pos, mode="abstract+shuffle")
    assert not any(fused.LAUNCHES.values())


@pytest.mark.parametrize("mode", MODES)
def test_mode_engine_tick_makes_no_host_sync(cuda, mode):
    """A small dense model under ``isa_mode=mode``: prefill and five ticks
    (host syncs forbidden) launch that mode's kernels and no native one."""
    cfg = ModelConfig(name="t", family="dense", num_layers=2, d_model=64,
                      num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
                      dtype="bfloat16")
    model = build_model(cfg, ParallelConfig(
        isa_mode=mode, fuse_epilogues=True, use_pallas_attn=True),
        device=cuda)
    params = model.init_params(0)
    eng = BatchedEngine(model, params, ServeConfig(
        batch_slots=2, max_seq_len=256, eos_id=-1, page_size=128))
    fused.reset_launch_counts()
    eng.add_request(Request(rid=0, prompt=[3, 5, 7, 9], max_new_tokens=40))
    torch.cuda.synchronize()
    assert fused.LAUNCHES[f"flash_attention_matmul_{mode}"] == cfg.num_layers
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
    assert {k: v for k, v in fused.LAUNCHES.items() if v} == {
        f"rmsnorm_matmul_{mode}": 5 * (cfg.num_layers + 1),
        f"rmsnorm_swiglu_{mode}": 5 * cfg.num_layers,
        f"paged_attention_matmul_{mode}": 5 * cfg.num_layers}


# ---------------------------------------------------------------------------
# granite-moe-3b-a800m's kernels under the abstract and abstract+shuffle
# modes: rmsnorm, add_rmsnorm, flash_attention, the tied f32 head, and the
# attention + wo kernels at head_dim 64, group 3, pages of 128
# ---------------------------------------------------------------------------


def _row_route(d, dtype, mode, aligned=True):
    """The route the row-norm C entries must report
    (``csrc/row_norm.cuh::row_plan``, mirrored by ``fused.row_norm_plan``)."""
    itemsize = torch.finfo(dtype).bits // 8
    if fused.row_norm_plan(d, itemsize) is None:
        return "loop"
    vec = mode == "native" and aligned and d % (16 // itemsize) == 0
    return "vector" if vec else "element"


@pytest.mark.parametrize("mode", ("native",) + MODES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("rows,d", NORM_SHAPES + [(3, 1536)])
def test_rmsnorm_matches_plain(cuda, mode, dt, rows, d):
    """Every mode against its plain version, on aligned operands and on
    views offset by one element (the element route); row counts that leave
    a block without a row (7, 33, 5, 3 rows) must pass every barrier."""
    gen = torch.Generator().manual_seed(rows * d)
    x = _rand(gen, (rows, d), DTYPES[dt], cuda)
    w = 1.0 + _rand(gen, (d,), DTYPES[dt], cuda, 0.1)
    counter = fused._count_name("rmsnorm", mode)
    out = _launched_only(counter, lambda: rmsnorm.rmsnorm(x, w, mode=mode))
    assert LAST_ROUTE[counter] == _row_route(d, x.dtype, mode)
    assert out.dtype == x.dtype and out.shape == x.shape
    want = rmsnorm.rmsnorm_plain(x, w, mode=mode)
    _close(out, want, dt)
    _close(rmsnorm.rmsnorm(_unaligned(x), _unaligned(w), mode=mode), want,
           dt)
    assert LAST_ROUTE[counter] == _row_route(d, x.dtype, mode, False)


@pytest.mark.parametrize("mode", ("native",) + MODES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("rows,d", NORM_SHAPES + [(3, 1536)])
def test_add_rmsnorm_matches_plain(cuda, mode, dt, rows, d):
    """As test_rmsnorm_matches_plain; the sum is bit-equal to the plain
    version's (one f32 add, rounded once) in every mode and on every
    route."""
    gen = torch.Generator().manual_seed(rows + d)
    x = _rand(gen, (2, rows, d), DTYPES[dt], cuda)
    r = _rand(gen, (2, rows, d), DTYPES[dt], cuda, 0.5)
    w = 1.0 + _rand(gen, (d,), DTYPES[dt], cuda, 0.1)
    counter = fused._count_name("add_rmsnorm", mode)
    normed, summed = _launched_only(
        counter, lambda: fused.add_rmsnorm(x, r, w, mode=mode))
    assert LAST_ROUTE[counter] == _row_route(d, x.dtype, mode)
    want_n, want_s = fused.add_rmsnorm_plain(x, r, w, mode=mode)
    assert torch.equal(summed, want_s)
    assert torch.equal(summed, fused.add_rmsnorm(x, r, w)[1])
    _close(normed, want_n, dt)
    normed, summed = fused.add_rmsnorm(_unaligned(x), r, _unaligned(w),
                                       mode=mode)
    assert LAST_ROUTE[counter] == _row_route(d, x.dtype, mode, False)
    assert torch.equal(summed, want_s)
    _close(normed, want_n, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["rmsnorm", "add_rmsnorm"])
@pytest.mark.parametrize("rows,d", [(8, 1536), (512, 5120), (300, 1539),
                                    (5, 16388), (4, 32768), (3, 32776)])
def test_row_norm_routes(cuda, dt, kernel, rows, d):
    """Each route the C entries report, in every mode: ``vector`` (native,
    16-byte loads), ``element`` (a width off the 16-byte slot, a view
    offset by one element, every other mode) and ``loop`` (rows wider than
    the registers hold: f32 past 16384, bf16 past 32768).  On the one-pass
    routes the split and the fold do not depend on the loads or on the
    butterfly's mode: native's vector and element launches and
    abstract+shuffle's give the same bits."""
    dtype = DTYPES[dt]
    gen = torch.Generator().manual_seed(rows + 7 * d)
    x = _rand(gen, (rows, d), dtype, cuda)
    r = _rand(gen, (rows, d), dtype, cuda, 0.5)
    w = 1.0 + _rand(gen, (d,), dtype, cuda, 0.1)

    def run(mode, x, w):
        if kernel == "rmsnorm":
            return rmsnorm.rmsnorm(x, w, mode=mode), \
                rmsnorm.rmsnorm_plain(x, w, mode=mode)
        (out, _), (want, _) = (fused.add_rmsnorm(x, r, w, mode=mode),
                               fused.add_rmsnorm_plain(x, r, w, mode=mode))
        return out, want
    outs = {}
    for mode in ("native",) + MODES:
        counter = fused._count_name(kernel, mode)
        LAST_ROUTE.clear()
        out, want = run(mode, x, w)
        torch.cuda.synchronize()
        assert LAST_ROUTE == {counter: _row_route(d, dtype, mode)}
        _close(out, want, dt)
        outs[mode] = out
    out, want = run("native", _unaligned(x), _unaligned(w))
    torch.cuda.synchronize()
    assert LAST_ROUTE[kernel] == _row_route(d, dtype, "native", False)
    _close(out, want, dt)
    if _row_route(d, dtype, "native") != "loop":
        assert torch.equal(out, outs["native"])
        assert torch.equal(outs["abstract+shuffle"], outs["native"])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,h,hkv,sq,skv,d,causal,kv_offset", [
    (1, 24, 8, 512, 512, 64, True, None),      # granite-moe prefill
    (1, 24, 8, 300, 300, 64, True, None),      # partial q and key tiles
    (1, 24, 8, 300, 300, 64, False, None),     # non-causal, partial tail
    (2, 4, 4, 37, 70, 128, True, None),
    (2, 4, 1, 20, 50, 32, True, 10),           # a given kv_offset
    (1, 8, 2, 1, 77, 64, True, None),          # one query
    (3, 6, 2, 65, 65, 16, False, None),
])
def test_flash_attention_modes_match_plain(cuda, mode, dt, b, h, hkv, sq,
                                           skv, d, causal, kv_offset):
    gen = torch.Generator().manual_seed(sq * skv + h)
    q = _rand(gen, (b, h, sq, d), DTYPES[dt], cuda)
    k = _rand(gen, (b, hkv, skv, d), DTYPES[dt], cuda)
    v = _rand(gen, (b, hkv, skv, d), DTYPES[dt], cuda)
    out = _launched_only(
        f"flash_attention_{mode}",
        lambda: attention.flash_attention(q, k, v, causal=causal,
                                          kv_offset=kv_offset, mode=mode))
    assert out.dtype == q.dtype and out.shape == q.shape
    assert bool(torch.isfinite(out).all())
    _close(out, attention.flash_attention_plain(
        q, k, v, causal=causal, kv_offset=kv_offset, mode=mode), dt)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("rows,d,n", [(8, 1536, 49155), (1, 1536, 49155),
                                      (300, 64, 515), (3, 100, 77)])
def test_rmsnorm_matmul_modes_read_a_tied_f32_table(cuda, mode, dt, rows, d,
                                                    n):
    """The tied head under a mode: the f32 [N, D] embedding as its
    transposed view, and an f32 [D, N] weight, beside bf16 or f32
    activations; odd N."""
    gen = torch.Generator().manual_seed(rows + n)
    x = _rand(gen, (rows, d), DTYPES[dt], cuda)
    w = 1.0 + _rand(gen, (d,), DTYPES[dt], cuda, 0.1)
    table = _rand(gen, (n, d), torch.float32, cuda, 0.02)
    for W in (table.t(), table.t().contiguous()):
        out = _launched_only(
            f"rmsnorm_matmul_{mode}",
            lambda: fused.rmsnorm_matmul(x, w, W, mode=mode))
        assert out.dtype == x.dtype and out.shape == (rows, n)
        _close(out, fused.rmsnorm_matmul_plain(x, w, W, mode=mode), dt)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("sq", [512, 300, 1])
def test_attention_matmul_modes_at_group_3_head_dim_64(cuda, mode, dt, sq):
    """granite-moe's widths under a mode: 24 query heads over 8 kv heads of
    64, wo [1536, 1536]; dense causal, and the paged decode shape at pages
    of 128."""
    gen = torch.Generator().manual_seed(sq)
    q, k, v, wo = _attn_inputs(gen, DTYPES[dt], cuda, 1, 24, 8, sq, sq, 64,
                               1536)
    out = _launched_only(
        f"flash_attention_matmul_{mode}",
        lambda: fused.flash_attention_matmul(q, k, v, wo, mode=mode))
    _close(out, fused.flash_attention_matmul_plain(q, k, v, wo, mode=mode),
           dt)
    b, ps, maxp = 8, 128, 5
    qd = _rand(gen, (b, 24, 1, 64), DTYPES[dt], cuda)
    kp = _rand(gen, (b * maxp, 8, ps, 64), DTYPES[dt], cuda)
    vp = _rand(gen, (b * maxp, 8, ps, 64), DTYPES[dt], cuda)
    tables = torch.randperm(b * maxp, generator=gen).to(torch.int32).reshape(
        b, maxp).to(cuda)
    pos = torch.randint(0, maxp * ps, (b,), generator=gen,
                        dtype=torch.int32).to(cuda)
    out = _launched_only(
        f"paged_attention_matmul_{mode}",
        lambda: fused.paged_attention_matmul(qd, kp, vp, wo,
                                             block_tables=tables, pos=pos,
                                             mode=mode))
    _close(out, fused.paged_attention_matmul_plain(
        qd, kp, vp, wo, block_tables=tables, pos=pos, mode=mode), dt)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("policy", ["P1", "P2"])
def test_moe_mode_tick_makes_no_host_sync(cuda, policy, mode):
    """A small granite-moe-shaped model (router-only MoE, tied head) under
    ``isa_mode=mode``, fused (P1) and unfused (P2): prefill and five ticks
    (host syncs forbidden) launch that mode's kernels and no native one."""
    par = dict(isa_mode=mode, use_pallas_attn=True)
    if policy == "P1":
        par["fuse_epilogues"] = True
    cfg = ModelConfig(name="m", family="moe", num_layers=2, d_model=64,
                      num_heads=6, num_kv_heads=2, head_dim=16, d_ff=32,
                      vocab_size=257, tie_embeddings=True,
                      moe=MoEConfig(num_experts=8, top_k=4, group_size=64),
                      dtype="bfloat16")
    model = build_model(cfg, ParallelConfig(**par), device=cuda)
    params = model.init_params(0)
    eng = BatchedEngine(model, params, ServeConfig(
        batch_slots=2, max_seq_len=256, eos_id=-1, page_size=128))
    fused.reset_launch_counts()
    eng.add_request(Request(rid=0, prompt=list(range(3, 80)),
                            max_new_tokens=40))
    torch.cuda.synchronize()
    layers = cfg.num_layers
    if policy == "P1":
        per_prefill = {f"rmsnorm_matmul_{mode}": layers + 1,
                       f"add_rmsnorm_{mode}": layers,
                       f"flash_attention_matmul_{mode}": layers}
        per_tick = {f"rmsnorm_matmul_{mode}": layers + 1,
                    f"add_rmsnorm_{mode}": layers,
                    f"paged_attention_matmul_{mode}": layers}
    else:
        per_prefill = {f"rmsnorm_{mode}": 2 * layers + 1,
                       f"flash_attention_{mode}": layers}
        per_tick = {f"rmsnorm_{mode}": 2 * layers + 1}
    assert {k: v for k, v in fused.LAUNCHES.items() if v} == per_prefill
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
    assert {k: v for k, v in fused.LAUNCHES.items() if v} == \
        {k: 5 * v for k, v in per_tick.items()}


# ---------------------------------------------------------------------------
# the SSD kernels' abstract and abstract+shuffle lowerings, and mamba2 under
# the modes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dt_name", ["f32", "bf16"])
@pytest.mark.parametrize("b,l,h,p,g,n,chunk,init", [
    (1, 512, 80, 64, 1, 128, 256, False),    # mamba2-2.7b prefill
    (1, 300, 80, 64, 1, 128, 256, True),     # partial last chunk, h0
    (1, 128, 80, 64, 1, 128, 256, False),    # chunk clamped to L
    (2, 37, 4, 16, 2, 16, 16, True),         # reduced widths, G = 2
    (3, 70, 6, 20, 3, 12, 32, False),        # widths off the 4-grid
    (1, 300, 8, 64, 2, 128, 256, True),      # G = 2 at N 128, P 64, h0
    (2, 200, 4, 64, 1, 128, 128, False),     # Q 128, a tail of 72
])
def test_ssd_scan_modes_match_plain(cuda, mode, dt_name, b, l, h, p, g, n,
                                    chunk, init):
    gen = torch.Generator().manual_seed(l * h + n + 1)
    x, dt, A, B, C = _ssd_inputs(gen, DTYPES[dt_name], cuda, b, l, h, p, g, n)
    h0 = (torch.randn((b, g, h // g, n, p), generator=gen).to(cuda)
          if init else None)
    LAST_ROUTE.clear()
    y, state = _launched_only(f"ssd_scan_{mode}", lambda: ssd.ssd_scan(
        x, dt, A, B, C, h0, chunk=chunk, mode=mode))
    assert LAST_ROUTE == {f"ssd_scan_{mode}": _scan_route_of(dt_name, p, n)}
    y_ref, state_ref = ssd.ssd_scan_plain(x, dt, A, B, C, h0, chunk=chunk,
                                          mode=mode)
    assert y.dtype == x.dtype and state.dtype == torch.float32
    _close(y, y_ref, dt_name)
    _close(state, state_ref, "f32")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dt_name", ["f32", "bf16"])
@pytest.mark.parametrize("b,h,p,g,n", [(8, 80, 64, 1, 128),
                                       (5, 80, 64, 1, 128),
                                       (3, 4, 16, 2, 16),
                                       (2, 6, 8, 3, 64),
                                       (2, 4, 12, 1, 4)])
def test_ssd_decode_modes_match_plain(cuda, mode, dt_name, b, h, p, g, n):
    """mamba2-2.7b's widths, the reduced config's N = 16 (16-lane groups
    under abstract+shuffle), two rows a lane (N = 64), and N = 4 (4-lane
    groups, P = 12: three column quads)."""
    gen = torch.Generator().manual_seed(b * h + n + 1)
    x, dt, A, B, C = _ssd_inputs(gen, DTYPES[dt_name], cuda, b, 1, h, p, g, n)
    x, dt, B, C = x[:, 0], dt[:, 0], B[:, 0], C[:, 0]
    state = torch.randn((b, g, h // g, n, p), generator=gen).to(cuda)
    new, y = _launched_only(f"ssd_decode_{mode}", lambda: ssd.ssd_decode(
        state, x, dt, A, B, C, mode=mode))
    new_ref, y_ref = ssd.ssd_decode_plain(state, x, dt, A, B, C, mode=mode)
    _close(y, y_ref, dt_name)
    _close(new, new_ref, "f32")
    # in place: each state element is read and written by one thread
    same, y2 = ssd.ssd_decode(state, x, dt, A, B, C, out=state, mode=mode)
    torch.cuda.synchronize()
    assert same is state
    _close(state, new_ref, "f32")
    _close(y2, y_ref, dt_name)


@pytest.mark.parametrize("mode", ("native",) + MODES)
@pytest.mark.parametrize("b,h,p,g,n", [(8, 80, 64, 1, 128),
                                       (2, 4, 12, 1, 4)])
def test_ssd_decode_in_place_equals_the_copy(cuda, mode, b, h, p, g, n):
    """Every mode stages its whole tile before it writes any of it: the
    update in place gives the out-of-place launch's state and y bit for
    bit.  At mamba2-2.7b's widths the blocks of 8 slots (two a slot and
    head) run in one wave on the card's SMs."""
    gen = torch.Generator().manual_seed(b * h + n + 2)
    x, dt, A, B, C = _ssd_inputs(gen, torch.bfloat16, cuda, b, 1, h, p, g, n)
    x, dt, B, C = x[:, 0], dt[:, 0], B[:, 0], C[:, 0]
    state = torch.randn((b, g, h // g, n, p), generator=gen).to(cuda)
    new, y = ssd.ssd_decode(state, x, dt, A, B, C, mode=mode)
    st = state.clone()
    same, y2 = ssd.ssd_decode(st, x, dt, A, B, C, out=st, mode=mode)
    torch.cuda.synchronize()
    assert same is st
    assert torch.equal(st, new) and torch.equal(y2, y)
    new_ref, y_ref = ssd.ssd_decode_plain(state, x, dt, A, B, C, mode=mode)
    _close(new, new_ref, "f32")
    _close(y, y_ref, "bf16")
    if n == 128:
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        blocks = b * h * -(-p // ssd.DECODE_BLOCK_P)
        assert ssd.decode_resident_blocks(mode, torch.bfloat16, n, p) * sms \
            >= blocks


def test_ssd_mode_wrappers_refuse_what_has_no_kernel(cuda):
    """A state width off the power of two raises outside native (native
    takes it), and a dialect without lane shuffles raises on the card
    instead of taking its declared abstract+shuffle -> abstract fallback."""
    from repro_torch.core import ExecutionPolicy, UnsupportedLowering
    gen = torch.Generator().manual_seed(0)
    x, dt, A, B, C = _ssd_inputs(gen, torch.float32, cuda, 2, 1, 4, 8, 1, 12)
    state = torch.zeros(2, 1, 4, 12, 8, device=cuda)
    for mode in MODES:
        with pytest.raises(ValueError, match="power-of-two"):
            ssd.ssd_decode(state, x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0],
                           mode=mode)
    ssd.ssd_decode(state, x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0])
    pol = ExecutionPolicy(mode="abstract+shuffle", dialect="uisa-universal10")
    with pytest.raises(UnsupportedLowering, match="on the card"):
        ops.fused_ssd_scan(x, dt, A, B, C, chunk=8, policy=pol)
    with pytest.raises(UnsupportedLowering, match="on the card"):
        ops.fused_ssd_decode(state, x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0],
                             policy=pol)


@pytest.mark.parametrize("mode", MODES)
def test_mamba_mode_tick_makes_no_host_sync(cuda, mode):
    """A small mamba2-shaped model under ``isa_mode=mode``: prefill and five
    ticks (host syncs forbidden) launch that mode's ssd_scan, ssd_decode and
    rmsnorm (2 x layers + 1 a call) and no native kernel."""
    cfg = ModelConfig(name="t", family="ssm", num_layers=2, d_model=64,
                      num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=256,
                      dtype="bfloat16", subquadratic=True, tie_embeddings=True,
                      ssm=SSMConfig(state_dim=16, head_dim=16, chunk_size=8))
    model = build_model(cfg, ParallelConfig(isa_mode=mode,
                                            fuse_epilogues=True),
                        device=cuda)
    params = model.init_params(0)
    eng = BatchedEngine(model, params, ServeConfig(
        batch_slots=2, max_seq_len=64, eos_id=-1))
    fused.reset_launch_counts()
    eng.add_request(Request(rid=0, prompt=[3, 5, 7, 9, 11], max_new_tokens=40))
    torch.cuda.synchronize()
    layers = cfg.num_layers
    assert {k: v for k, v in fused.LAUNCHES.items() if v} == {
        f"ssd_scan_{mode}": layers, f"rmsnorm_{mode}": 2 * layers + 1}
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
    assert {k: v for k, v in fused.LAUNCHES.items() if v} == {
        f"ssd_decode_{mode}": 5 * layers,
        f"rmsnorm_{mode}": 5 * (2 * layers + 1)}


# ---------------------------------------------------------------------------
# the int8 twins under the abstract and abstract+shuffle modes, and the
# int8 tied head (a transposed f32 table quantized per call)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("rows,d,n", [(1, 256, 320), (8, 4096, 6144),
                                      (37, 100, 200), (300, 4096, 6144),
                                      (520, 512, 6000), (8, 1536, 2560)])
def test_rmsnorm_matmul_q8_modes_match_plain(cuda, mode, dt, rows, d, n):
    gen = torch.Generator().manual_seed(rows + n + 1)
    x = _rand(gen, (rows, d), DTYPES[dt], cuda)
    w = 1.0 + _rand(gen, (d,), DTYPES[dt], cuda, 0.1)
    W, s = _q8(_rand(gen, (d, n), torch.float32, cuda, d ** -0.5))
    out = _launched_only(
        f"rmsnorm_matmul_q8_{mode}",
        lambda: fused.rmsnorm_matmul_q8(x, w, W, w_scale=s, mode=mode))
    assert out.dtype == x.dtype and out.shape == (rows, n)
    _close(out, fused.rmsnorm_matmul_q8_plain(x, w, W, s, mode=mode), dt)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("rows,d,f", [(3, 256, 96), (8, 4096, 1024),
                                      (70, 500, 330), (300, 512, 7000)])
def test_rmsnorm_swiglu_q8_modes_match_plain(cuda, mode, dt, rows, d, f):
    gen = torch.Generator().manual_seed(rows + f + 1)
    x = _rand(gen, (rows, d), DTYPES[dt], cuda)
    w = 1.0 + _rand(gen, (d,), DTYPES[dt], cuda, 0.1)
    w_cat, s = _q8(_rand(gen, (d, 2 * f), torch.float32, cuda, d ** -0.5))
    out = _launched_only(
        f"rmsnorm_swiglu_q8_{mode}",
        lambda: fused.rmsnorm_swiglu_q8(x, w, w_cat, w_scale=s, mode=mode))
    _close(out, fused.rmsnorm_swiglu_q8_plain(x, w, w_cat, s, mode=mode), dt)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,h,hkv,sq,skv,d,n,kv_offset", [
    (1, 8, 2, 100, 100, 64, 200, None), (1, 32, 8, 300, 300, 128, 512, None),
    (1, 24, 8, 130, 130, 64, 1536, None), (2, 4, 1, 20, 50, 32, 64, 10)])
def test_flash_attention_matmul_q8_modes_causal_and_pos(
        cuda, mode, dt, b, h, hkv, sq, skv, d, n, kv_offset):
    gen = torch.Generator().manual_seed(sq * skv + 2)
    q, k, v, wo = _attn_inputs(gen, DTYPES[dt], cuda, b, h, hkv, sq, skv,
                               d, n)
    woq, s = _q8(wo.float())
    out = _launched_only(
        f"flash_attention_matmul_q8_{mode}",
        lambda: fused.flash_attention_matmul_q8(q, k, v, woq, w_scale=s,
                                                kv_offset=kv_offset,
                                                mode=mode))
    _close(out, fused.flash_attention_matmul_q8_plain(
        q, k, v, woq, s, kv_offset=kv_offset, mode=mode), dt)
    qd, kd, vd, _ = _attn_inputs(gen, DTYPES[dt], cuda, 4, h, hkv, 1, skv,
                                 d, n)
    pos = torch.tensor([0, skv // 3, skv - 1, -1], dtype=torch.int32,
                       device=cuda)
    out = _launched_only(
        f"flash_attention_matmul_q8_pos_{mode}",
        lambda: fused.flash_attention_matmul_q8(qd, kd, vd, woq, w_scale=s,
                                                pos=pos, mode=mode))
    _close(out, fused.flash_attention_matmul_q8_plain(
        qd, kd, vd, woq, s, pos=pos, mode=mode), dt)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("kv", ["int8", "float"])
@pytest.mark.parametrize("d,h,hkv", [(128, 8, 2), (64, 24, 8)])
def test_paged_attention_matmul_q8_modes(cuda, mode, dt, kv, d, h, hkv):
    """Pages of 128 keys: int8 pools and scale pools read through the
    clamped table entry (sentinels past pos, a trash page past P) beside an
    int8 wo, and pools at the working dtype beside an int8 wo."""
    from repro_torch.models.attention import quantize_kv
    gen = torch.Generator().manual_seed(d + h)
    dtype = DTYPES[dt]
    page_size, b, n, num_pages, maxp = 128, 4, 256, 13, 3
    q = _rand(gen, (b, h, 1, d), dtype, cuda)
    kp = _rand(gen, (num_pages, hkv, page_size, d), dtype, cuda)
    vp = _rand(gen, (num_pages, hkv, page_size, d), dtype, cuda)
    ks = vs = None
    if kv == "int8":
        (kp, ks), (vp, vs) = quantize_kv(kp), quantize_kv(vp)
    woq, s = _q8(_rand(gen, (h * d, n), torch.float32, cuda,
                       (h * d) ** -0.5))
    tables = np.random.default_rng(d).permutation(num_pages)[:b * maxp] \
        .reshape(b, maxp).astype(np.int32)
    tables[1, 1:] = num_pages                 # sentinel entries past pos
    tables = torch.from_numpy(tables).to(cuda)
    pos = torch.tensor([3 * page_size - 1, 100, 0, page_size + 5],
                       dtype=torch.int32, device=cuda)
    kwargs = dict(w_scale=s, k_scale=ks, v_scale=vs, block_tables=tables,
                  pos=pos)
    out = _launched_only(
        f"paged_attention_matmul_q8_{mode}",
        lambda: fused.flash_attention_matmul_q8(q, kp, vp, woq, mode=mode,
                                                **kwargs))
    _close(out, fused.flash_attention_matmul_q8_plain(
        q, kp, vp, woq, mode=mode, **kwargs), dt)


@pytest.mark.parametrize("mode", ("native",) + MODES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_int8_tied_head_quantizes_a_transposed_table(cuda, mode, dt):
    """The int8 policy's tied head: an f32 [V, D] table reaches the q8 op
    as its transposed view, read in place by the decode GEMV's
    transposed form, which quantizes each table row in its stream (pass 1
    the row scales): one call on the gemv route, right against the plain
    version of ``quantize_weight``'s contiguous int8 [D, V], and beside
    the two-step path (``quantize_weight``, then the int8 weight's own
    route, the FMA kernel at an odd V) within the same tolerance: the
    transposed form sums K in order, the FMA kernel in its tiles."""
    gen = torch.Generator().manual_seed(11)
    v, d = 4099, 1536
    x = _rand(gen, (8, d), DTYPES[dt], cuda)
    w = 1.0 + _rand(gen, (d,), DTYPES[dt], cuda, 0.1)
    table = _rand(gen, (v, d), torch.float32, cuda, 0.02)
    counter = "rmsnorm_matmul_q8" + ("" if mode == "native" else f"_{mode}")
    out = _launched_only(
        counter, lambda: fused.rmsnorm_matmul_q8(x, w, table.t(), mode=mode))
    assert LAST_ROUTE[counter] == "gemv"
    assert out.shape == (8, v) and out.dtype == x.dtype
    wq, ws = fused.quantize_weight(table.t())
    assert wq.is_contiguous()
    _close(out, fused.rmsnorm_matmul_q8_plain(x, w, wq, ws, mode=mode), dt)
    two_step = fused.rmsnorm_matmul_q8(x, w, wq, w_scale=ws, mode=mode)
    assert LAST_ROUTE[counter] == "fma"
    _close(out, two_step, dt)


# ---------------------------------------------------------------------------
# a float head quantized per call inside the decode GEMV: granite-8b's bf16
# lm_head read [K, N] (and its f32 form), granite-moe's f32 table read
# transposed
# ---------------------------------------------------------------------------

#: form -> (K, N): a [K, N] head at x's dtype, too narrow for a strip of 64
#: columns an SM (bf16: pass 1, then the two-pass GEMV) or wide enough
#: (bf16: the strip kernel); the [N, K] f32 table (odd N: its strip kernel
#: where x_n fits its shared memory, at most 9 rows of K = 1536; else pass 1,
#: then the two-pass transposed form)
Q8_HEADS = {"kn": (1024, 1024), "strip": (1024, 16384),
            "table": (1536, 4099)}


def _q8_head(gen, form, dt, dev, edges=False):
    """The float head of ``form`` as the q8 op receives it (the table as
    its transposed view); with ``edges`` its channels 0-2 are a channel of
    zeros, one with a subnormal max and one whose largest magnitude is
    negative."""
    k, n = Q8_HEADS[form]
    if form != "table":
        head = _rand(gen, (k, n), DTYPES[dt], dev, k ** -0.5)
    else:
        head = _rand(gen, (n, k), torch.float32, dev, 0.02).t()
    if edges:
        head[:, 0] = 0.0
        head[:, 1] = _rand(gen, (k,), torch.float32, dev, 2.0 ** -130)
        head[7, 2] = -4.0
    return head


@pytest.mark.parametrize("rows", [1, 5, 8, 16])
@pytest.mark.parametrize("mode", ("native",) + MODES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("form", list(Q8_HEADS))
def test_q8_float_head_matches_plain(cuda, form, dt, mode, rows):
    """One call on the gemv route in every mode (pass 1, the normalized
    rows, the GEMV quantizing in its stream; the wide bf16 head the
    normalized rows, then the strip kernel: counted once), right against
    the plain version of ``quantize_weight``'s int8 weight and scales."""
    gen = torch.Generator().manual_seed(rows + len(form))
    k, n = Q8_HEADS[form]
    x = _rand(gen, (rows, k), DTYPES[dt], cuda)
    w = 1.0 + _rand(gen, (k,), DTYPES[dt], cuda, 0.1)
    head = _q8_head(gen, form, dt, cuda, edges=rows == 5)
    counter = fused._count_name("rmsnorm_matmul_q8", mode)
    out = _launched_only(counter, lambda: fused.rmsnorm_matmul_q8(
        x, w, head, mode=mode))
    assert LAST_ROUTE[counter] == "gemv"
    assert out.shape == (rows, n) and out.dtype == x.dtype
    wq, ws = fused.quantize_weight(head)
    _close(out, fused.rmsnorm_matmul_q8_plain(x, w, wq, ws, mode=mode), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("form", list(Q8_HEADS))
def test_q8_float_head_against_the_two_step_path(cuda, form, dt):
    """Against the two-step path (``quantize_weight``, then the int8
    weight's route).  The two-pass [K, N] form keeps the int8 route's K
    split and order (plan_gemv_q; q exact in bf16 on the same mma
    fragments, or in f32 on the same FMAs), so it equals that path bit for
    bit in both dtypes (the narrow head, and the wide one in f32); the
    strip kernel sums the chunks of its 8 warps in warp order, and the
    transposed table sums K in order where its int8 copy (V
    odd) takes the FMA kernel: both are held at the row's tolerance (their
    q and scales bit for bit in the one-hot test below)."""
    gen = torch.Generator().manual_seed(31)
    k, _ = Q8_HEADS[form]
    x = _rand(gen, (8, k), DTYPES[dt], cuda)
    w = 1.0 + _rand(gen, (k,), DTYPES[dt], cuda, 0.1)
    head = _q8_head(gen, form, dt, cuda, edges=True)
    out = fused.rmsnorm_matmul_q8(x, w, head)
    wq, ws = fused.quantize_weight(head)
    two_step = fused.rmsnorm_matmul_q8(x, w, wq, w_scale=ws)
    torch.cuda.synchronize()
    assert LAST_ROUTE["rmsnorm_matmul_q8"] == \
        ("fma" if form == "table" else "gemv")
    if form == "kn" or (form == "strip" and dt == "f32"):
        assert torch.equal(out, two_step)
    else:
        _close(out, two_step, dt)


@pytest.mark.parametrize("mode", ("native",) + MODES)
@pytest.mark.parametrize("form", ["strip", "table"])
def test_q8_float_head_one_hot_rows_equal_the_two_step_path(cuda, form,
                                                            mode):
    """Rows of x each one-hot at its own k: every output is one product
    x_n[k] q (exact in f32) times the channel's scale, whatever the K order,
    so the strip kernel and the transposed table (at an even V: its int8
    copy then takes the GEMV too) equal the two-step path bit for bit:
    their in-kernel scales and q are ``quantize_weight``'s."""
    gen = torch.Generator().manual_seed(71)
    k, n = Q8_HEADS[form][0], 4096 if form == "table" else Q8_HEADS[form][1]
    bf = torch.bfloat16
    x = torch.zeros(8, k, dtype=bf, device=cuda)
    x[torch.arange(8), torch.arange(8) * (k // 8) + 5] = 1.5
    w = 1.0 + _rand(gen, (k,), bf, cuda, 0.1)
    if form == "table":
        head = _rand(gen, (n, k), torch.float32, cuda, 0.02).t()
    else:
        head = _rand(gen, (k, n), bf, cuda, k ** -0.5)
    head[:, 0] = 0.0
    counter = fused._count_name("rmsnorm_matmul_q8", mode)
    out = fused.rmsnorm_matmul_q8(x, w, head, mode=mode)
    assert LAST_ROUTE[counter] == "gemv"
    wq, ws = fused.quantize_weight(head)
    two_step = fused.rmsnorm_matmul_q8(x, w, wq, w_scale=ws, mode=mode)
    assert LAST_ROUTE[counter] == "gemv"
    torch.cuda.synchronize()
    assert torch.equal(out, two_step)


@pytest.mark.parametrize("form,dt", [("kn", "bf16"), ("kn", "f32"),
                                     ("strip", "bf16"), ("table", "f32")])
def test_q8_pass1_scales_equal_quantize_weight(cuda, form, dt):
    """Pass 1 alone (``quantize_scales``) gives ``quantize_weight``'s
    scales bit for bit, on the card and on the CPU, edge channels too."""
    gen = torch.Generator().manual_seed(41)
    head = _q8_head(gen, form, dt, cuda, edges=True)
    got = fused.quantize_scales(head)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["q8_scales"] >= 1
    _, want = fused.quantize_weight(head)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), fused.quantize_weight(head.cpu())[1])
    assert float(got[0]) == float(torch.tensor(1e-8)) \
        == float(got[1])


@pytest.mark.parametrize("form", list(Q8_HEADS))
def test_q8_float_head_launches_only_the_port_kernels(cuda, form):
    """Under ``torch.profiler``, one call on a float head launches the
    port's kernels alone (pass 1, the normalized rows, the GEMV; the wide
    bf16 head and the table beside bf16 x the normalized rows and a strip
    kernel): no PyTorch elementwise, copy or reduction kernel."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator().manual_seed(51)
    k, _ = Q8_HEADS[form]
    x = _rand(gen, (8, k), torch.bfloat16, cuda)
    w = 1.0 + _rand(gen, (k,), torch.bfloat16, cuda, 0.1)
    head = _q8_head(gen, form, "bf16", cuda)
    fused.rmsnorm_matmul_q8(x, w, head)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fused.rmsnorm_matmul_q8(x, w, head)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert names and all("uisa::" in n for n in names), names
    first = {"kn": "q8_scales", "strip": "qstrip", "table": "tq_kernel"}
    assert any(first[form] in n for n in names), names
    assert len(names) == (3 if form == "kn" else 2), names


@pytest.mark.parametrize("form", list(Q8_HEADS))
def test_q8_float_head_reads_a_weight_changed_in_place(cuda, form):
    """Nothing is cached across calls: a head changed in place between two
    calls of the same shapes gives the new weight's result."""
    gen = torch.Generator().manual_seed(61)
    k, _ = Q8_HEADS[form]
    x = _rand(gen, (8, k), torch.bfloat16, cuda)
    w = 1.0 + _rand(gen, (k,), torch.bfloat16, cuda, 0.1)
    head = _q8_head(gen, form, "bf16", cuda)
    first = fused.rmsnorm_matmul_q8(x, w, head)
    head.mul_(-3.0)
    head[:, 3] = 0.0
    second = fused.rmsnorm_matmul_q8(x, w, head)
    torch.cuda.synchronize()
    wq, ws = fused.quantize_weight(head)
    _close(second, fused.rmsnorm_matmul_q8_plain(x, w, wq, ws), "bf16")
    assert not torch.equal(first, second)
    assert not second[:, 3].any()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tied", [False, True])
def test_int8_mode_engine_tick_makes_no_host_sync(cuda, mode, tied):
    """A small dense model under the int8 policy in ``mode`` (int8 weights,
    int8 pools at pages of 128; tied: the head quantizes the f32 table per
    call): prefill and five ticks (host syncs forbidden) launch that mode's
    q8 kernels and nothing else."""
    from repro_torch.models import common
    cfg = ModelConfig(name="t", family="dense", num_layers=2, d_model=64,
                      num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
                      dtype="bfloat16", tie_embeddings=tied)
    model = build_model(cfg, ParallelConfig(
        isa_mode=mode, fuse_epilogues=True, use_pallas_attn=True,
        weight_precision="int8", kv_cache_int8=True), device=cuda)
    params = common.quantize_params(model.init_params(0))
    eng = BatchedEngine(model, params, ServeConfig(
        batch_slots=2, max_seq_len=256, eos_id=-1, page_size=128))
    fused.reset_launch_counts()
    eng.add_request(Request(rid=0, prompt=[3, 5, 7, 9], max_new_tokens=40))
    torch.cuda.synchronize()
    assert {k: v for k, v in fused.LAUNCHES.items() if v} == {
        f"rmsnorm_matmul_q8_{mode}": cfg.num_layers + 1,
        f"rmsnorm_swiglu_q8_{mode}": cfg.num_layers,
        f"flash_attention_matmul_q8_{mode}": cfg.num_layers}
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
    assert {k: v for k, v in fused.LAUNCHES.items() if v} == {
        f"rmsnorm_matmul_q8_{mode}": 5 * (cfg.num_layers + 1),
        f"rmsnorm_swiglu_q8_{mode}": 5 * cfg.num_layers,
        f"paged_attention_matmul_q8_{mode}": 5 * cfg.num_layers}


# ---------------------------------------------------------------------------
# the tensor-core routes of rmsnorm_matmul and flash_attention_matmul: each
# side of every route condition, in every mode, against the plain version
# ---------------------------------------------------------------------------

ALL_MODES = ("native",) + MODES


@pytest.mark.parametrize("mode", ALL_MODES)
@pytest.mark.parametrize("dt,rows,d,n,route", [
    ("bf16", 16, 512, 520, "gemv"),         # decode rows: M <= SMALL_M
    ("bf16", 17, 512, 520, "tc"),
    ("bf16", 300, 4096, 6144, "tc"),        # granite-8b's qkv
    ("bf16", 513, 512, 200, "tc"),          # a ragged last row tile
    ("bf16", 300, 520, 512, "fma"),         # K % 64 != 0
    ("bf16", 300, 512, 517, "fma"),         # N % 8 != 0
    ("f32", 300, 512, 520, "fma"),          # f32 activations
    ("f32", 8, 512, 520, "gemv"),           # f32 decode rows
    ("bf16", 8, 512, 517, "fma"),           # decode rows, N % 8 != 0
])
def test_rmsnorm_matmul_routes(cuda, mode, dt, rows, d, n, route):
    gen = torch.Generator().manual_seed(rows + d + n)
    dtype = DTYPES[dt]
    x = _rand(gen, (rows, d), dtype, cuda)
    w = _rand(gen, (d,), dtype, cuda)
    W = _rand(gen, (d, n), dtype, cuda, d ** -0.5)
    LAST_ROUTE.clear()
    out = fused.rmsnorm_matmul(x, w, W, mode=mode)
    torch.cuda.synchronize()
    assert LAST_ROUTE[fused._count_name("rmsnorm_matmul", mode)] == route
    _close(out, fused.rmsnorm_matmul_plain(x, w, W, mode=mode), dt)


def test_rmsnorm_matmul_tc_route_skips_unaligned_and_tied_weights(cuda):
    gen = torch.Generator().manual_seed(5)
    x = _rand(gen, (64, 512), torch.bfloat16, cuda)
    w = _rand(gen, (512,), torch.bfloat16, cuda)
    flat = _rand(gen, (512 * 520 + 4,), torch.bfloat16, cuda, 512 ** -0.5)
    W = flat[4:].view(512, 520)               # 8 bytes off 16-byte alignment
    table = _rand(gen, (520, 512), torch.float32, cuda, 512 ** -0.5)
    for weight in (W, table.t()):
        LAST_ROUTE.clear()
        out = fused.rmsnorm_matmul(x, w, weight)
        torch.cuda.synchronize()
        assert LAST_ROUTE["rmsnorm_matmul"] == "fma"
        _close(out, fused.rmsnorm_matmul_plain(x, w, weight), "bf16")


@pytest.mark.parametrize("mode", ALL_MODES)
@pytest.mark.parametrize("b,h,hkv,sq,skv,d,n,kv_offset,route", [
    (1, 16, 4, 300, 300, 128, 512, None, "tc"),     # G 4, D 128
    (1, 12, 4, 300, 300, 64, 384, None, "tc"),      # G 3, D 64
    (2, 8, 2, 70, 200, 128, 256, None, "tc"),       # Sq < Skv, offset 130
    (1, 12, 4, 100, 230, 64, 96, 77, "tc"),         # offset not Skv - Sq
    (1, 12, 4, 16, 16, 64, 96, None, "fma"),        # B x Sq = 16 rows
    (1, 12, 4, 17, 17, 64, 96, None, "tc"),
    (1, 8, 2, 100, 100, 32, 96, None, "fma"),       # D 32
    (1, 8, 2, 100, 100, 64, 100, None, "fma"),      # N % 8 != 0
])
def test_flash_attention_matmul_routes(cuda, mode, b, h, hkv, sq, skv, d, n,
                                       kv_offset, route):
    gen = torch.Generator().manual_seed(sq * skv + d)
    q, k, v, wo = _attn_inputs(gen, torch.bfloat16, cuda, b, h, hkv, sq, skv,
                               d, n)
    LAST_ROUTE.clear()
    out = fused.flash_attention_matmul(q, k, v, wo, kv_offset=kv_offset,
                                       mode=mode)
    torch.cuda.synchronize()
    assert LAST_ROUTE[fused._count_name("flash_attention_matmul", mode)] == \
        route
    _close(out, fused.flash_attention_matmul_plain(
        q, k, v, wo, kv_offset=kv_offset, mode=mode), "bf16")


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_flash_attention_matmul_tc_route_skips_unaligned_qkv(cuda, which):
    """The core loads q, k and v with 16-byte cp.async: an operand 8 bytes
    off that alignment (a contiguous view into a larger buffer) takes the
    fma route instead of faulting."""
    gen = torch.Generator().manual_seed(12)
    ops = dict(zip("qkvw", _attn_inputs(gen, torch.bfloat16, cuda, 1, 8, 2,
                                        100, 100, 64, 256)))
    t = ops[which]
    flat = torch.empty(t.numel() + 4, dtype=t.dtype, device=cuda)
    ops[which] = flat[4:].view(t.shape)
    ops[which].copy_(t)
    assert ops[which].is_contiguous() and ops[which].data_ptr() % 16 == 8
    LAST_ROUTE.clear()
    out = fused.flash_attention_matmul(ops["q"], ops["k"], ops["v"], ops["w"])
    torch.cuda.synchronize()
    assert LAST_ROUTE["flash_attention_matmul"] == "fma"
    _close(out, fused.flash_attention_matmul_plain(
        ops["q"], ops["k"], ops["v"], ops["w"]), "bf16")


def test_tc_route_shapes_take_fma_in_f32_and_int8(cuda):
    """f32 attention at a tc shape takes fma; the int8 weight of
    rmsnorm_matmul_q8 at the decode shape takes the decode GEMV (its
    prefill takes tc: test_rmsnorm_matmul_q8_routes)."""
    gen = torch.Generator().manual_seed(8)
    q, k, v, wo = _attn_inputs(gen, torch.float32, cuda, 1, 8, 2, 100, 100,
                               64, 256)
    LAST_ROUTE.clear()
    out = fused.flash_attention_matmul(q, k, v, wo)
    torch.cuda.synchronize()
    assert LAST_ROUTE["flash_attention_matmul"] == "fma"
    _close(out, fused.flash_attention_matmul_plain(q, k, v, wo), "f32")
    x = _rand(gen, (8, 512), torch.bfloat16, cuda)
    w = _rand(gen, (512,), torch.bfloat16, cuda)
    wq, ws = fused.quantize_weight(_rand(gen, (512, 1024), torch.bfloat16,
                                         cuda, 512 ** -0.5))
    out = fused.rmsnorm_matmul_q8(x, w, wq, w_scale=ws)
    torch.cuda.synchronize()
    assert LAST_ROUTE["rmsnorm_matmul_q8"] == "gemv"
    _close(out, fused.rmsnorm_matmul_q8_plain(x, w, wq, ws), "bf16")


def test_flash_attention_matmul_q8_causal_takes_tc(cuda):
    """The bf16 causal shape with an int8 wo takes the tensor cores, as the
    bf16 wo does (the int8 tiles widened in the GEMM)."""
    gen = torch.Generator().manual_seed(8)
    q, k, v, wo = _attn_inputs(gen, torch.bfloat16, cuda, 1, 8, 2, 100, 100,
                               64, 256)
    wq, ws = fused.quantize_weight(wo)
    LAST_ROUTE.clear()
    out = fused.flash_attention_matmul_q8(q, k, v, wq, w_scale=ws)
    torch.cuda.synchronize()
    assert LAST_ROUTE["flash_attention_matmul_q8"] == "tc"
    _close(out, fused.flash_attention_matmul_q8_plain(q, k, v, wq, ws),
           "bf16")


def test_tc_route_wrappers_raise_instead_of_falling_back(cuda):
    gen = torch.Generator().manual_seed(9)
    x = _rand(gen, (300, 512), torch.bfloat16, cuda)
    w = _rand(gen, (512,), torch.bfloat16, cuda)
    W = _rand(gen, (512, 520), torch.bfloat16, cuda)
    before = dict(fused.LAUNCHES)
    with pytest.raises(TypeError):              # a half weight
        fused.rmsnorm_matmul(x, w, W.half())
    with pytest.raises(ValueError):             # the weight on the host
        fused.rmsnorm_matmul(x, w, W.cpu())
    q, k, v, wo = _attn_inputs(gen, torch.bfloat16, cuda, 1, 8, 2, 100, 100,
                               64, 256)
    with pytest.raises(TypeError):              # an f32 wo beside bf16 q
        fused.flash_attention_matmul(q, k, v, wo.float())
    with pytest.raises(ValueError):             # a transposed wo
        fused.flash_attention_matmul(q, k, v, wo.t().contiguous().t())
    assert fused.LAUNCHES == before


def test_tc_routes_make_no_host_sync(cuda):
    """A granite-8b-shaped small model in bf16 (head_dim 128): a 40-token
    prefill takes the tc routes, then five ticks and two more tc launches
    run with host syncs forbidden."""
    cfg = ModelConfig(name="t", family="dense", num_layers=2, d_model=512,
                      num_heads=4, num_kv_heads=2, head_dim=128, d_ff=512,
                      vocab_size=512, dtype="bfloat16")
    model = build_model(cfg, ParallelConfig(fuse_epilogues=True,
                                            use_pallas_attn=True),
                        device=cuda)
    params = model.init_params(0)
    eng = BatchedEngine(model, params, ServeConfig(
        batch_slots=2, max_seq_len=128, eos_id=-1, page_size=16))
    LAST_ROUTE.clear()
    eng.add_request(Request(rid=0, prompt=list(range(3, 43)),
                            max_new_tokens=40))
    torch.cuda.synchronize()
    assert LAST_ROUTE["flash_attention_matmul"] == "tc"
    eng.step()                                  # warm-up outside the guard
    gen = torch.Generator().manual_seed(10)
    x = _rand(gen, (40, 512), torch.bfloat16, cuda)
    w = _rand(gen, (512,), torch.bfloat16, cuda)
    W = _rand(gen, (512, 1024), torch.bfloat16, cuda)
    q, k, v, wo = _attn_inputs(gen, torch.bfloat16, cuda, 1, 4, 2, 40, 40,
                               128, 512)
    fused.rmsnorm_matmul(x, w, W)
    fused.flash_attention_matmul(q, k, v, wo)
    torch.cuda.synchronize()
    fused.reset_launch_counts()
    LAST_ROUTE.clear()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(5):
            eng.step()
        fused.rmsnorm_matmul(x, w, W)
        fused.flash_attention_matmul(q, k, v, wo)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    eng.sync()
    assert len(eng.slots[0].generated) == 7
    assert LAST_ROUTE["rmsnorm_matmul"] == "tc"
    assert LAST_ROUTE["flash_attention_matmul"] == "tc"
    assert fused.LAUNCHES["paged_attention_matmul"] == 5 * cfg.num_layers
    assert fused.LAUNCHES["flash_attention_matmul"] == 1


# ---------------------------------------------------------------------------
# the tensor-core routes of rmsnorm_swiglu (bf16 and int8 w_cat) and of the
# int8 wo of flash_attention_matmul_q8: each side of every route condition,
# in every mode, against the plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ALL_MODES)
@pytest.mark.parametrize("q8,dt,rows,d,f,route", [
    (False, "bf16", 16, 512, 520, "gemv"),  # decode rows: M <= SMALL_M
    (False, "bf16", 17, 512, 520, "tc"),
    (False, "bf16", 300, 4096, 2048, "tc"),  # granite-8b's D, narrower F
    (False, "bf16", 513, 512, 200, "tc"),   # ragged row and column tiles
    (False, "bf16", 300, 520, 512, "fma"),  # K % 64 != 0
    (False, "bf16", 300, 512, 516, "fma"),  # F % 8 != 0
    (False, "f32", 300, 512, 520, "fma"),   # f32 activations
    (True, "bf16", 16, 512, 528, "gemv"),
    (True, "bf16", 17, 512, 528, "tc"),
    (True, "bf16", 300, 4096, 2048, "tc"),
    (True, "bf16", 513, 512, 208, "tc"),
    (True, "bf16", 300, 520, 512, "fma"),
    (True, "bf16", 300, 512, 520, "fma"),   # F % 16 != 0 for int8
    (True, "f32", 300, 512, 528, "fma"),
    (False, "f32", 8, 512, 520, "gemv"),    # f32 decode rows
    (True, "f32", 8, 512, 528, "gemv"),
    (True, "bf16", 8, 512, 520, "fma"),     # decode rows, F % 16 != 0
])
def test_rmsnorm_swiglu_routes(cuda, mode, q8, dt, rows, d, f, route):
    gen = torch.Generator().manual_seed(rows + d + f)
    dtype = DTYPES[dt]
    x = _rand(gen, (rows, d), dtype, cuda)
    w = _rand(gen, (d,), dtype, cuda)
    w_cat = _rand(gen, (d, 2 * f), dtype, cuda, d ** -0.5)
    LAST_ROUTE.clear()
    if q8:
        wq, ws = fused.quantize_weight(w_cat)
        out = fused.rmsnorm_swiglu_q8(x, w, wq, w_scale=ws, mode=mode)
        ref = fused.rmsnorm_swiglu_q8_plain(x, w, wq, ws, mode=mode)
    else:
        out = fused.rmsnorm_swiglu(x, w, w_cat, mode=mode)
        ref = fused.rmsnorm_swiglu_plain(x, w, w_cat, mode=mode)
    torch.cuda.synchronize()
    name = "rmsnorm_swiglu_q8" if q8 else "rmsnorm_swiglu"
    assert LAST_ROUTE[fused._count_name(name, mode)] == route
    _close(out, ref, dt)


@pytest.mark.parametrize("q8", [False, True])
def test_rmsnorm_swiglu_tc_route_skips_unaligned_w_cat(cuda, q8):
    """A w_cat 8 bytes off 16-byte alignment (a contiguous view into a
    larger buffer) takes the fma route, for a bf16 and an int8 weight."""
    gen = torch.Generator().manual_seed(6)
    x = _rand(gen, (64, 512), torch.bfloat16, cuda)
    w = _rand(gen, (512,), torch.bfloat16, cuda)
    w_cat = _rand(gen, (512, 1024), torch.bfloat16, cuda, 512 ** -0.5)
    wq, ws = fused.quantize_weight(w_cat)
    t = wq if q8 else w_cat
    flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=cuda)
    off = 8 // t.element_size()
    view = flat[off:off + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == 8
    LAST_ROUTE.clear()
    if q8:
        out = fused.rmsnorm_swiglu_q8(x, w, view, w_scale=ws)
        ref = fused.rmsnorm_swiglu_q8_plain(x, w, wq, ws)
    else:
        out = fused.rmsnorm_swiglu(x, w, view)
        ref = fused.rmsnorm_swiglu_plain(x, w, w_cat)
    torch.cuda.synchronize()
    assert LAST_ROUTE["rmsnorm_swiglu_q8" if q8 else "rmsnorm_swiglu"] \
        == "fma"
    _close(out, ref, "bf16")


@pytest.mark.parametrize("mode", ALL_MODES)
@pytest.mark.parametrize("b,h,hkv,sq,skv,d,n,kv_offset,route", [
    (1, 16, 4, 300, 300, 128, 512, None, "tc"),     # G 4, D 128
    (1, 24, 8, 300, 300, 64, 1536, None, "tc"),     # granite-moe's heads
    (2, 8, 2, 70, 200, 128, 256, None, "tc"),       # Sq < Skv, offset 130
    (1, 12, 4, 100, 230, 64, 96, 77, "tc"),         # offset not Skv - Sq
    (1, 12, 4, 16, 16, 64, 96, None, "fma"),        # B x Sq = 16 rows
    (1, 12, 4, 17, 17, 64, 96, None, "tc"),
    (1, 8, 2, 100, 100, 32, 96, None, "fma"),       # D 32
    (1, 8, 2, 100, 100, 64, 104, None, "fma"),      # N % 16 != 0 for int8
])
def test_flash_attention_matmul_q8_routes(cuda, mode, b, h, hkv, sq, skv, d,
                                          n, kv_offset, route):
    gen = torch.Generator().manual_seed(sq * skv + d + n)
    q, k, v, wo = _attn_inputs(gen, torch.bfloat16, cuda, b, h, hkv, sq, skv,
                               d, n)
    wq, ws = fused.quantize_weight(wo)
    LAST_ROUTE.clear()
    out = fused.flash_attention_matmul_q8(q, k, v, wq, w_scale=ws,
                                          kv_offset=kv_offset, mode=mode)
    torch.cuda.synchronize()
    assert LAST_ROUTE[fused._count_name("flash_attention_matmul_q8",
                                        mode)] == route
    _close(out, fused.flash_attention_matmul_q8_plain(
        q, k, v, wq, ws, kv_offset=kv_offset, mode=mode), "bf16")


def test_flash_attention_matmul_q8_tc_route_skips_unaligned_wo(cuda):
    """An int8 wo 8 bytes off 16-byte alignment takes the fma route."""
    gen = torch.Generator().manual_seed(13)
    q, k, v, wo = _attn_inputs(gen, torch.bfloat16, cuda, 1, 8, 2, 100, 100,
                               64, 256)
    wq, ws = fused.quantize_weight(wo)
    flat = torch.empty(wq.numel() + 8, dtype=torch.int8, device=cuda)
    view = flat[8:].view(wq.shape)
    view.copy_(wq)
    assert view.is_contiguous() and view.data_ptr() % 16 == 8
    LAST_ROUTE.clear()
    out = fused.flash_attention_matmul_q8(q, k, v, view, w_scale=ws)
    torch.cuda.synchronize()
    assert LAST_ROUTE["flash_attention_matmul_q8"] == "fma"
    _close(out, fused.flash_attention_matmul_q8_plain(q, k, v, wq, ws),
           "bf16")


@pytest.mark.parametrize("mode", ALL_MODES)
def test_int8_tc_routes_make_no_host_sync(cuda, mode):
    """A granite-8b-shaped small model under the int8 policy in ``mode``: a
    40-token prefill takes the tc routes of rmsnorm_swiglu_q8 and
    flash_attention_matmul_q8 (and of rmsnorm_matmul_q8's qkv; its last
    launch, the head at one row, takes the decode GEMV), then five ticks
    and one more launch of each tc route, and of bf16 rmsnorm_swiglu, run
    with host syncs forbidden."""
    from repro_torch.models import common
    cfg = ModelConfig(name="t", family="dense", num_layers=2, d_model=512,
                      num_heads=4, num_kv_heads=2, head_dim=128, d_ff=512,
                      vocab_size=512, dtype="bfloat16")
    model = build_model(cfg, ParallelConfig(
        isa_mode=mode, fuse_epilogues=True, use_pallas_attn=True,
        weight_precision="int8", kv_cache_int8=True), device=cuda)
    params = common.quantize_params(model.init_params(0))
    eng = BatchedEngine(model, params, ServeConfig(
        batch_slots=2, max_seq_len=256, eos_id=-1, page_size=128))
    LAST_ROUTE.clear()
    eng.add_request(Request(rid=0, prompt=list(range(3, 43)),
                            max_new_tokens=40))
    torch.cuda.synchronize()
    assert LAST_ROUTE[fused._count_name("rmsnorm_swiglu_q8", mode)] == "tc"
    assert LAST_ROUTE[fused._count_name("flash_attention_matmul_q8",
                                        mode)] == "tc"
    assert LAST_ROUTE[fused._count_name("rmsnorm_matmul_q8", mode)] == \
        "gemv"
    eng.step()                                  # warm-up outside the guard
    gen = torch.Generator().manual_seed(11)
    x = _rand(gen, (40, 512), torch.bfloat16, cuda)
    w = _rand(gen, (512,), torch.bfloat16, cuda)
    w_cat = _rand(gen, (512, 1024), torch.bfloat16, cuda, 512 ** -0.5)
    wq, ws = fused.quantize_weight(w_cat)
    q, k, v, wo = _attn_inputs(gen, torch.bfloat16, cuda, 1, 4, 2, 40, 40,
                               128, 512)
    woq, wos = fused.quantize_weight(wo)

    Wq, Ws = fused.quantize_weight(w_cat)

    def tc_calls():
        fused.rmsnorm_swiglu(x, w, w_cat, mode=mode)
        fused.rmsnorm_swiglu_q8(x, w, wq, w_scale=ws, mode=mode)
        fused.flash_attention_matmul_q8(q, k, v, woq, w_scale=wos, mode=mode)
        fused.rmsnorm_matmul_q8(x, w, Wq, w_scale=Ws, mode=mode)
    tc_calls()
    torch.cuda.synchronize()
    fused.reset_launch_counts()
    LAST_ROUTE.clear()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(5):
            eng.step()
        tc_calls()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    eng.sync()
    assert len(eng.slots[0].generated) == 7
    for name in ("rmsnorm_swiglu", "rmsnorm_swiglu_q8",
                 "flash_attention_matmul_q8", "rmsnorm_matmul_q8"):
        assert LAST_ROUTE[fused._count_name(name, mode)] == "tc"
    assert fused.LAUNCHES[fused._count_name("paged_attention_matmul_q8",
                                            mode)] == 5 * cfg.num_layers


# ---------------------------------------------------------------------------
# the tensor-core routes of plain flash_attention and of rmsnorm_matmul_q8's
# int8 prefill, and the lifetime of the copies every wrapper hands a launch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ALL_MODES)
@pytest.mark.parametrize("dt,b,h,hkv,sq,skv,d,causal,kv_offset,route", [
    ("bf16", 1, 24, 8, 300, 300, 64, True, None, "tc"),    # G 3: row 63 dead
    ("bf16", 1, 24, 8, 512, 512, 64, True, None, "tc"),
    ("bf16", 1, 24, 8, 300, 300, 64, False, None, "tc"),   # non-causal
    ("bf16", 1, 32, 8, 300, 300, 128, True, None, "tc"),   # G 4, D 128
    ("bf16", 2, 8, 2, 70, 200, 128, True, 33, "tc"),       # a given offset
    ("bf16", 1, 12, 4, 20, 50, 64, True, -10, "tc"),       # rows see no key
    ("bf16", 1, 4, 4, 1, 77, 64, True, None, "tc"),        # 63 dead rows
    ("bf16", 3, 6, 2, 65, 65, 16, False, None, "fma"),     # D 16
    ("bf16", 2, 4, 1, 20, 50, 32, True, 10, "fma"),        # D 32
    ("f32", 1, 24, 8, 300, 300, 64, True, None, "fma"),    # f32
])
def test_flash_attention_routes(cuda, mode, dt, b, h, hkv, sq, skv, d,
                                causal, kv_offset, route):
    gen = torch.Generator().manual_seed(sq * skv + h + d)
    q = _rand(gen, (b, h, sq, d), DTYPES[dt], cuda)
    k = _rand(gen, (b, hkv, skv, d), DTYPES[dt], cuda)
    v = _rand(gen, (b, hkv, skv, d), DTYPES[dt], cuda)
    LAST_ROUTE.clear()
    out = attention.flash_attention(q, k, v, causal=causal,
                                    kv_offset=kv_offset, mode=mode)
    torch.cuda.synchronize()
    assert LAST_ROUTE[fused._count_name("flash_attention", mode)] == route
    assert out.dtype == q.dtype and out.shape == q.shape
    assert bool(torch.isfinite(out).all())
    _close(out, attention.flash_attention_plain(
        q, k, v, causal=causal, kv_offset=kv_offset, mode=mode), dt)


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_flash_attention_tc_route_skips_unaligned_qkv(cuda, which):
    """The core loads q, k and v with 16-byte cp.async: an operand 8 bytes
    off that alignment (a contiguous view into a larger buffer) takes the
    fma route instead of faulting."""
    gen = torch.Generator().manual_seed(14)
    shapes = {"q": (1, 24, 100, 64), "k": (1, 8, 100, 64),
              "v": (1, 8, 100, 64)}
    ops = {n: _rand(gen, s, torch.bfloat16, cuda) for n, s in shapes.items()}
    t = ops[which]
    flat = torch.empty(t.numel() + 4, dtype=t.dtype, device=cuda)
    ops[which] = flat[4:].view(t.shape)
    ops[which].copy_(t)
    assert ops[which].is_contiguous() and ops[which].data_ptr() % 16 == 8
    LAST_ROUTE.clear()
    out = attention.flash_attention(ops["q"], ops["k"], ops["v"])
    torch.cuda.synchronize()
    assert LAST_ROUTE["flash_attention"] == "fma"
    _close(out, attention.flash_attention_plain(ops["q"], ops["k"],
                                                ops["v"]), "bf16")


@pytest.mark.parametrize("mode", ALL_MODES)
@pytest.mark.parametrize("dt,rows,d,n,route", [
    ("bf16", 300, 4096, 6144, "tc"),        # granite-8b's qkv prefill
    ("bf16", 512, 4096, 6144, "tc"),
    ("bf16", 17, 512, 528, "tc"),
    ("bf16", 513, 512, 208, "tc"),          # ragged row and column tiles
    ("bf16", 8, 4096, 6144, "gemv"),        # decode rows
    ("bf16", 16, 512, 528, "gemv"),         # M <= SMALL_M
    ("bf16", 300, 520, 512, "fma"),         # K % 64 != 0
    ("bf16", 300, 512, 520, "fma"),         # N % 16 != 0 for int8
    ("f32", 300, 512, 528, "fma"),          # f32 activations
    ("f32", 8, 512, 528, "gemv"),           # f32 decode rows
    ("bf16", 8, 512, 520, "fma"),           # decode rows, N % 16 != 0
])
def test_rmsnorm_matmul_q8_routes(cuda, mode, dt, rows, d, n, route):
    gen = torch.Generator().manual_seed(rows + d + n + 1)
    dtype = DTYPES[dt]
    x = _rand(gen, (rows, d), dtype, cuda)
    w = _rand(gen, (d,), dtype, cuda)
    wq, ws = fused.quantize_weight(_rand(gen, (d, n), dtype, cuda,
                                         d ** -0.5))
    LAST_ROUTE.clear()
    out = fused.rmsnorm_matmul_q8(x, w, wq, w_scale=ws, mode=mode)
    torch.cuda.synchronize()
    assert LAST_ROUTE[fused._count_name("rmsnorm_matmul_q8", mode)] == route
    _close(out, fused.rmsnorm_matmul_q8_plain(x, w, wq, ws, mode=mode), dt)


def test_rmsnorm_matmul_q8_tc_route_skips_unaligned_weight(cuda):
    """An int8 weight 8 bytes off 16-byte alignment takes the fma route."""
    gen = torch.Generator().manual_seed(15)
    x = _rand(gen, (64, 512), torch.bfloat16, cuda)
    w = _rand(gen, (512,), torch.bfloat16, cuda)
    wq, ws = fused.quantize_weight(_rand(gen, (512, 528), torch.bfloat16,
                                         cuda, 512 ** -0.5))
    flat = torch.empty(wq.numel() + 8, dtype=torch.int8, device=cuda)
    view = flat[8:].view(wq.shape)
    view.copy_(wq)
    assert view.is_contiguous() and view.data_ptr() % 16 == 8
    LAST_ROUTE.clear()
    out = fused.rmsnorm_matmul_q8(x, w, view, w_scale=ws)
    torch.cuda.synchronize()
    assert LAST_ROUTE["rmsnorm_matmul_q8"] == "fma"
    _close(out, fused.rmsnorm_matmul_q8_plain(x, w, wq, ws), "bf16")


@pytest.mark.parametrize("mode", ALL_MODES)
def test_flash_attention_and_q8_norm_tc_routes_make_no_host_sync(cuda, mode):
    """A small dense model at head width 64 under the unfused kernel policy
    in ``mode``: its 40-token prefill runs flash_attention on the tc route;
    then five ticks and one more tc launch of flash_attention and of
    rmsnorm_matmul_q8 run with host syncs forbidden."""
    cfg = ModelConfig(name="t", family="dense", num_layers=2, d_model=384,
                      num_heads=6, num_kv_heads=2, head_dim=64, d_ff=512,
                      vocab_size=512, dtype="bfloat16")
    model = build_model(cfg, ParallelConfig(isa_mode=mode,
                                            use_pallas_attn=True),
                        device=cuda)
    eng = BatchedEngine(model, model.init_params(0), ServeConfig(
        batch_slots=2, max_seq_len=256, eos_id=-1, page_size=128))
    LAST_ROUTE.clear()
    eng.add_request(Request(rid=0, prompt=list(range(3, 43)),
                            max_new_tokens=40))
    torch.cuda.synchronize()
    attn = fused._count_name("flash_attention", mode)
    assert LAST_ROUTE[attn] == "tc"
    eng.step()                                  # warm-up outside the guard
    gen = torch.Generator().manual_seed(16)
    q = _rand(gen, (1, 6, 40, 64), torch.bfloat16, cuda)
    k = _rand(gen, (1, 2, 40, 64), torch.bfloat16, cuda)
    x = _rand(gen, (40, 384), torch.bfloat16, cuda)
    w = _rand(gen, (384,), torch.bfloat16, cuda)
    wq, ws = fused.quantize_weight(_rand(gen, (384, 640), torch.bfloat16,
                                         cuda, 384 ** -0.5))

    def tc_calls():
        attention.flash_attention(q, k, k, mode=mode)
        fused.rmsnorm_matmul_q8(x, w, wq, w_scale=ws, mode=mode)
    tc_calls()
    torch.cuda.synchronize()
    fused.reset_launch_counts()
    LAST_ROUTE.clear()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(5):
            eng.step()
        tc_calls()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    eng.sync()
    assert len(eng.slots[0].generated) == 7
    assert LAST_ROUTE[attn] == "tc"
    assert LAST_ROUTE[fused._count_name("rmsnorm_matmul_q8", mode)] == "tc"
    assert fused.LAUNCHES[attn] == 1


def _head_major(gen, dtype, dev, b, s, h, hd):
    """[B, H, S, hd] as ``models/transformer.py::_project_qkv`` makes it: a
    transposed view of the projection's [B, S, H, hd], never contiguous."""
    return _rand(gen, (b, s, h * hd), dtype, dev).reshape(
        b, s, h, hd).transpose(1, 2)


@pytest.mark.parametrize("mode", ALL_MODES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_wrappers_keep_their_copies_alive(cuda, mode, dt):
    """Each copy a wrapper makes for a launch (``.contiguous()`` of a view)
    lives until the launch is queued: were one freed first, the caching
    allocator could hand its block to the next copy, which the stream runs
    before the kernel reads the first.  flash_attention at granite-moe's
    300-token prefill over transposed q, k and v (q 0.9 MB and k, v 0.3 MB
    share the small pool in bf16), the row norms over a transposed x and
    residual and a strided norm scale, the int8 norm-GEMM over a
    transposed x with a strided norm scale and strided column scales, and
    the int8 attention + wo decode route, dense and paged, over a strided
    q, transposed k and v, int64 frontiers and table and strided column
    scales, each from an empty cache, against the plain version."""
    dtype = DTYPES[dt]
    gen = torch.Generator().manual_seed(17)
    q = _head_major(gen, dtype, cuda, 1, 300, 24, 64)
    k = _head_major(gen, dtype, cuda, 1, 300, 8, 64)
    v = _head_major(gen, dtype, cuda, 1, 300, 8, 64)
    assert not (q.is_contiguous() or k.is_contiguous() or v.is_contiguous())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = attention.flash_attention(q, k, v, mode=mode)
    torch.cuda.synchronize()
    _close(out, attention.flash_attention_plain(q, k, v, mode=mode), dt)
    xt = _rand(gen, (1536, 300), dtype, cuda).t()
    rt = _rand(gen, (1536, 300), dtype, cuda, 0.5).t()
    wn = (1.0 + _rand(gen, (2 * 1536,), dtype, cuda, 0.1))[::2]
    assert not (xt.is_contiguous() or rt.is_contiguous()
                or wn.is_contiguous())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = rmsnorm.rmsnorm(xt, wn, mode=mode)
    normed, summed = fused.add_rmsnorm(xt, rt, wn, mode=mode)
    torch.cuda.synchronize()
    _close(out, rmsnorm.rmsnorm_plain(xt, wn, mode=mode), dt)
    want_n, want_s = fused.add_rmsnorm_plain(xt, rt, wn, mode=mode)
    assert torch.equal(summed, want_s)
    _close(normed, want_n, dt)
    d, n = 4096, 1024
    x = _rand(gen, (300, 1, d), dtype, cuda).transpose(0, 1)
    w = (1.0 + _rand(gen, (2 * d,), dtype, cuda, 0.1))[::2]
    wq, ws = fused.quantize_weight(_rand(gen, (d, n), dtype, cuda,
                                         d ** -0.5))
    ws_strided = torch.stack([ws, torch.zeros_like(ws)], dim=1)[:, 0]
    assert not (w.is_contiguous() or ws_strided.is_contiguous())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = fused.rmsnorm_matmul_q8(x, w, wq, w_scale=ws_strided, mode=mode)
    torch.cuda.synchronize()
    _close(out, fused.rmsnorm_matmul_q8_plain(x, w, wq, ws, mode=mode), dt)
    # the attention + wo decode route: a strided q, transposed dense k and
    # v, int64 frontiers and table, strided wo scales, dense and paged
    b, h, hkv, hd, n, skv, ps = 8, 32, 8, 128, 1024, 576, 128
    q = _rand(gen, (b, h, 1, 2 * hd), dtype, cuda)[..., ::2]
    k = _head_major(gen, dtype, cuda, b, skv, hkv, hd)
    v = _head_major(gen, dtype, cuda, b, skv, hkv, hd)
    wq, ws = fused.quantize_weight(_rand(gen, (h * hd, n), dtype, cuda,
                                         (h * hd) ** -0.5))
    ws_strided = torch.stack([ws, torch.zeros_like(ws)], dim=1)[:, 0]
    pos = torch.arange(b, device=cuda, dtype=torch.int64) * 67 + 40
    maxp = skv // ps
    kp = _rand(gen, (b * maxp, hkv, ps, hd), dtype, cuda)
    vp = _rand(gen, (b * maxp, hkv, ps, hd), dtype, cuda)
    tables = torch.randperm(b * maxp, device=cuda).reshape(b, maxp)
    assert not (q.is_contiguous() or k.is_contiguous() or v.is_contiguous())
    for kk, vv, tb in ((k, v, None), (kp, vp, tables)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        LAST_ROUTE.clear()
        out = fused.flash_attention_matmul_q8(
            q, kk, vv, wq, w_scale=ws_strided, pos=pos, block_tables=tb,
            mode=mode)
        torch.cuda.synchronize()
        assert set(LAST_ROUTE.values()) == {"decode"}
        _close(out, fused.flash_attention_matmul_q8_plain(
            q, kk, vv, wq, ws, pos=pos, block_tables=tb, mode=mode), dt)


# ---------------------------------------------------------------------------
# the decode GEMV route of the norm-GEMMs (csrc/norm_gemv.cuh): rmsnorm_matmul,
# rmsnorm_swiglu and their int8 twins at M <= 16, in every mode
# ---------------------------------------------------------------------------

GEMV_KINDS = ("matmul", "swiglu", "matmul_q8", "swiglu_q8")


def _gemv_call(kind, x, w, big, mode="native"):
    """(out, plain, counter) of one norm-GEMM kind on ``big`` ([D, N]; for
    swiglu [D, 2F]), quantized first for a ``_q8`` kind."""
    if kind == "matmul":
        return (fused.rmsnorm_matmul(x, w, big, mode=mode),
                fused.rmsnorm_matmul_plain(x, w, big, mode=mode),
                "rmsnorm_matmul")
    if kind == "swiglu":
        return (fused.rmsnorm_swiglu(x, w, big, mode=mode),
                fused.rmsnorm_swiglu_plain(x, w, big, mode=mode),
                "rmsnorm_swiglu")
    wq, ws = fused.quantize_weight(big)
    if kind == "matmul_q8":
        return (fused.rmsnorm_matmul_q8(x, w, wq, w_scale=ws, mode=mode),
                fused.rmsnorm_matmul_q8_plain(x, w, wq, ws, mode=mode),
                "rmsnorm_matmul_q8")
    return (fused.rmsnorm_swiglu_q8(x, w, wq, w_scale=ws, mode=mode),
            fused.rmsnorm_swiglu_q8_plain(x, w, wq, ws, mode=mode),
            "rmsnorm_swiglu_q8")


@pytest.mark.parametrize("mode", ALL_MODES)
@pytest.mark.parametrize("kind", GEMV_KINDS)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("rows,d,n", [
    (1, 512, 528), (7, 512, 528), (8, 4096, 1040),   # N tail: 1040 % 64
    (9, 512, 528), (16, 1536, 2560), (8, 1000, 272),  # K % 32 != 0
])
def test_gemv_route_takes_decode_rows(cuda, mode, kind, dt, rows, d, n):
    """Every decode row count (1, 7, 8, 9: a second row group, 16) in every
    mode, dtype and weight type takes the decode GEMV and agrees with the
    plain version, with a partial last column tile and a K that is not a
    multiple of a block's k rows."""
    gen = torch.Generator().manual_seed(rows * d + n)
    dtype = DTYPES[dt]
    x = _rand(gen, (rows, d), dtype, cuda)
    w = 1.0 + _rand(gen, (d,), dtype, cuda, 0.1)
    cols = 2 * n if kind.startswith("swiglu") else n
    big = _rand(gen, (d, cols), dtype, cuda, d ** -0.5)
    LAST_ROUTE.clear()
    before = dict(fused.LAUNCHES)
    out, ref, name = _gemv_call(kind, x, w, big, mode)
    torch.cuda.synchronize()
    counter = fused._count_name(name, mode)
    assert LAST_ROUTE[counter] == "gemv"
    assert fused.LAUNCHES[counter] == before[counter] + 1
    assert out.shape == ref.shape == (rows, n) and out.dtype == dtype
    assert bool(torch.isfinite(out).all())
    _close(out, ref, dt)


def _misaligned(t):
    """A contiguous copy of ``t`` 8 bytes off 16-byte alignment."""
    flat = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    off = 8 // t.element_size()
    view = flat[off:off + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == 8
    return view


@pytest.mark.parametrize("mode", ALL_MODES)
def test_gemv_route_refusals_take_fma(cuda, mode):
    """At decode, the shapes the GEMV refuses keep the FMA kernel and stay
    right: an odd N, a weight 8 bytes off 16-byte alignment (bf16 and
    int8), an f32 weight beside bf16 activations, and a float head of an
    odd N under the int8 twin (quantized first, to int8 rows 517 bytes
    apart).  The tied f32 table read transposed takes the GEMV's
    transposed form (test_tied_table_routes), and under the int8 twin
    granite-moe's 49155-row table too, quantized in the GEMV's stream."""
    gen = torch.Generator().manual_seed(21)
    bf = torch.bfloat16
    x = _rand(gen, (8, 512), bf, cuda)
    w = 1.0 + _rand(gen, (512,), bf, cuda, 0.1)
    odd = _rand(gen, (512, 517), bf, cuda, 512 ** -0.5)
    W = _rand(gen, (512, 528), bf, cuda, 512 ** -0.5)
    wq, ws = fused.quantize_weight(W)
    name = fused._count_name("rmsnorm_matmul", mode)
    for weight in (odd, _misaligned(W), W.float()):
        LAST_ROUTE.clear()
        out = fused.rmsnorm_matmul(x, w, weight, mode=mode)
        torch.cuda.synchronize()
        assert LAST_ROUTE[name] == "fma"
        _close(out, fused.rmsnorm_matmul_plain(x, w, weight, mode=mode),
               "bf16")
    LAST_ROUTE.clear()
    out = fused.rmsnorm_matmul_q8(x, w, _misaligned(wq), w_scale=ws,
                                  mode=mode)
    torch.cuda.synchronize()
    assert LAST_ROUTE[fused._count_name("rmsnorm_matmul_q8", mode)] == "fma"
    _close(out, fused.rmsnorm_matmul_q8_plain(x, w, wq, ws, mode=mode),
           "bf16")
    LAST_ROUTE.clear()
    out = fused.rmsnorm_swiglu(x, w, _misaligned(W), mode=mode)
    torch.cuda.synchronize()
    assert LAST_ROUTE[fused._count_name("rmsnorm_swiglu", mode)] == "fma"
    _close(out, fused.rmsnorm_swiglu_plain(x, w, W, mode=mode), "bf16")
    oq, os_ = fused.quantize_weight(odd)
    LAST_ROUTE.clear()
    out = fused.rmsnorm_matmul_q8(x, w, odd, mode=mode)
    torch.cuda.synchronize()
    assert LAST_ROUTE[fused._count_name("rmsnorm_matmul_q8", mode)] == "fma"
    _close(out, fused.rmsnorm_matmul_q8_plain(x, w, oq, os_, mode=mode),
           "bf16")
    xm = _rand(gen, (8, 1536), bf, cuda)
    wm = 1.0 + _rand(gen, (1536,), bf, cuda, 0.1)
    embed = _rand(gen, (49155, 1536), torch.float32, cuda, 0.02)
    hq, hs = fused.quantize_weight(embed.t())
    LAST_ROUTE.clear()
    out = fused.rmsnorm_matmul_q8(xm, wm, embed.t(), mode=mode)
    torch.cuda.synchronize()
    assert LAST_ROUTE[fused._count_name("rmsnorm_matmul_q8", mode)] == "gemv"
    _close(out, fused.rmsnorm_matmul_q8_plain(xm, wm, hq, hs, mode=mode),
           "bf16")


@pytest.mark.parametrize("kind", GEMV_KINDS)
@pytest.mark.parametrize("rows,d,n", [(8, 4096, 6144), (8, 1536, 2560),
                                      (3, 4096, 1024)])
def test_gemv_route_is_bitwise_repeatable(cuda, kind, rows, d, n):
    """K split across blocks (granite-8b's qkv D, granite-moe's qkv) is
    summed in split order by whichever block arrives last: two calls give
    the same bits."""
    gen = torch.Generator().manual_seed(rows + d + n + 5)
    x = _rand(gen, (rows, d), torch.bfloat16, cuda)
    w = 1.0 + _rand(gen, (d,), torch.bfloat16, cuda, 0.1)
    cols = 2 * n if kind.startswith("swiglu") else n
    big = _rand(gen, (d, cols), torch.bfloat16, cuda, d ** -0.5)
    first, ref, name = _gemv_call(kind, x, w, big)
    second, _, _ = _gemv_call(kind, x, w, big)
    torch.cuda.synchronize()
    assert LAST_ROUTE[name] == "gemv"
    assert torch.equal(first, second)
    _close(first, ref, "bf16")


def test_gemv_route_wrappers_raise_instead_of_falling_back(cuda):
    """Decode-shaped calls the kernels cannot take raise and launch
    nothing: a half weight, a weight on the host, int8 scales of the wrong
    length, and a swiglu w_cat of an odd width."""
    gen = torch.Generator().manual_seed(22)
    x = _rand(gen, (8, 512), torch.bfloat16, cuda)
    w = _rand(gen, (512,), torch.bfloat16, cuda)
    W = _rand(gen, (512, 528), torch.bfloat16, cuda, 512 ** -0.5)
    wq, ws = fused.quantize_weight(W)
    before = dict(fused.LAUNCHES)
    with pytest.raises(TypeError):
        fused.rmsnorm_matmul(x, w, W.half())
    with pytest.raises(ValueError):
        fused.rmsnorm_matmul(x, w, W.cpu())
    with pytest.raises(ValueError):
        fused.rmsnorm_matmul_q8(x, w, wq, w_scale=ws[:-16])
    with pytest.raises(ValueError):
        fused.rmsnorm_swiglu(x, w, W[:, :527].contiguous())
    with pytest.raises(TypeError):
        fused.rmsnorm_swiglu(x, w, W.half())
    assert fused.LAUNCHES == before


@pytest.mark.parametrize("mode", ALL_MODES)
def test_gemv_route_makes_no_host_sync(cuda, mode):
    """A decode call of each kind (K split across blocks, so the tickets
    and the partials are on the path) runs with host syncs forbidden."""
    gen = torch.Generator().manual_seed(23)
    x = _rand(gen, (8, 4096), torch.bfloat16, cuda)
    w = _rand(gen, (4096,), torch.bfloat16, cuda)
    W = _rand(gen, (4096, 2048), torch.bfloat16, cuda, 4096 ** -0.5)
    wq, ws = fused.quantize_weight(W)

    def calls():
        fused.rmsnorm_matmul(x, w, W, mode=mode)
        fused.rmsnorm_swiglu(x, w, W, mode=mode)
        fused.rmsnorm_matmul_q8(x, w, wq, w_scale=ws, mode=mode)
        fused.rmsnorm_swiglu_q8(x, w, wq, w_scale=ws, mode=mode)
    calls()
    torch.cuda.synchronize()
    LAST_ROUTE.clear()
    torch.cuda.set_sync_debug_mode("error")
    try:
        calls()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for name in ("rmsnorm_matmul", "rmsnorm_swiglu", "rmsnorm_matmul_q8",
                 "rmsnorm_swiglu_q8"):
        assert LAST_ROUTE[fused._count_name(name, mode)] == "gemv"


# ---------------------------------------------------------------------------
# the decode route of the attention + wo kernels (csrc/attention_decode.cuh):
# the pos and paged shapes in bf16 and f32, every mode, an int8 wo, int8
# pools
# ---------------------------------------------------------------------------

DECODE_FORMS = ("pos", "pos_q8", "paged", "paged_q8", "paged_q8_kv")


def _decode_inputs(gen, dtype, dev, form, b, h, hkv, d, n, skv, ps):
    """(kernel fn, plain fn, counter) of one decode form: a dense cache of
    ``skv`` keys or pools of pages of ``ps`` through a permuted table with
    a sentinel entry past slot 1's frontier; frontiers at a page (or tile)
    boundary, the first key, the last key and, dense, -1 (every key
    masked: the walk averages them all, as the plain version does)."""
    from repro_torch.models.attention import quantize_kv
    q = _rand(gen, (b, h, 1, d), dtype, dev)
    wo = _rand(gen, (h * d, n), dtype, dev, (h * d) ** -0.5)
    kw = {}
    if form.endswith("q8") or form.endswith("q8_kv"):
        wo, kw["w_scale"] = _q8(wo)
    last = skv - 1
    pattern = [ps - 1, 0, last, 2 * ps % skv, last // 2, 1, last - 3,
               3 * ps % skv]
    pos = [pattern[i % len(pattern)] for i in range(b)]
    if form.startswith("pos"):
        pos[-1] = -1
        k = _rand(gen, (b, hkv, skv, d), dtype, dev)
        v = _rand(gen, (b, hkv, skv, d), dtype, dev)
    else:
        maxp = -(-skv // ps)
        num_pages = b * maxp + 1
        k = _rand(gen, (num_pages, hkv, ps, d), dtype, dev)
        v = _rand(gen, (num_pages, hkv, ps, d), dtype, dev)
        if form == "paged_q8_kv":
            (k, kw["k_scale"]), (v, kw["v_scale"]) = quantize_kv(k), \
                quantize_kv(v)
        rng = np.random.default_rng(b + d + ps)
        tables = np.asarray(rng.permutation(num_pages)[:b * maxp]
                            .reshape(b, maxp), np.int32)
        tables[1, -1] = num_pages               # a sentinel past pos 0
        kw["block_tables"] = torch.from_numpy(tables).to(dev)
    kw["pos"] = torch.tensor(pos, dtype=torch.int32, device=dev)
    paged = "block_tables" in kw
    if "w_scale" in kw:
        counter = ("paged_attention_matmul_q8" if paged
                   else "flash_attention_matmul_q8_pos")
        plain_kw = {key: t for key, t in kw.items() if key != "w_scale"}
        return (lambda m: fused.flash_attention_matmul_q8(
                    q, k, v, wo, mode=m, **kw),
                lambda m: fused.flash_attention_matmul_q8_plain(
                    q, k, v, wo, kw["w_scale"], mode=m, **plain_kw),
                counter)
    counter = ("paged_attention_matmul" if paged
               else "flash_attention_matmul_pos")
    return (lambda m: fused.flash_attention_matmul(q, k, v, wo, mode=m, **kw),
            lambda m: fused.flash_attention_matmul_plain(q, k, v, wo, mode=m,
                                                         **kw),
            counter)


@pytest.mark.parametrize("mode", ALL_MODES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("form", DECODE_FORMS)
@pytest.mark.parametrize("b,h,hkv,d,n,skv,ps", [
    (4, 12, 4, 64, 96, 300, 128),       # G 3, D 64, a part-filled last page
    (5, 32, 8, 128, 256, 576, 128),     # G 4, D 128: granite-8b's heads
    (3, 4, 2, 16, 64, 40, 128),         # the reduced configs' D 16
    (7, 16, 2, 128, 48, 256, 128),      # G 8, 7 slots
])
def test_decode_route_takes_pos_and_paged_shapes(cuda, mode, dt, form, b, h,
                                                 hkv, d, n, skv, ps):
    """Each decode form in every mode and dtype takes the decode route,
    gives the same bits on two calls and agrees with the plain version."""
    gen = torch.Generator().manual_seed(b * d + skv)
    kernel, plain, counter = _decode_inputs(gen, DTYPES[dt], cuda, form, b,
                                            h, hkv, d, n, skv, ps)
    LAST_ROUTE.clear()
    before = dict(fused.LAUNCHES)
    out = kernel(mode)
    again = kernel(mode)
    torch.cuda.synchronize()
    name = fused._count_name(counter, mode)
    assert LAST_ROUTE[name] == "decode"
    assert fused.LAUNCHES[name] == before[name] + 2
    assert torch.equal(out, again)
    _close(out, plain(mode), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("form", ["paged", "paged_q8", "paged_q8_kv"])
def test_decode_route_at_pages_of_64_and_16(cuda, dt, form):
    """Native pages of 64 (granite-8b's served pages) and of 16 (a tile
    across four pages)."""
    for ps in (64, 16):
        gen = torch.Generator().manual_seed(ps)
        kernel, plain, counter = _decode_inputs(
            gen, DTYPES[dt], cuda, form, 6, 32, 8, 128, 256, 300, ps)
        LAST_ROUTE.clear()
        out = kernel("native")
        torch.cuda.synchronize()
        assert LAST_ROUTE[counter] == "decode"
        _close(out, plain("native"), dt)


@pytest.mark.parametrize("mode", ALL_MODES)
def test_paged_decode_slot_below_zero_gets_zero(cuda, mode):
    """A paged slot with pos < 0 sees no key on the decode route and gets
    0, as the JAX kernel's skip_dead gives it; the other slots agree with
    the plain version."""
    gen = torch.Generator().manual_seed(31)
    b, h, hkv, d, n, ps, maxp = 3, 8, 2, 64, 96, 128, 2
    q = _rand(gen, (b, h, 1, d), torch.bfloat16, cuda)
    kp = _rand(gen, (b * maxp, hkv, ps, d), torch.bfloat16, cuda)
    vp = _rand(gen, (b * maxp, hkv, ps, d), torch.bfloat16, cuda)
    wo = _rand(gen, (h * d, n), torch.bfloat16, cuda, (h * d) ** -0.5)
    tables = torch.arange(b * maxp, dtype=torch.int32,
                          device=cuda).reshape(b, maxp)
    pos = torch.tensor([200, -1, 5], dtype=torch.int32, device=cuda)
    LAST_ROUTE.clear()
    out = fused.paged_attention_matmul(q, kp, vp, wo, block_tables=tables,
                                       pos=pos, mode=mode)
    torch.cuda.synchronize()
    assert LAST_ROUTE[fused._count_name("paged_attention_matmul",
                                        mode)] == "decode"
    assert not out[1].any()
    live = torch.tensor([0, 2], device=cuda)
    _close(out[live], fused.paged_attention_matmul_plain(
        q, kp, vp, wo, block_tables=tables, pos=pos, mode=mode)[live],
        "bf16")


def _offset_view(t):
    """A contiguous copy of ``t`` 8 bytes off 16-byte alignment."""
    flat = torch.empty(t.numel() * t.element_size() + 8, dtype=torch.uint8,
                       device=t.device)
    out = flat[8:].view(t.dtype).view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 == 8
    return out


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("case", ["n_odd", "q_off16", "k_off16", "group_9",
                                  "slots_17"])
def test_decode_route_refusals_take_fma(cuda, paged, case):
    """Where the decode route's predicate refuses (N columns of bf16 wo not
    a multiple of 16 bytes, q or k 8 bytes off 16, nine heads a group, 17
    slots), the C entry takes fma by its own decision and agrees with the
    plain version; the causal prefill stays on the tensor cores."""
    gen = torch.Generator().manual_seed(41)
    bf = torch.bfloat16
    b, h, hkv, d, n = 4, 8, 2, 64, 96
    if case == "n_odd":
        n = 100
    elif case == "group_9":
        h, hkv = 18, 2
    elif case == "slots_17":
        b = 17
    q = _rand(gen, (b, h, 1, d), bf, cuda)
    wo = _rand(gen, (h * d, n), bf, cuda, (h * d) ** -0.5)
    pos = torch.tensor([(37 * i) % 200 for i in range(b)], dtype=torch.int32,
                       device=cuda)
    if case == "q_off16":
        q = _offset_view(q)
    kw = dict(pos=pos)
    if paged:
        ps, maxp = 64, 4
        k = _rand(gen, (b * maxp, hkv, ps, d), bf, cuda)
        v = _rand(gen, (b * maxp, hkv, ps, d), bf, cuda)
        kw["block_tables"] = torch.arange(b * maxp, dtype=torch.int32,
                                          device=cuda).reshape(b, maxp)
        counter = "paged_attention_matmul"
    else:
        k = _rand(gen, (b, hkv, 200, d), bf, cuda)
        v = _rand(gen, (b, hkv, 200, d), bf, cuda)
        counter = "flash_attention_matmul_pos"
    if case == "k_off16":
        k = _offset_view(k)
    LAST_ROUTE.clear()
    out = fused.flash_attention_matmul(q, k, v, wo, **kw)
    torch.cuda.synchronize()
    assert LAST_ROUTE[counter] == "fma"
    _close(out, fused.flash_attention_matmul_plain(q, k, v, wo, **kw),
           "bf16")
    qc, kc, vc, woc = _attn_inputs(gen, bf, cuda, 1, 8, 2, 100, 100, 64, 256)
    fused.flash_attention_matmul(qc, kc, vc, woc)
    torch.cuda.synchronize()
    assert LAST_ROUTE["flash_attention_matmul"] == "tc"


@pytest.mark.parametrize("mode", ALL_MODES)
def test_decode_route_makes_no_host_sync(cuda, mode):
    """The decode route's three launches, dense and paged, int8 forms too,
    run with host syncs forbidden."""
    gen = torch.Generator().manual_seed(43)
    calls = [_decode_inputs(gen, torch.bfloat16, cuda, form, 8, 32, 8, 128,
                            512, 576, 128)[0] for form in DECODE_FORMS]
    for call in calls:
        call(mode)
    torch.cuda.synchronize()
    LAST_ROUTE.clear()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for call in calls:
            call(mode)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert set(LAST_ROUTE.values()) == {"decode"}


# ---------------------------------------------------------------------------
# the tied f32 table on the GEMV's transposed form, the persistent 2-per-
# thread reduction, and ROADMAP C.1 (gemm past the rounded split) and C.2
# (a paged slot below zero on the fma route)
# ---------------------------------------------------------------------------


def _table_off16(table):
    """A contiguous copy of the [N, K] f32 ``table`` 4 bytes off 16-byte
    alignment."""
    flat = torch.empty(table.numel() + 4, dtype=table.dtype,
                       device=table.device)
    view = flat[1:1 + table.numel()].view(table.shape)
    view.copy_(table)
    assert view.data_ptr() % 16 == 4
    return view


@pytest.mark.parametrize("mode", ALL_MODES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case,rows,k,n,route", [
    ("decode", 1, 1536, 49155, "gemv"),       # granite-moe's head
    ("decode", 8, 1536, 49155, "gemv"),
    ("decode", 16, 512, 520, "gemv"),
    ("decode", 16, 1536, 49155, "gemv"),
    ("prefill", 17, 512, 520, "fma"),         # past the decode rows
    ("off16", 8, 512, 520, "fma"),            # the table off 16 bytes
    ("k_odd", 8, 514, 520, "fma"),            # K x 4 not a multiple of 16
])
def test_tied_table_routes(cuda, mode, dt, case, rows, k, n, route):
    gen = torch.Generator().manual_seed(rows + k + n)
    x = _rand(gen, (rows, k), DTYPES[dt], cuda)
    w = 1.0 + _rand(gen, (k,), DTYPES[dt], cuda, 0.1)
    table = _rand(gen, (n, k), torch.float32, cuda, 0.02)
    if case == "off16":
        table = _table_off16(table)
    name = fused._count_name("rmsnorm_matmul", mode)
    LAST_ROUTE.clear()
    out = _launched_only(name, lambda: fused.rmsnorm_matmul(
        x, w, table.t(), mode=mode))
    assert LAST_ROUTE[name] == route
    assert out.dtype == x.dtype and out.shape == (rows, n)
    _close(out, fused.rmsnorm_matmul_plain(x, w, table.t(), mode=mode), dt)
    if route == "gemv":                        # splits summed in order
        again = fused.rmsnorm_matmul(x, w, table.t(), mode=mode)
        torch.cuda.synchronize()
        assert torch.equal(out, again)


@pytest.mark.parametrize("mode", reduction.MODES)
@pytest.mark.parametrize("dt", ["f32", "bf16", "int32"])
@pytest.mark.parametrize("n", [1 << 24, (1 << 20) + 3, 999, 512, 1])
@pytest.mark.parametrize("offset", [False, True])
def test_reduce_sum_small_tile_equals_plain_bitwise(cuda, mode, dt, n,
                                                    offset):
    """Row 10d's persistent route: the kernel equals reduce_sum_plain bit
    for bit at tile 512 (the same fold and trees), on a base off 16 bytes
    too (native's scalar form), and two calls in a row agree (native's
    ticket is reset)."""
    gen = torch.Generator().manual_seed(n % 9973)
    x = torch.randn(n + 1, generator=gen) * 4
    x = (x.to(torch.int32) if dt == "int32" else x.to(DTYPES[dt])).to(cuda)
    x = x[1:] if offset else x[:n]
    key = f"reduction_{mode}"
    before = fused.LAUNCHES[key]
    got = reduction.reduce_sum_kernel(x, mode, reduction.SMALL_TILE)
    again = reduction.reduce_sum_kernel(x, mode, reduction.SMALL_TILE)
    torch.cuda.synchronize()
    assert fused.LAUNCHES[key] == before + 2
    assert LAST_ROUTE[key] == "persistent"
    want = reduction.reduce_sum_plain(x, mode=mode,
                                      tile=reduction.SMALL_TILE)
    assert got.view(torch.int32).item() == want.view(torch.int32).item(), \
        (float(got), float(want))
    assert again.view(torch.int32).item() == got.view(torch.int32).item()
    params = reduction.launch_params(mode, n, reduction.SMALL_TILE, x)
    assert params["route"] == "persistent" and 1 <= params["grid"] <= n


def test_reduce_sum_default_tile_keeps_the_tile_route(cuda):
    x = torch.randn(300001, device=cuda)
    for mode in reduction.MODES:
        reduction.reduce_sum_kernel(x, mode)
        assert LAST_ROUTE[f"reduction_{mode}"] == "tile"


def _gemm_c1_cases(cuda):
    """(name, A, B) on the card: rows of FLT_MAX against the identity, an
    inf in A and in B against nonzero values, inf meeting inf and 0, NaN."""
    gen = torch.Generator().manual_seed(17)
    fmax = torch.finfo(torch.float32).max
    out = []
    a = torch.randn(9, 40, generator=gen)
    a[:4] = fmax
    a[4] = -fmax
    out.append(("flt_max", a, torch.eye(40, 11)))
    b = torch.randn(40, 11, generator=gen)
    b[b.abs() < 1e-3] = 1.0
    for name, at_a, at_b in (("inf_in_a", (1, 7), None),
                             ("inf_in_b", None, (12, 2)),
                             ("inf_meets_inf", (2, 5), (5, 4))):
        a2, b2 = torch.randn(9, 40, generator=gen), b.clone()
        if at_a is not None:
            a2[at_a] = float("inf")
        if at_b is not None:
            b2[at_b] = -float("inf")
        out.append((name, a2, b2))
    a3, b3 = torch.randn(9, 40, generator=gen), b.clone()
    a3[6, 21], b3[21, 3] = float("inf"), 0.0
    a3[0, 0] = float("nan")
    out.append(("inf_zero_nan", a3, b3))
    return [(n, a.to(cuda), b.to(cuda)) for n, a, b in out]


@pytest.mark.parametrize("mode", gemm.MODES)
def test_gemm_past_the_rounded_split(cuda, mode):
    """ROADMAP C.1 on the card: f32's finite value, inf or NaN, element for
    element, as the plain version and full-f32 torch.matmul give them."""
    for name, a, b in _gemm_c1_cases(cuda):
        got = gemm.gemm(a, b, mode=mode)
        plain = gemm.gemm_plain(a, b, mode=mode)
        ref = torch.matmul(a, b)
        torch.cuda.synchronize()
        for other in (plain, ref):
            assert torch.equal(torch.isnan(got), torch.isnan(other)), name
            assert torch.equal(torch.isinf(got), torch.isinf(other)), name
            fin = torch.isfinite(other)
            assert torch.equal(got[torch.isinf(other)],
                               other[torch.isinf(other)]), name
            torch.testing.assert_close(got[fin], other[fin], rtol=1e-5,
                                       atol=1e-5 * float(
                                           other[fin].abs().max()))


@pytest.mark.parametrize("mode", ALL_MODES)
@pytest.mark.parametrize("slots,route", [(16, "decode"), (17, "fma")])
def test_paged_slot_below_zero_gets_zero_on_both_routes(cuda, mode, slots,
                                                        route):
    """ROADMAP C.2: a paged slot with pos < 0 gets 0 at 17 slots (the fma
    route) as at 16 (decode), bf16 pools and int8 pools with an int8 wo;
    the other slots agree with the plain version."""
    gen = torch.Generator().manual_seed(slots)
    h, hkv, d, n, ps, maxp = 8, 2, 64, 96, 128, 2
    q = _rand(gen, (slots, h, 1, d), torch.bfloat16, cuda)
    kp = _rand(gen, (slots * maxp, hkv, ps, d), torch.bfloat16, cuda)
    vp = _rand(gen, (slots * maxp, hkv, ps, d), torch.bfloat16, cuda)
    wo = _rand(gen, (h * d, n), torch.bfloat16, cuda, (h * d) ** -0.5)
    tables = torch.arange(slots * maxp, dtype=torch.int32,
                          device=cuda).reshape(slots, maxp)
    pos = torch.arange(slots, dtype=torch.int32, device=cuda) * 13
    pos[1], pos[slots - 1] = -1, -5
    dead = (pos < 0).nonzero().flatten()
    live = (pos >= 0).nonzero().flatten()
    from repro_torch.models.attention import quantize_kv
    (kq, ks), (vq, vs) = quantize_kv(kp), quantize_kv(vp)
    wq, ws = fused.quantize_weight(wo)
    for q8 in (False, True):
        counter = fused._count_name("paged_attention_matmul"
                                    + ("_q8" if q8 else ""), mode)
        LAST_ROUTE.clear()
        if q8:
            out = fused.flash_attention_matmul_q8(
                q, kq, vq, wq, w_scale=ws, k_scale=ks, v_scale=vs,
                block_tables=tables, pos=pos, mode=mode)
            plain = fused.flash_attention_matmul_q8_plain(
                q, kq, vq, wq, ws, block_tables=tables, pos=pos, k_scale=ks,
                v_scale=vs, mode=mode)
        else:
            out = fused.paged_attention_matmul(q, kp, vp, wo,
                                               block_tables=tables, pos=pos,
                                               mode=mode)
            plain = fused.paged_attention_matmul_plain(
                q, kp, vp, wo, block_tables=tables, pos=pos, mode=mode)
        torch.cuda.synchronize()
        assert LAST_ROUTE[counter] == route
        assert not out[dead].any() and not plain[dead].any()
        _close(out[live], plain[live], "bf16")


# ---------------------------------------------------------------------------
# quantize_kv's scales on the card, the hybrid family's tick and the cell
# router's tick
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_quantize_kv_equals_the_cpu_bit_for_bit(cuda, dt):
    """K/V rows over a wide range of exponents (each row a normal draw
    times 2^e, e in [-60, 60), as ``scripts/scalar_division_check.py``
    draws values): the card's int8 values and f32 scales equal the CPU's
    bit for bit (each scale is max|row| / 127 by IEEE division)."""
    from repro_torch.models.attention import quantize_kv
    gen = torch.Generator().manual_seed(37)
    rows, d = 1 << 16, 128
    x = (torch.randn(rows, d, generator=gen)
         * torch.exp2(torch.randint(-60, 60, (rows, 1), generator=gen)
                      .float())).to(DTYPES[dt])
    q_card, s_card = quantize_kv(x.to(cuda).reshape(64, 8, rows // 512, d))
    q_cpu, s_cpu = quantize_kv(x.reshape(64, 8, rows // 512, d))
    torch.cuda.synchronize()
    assert s_card.dtype == torch.float32 and q_card.dtype == torch.int8
    assert torch.equal(s_card.cpu(), s_cpu)
    assert torch.equal(q_card.cpu(), q_cpu)


def _hybrid_cfg():
    from repro_torch.models.config import HybridConfig
    return ModelConfig(name="t", family="hybrid", num_layers=3, d_model=64,
                       num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
                       vocab_size=256, dtype="bfloat16", subquadratic=True,
                       ssm=SSMConfig(state_dim=16, head_dim=16, chunk_size=8),
                       hybrid=HybridConfig(attn_every=2))


@pytest.mark.parametrize("mode", ("native",) + MODES)
def test_hybrid_tick_makes_no_host_sync(cuda, mode):
    """A small hybrid (3 mamba layers, the shared block after the second,
    one trailing layer) under ``isa_mode=mode`` with the fused policy:
    the prefill launches the scan a layer, rmsnorm 2 x layers + 1 and the
    shared block's rmsnorm_matmul, rmsnorm_swiglu and causal
    flash_attention_matmul once; five ticks with host syncs forbidden
    launch ssd_decode a layer, the norms, rmsnorm_matmul and rmsnorm_swiglu
    (the shared block's decode attention is plain PyTorch)."""
    from repro_torch.kernels._launch import count_name
    cfg = _hybrid_cfg()
    model = build_model(cfg, ParallelConfig(
        isa_mode=mode, fuse_epilogues=True, use_pallas_attn=True),
        device=cuda)
    params = model.init_params(0)
    eng = BatchedEngine(model, params, ServeConfig(
        batch_slots=2, max_seq_len=64, eos_id=-1))
    fused.reset_launch_counts()
    eng.add_request(Request(rid=0, prompt=[3, 5, 7, 9, 11], max_new_tokens=40))
    torch.cuda.synchronize()
    c = lambda k: count_name(k, mode)
    layers = cfg.num_layers
    assert {k: v for k, v in fused.LAUNCHES.items() if v} == {
        c("ssd_scan"): layers, c("rmsnorm"): 2 * layers + 1,
        c("rmsnorm_matmul"): 1, c("rmsnorm_swiglu"): 1,
        c("flash_attention_matmul"): 1}
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
    assert {k: v for k, v in fused.LAUNCHES.items() if v} == {
        c("ssd_decode"): 5 * layers, c("rmsnorm"): 5 * (2 * layers + 1),
        c("rmsnorm_matmul"): 5, c("rmsnorm_swiglu"): 5}


def test_router_tick_makes_no_host_sync(cuda, monkeypatch):
    """Two paged cells of the small dense model behind a CellRouter: five
    router ticks with host syncs forbidden, then one sync that copies the
    whole fleet's harvest to the host once."""
    from repro_torch.serve import make_cells
    cfg = ModelConfig(name="t", family="dense", num_layers=2, d_model=64,
                      num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
                      dtype="bfloat16")
    model = build_model(cfg, ParallelConfig(fuse_epilogues=True,
                                            use_pallas_attn=True),
                        device=cuda)
    router = make_cells(model, model.init_params(0), ServeConfig(
        batch_slots=2, max_seq_len=64, eos_id=-1, page_size=16), 2)
    reqs = [Request(rid=i, prompt=[3 + i, 5, 7, 9], max_new_tokens=40)
            for i in range(4)]
    assert router.admit(reqs) == 4
    assert all(len([r for r in c.slots if r is not None]) == 2
               for c in router.cells)
    router.step()                               # warm-up outside the guard
    torch.cuda.synchronize()
    fused.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(5):
            router.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert fused.LAUNCHES["paged_attention_matmul"] == 2 * 5 * cfg.num_layers
    copies = []
    real_cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda t, *a, **k:
                        copies.append(t.device.type)
                        or real_cpu(t, *a, **k))
    router.sync()
    assert copies == ["cuda"]
    assert all(len(r.generated) == 7 for r in reqs)


@pytest.mark.parametrize("dialect", [None, "uisa-universal10"],
                         ids=["hopper", "uisa-universal10"])
@pytest.mark.parametrize("arch", ["granite-8b", "mamba2-2.7b"])
def test_auto_tick_makes_no_host_sync(cuda, arch, dialect):
    """``isa_mode="auto"`` at full width and 2 layers: five ticks with host
    syncs forbidden (the registry's picks are memoised and ranked from
    Python shapes, reading no tensor), every launch in the picked mode:
    on Hopper granite-8b's fused ops native and mamba2's kernels
    abstract+shuffle, on uisa-universal10 all abstract."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch), num_layers=2)
    dense = cfg.family == "dense"
    par = ParallelConfig(isa_mode="auto", isa_dialect=dialect,
                         use_pallas_attn=dense)
    model = build_model(cfg, par, device=cuda)
    eng = BatchedEngine(model, model.init_params(0), ServeConfig(
        batch_slots=2, max_seq_len=256, eos_id=-1,
        page_size=128 if dense else None))
    eng.add_request(Request(rid=0, prompt=list(range(3, 40)),
                            max_new_tokens=40))
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
    counts = {k: v for k, v in fused.LAUNCHES.items() if v}
    assert counts
    if dialect is not None:
        assert all(k.endswith("_abstract") for k in counts), counts
    elif dense:
        assert all(not k.endswith(("_abstract", "_abstract+shuffle"))
                   for k in counts), counts
    else:
        assert all(k.endswith("_abstract+shuffle") for k in counts), counts


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("l", [300, 512])
def test_ssd_scan_tuned_chunk_matches_plain(cuda, dt, l):
    """``ssd_scan(chunk=None)`` on the card resolves the chunk as on the
    CPU (the Hopper slice of the tuning table, else the first candidate)
    and matches the plain version at that chunk."""
    gen = torch.Generator().manual_seed(l)
    x, dtv, A, B, C = _ssd_inputs(gen, DTYPES[dt], cuda, 1, l, 4, 64, 1, 128)
    q = ssd.resolve_chunk(l, None, mode="native", p=64, n=128)
    y, h = ssd.ssd_scan(x, dtv, A, B, C, chunk=None)
    y_p, h_p = ssd.ssd_scan_plain(x, dtv, A, B, C, chunk=q)
    _close(y, y_p, dt)
    _close(h, h_p, dt)
    y2, h2 = ops.fused_ssd_scan(x, dtv, A, B, C, chunk=None, mode="auto")
    y2_p, h2_p = ssd.ssd_scan_plain(
        x, dtv, A, B, C, chunk=ssd.resolve_chunk(
            l, None, mode="abstract+shuffle", p=64, n=128),
        mode="abstract+shuffle")
    _close(y2, y2_p, dt)
    _close(h2, h2_p, dt)
