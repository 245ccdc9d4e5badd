"""The port's hand-written CUDA kernels on the card (skipped without one).

Each kernel is held against its plain PyTorch version on the same CUDA
inputs, in f32 and bf16.  Tolerances: f32 differs only in summation order
(rtol 1e-4, atol 1e-4 x max|plain|); bf16 rounds its output (and the
attention output before wo) once, where the plain version may round in
other places (rtol 2e-2, atol 2e-2 x max|plain|).

Run on a machine with the card (``--noconftest``: tests/conftest.py
imports JAX, which the port does not need):
``PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import fused
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig, ParallelConfig
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
