"""The port's optimizer, train step and gradient compression against the
JAX package's, on the CPU: ``adamw_update`` over 5 steps with clipping,
warmup and cosine decay under each compression (none, bf16, int8_ef) and
with bf16 params beside f32 masters; 3 steps of ``build_train_step`` with
``grad_accum`` 1 and 2 (params, optimizer state and metrics);
``quantize_int8`` bit for bit; the refusal of every policy that routes an
op into a kernel (JAX's ``value_and_grad`` fails there too); and
tests/test_substrate.py's optimizer and compression tests on the port."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # optional dev dep (requirements-dev.txt)
    from _hypothesis_stub import given, settings, st

from conftest import tolerance_for
from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticLMDataset as RefDataset
from repro.models import build_model as ref_build
from repro.models.config import ParallelConfig as RefPar
from repro.parallel import compress as ref_compress
from repro.train import optim as ref_optim
from repro.train import build_train_step as ref_build_train_step
from test_serve_equivalence import tiny_model

from repro_torch.tree import flatten
from repro_torch.configs import get_reduced
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig, ParallelConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.parallel import compress
from repro_torch.train import (OptConfig, adamw_update, build_eval_step,
                               build_train_step, init_opt_state, lr_at_step)
from repro_torch.train.step import init_train_state

TOL = tolerance_for("f32")
KEY = jax.random.PRNGKey(0)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        if np.asarray(a).dtype.name == "bfloat16"
                        else np.asarray(a), tree)


def _close_trees(got, want, what, tol=TOL):
    got, want = flatten(got), flatten(_np(want))
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        np.testing.assert_allclose(got[k].float().numpy(), w, **tol,
                                   err_msg=f"{what}: {k}")


# --------------------------------------------------------------------------
# the optimizer against the reference
# --------------------------------------------------------------------------


OPT = OptConfig(lr=1e-2, warmup_steps=2, total_steps=5, grad_clip=1.0,
                weight_decay=0.1)


def _opt_inputs(seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((8, 12)).astype(np.float32),
              "blocks": {"a": rng.standard_normal((2, 6)).astype(np.float32),
                         "b": rng.standard_normal((3,)).astype(np.float32)}}
    # steps whose global norm falls on both sides of the clip
    grads = [jax.tree.map(lambda p, s=s: (rng.standard_normal(p.shape)
                                          * s).astype(np.float32), params)
             for s in (0.05, 1.0, 0.02, 3.0, 0.1)]
    return params, grads


@pytest.mark.parametrize("compression,dtype", [
    ("none", "float32"), ("bf16", "float32"), ("int8_ef", "float32"),
    ("none", "bfloat16")])
def test_adamw_update_matches_reference(compression, dtype):
    cfg = dataclasses.replace(OPT, compression=compression)
    ref_cfg = ref_optim.OptConfig(**dataclasses.asdict(cfg))
    params_np, grads_np = _opt_inputs()
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref_params = jax.tree.map(lambda a: jnp.asarray(a, jdt), params_np)
    ref_state = ref_optim.init_opt_state(ref_params, ref_cfg)
    params = params_from_numpy(params_np, "cpu", tdt)
    state = init_opt_state(params, cfg)
    for g_np in grads_np:
        ref_params, ref_state, ref_stats = ref_optim.adamw_update(
            jax.tree.map(lambda a: jnp.asarray(a, jdt), g_np), ref_state,
            ref_params, ref_cfg)
        params, state, stats = adamw_update(
            params_from_numpy(g_np, "cpu", tdt), state, params, cfg)
        for k, v in ref_stats.items():
            np.testing.assert_allclose(float(stats[k]), float(v), **TOL,
                                       err_msg=k)
    assert int(state["step"]) == int(ref_state["step"]) == 5
    assert state["step"].dtype == torch.int32
    assert all(p.dtype == tdt for p in flatten(params).values())
    _close_trees(params, ref_params, "params")
    for name in ("m", "v", "master") + (("ef",) if compression == "int8_ef"
                                        else ()):
        _close_trees(state[name], ref_state[name], name)
        assert all(t.dtype == torch.float32
                   for t in flatten(state[name]).values())


def test_lr_schedule_matches_reference():
    cfg = OptConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    ref_cfg = ref_optim.OptConfig(**dataclasses.asdict(cfg))
    steps = np.arange(0, 120, 3)
    got = lr_at_step(cfg, torch.from_numpy(steps.astype(np.int32))).numpy()
    want = np.asarray(ref_optim.lr_at_step(ref_cfg, jnp.asarray(steps)))
    np.testing.assert_allclose(got, want, **TOL)
    assert lr_at_step(cfg, 0).dtype == torch.float32


def test_quantize_int8_is_bitwise_the_reference():
    rng = np.random.default_rng(3)
    for scale in (1e-30, 1e-6, 1.0, 1e3, 1e30):
        g = (rng.standard_normal(257) * scale).astype(np.float32)
        q, s = compress.quantize_int8(torch.from_numpy(g))
        rq, rs = ref_compress.quantize_int8(jnp.asarray(g))
        assert np.array_equal(q.numpy(), np.asarray(rq))
        assert s.numpy().tobytes() == np.asarray(rs).tobytes()
        deq = compress.dequantize_int8(q, s)
        assert deq.numpy().tobytes() == np.asarray(
            ref_compress.dequantize_int8(rq, rs)).tobytes()
    zeros = compress.quantize_int8(torch.zeros(4, dtype=torch.bfloat16))
    assert zeros[0].dtype == torch.int8
    assert float(zeros[1]) == float(np.float32(1e-12))


# --------------------------------------------------------------------------
# the train step against the reference
# --------------------------------------------------------------------------


def _data(cfg, b=4, s=16):
    return RefDataset(RefDataConfig(global_batch=b, seq_len=s,
                                    vocab_size=cfg.vocab_size, seed=5))


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_steps_match_reference(grad_accum):
    ref_cfg = tiny_model()[1]
    cfg = ModelConfig(**dataclasses.asdict(ref_cfg))
    opt_cfg = OptConfig(lr=1e-2, warmup_steps=1, total_steps=3)
    ref_model = ref_build(ref_cfg, RefPar(remat="none",
                                          grad_accum=grad_accum))
    ref_step, _ = ref_build_train_step(
        ref_model, ref_optim.OptConfig(**dataclasses.asdict(opt_cfg)))
    ref_step = jax.jit(ref_step)
    ref_params = ref_model.init_params(KEY)
    ref_state = ref_optim.init_opt_state(ref_params, opt_cfg)
    model = build_model(cfg, ParallelConfig(remat="full",
                                            grad_accum=grad_accum),
                        device="cpu")
    step, shardings = build_train_step(model, opt_cfg)
    assert shardings is None
    params = params_from_numpy(_np(ref_params), "cpu")
    state = init_opt_state(params, opt_cfg)
    data = _data(cfg)
    for i in range(3):
        batch = data.batch_at(i)
        ref_params, ref_state, ref_metrics = ref_step(
            ref_params, ref_state, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        params, state, metrics = step(
            params, state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert sorted(metrics) == sorted(ref_metrics)
        for k, v in ref_metrics.items():
            np.testing.assert_allclose(float(metrics[k]), float(v), **TOL,
                                       err_msg=f"step {i}: {k}")
            assert not metrics[k].requires_grad
    _close_trees(params, ref_params, "params")
    assert int(state["step"]) == 3
    for name in ("m", "v", "master"):
        _close_trees(state[name], ref_state[name], name)
    assert not any(p.requires_grad for p in flatten(params).values())


def test_grad_accum_sums_in_f32():
    """bf16 params: the two microbatches' bf16 grads are summed in f32 and
    halved, as JAX's scan carry does (``.grad`` would sum in bf16)."""
    cfg = dataclasses.replace(get_reduced("granite-8b"), dtype="bfloat16")
    opt_cfg = OptConfig(warmup_steps=1, total_steps=3)
    batch = {k: torch.from_numpy(v) for k, v in _data(cfg).batch_at(0).items()}
    model = build_model(cfg, ParallelConfig(grad_accum=2), device="cpu")
    params, state = init_train_state(model, opt_cfg, seed=1)
    halves = []
    for half in ({k: v[:2] for k, v in batch.items()},
                 {k: v[2:] for k, v in batch.items()}):
        leaves = list(flatten(params).values())
        for p in leaves:
            p.requires_grad_(True)
        halves.append(torch.autograd.grad(model.loss_fn(params, half)[0],
                                          leaves))
        for p in leaves:
            p.requires_grad_(False)
    assert halves[0][0].dtype == torch.bfloat16
    want = torch.sqrt(torch.stack([
        ((a.float() + b.float()) / 2).square().sum()
        for a, b in zip(*halves)]).sum())
    _, _, metrics = build_train_step(model, opt_cfg)[0](params, state,
                                                        batch)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(want),
                               rtol=1e-6)


# --------------------------------------------------------------------------
# refusals (ROADMAP C.14) and the eval step
# --------------------------------------------------------------------------


KERNEL_POLICIES = {
    "fused": dict(fuse_epilogues=True),
    "pallas_attn": dict(use_pallas_attn=True),
    "native": dict(isa_mode="native"),
    "abstract": dict(isa_mode="abstract"),
    "auto": dict(isa_mode="auto"),
}


@pytest.mark.parametrize("name", sorted(KERNEL_POLICIES))
def test_build_train_step_refuses_kernel_policies(name):
    cfg = ModelConfig(**dataclasses.asdict(tiny_model()[1]))
    model = build_model(cfg, ParallelConfig(**KERNEL_POLICIES[name]),
                        device="cpu")
    with pytest.raises(ValueError, match="plain versions only"):
        build_train_step(model, OptConfig())
    if "use_pallas_attn" not in KERNEL_POLICIES[name]:
        # a policy= override is checked too
        plain = build_model(cfg, ParallelConfig(), device="cpu")
        with pytest.raises(ValueError, match="plain versions only"):
            build_train_step(plain, OptConfig(), policy=model.policy)


@pytest.mark.parametrize("kw", [dict(), dict(isa_mode="library"),
                                dict(kv_cache_int8=True),
                                dict(weight_precision="int8")])
def test_build_train_step_takes_plain_policies(kw):
    cfg = ModelConfig(**dataclasses.asdict(tiny_model()[1]))
    build_train_step(build_model(cfg, ParallelConfig(**kw), device="cpu"),
                     OptConfig())


def test_grad_compression_is_one_decision():
    """``build_train_step`` refuses an ``OptConfig`` whose compression is
    not the model's ``ParallelConfig.grad_compression``; under int8_ef the
    step carries the residual and moves the params otherwise than none."""
    cfg = ModelConfig(**dataclasses.asdict(tiny_model()[1]))
    for par, opt in (("int8_ef", "none"), ("none", "bf16")):
        model = build_model(cfg, ParallelConfig(grad_compression=par),
                            device="cpu")
        with pytest.raises(ValueError, match="grad_compression"):
            build_train_step(model, OptConfig(compression=opt))
    batch = {k: torch.from_numpy(v)
             for k, v in _data(cfg).batch_at(0).items()}
    out = {}
    for mode in ("none", "int8_ef"):
        model = build_model(cfg, ParallelConfig(grad_compression=mode),
                            device="cpu")
        opt = OptConfig(lr=1e-2, warmup_steps=1, total_steps=3,
                        compression=mode)
        params, state = init_train_state(model, opt, seed=0)
        params, state, _ = build_train_step(model, opt)[0](params, state,
                                                           batch)
        out[mode] = flatten(params), state
    assert "ef" not in out["none"][1]
    assert any(bool(e.abs().max() > 0)
               for e in flatten(out["int8_ef"][1]["ef"]).values())
    assert any(not torch.equal(p, out["none"][0][k])
               for k, p in out["int8_ef"][0].items())


def test_reference_cannot_differentiate_a_kernel_policy():
    """The record of the JAX package's side: its value_and_grad fails under
    a fused policy (its Pallas kernels have no backward)."""
    cfg = tiny_model()[1]
    model = ref_build(cfg, RefPar(remat="none", fuse_epilogues=True))
    params = model.init_params(KEY)
    toks = jnp.ones((1, 8), jnp.int32)
    with pytest.raises(Exception):
        jax.value_and_grad(model.loss_fn, has_aux=True)(
            params, {"tokens": toks, "labels": toks})


def test_eval_step_runs_any_policy_without_grad():
    cfg = ModelConfig(**dataclasses.asdict(tiny_model()[1]))
    plain = build_model(cfg, ParallelConfig(), device="cpu")
    params = plain.init_params(0)
    batch = {k: torch.from_numpy(v)
             for k, v in _data(cfg).batch_at(0).items()}
    want = plain.loss_fn(params, batch)[0]
    for kw in (dict(), dict(fuse_epilogues=True, use_pallas_attn=True)):
        model = build_model(cfg, ParallelConfig(**kw), device="cpu")
        out = build_eval_step(model)(params, batch)
        assert not out["loss"].requires_grad
        np.testing.assert_allclose(float(out["loss"]), float(want), **TOL)


# --------------------------------------------------------------------------
# tests/test_substrate.py's optimizer and compression tests, on the port
# --------------------------------------------------------------------------


class TestOptimizer:
    def test_lr_schedule_shape(self):
        cfg = OptConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                        min_lr_ratio=0.1)
        assert float(lr_at_step(cfg, 0)) == 0.0
        np.testing.assert_allclose(float(lr_at_step(cfg, 10)), 1e-3,
                                   rtol=1e-5)
        assert float(lr_at_step(cfg, 100)) == pytest.approx(1e-4, rel=1e-4)
        lrs = [float(lr_at_step(cfg, s)) for s in range(10, 101, 10)]
        assert all(a >= b for a, b in zip(lrs, lrs[1:]))

    def test_adamw_descends_quadratic(self):
        cfg = OptConfig(lr=0.1, warmup_steps=0, total_steps=100,
                        weight_decay=0.0, grad_clip=1e9)
        params = {"w": torch.tensor([5.0, -3.0])}
        state = init_opt_state(params, cfg)
        for _ in range(60):
            grads = {"w": params["w"].clone()}        # d/dw (w^2/2)
            params, state, _ = adamw_update(grads, state, params, cfg)
        assert float(params["w"].abs().max()) < 1.0

    def test_grad_clipping(self):
        cfg = OptConfig(grad_clip=1.0, warmup_steps=0)
        params = {"w": torch.zeros(4)}
        state = init_opt_state(params, cfg)
        grads = {"w": torch.full((4,), 100.0)}
        _, _, stats = adamw_update(grads, state, params, cfg)
        assert float(stats["grad_norm"]) == pytest.approx(200.0)
        assert float(stats["clip_factor"]) == pytest.approx(1 / 200.0)
        assert float(grads["w"][0]) == 100.0          # the caller's grads

    def test_int8_ef_residual_carries(self):
        cfg = OptConfig(lr=0.01, warmup_steps=0, compression="int8_ef",
                        weight_decay=0.0, grad_clip=1e9)
        params = {"w": torch.tensor([1.0, 1e-3])}
        state = init_opt_state(params, cfg)
        assert "ef" in state
        for _ in range(5):
            grads = {"w": torch.tensor([1.0, 1e-3])}
            params, state, _ = adamw_update(grads, state, params, cfg)
        # 1e-3 quantizes to 0 alone; the residual keeps it
        assert float(state["ef"]["w"][1].abs()) > 0.0

    def test_master_weights_are_fp32_copies(self):
        cfg = dataclasses.replace(
            ModelConfig(**dataclasses.asdict(tiny_model()[1])),
            dtype="bfloat16")
        model = build_model(cfg, ParallelConfig(), device="cpu")
        params, state = init_train_state(model, OptConfig())
        for m, p in zip(flatten(state["master"]).values(),
                        flatten(params).values()):
            assert m.dtype == torch.float32 and m.shape == p.shape
            assert torch.equal(m, p.float())
            assert m.data_ptr() != p.data_ptr()

    @given(step=st.integers(0, 10000))
    @settings(max_examples=50, deadline=None)
    def test_lr_always_in_range(self, step):
        cfg = OptConfig(lr=3e-4, warmup_steps=200, total_steps=10000)
        lr = float(lr_at_step(cfg, step))
        assert 0.0 <= lr <= cfg.lr * (1 + 1e-6)


class TestCompression:
    @given(scale=st.floats(1e-6, 1e3))
    @settings(max_examples=30, deadline=None)
    def test_int8_roundtrip_error_bound(self, scale):
        g = torch.from_numpy(np.random.default_rng(0).standard_normal(
            256).astype(np.float32)) * scale
        q, s = compress.quantize_int8(g)
        deq = compress.dequantize_int8(q, s)
        assert float((deq - g).abs().max()) <= float(s) * 0.5 + 1e-9

    def test_int8_wire_dtype(self):
        q, _ = compress.quantize_int8(torch.randn(64))
        assert q.dtype == torch.int8
