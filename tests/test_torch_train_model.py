"""The port's ``loss_fn`` and its gradients against the JAX package's, on
the CPU, for the reduced transformer architectures (dense, MoE, VLM) in
f32 (tests/test_torch_train_families.py takes the SSM, hybrid and
encoder-decoder ones through the same tests): ``total``,
``ce_loss`` and ``aux_loss`` at ``TOLERANCES["f32"]`` (ROADMAP C.13: the
port dropped the MoE auxiliary loss), every gradient leaf against
``jax.grad`` at rtol 2e-4 and atol 2e-4 x max|JAX leaf|, and the three
remat modes bitwise equal in the port, losses and grads.  Parameters are
the reference's (``params_from_numpy``); batches are numpy from a seed."""
import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from conftest import tolerance_for
from repro import configs as ref_configs
from repro.models import build_model as ref_build
from repro.models.config import ParallelConfig as RefPar

from repro_torch.configs import ARCHS, get_reduced
from repro_torch.models import build_model, common
from repro_torch.models.config import ParallelConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.tree import flatten, unflatten

TOL = tolerance_for("f32")
GRAD_RTOL = GRAD_ATOL_SCALE = 2e-4
REMATS = ("none", "full", "dots")
TRANSFORMERS = tuple(a for a in ARCHS
                     if get_reduced(a).family in ("dense", "moe", "vlm"))


def batch_np(cfg, seed=0, b=2, s=16):
    """tokens / labels (the next tokens) and the family's stub inputs."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family in ("encdec", "audio"):
        out["frames"] = rng.standard_normal(
            (b, cfg.encdec.num_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.standard_normal(
            (b, cfg.vlm.num_patches, cfg.d_model)).astype(np.float32)
    return out


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def reference(arch):
    """JAX: (params as numpy, batch, loss, metrics, grads as numpy)."""
    model = ref_build(ref_configs.get_reduced(arch), RefPar(remat="none"))
    params = model.init_params(jax.random.PRNGKey(0))
    batch = batch_np(get_reduced(arch))
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        model.loss_fn, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    to_np = functools.partial(jax.tree.map, np.asarray)
    return (to_np(params), batch, float(loss), to_np(metrics),
            to_np(grads))


def port_loss_and_grads(arch, remat="none"):
    params_np, batch = reference(arch)[:2]
    model = build_model(get_reduced(arch), ParallelConfig(remat=remat),
                        device="cpu")
    params = params_from_numpy(params_np, "cpu")
    flat = flatten(params)
    for p in flat.values():
        p.requires_grad_(True)
    loss, metrics = model.loss_fn(params, to_torch(batch))
    grads = torch.autograd.grad(loss, list(flat.values()))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten(params, dict(zip(flat, grads))))


def check_loss(arch):
    _, _, ref_loss, ref_metrics, _ = reference(arch)
    loss, metrics, _ = port_loss_and_grads(arch)
    assert sorted(metrics) == sorted(ref_metrics)
    np.testing.assert_allclose(float(loss), ref_loss, **TOL)
    for k, v in ref_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), **TOL)
    if get_reduced(arch).moe is not None:
        # C.13: the MoE layers' load-balancing loss reaches the total
        aux = float(metrics["aux_loss"])
        assert aux > 0
        want = float(metrics["ce_loss"]) + 0.01 * aux \
            / get_reduced(arch).num_layers
        np.testing.assert_allclose(float(loss), want, rtol=1e-6)


def check_grads(arch):
    ref_grads = flatten(reference(arch)[4])
    grads = flatten(port_loss_and_grads(arch)[2])
    assert sorted(grads) == sorted(ref_grads)
    for key, want in ref_grads.items():
        got = grads[key].numpy()
        assert got.shape == want.shape, key
        np.testing.assert_allclose(
            got, want, rtol=GRAD_RTOL,
            atol=GRAD_ATOL_SCALE * float(np.abs(want).max()), err_msg=key)


def check_remat(arch):
    """What the backward recomputes changes no bit of the loss or of any
    gradient."""
    runs = {r: port_loss_and_grads(arch, r) for r in REMATS}
    base_loss, base_metrics, base_grads = runs["none"]
    for remat in REMATS[1:]:
        loss, metrics, grads = runs[remat]
        assert torch.equal(loss, base_loss), remat
        for k in base_metrics:
            assert torch.equal(metrics[k], base_metrics[k]), (remat, k)
        for key, g in flatten(grads).items():
            assert torch.equal(g, flatten(base_grads)[key]), (remat, key)


@pytest.mark.parametrize("arch", TRANSFORMERS)
def test_loss_fn_matches_reference(arch):
    check_loss(arch)


@pytest.mark.parametrize("arch", TRANSFORMERS)
def test_grads_match_reference(arch):
    check_grads(arch)


@pytest.mark.parametrize("arch", TRANSFORMERS)
def test_remat_modes_are_bitwise_equal(arch):
    check_remat(arch)


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


def test_remat_recomputes_what_its_mode_says():
    """The backward of "full" recomputes the layer's products and the
    rest, "dots" the rest alone (its 2-D products saved), "none" nothing;
    outside grad mode each mode is one plain call."""
    torch.manual_seed(0)
    w1 = torch.randn(16, 32, requires_grad=True)
    w2 = torch.randn(32, 16, requires_grad=True)
    x = torch.randn(4, 16, requires_grad=True)

    def layer(h):
        return torch.exp(torch.relu(h @ w1)) @ w2

    backward = {}
    for remat in REMATS:
        y = common.remat_call(layer, remat, x)
        with _OpCount() as count:
            y.sum().backward()
        backward[remat] = count.ops
    assert backward["none"]["exp"] == 0
    assert backward["full"]["exp"] == backward["dots"]["exp"] == 1
    assert backward["full"]["mm"] > backward["none"]["mm"]
    assert backward["dots"]["mm"] == backward["none"]["mm"]
    with torch.no_grad():
        calls = []
        common.remat_call(lambda h: calls.append(h) or h, "full", x)
        assert len(calls) == 1
    with pytest.raises(ValueError, match="remat"):
        common.remat_call(layer, "some", x)


def test_layer_views_are_the_stacked_rows():
    blocks = {"a": torch.arange(12.).reshape(3, 4),
              "sub": {"b": torch.arange(6.).reshape(3, 2)}}
    views = common.layer_views(blocks)
    assert len(views) == 3
    for i, view in enumerate(views):
        assert torch.equal(view["a"], blocks["a"][i])
        assert view["sub"]["b"].data_ptr() == blocks["sub"]["b"][i].data_ptr()


def test_parallel_config_training_fields_equal_reference():
    names = ("grad_accum", "remat", "grad_compression")
    got = {f.name: f.default for f in dataclasses.fields(ParallelConfig)}
    want = {f.name: f.default for f in dataclasses.fields(RefPar)}
    assert {n: got[n] for n in names} == {n: want[n] for n in names}
