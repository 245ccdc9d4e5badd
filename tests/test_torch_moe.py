"""The port's mixture of experts against the JAX package's: routing
(dispatch, combine and the load-balance loss, with capacity drops, tied
gates and a zero-padded group), ``apply_moe`` router-only and with a shared
expert, and granite-moe-3b-a800m-reduced's prefill and decode logits
(dense and paged caches) under the library policy, the fused policy (P1)
and the unfused kernel policy (P2), in f32 at ``TOLERANCES["f32"]``.  Both
sides get the reference's parameters and the same numpy inputs; the JAX
side runs its Pallas kernels in interpret mode."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tolerance_for
from repro.configs import get_reduced as ref_reduced
from repro.models import build_model as ref_build
from repro.models import mlp as ref_mlp
from repro.models.config import MoEConfig as RefMoE
from repro.models.config import ParallelConfig as RefPar
from repro.models.config import ParamLayout as RefLayout

from repro_torch.configs import get_reduced
from repro_torch.models import build_model, mlp
from repro_torch.models.config import (ModelConfig, MoEConfig,
                                       ParallelConfig, ParamLayout)
from repro_torch.models.convert import params_from_numpy

TOL = tolerance_for("f32")
POLICIES = {"library": dict(),
            "fused": dict(fuse_epilogues=True, use_pallas_attn=True),
            "unfused-kernel": dict(use_pallas_attn=True, isa_mode="native")}
ARCH = "granite-moe-3b-a800m"


def port_config(ref_cfg) -> ModelConfig:
    """A JAX ModelConfig as the port's (the MoE field rebuilt)."""
    d = dataclasses.asdict(ref_cfg)
    if d["moe"] is not None:
        d["moe"] = MoEConfig(**d["moe"])
    return ModelConfig(**d)


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_config_matches_reference():
    assert get_reduced(ARCH) == port_config(ref_reduced(ARCH))
    from repro.configs import get_config as ref_config
    from repro_torch.configs import get_config
    assert get_config(ARCH) == port_config(ref_config(ARCH))
    assert {f.name for f in dataclasses.fields(MoEConfig)} == \
        {f.name for f in dataclasses.fields(RefMoE)}


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

ROUTE_CASES = {
    # name: (groups, group size, experts, top_k, capacity_factor, skew)
    "top4": (2, 64, 8, 4, 1.25, 0.0),
    "drops": (1, 64, 8, 4, 1.25, 4.0),        # expert 0 takes every token
    "top1": (1, 40, 6, 1, 1.0, 2.0),          # capacity 8 of 40 tokens
    "decode8": (1, 8, 40, 8, 1.25, 0.0),      # granite-moe's decode group
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_route_matches_reference(case):
    g, s, e, k, cf, skew = ROUTE_CASES[case]
    moe = MoEConfig(num_experts=e, top_k=k, capacity_factor=cf)
    rng = np.random.default_rng(len(case))
    logits = _np(rng, g, s, e)
    logits[..., 0] += skew
    logits[:, -5:] = 0.0              # zero-padded rows: every gate equal
    want = ref_mlp.route(jnp.asarray(logits), RefMoE(**dataclasses.asdict(
        moe)))
    got = mlp.route(torch.from_numpy(logits), moe)
    for a, b in zip(got, want):
        _close(a, b)
    dispatch = got[0]
    assert dispatch.shape == (g, s, e, mlp._capacity(s, moe))
    if skew:                           # some assignments found no place
        assert dispatch.sum() < g * s * k
    else:
        assert dispatch.sum() == g * s * k


def _moe_params(moe, d, f, layout, seed=0):
    ref_params, _ = ref_mlp.init_moe(jax.random.PRNGKey(seed), d, f,
                                     RefMoE(**dataclasses.asdict(moe)),
                                     "silu", jnp.float32, layout)
    return ref_params, params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                         "cpu")


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("tokens", [7, 80])          # 80 pads a 64-group
@pytest.mark.parametrize("policy", ["library", "fused"])
def test_apply_moe_matches_reference(shared, tokens, policy):
    d, f = 32, 16
    moe = MoEConfig(num_experts=8, top_k=4, group_size=64,
                    shared_experts=shared)
    ref_par = RefPar(**POLICIES[policy])
    par = ParallelConfig(**POLICIES[policy])
    layout = RefLayout(mlp_swiglu=ref_par.execution_policy().fuses())
    ref_params, params = _moe_params(moe, d, f, layout, seed=shared)
    rng = np.random.default_rng(tokens)
    x = _np(rng, 1, tokens, d)
    scale = 1.0 + _np(rng, d, scale=0.1)
    fuse = par.execution_policy().fuses()
    kw = dict(norm_scale=scale) if fuse else {}
    want_y, want_aux = ref_mlp.apply_moe(
        ref_params, jnp.asarray(x), RefMoE(**dataclasses.asdict(moe)), "silu",
        None, policy=ref_par.execution_policy(), eps=1e-6, **kw)
    got_y, got_aux = mlp.apply_moe(
        params, torch.from_numpy(x), moe, "silu",
        policy=par.execution_policy(), eps=1e-6,
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    _close(got_y, want_y)
    _close(got_aux, want_aux)
    assert ("shared" in params) == bool(shared)
    if shared and fuse:
        assert "wig" in params["shared"]


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

BATCH, PROMPT_LEN, STEPS, PAGE = 2, 40, 4, 8    # 80 prefill tokens
MAXP = -(-(PROMPT_LEN + STEPS) // PAGE)
NUM_PAGES = BATCH * MAXP


def _models(policy):
    ref_cfg = ref_reduced(ARCH)
    ref = ref_build(ref_cfg, RefPar(remat="none", **POLICIES[policy]))
    port = build_model(port_config(ref_cfg),
                       ParallelConfig(**POLICIES[policy]), device="cpu")
    ref_params = ref.init_params(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), "cpu")
    return ref, ref_params, port, params, ref_cfg


def _paged(k, v, prompt_len):
    """Each slot's prefill rows on a shuffled set of pages."""
    nl, b, hkv, _, hd = k.shape
    tables = np.random.default_rng(1).permutation(NUM_PAGES).astype(
        np.int32).reshape(b, MAXP)
    pools = []
    for strip in (k, v):
        pool = np.zeros((nl, NUM_PAGES, hkv, PAGE, hd), np.float32)
        for slot in range(b):
            for j in range(-(-prompt_len // PAGE)):
                rows = strip[:, slot, :, j * PAGE:(j + 1) * PAGE]
                pool[:, tables[slot, j], :, :rows.shape[2]] = rows
        pools.append(pool)
    pos = np.full((b,), prompt_len, np.int32)
    ref = {"k_pages": jnp.asarray(pools[0]), "v_pages": jnp.asarray(pools[1]),
           "block_tables": jnp.asarray(tables), "pos": jnp.asarray(pos)}
    trash = np.zeros((nl, 1) + pools[0].shape[2:], np.float32)
    port = {"k_pages": torch.from_numpy(np.concatenate([pools[0], trash], 1)),
            "v_pages": torch.from_numpy(np.concatenate([pools[1], trash], 1)),
            "block_tables": torch.from_numpy(tables),
            "pos": torch.from_numpy(pos)}
    return ref, port


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_prefill_and_decode_match_reference(policy):
    ref, ref_params, port, params, cfg = _models(policy)
    layout = port.param_layout
    assert layout == ParamLayout.plan(port.cfg, port.policy)
    assert ("wqkv" in params["blocks"]["attn"]) == layout.attn_qkv
    rng = np.random.default_rng(0)
    toks = rng.integers(2, cfg.vocab_size, (BATCH, PROMPT_LEN)).astype(
        np.int32)
    ref_logits, ref_cache = jax.jit(ref.prefill)(
        ref_params, {"tokens": jnp.asarray(toks)})
    logits, cache = port.prefill(params, {"tokens": torch.from_numpy(toks)})
    _close(logits, ref_logits)
    _close(cache["k"], ref_cache["k"])
    _close(cache["v"], ref_cache["v"])
    ref_decode = jax.jit(ref.decode_step)
    ref_paged, paged = _paged(np.asarray(ref_cache["k"]),
                              np.asarray(ref_cache["v"]), PROMPT_LEN)
    pad = STEPS + 2
    ref_dense = dict(ref_cache, **{
        n: jnp.pad(ref_cache[n], ((0, 0),) * 3 + ((0, pad), (0, 0)))
        for n in ("k", "v")})
    dense = dict(cache, **{n: torch.nn.functional.pad(cache[n], (0, 0, 0, pad))
                           for n in ("k", "v")})
    nxt = np.argmax(np.asarray(ref_logits), -1).astype(np.int32)
    for _ in range(STEPS):
        want, ref_paged = ref_decode(ref_params, jnp.asarray(nxt), ref_paged)
        got, paged = port.decode_step(params, torch.from_numpy(nxt), paged)
        _close(got, want)
        want_d, ref_dense = ref_decode(ref_params, jnp.asarray(nxt),
                                       ref_dense)
        got_d, dense = port.decode_step(params, torch.from_numpy(nxt), dense)
        _close(got_d, want_d)
        nxt = np.argmax(np.asarray(want), -1).astype(np.int32)
    _close(paged["k_pages"][:, :NUM_PAGES], ref_paged["k_pages"])
    _close(dense["v"], ref_dense["v"])


def test_one_parameter_set_serves_both_policies():
    """Parameters initialized under P1 (concatenated wqkv) run under P2
    through the layout accessors, as the JAX package's do."""
    cfg = port_config(ref_reduced(ARCH))
    p1 = build_model(cfg, ParallelConfig(**POLICIES["fused"]), device="cpu")
    p2 = build_model(cfg, ParallelConfig(**POLICIES["unfused-kernel"]),
                     device="cpu")
    assert p1.param_layout.attn_qkv and not p2.param_layout.attn_qkv
    params = p1.init_params(0)
    assert set(params["blocks"]["moe"]) == {"router", "wi", "wg", "wo"}
    assert params["blocks"]["moe"]["wi"].shape == (2, 8, 64, 32)
    assert "lm_head" not in params
    toks = torch.arange(2, 70, dtype=torch.int32)[None]
    want, _ = p1.prefill(params, {"tokens": toks})
    got, _ = p2.prefill(params, {"tokens": toks})
    torch.testing.assert_close(got, want, **TOL)
