"""TransformerLM of the port against the JAX package's: prefill logits and
8 decode steps (dense cache and paged cache, with a reaped slot writing
through sentinel entries), on the serve-equivalence tiny model and on
granite-8b-reduced, under the unfused and the fused policy, in f32 at
``TOLERANCES["f32"]``.  Both sides get the reference's parameters and the
same tokens; decode is teacher-forced with the reference's argmax."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tolerance_for
from repro.configs import get_reduced as ref_reduced
from repro.models import build_model as ref_build
from repro.models.config import ParallelConfig as RefPar
from test_serve_equivalence import tiny_model

from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig, ParallelConfig
from repro_torch.models.convert import params_from_numpy

TOL = tolerance_for("f32")
POLICIES = {"unfused": dict(),
            "fused": dict(fuse_epilogues=True, use_pallas_attn=True)}
CONFIGS = {"tiny": lambda: tiny_model()[1],
           "granite-8b-reduced": lambda: ref_reduced("granite-8b")}
PROMPT_LEN, STEPS, PAGE, NUM_PAGES = 6, 8, 4, 10


def _models(cfg_name, policy):
    ref_cfg = CONFIGS[cfg_name]()
    ref = ref_build(ref_cfg, RefPar(remat="none", **POLICIES[policy]))
    port = build_model(ModelConfig(**dataclasses.asdict(ref_cfg)),
                       ParallelConfig(**POLICIES[policy]), device="cpu")
    ref_params = ref.init_params(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), "cpu")
    return ref, ref_params, port, params, ref_cfg


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _paged_caches(k, v, cfg, prompt_len):
    """Slot 0 holds the prefill rows on pages [7, 2, 9, 4]; slot 1 is a
    reaped slot (sentinel row) whose pos keeps advancing."""
    nl, _, hkv, _, hd = k.shape
    tables = np.array([[7, 2, 9, 4], [NUM_PAGES] * 4], np.int32)
    pools = []
    for strip in (k, v):
        pool = np.zeros((nl, NUM_PAGES, hkv, PAGE, hd), np.float32)
        for j in range(-(-prompt_len // PAGE)):
            rows = strip[:, 0, :, j * PAGE:(j + 1) * PAGE]
            pool[:, tables[0, j], :, :rows.shape[2]] = rows
        pools.append(pool)
    pos = np.full((2,), prompt_len, np.int32)
    ref = {"k_pages": jnp.asarray(pools[0]), "v_pages": jnp.asarray(pools[1]),
           "block_tables": jnp.asarray(tables), "pos": jnp.asarray(pos)}
    trash = np.zeros((nl, 1) + pools[0].shape[2:], np.float32)
    port = {"k_pages": torch.from_numpy(np.concatenate([pools[0], trash], 1)),
            "v_pages": torch.from_numpy(np.concatenate([pools[1], trash], 1)),
            "block_tables": torch.from_numpy(tables),
            "pos": torch.from_numpy(pos)}
    return ref, port


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_prefill_and_decode_match_reference(cfg_name, policy):
    ref, ref_params, port, params, cfg = _models(cfg_name, policy)
    rng = np.random.default_rng(0)
    toks = rng.integers(2, cfg.vocab_size, (2, PROMPT_LEN)).astype(np.int32)
    ref_prefill, ref_decode = jax.jit(ref.prefill), jax.jit(ref.decode_step)
    ref_logits, ref_cache = ref_prefill(ref_params,
                                        {"tokens": jnp.asarray(toks)})
    logits, cache = port.prefill(params, {"tokens": torch.from_numpy(toks)})
    _close(logits, ref_logits)
    _close(cache["k"], ref_cache["k"])

    # dense: caches padded to PROMPT_LEN + STEPS + 2
    pad = STEPS + 2
    ref_dense = dict(ref_cache, **{
        n: jnp.pad(ref_cache[n], ((0, 0),) * 3 + ((0, pad), (0, 0)))
        for n in ("k", "v")})
    dense = dict(cache, **{n: torch.nn.functional.pad(cache[n], (0, 0, 0, pad))
                           for n in ("k", "v")})
    ref_paged, paged = _paged_caches(np.asarray(ref_cache["k"]),
                                     np.asarray(ref_cache["v"]), cfg,
                                     PROMPT_LEN)
    nxt = np.argmax(np.asarray(ref_logits), -1).astype(np.int32)
    nxt_paged = nxt.copy()
    for _ in range(STEPS):
        ref_l, ref_dense = ref_decode(ref_params, jnp.asarray(nxt),
                                      ref_dense)
        got, dense = port.decode_step(params, torch.from_numpy(nxt), dense)
        _close(got, ref_l)
        ref_lp, ref_paged = ref_decode(ref_params, jnp.asarray(nxt_paged),
                                       ref_paged)
        got_p, paged = port.decode_step(params, torch.from_numpy(nxt_paged),
                                        paged)
        _close(got_p, ref_lp)
        nxt = np.argmax(np.asarray(ref_l), -1).astype(np.int32)
        nxt_paged = np.argmax(np.asarray(ref_lp), -1).astype(np.int32)
    _close(dense["k"], ref_dense["k"])
    _close(paged["k_pages"][:, :NUM_PAGES], ref_paged["k_pages"])
    _close(paged["v_pages"][:, :NUM_PAGES], ref_paged["v_pages"])
    assert paged["pos"].tolist() == [PROMPT_LEN + STEPS] * 2


def test_fused_layout_and_unported_options():
    cfg = ModelConfig(**dataclasses.asdict(ref_reduced("granite-8b")))
    fused = build_model(cfg, ParallelConfig(**POLICIES["fused"]),
                        device="cpu")
    assert fused.param_layout.attn_qkv and fused.param_layout.mlp_swiglu
    params = fused.init_params(3)
    assert params["blocks"]["attn"]["wqkv"].shape == (2, 64, 4 * 16 + 2 * 2 * 16)
    assert params["blocks"]["mlp"]["wig"].shape == (2, 64, 256)
    assert params["embed"].dtype == torch.float32
    legacy = build_model(cfg, ParallelConfig(), device="cpu").init_params(3)
    assert set(legacy["blocks"]["attn"]) == {"wq", "wk", "wv", "wo"}
    # the int8 options build (tests/test_torch_int8_engine.py serves them)
    for opt in (dict(kv_cache_int8=True), dict(weight_precision="int8")):
        model = build_model(cfg, ParallelConfig(**opt), device="cpu")
        cache = model.init_paged_cache(2, 4, 8, 2)
        int8 = opt.get("kv_cache_int8", False)
        assert cache["k_pages"].dtype == (torch.int8 if int8
                                          else torch.float32)
        assert ("k_scale_pages" in cache) == int8


def test_default_device_is_the_card():
    cfg = ModelConfig(**dataclasses.asdict(ref_reduced("granite-8b")))
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(cfg)
