"""The port's VLM (llava-next-mistral-7b reduced: the text decoder over a
prefix of stub patch embeddings) against the JAX package's, on the CPU,
under the fused and the library policy: prefill with ``patch_embeds``
(logits, the K/V cache, ``pos`` counting patches and text), then five
decode steps on a cache with room for them, in f32 at
``TOLERANCES["f32"]``; the patches' dtype cast and their share of the
``sqrt(d_model)`` scale; and the BatchedEngine's text-only tokens (the
JAX engine prefills ``{"tokens"}`` alone) against the JAX engine's, dense
and paged.  Both sides get the reference's parameters; the JAX side runs
its Pallas kernels in interpret mode."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tolerance_for
from repro.configs import get_reduced as ref_reduced
from repro.models import build_model as ref_build
from repro.models.config import ParallelConfig as RefPar
from repro.serve import BatchedEngine as RefEngine
from repro.serve import Request as RefRequest
from repro.serve import ServeConfig as RefServe

from repro_torch.configs import get_reduced
from repro_torch.models import build_model
from repro_torch.models.config import ParallelConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import TransformerLM
from repro_torch.serve import BatchedEngine, Request, ServeConfig

TOL = tolerance_for("f32")
ARCH = "llava-next-mistral-7b"
POLICIES = {"library": dict(),
            "fused": dict(fuse_epilogues=True, use_pallas_attn=True)}
TEXT_LEN, STEPS = 9, 5


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want), **TOL)


@functools.lru_cache(maxsize=None)
def _setup(policy):
    ref = ref_build(ref_reduced(ARCH), RefPar(remat="none",
                                              **POLICIES[policy]))
    ref_params = ref.init_params(jax.random.PRNGKey(0))
    port = build_model(get_reduced(ARCH), ParallelConfig(**POLICIES[policy]),
                       device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), "cpu")
    return ref, ref_params, port, params


def _inputs(cfg, seed=0, b=2):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(2, cfg.vocab_size, (b, TEXT_LEN)).astype(np.int32)
    patches = rng.standard_normal(
        (b, cfg.vlm.num_patches, cfg.d_model)).astype(np.float32)
    return tokens, patches


def test_vlm_builds_a_transformer():
    cfg = get_reduced(ARCH)
    assert cfg.family == "vlm" and cfg.vlm.num_patches == 8
    assert isinstance(build_model(cfg, device="cpu"), TransformerLM)


@pytest.mark.parametrize("policy", list(POLICIES))
def test_patch_prefill_and_decode_match_reference(policy):
    ref, ref_params, port, params = _setup(policy)
    cfg = port.cfg
    tokens, patches = _inputs(cfg)
    want, ref_cache = jax.jit(ref.prefill)(ref_params, {
        "tokens": jnp.asarray(tokens), "patch_embeds": jnp.asarray(patches)})
    got, cache = port.prefill(params, {
        "tokens": torch.from_numpy(tokens),
        "patch_embeds": torch.from_numpy(patches)})
    _close(got, want)
    seq = cfg.vlm.num_patches + TEXT_LEN
    assert set(cache) == set(ref_cache) == {"k", "v", "pos"}
    for key in ("k", "v"):
        assert tuple(cache[key].shape) == ref_cache[key].shape == (
            cfg.num_layers, 2, cfg.num_kv_heads, seq, cfg.resolved_head_dim)
        _close(cache[key], ref_cache[key])
    assert cache["pos"].tolist() == np.asarray(ref_cache["pos"]).tolist() \
        == [seq, seq]
    # decode on caches at capacity, the prefill rows copied in
    cap = seq + STEPS + 1
    ref_cap = ref.init_cache(2, cap)
    ref_cap = {"k": ref_cap["k"].at[:, :, :, :seq].set(ref_cache["k"]),
               "v": ref_cap["v"].at[:, :, :, :seq].set(ref_cache["v"]),
               "pos": ref_cache["pos"]}
    port_cap = port.init_cache(2, cap)
    port_cap["k"][:, :, :, :seq] = cache["k"]
    port_cap["v"][:, :, :, :seq] = cache["v"]
    port_cap["pos"] = cache["pos"]
    decode = jax.jit(ref.decode_step)
    for _ in range(STEPS):
        nxt = np.argmax(np.asarray(want), -1).astype(np.int32)
        want, ref_cap = decode(ref_params, jnp.asarray(nxt), ref_cap)
        got, port_cap = port.decode_step(params, torch.from_numpy(nxt),
                                         port_cap)
        _close(got, want)
    for key in ref_cap:
        _close(port_cap[key], ref_cap[key])
    assert port_cap["pos"].tolist() == [seq + STEPS] * 2


def test_patch_prefix_embedding():
    """The patches are cast to the model dtype and concatenated before the
    text, then scaled by sqrt(d_model) with it; a text-only batch embeds
    the tokens alone."""
    _, _, port, params = _setup("library")
    cfg = port.cfg
    tokens, patches = _inputs(cfg, seed=1)
    t, p = torch.from_numpy(tokens), torch.from_numpy(patches)
    x = port._embed(params, t, {"tokens": t, "patch_embeds": p})
    scale = cfg.d_model ** 0.5
    assert x.shape == (2, cfg.vlm.num_patches + TEXT_LEN, cfg.d_model)
    torch.testing.assert_close(x[:, :cfg.vlm.num_patches], p * scale)
    torch.testing.assert_close(x[:, cfg.vlm.num_patches:],
                               params["embed"][t] * scale)
    torch.testing.assert_close(port._embed(params, t, {"tokens": t}),
                               params["embed"][t] * scale)
    bf16 = build_model(dataclasses.replace(cfg, dtype="bfloat16"),
                       device="cpu")
    xb = bf16._embed(params, t, {"tokens": t, "patch_embeds": p})
    assert xb.dtype == torch.bfloat16
    torch.testing.assert_close(
        xb[:, :cfg.vlm.num_patches],
        p.to(torch.bfloat16) * torch.tensor(scale, dtype=torch.bfloat16))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("policy", list(POLICIES))
def test_text_engine_tokens_match_reference(policy, paged):
    ref, ref_params, port, params = _setup(policy)
    serve = dict(batch_slots=2, max_seq_len=40, eos_id=-1,
                 page_size=8 if paged else None)
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(2, port.cfg.vocab_size, n)]
               for n in (11, 16, 6)]
    prompts[1][:8] = prompts[0][:8]                    # one shared page
    news = (5, 6, 4)
    ref_eng = RefEngine(ref, ref_params, RefServe(**serve))
    eng = BatchedEngine(port, params, ServeConfig(**serve))
    want = ref_eng.run([RefRequest(rid=i, prompt=list(p), max_new_tokens=m)
                        for i, (p, m) in enumerate(zip(prompts, news))])
    got = eng.run([Request(rid=i, prompt=list(p), max_new_tokens=m)
                   for i, (p, m) in enumerate(zip(prompts, news))])
    assert {r.rid: r.generated for r in got} == \
        {r.rid: r.generated for r in want}
    assert all(r.done and len(r.generated) == m for r, m in zip(got, news))
    if paged:
        assert eng.pool.shared_hits == ref_eng.pool.shared_hits == 1
