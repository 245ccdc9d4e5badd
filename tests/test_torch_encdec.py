"""The port's EncDecLM (whisper-base reduced: stub frames, a non-causal
encoder with sinusoidal positions, a causal decoder with learned positions
and cross-attention, layernorm, gelu, the tied head) against the JAX
package's, on the CPU, under the fused and the library policy: ``encode``'s
memory, prefill logits and every cache leaf (``k``, ``v``, ``memory``,
``pos``), then 8 greedy decode steps on a cache at capacity (the prefill
rows copied into ``init_cache``; both packages decode the same way there),
in f32 at ``TOLERANCES["f32"]``, on the reference's parameters; and the
kernels each policy reaches (the fused policy: the attention + wo kernel's
plain version, non-causal for each encoder layer and causal for each
decoder layer of a prefill, none in a decode step); and a layernorm /
gelu TransformerLM against the JAX one (the layernorm head).  The JAX side
runs its Pallas kernels in interpret mode."""
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

from repro_torch.configs import get_reduced
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig, ParallelConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.encdec import EncDecLM

TOL = tolerance_for("f32")
ARCH = "whisper-base"
POLICIES = {"library": dict(),
            "fused": dict(fuse_epilogues=True, use_pallas_attn=True)}
PROMPT_LEN, STEPS = 7, 8


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
    frames = rng.standard_normal(
        (b, cfg.encdec.num_frames, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(2, cfg.vocab_size, (b, PROMPT_LEN)).astype(np.int32)
    return frames, tokens


def test_encdec_builds():
    cfg = get_reduced(ARCH)
    model = build_model(cfg, device="cpu")
    assert isinstance(model, EncDecLM) and cfg.norm == "layernorm"
    cache = model.init_cache(3, 20)
    assert tuple(cache["memory"].shape) == (3, cfg.encdec.num_frames,
                                            cfg.d_model)
    assert tuple(cache["k"].shape) == (cfg.num_layers, 3, cfg.num_kv_heads,
                                       20, cfg.resolved_head_dim)


@pytest.mark.parametrize("policy", list(POLICIES))
def test_encode_matches_reference(policy):
    ref, ref_params, port, params = _setup(policy)
    frames, _ = _inputs(port.cfg)
    want = jax.jit(ref.encode)(ref_params, jnp.asarray(frames))
    got = port.encode(params, torch.from_numpy(frames))
    assert tuple(got.shape) == want.shape
    _close(got, want)


@pytest.mark.parametrize("policy", list(POLICIES))
def test_prefill_and_greedy_decode_match_reference(policy):
    ref, ref_params, port, params = _setup(policy)
    cfg = port.cfg
    frames, tokens = _inputs(cfg, seed=1)
    want, ref_cache = jax.jit(ref.prefill)(ref_params, {
        "frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens)})
    got, cache = port.prefill(params, {"frames": torch.from_numpy(frames),
                                       "tokens": torch.from_numpy(tokens)})
    _close(got, want)
    assert set(cache) == set(ref_cache) == {"k", "v", "memory", "pos"}
    for key in ("k", "v", "memory"):
        assert tuple(cache[key].shape) == ref_cache[key].shape, key
        _close(cache[key], ref_cache[key])
    assert cache["pos"].tolist() == np.asarray(ref_cache["pos"]).tolist() \
        == [PROMPT_LEN] * 2
    cap = PROMPT_LEN + STEPS + 1
    ref_cap = ref.init_cache(2, cap)
    ref_cap = dict(ref_cap,
                   k=ref_cap["k"].at[:, :, :, :PROMPT_LEN].set(ref_cache["k"]),
                   v=ref_cap["v"].at[:, :, :, :PROMPT_LEN].set(ref_cache["v"]),
                   memory=ref_cache["memory"], pos=ref_cache["pos"])
    port_cap = port.init_cache(2, cap)
    port_cap["k"][:, :, :, :PROMPT_LEN] = cache["k"]
    port_cap["v"][:, :, :, :PROMPT_LEN] = cache["v"]
    port_cap.update(memory=cache["memory"], pos=cache["pos"])
    decode = jax.jit(ref.decode_step)
    ref_tokens, port_tokens = [], []
    nxt_ref = np.argmax(np.asarray(want), -1).astype(np.int32)
    nxt = got.argmax(-1).to(torch.int32)
    for _ in range(STEPS):
        ref_tokens.append(nxt_ref.tolist())
        port_tokens.append(nxt.tolist())
        want, ref_cap = decode(ref_params, jnp.asarray(nxt_ref), ref_cap)
        got, port_cap = port.decode_step(params, nxt, port_cap)
        _close(got, want)
        nxt_ref = np.argmax(np.asarray(want), -1).astype(np.int32)
        nxt = got.argmax(-1).to(torch.int32)
    assert port_tokens == ref_tokens
    for key in ("k", "v", "memory"):
        _close(port_cap[key], ref_cap[key])
    assert port_cap["pos"].tolist() == [PROMPT_LEN + STEPS] * 2


def test_fused_policy_reaches_the_attention_kernel_at_prefill_only(
        monkeypatch):
    """Under the fused policy a prefill selects flash_attention_matmul
    once an encoder layer (non-causal), then once a decoder layer (causal),
    and nothing else; a decode step selects no kernel op: its
    self-attention takes no ``fuse_wo``, and the layernorms, MLPs,
    cross-attention and head are plain PyTorch."""
    from repro_torch.core.registry import REGISTRY
    _, _, port, params = _setup("fused")
    cfg = port.cfg
    seen = []
    real_select = REGISTRY.select

    def select(op, *args, **kw):
        seen.append((op, (kw.get("shape") or {}).get("causal")))
        return real_select(op, *args, **kw)
    monkeypatch.setattr(REGISTRY, "select", select)
    frames, tokens = _inputs(cfg, seed=2)
    _, cache = port.prefill(params, {"frames": torch.from_numpy(frames),
                                     "tokens": torch.from_numpy(tokens)})
    assert seen == ([("flash_attention_matmul", False)]
                    * cfg.encdec.encoder_layers
                    + [("flash_attention_matmul", True)] * cfg.num_layers)
    seen.clear()
    port.decode_step(params, torch.ones(2, dtype=torch.int32),
                     {k: torch.nn.functional.pad(v, (0, 0, 0, 2))
                      if k in ("k", "v") else v for k, v in cache.items()})
    assert seen == []


@pytest.mark.parametrize("policy", list(POLICIES))
def test_layernorm_transformer_matches_reference(policy):
    """A TransformerLM with layernorm and gelu (no such config ships; the
    branch is JAX's): the blocks norm unfused under either policy, the
    head takes the final layernorm, then a plain product; prefill logits
    and three decode steps against the reference."""
    cfg = dataclasses.replace(ref_reduced("granite-8b"), norm="layernorm",
                              act="gelu")
    ref = ref_build(cfg, RefPar(remat="none", **POLICIES[policy]))
    ref_params = ref.init_params(jax.random.PRNGKey(1))
    port = build_model(ModelConfig(**dataclasses.asdict(cfg)),
                       ParallelConfig(**POLICIES[policy]), device="cpu")
    assert set(ref_params["final_norm"]) == {"scale", "bias"}
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), "cpu")
    own = port.init_params(0)
    assert set(own["final_norm"]) == set(own["blocks"]["ln1"]) == {
        "scale", "bias"}
    assert "wqkv" not in own["blocks"]["attn"]
    rng = np.random.default_rng(4)
    toks = rng.integers(2, cfg.vocab_size, (2, 6)).astype(np.int32)
    want, ref_cache = jax.jit(ref.prefill)(ref_params,
                                           {"tokens": jnp.asarray(toks)})
    got, cache = port.prefill(params, {"tokens": torch.from_numpy(toks)})
    _close(got, want)
    ref_cache = dict(ref_cache, **{
        n: jnp.pad(ref_cache[n], ((0, 0),) * 3 + ((0, 4), (0, 0)))
        for n in ("k", "v")})
    cache = dict(cache, **{n: torch.nn.functional.pad(cache[n], (0, 0, 0, 4))
                          for n in ("k", "v")})
    decode = jax.jit(ref.decode_step)
    for _ in range(3):
        nxt = np.argmax(np.asarray(want), -1).astype(np.int32)
        want, ref_cache = decode(ref_params, jnp.asarray(nxt), ref_cache)
        got, cache = port.decode_step(params, torch.from_numpy(nxt), cache)
        _close(got, want)
