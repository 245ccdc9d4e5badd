"""HybridLM of the port (zamba2-1.2b) against the JAX package's, on the CPU:
the configs field by field, the parameter tree, prefill logits and every
cache leaf, five teacher-forced decode steps, and the BatchedEngine's
tokens on 2 slots with slot reuse, under the fused policy
(``fuse_epilogues=True, use_pallas_attn=True``) and under
``use_pallas_attn`` alone; the paged ``ServeConfig`` refused by both.  Both
sides get the reference's parameters (``params_from_numpy``) and the same
tokens; the JAX side runs its Pallas kernels in interpret mode.  Logits and
the shared block's K/V at ``TOLERANCES["f32"]``, the leaves downstream of
the SSD scan (``h``, ``conv``) at ``TOLERANCES["f32_accum"]``.

Also the dense engine's refusal of a prompt longer than ``max_seq_len``:
both engines raise ``ValueError`` and the port's cache is left as it was,
on the serve-equivalence tiny model and on the hybrid."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_serve_equivalence as tse
from conftest import tolerance_for
from repro.configs import get_config as ref_config
from repro.configs import get_reduced as ref_reduced
from repro.models import build_model as ref_build
from repro.models.config import HybridConfig as RefHybridConfig
from repro.models.config import ParallelConfig as RefPar
from repro.serve import BatchedEngine as RefEngine
from repro.serve import Request as RefRequest
from repro.serve import ServeConfig as RefServe

from repro_torch.configs import get_config, get_reduced
from repro_torch.models import build_model
from repro_torch.models.config import (HybridConfig, ModelConfig,
                                       ParallelConfig, SSMConfig)
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.hybrid import HybridLM
from repro_torch.serve import BatchedEngine, Request, ServeConfig

TOL = tolerance_for("f32")
TOL_ACCUM = tolerance_for("f32_accum")
ARCH = "zamba2-1.2b"
POLICIES = {"fused": dict(fuse_epilogues=True, use_pallas_attn=True),
            "pallas_attn": dict(use_pallas_attn=True)}
#: the reduced config (two applications of the shared block) and a 5-layer
#: cut of it, whose last mamba layer follows the last application, as
#: zamba2-1.2b's last two do (38 = 6 x 6 + 2)
DEPTHS = {"reduced": 4, "trailing": 5}
PROMPT_LEN, STEPS, CACHE_LEN = 21, 5, 32
#: the leaves downstream of the SSD scan
ACCUM_LEAVES = ("h", "conv")


def port_config(ref_cfg) -> ModelConfig:
    d = dataclasses.asdict(ref_cfg)
    d["ssm"] = SSMConfig(**d["ssm"])
    d["hybrid"] = HybridConfig(**d["hybrid"])
    return ModelConfig(**d)


def _ref_cfg(depth):
    return dataclasses.replace(ref_reduced(ARCH), num_layers=DEPTHS[depth])


@functools.lru_cache(maxsize=None)
def _params(depth, policy):
    """The reference's parameters (PRNGKey(0)) in the policy's layout, and
    the port's copy of them."""
    ref = ref_build(_ref_cfg(depth), RefPar(remat="none", **POLICIES[policy]))
    ref_params = ref.init_params(jax.random.PRNGKey(0))
    return ref_params, params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                         "cpu")


def _models(depth, policy):
    cfg = _ref_cfg(depth)
    ref = ref_build(cfg, RefPar(remat="none", **POLICIES[policy]))
    port = build_model(port_config(cfg), ParallelConfig(**POLICIES[policy]),
                       device="cpu")
    return (ref, *_params(depth, policy), port, cfg)


def _close(got, want, key=None):
    tol = TOL_ACCUM if key in ACCUM_LEAVES else TOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want), **tol)


def _pad_kv(cache, length, pad):
    """The shared block's K/V strips padded to ``length`` positions, so
    that decode writes land (past the strip both sides drop them)."""
    out = dict(cache)
    for key in ("attn_k", "attn_v"):
        n = length - cache[key].shape[3]
        out[key] = pad(cache[key], n)
    return out


@pytest.mark.parametrize("which", ["CONFIG", "REDUCED"])
def test_configs_equal_reference(which):
    get, ref_get = ((get_config, ref_config) if which == "CONFIG"
                    else (get_reduced, ref_reduced))
    assert dataclasses.asdict(get(ARCH)) == dataclasses.asdict(ref_get(ARCH))
    assert get("zamba2_1.2b") == get(ARCH) == port_config(ref_get(ARCH))


def test_hybrid_config_schema_equals_reference():
    fields = [(f.name, f.default) for f in dataclasses.fields(HybridConfig)]
    assert fields == [(f.name, f.default)
                      for f in dataclasses.fields(RefHybridConfig)]


def test_layer_groups_equal_reference():
    """zamba2-1.2b: six applications after mamba layers 6, 12, ..., 36 and
    two trailing mamba layers, as the reference plans them."""
    ref = ref_build(ref_config(ARCH), RefPar(remat="none"))
    port = build_model(get_config(ARCH), ParallelConfig(), device="cpu")
    assert isinstance(port, HybridLM)
    assert port.n_apps == ref.n_apps == 6
    assert port._layer_groups() == ref._layer_groups() == (
        [(0, 6), (6, 12), (12, 18), (18, 24), (24, 30), (30, 36)], (36, 38))


@pytest.mark.parametrize("policy", list(POLICIES))
def test_params_match_the_reference_tree(policy):
    """The port's own draw has the reference's keys, shapes and dtypes in
    the layout the policy plans (``shared_attn`` concatenated under the
    fused policy), and the converted reference tree keeps every dtype."""
    cfg = _ref_cfg("reduced")
    ref_params, params = _params("reduced", policy)
    port = build_model(port_config(cfg), ParallelConfig(**POLICIES[policy]),
                       device="cpu")
    own = port.init_params(0)
    ref_flat = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    for tree in (own, params):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        assert [p for p, _ in flat] == [p for p, _ in ref_flat]
        for (_, got), (path, want) in zip(flat, ref_flat):
            assert tuple(got.shape) == want.shape, path
            assert str(got.dtype).split(".")[-1] == str(want.dtype), path
    fused = policy == "fused"
    assert ("wqkv" in own["shared_attn"]["attn"]) == fused
    assert ("wig" in own["shared_attn"]["mlp"]) == fused
    assert own["blocks"]["A_log"].dtype == torch.float32


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("depth", list(DEPTHS))
def test_prefill_and_decode_match_reference(depth, policy):
    ref, ref_params, params, port, cfg = _models(depth, policy)
    rng = np.random.default_rng(0)
    tokens = rng.integers(2, cfg.vocab_size, (2, PROMPT_LEN)).astype(np.int32)
    want, ref_cache = jax.jit(ref.prefill)(
        ref_params, {"tokens": jnp.asarray(tokens)})   # two chunks of 16
    got, cache = port.prefill(params, {"tokens": torch.from_numpy(tokens)})
    _close(got, want)
    assert set(cache) == set(ref_cache)
    for key in ref_cache:
        assert tuple(cache[key].shape) == ref_cache[key].shape, key
        _close(cache[key], ref_cache[key], key)
    assert cache["h"].dtype == torch.float32
    ref_cache = _pad_kv(ref_cache, CACHE_LEN, lambda t, n: jnp.pad(
        t, ((0, 0),) * 3 + ((0, n), (0, 0))))
    cache = _pad_kv(cache, CACHE_LEN, lambda t, n: torch.nn.functional.pad(
        t, (0, 0, 0, n)))
    ref_decode = jax.jit(ref.decode_step)
    for _ in range(STEPS):
        nxt = np.argmax(np.asarray(want), -1).astype(np.int32)
        want, ref_cache = ref_decode(ref_params, jnp.asarray(nxt), ref_cache)
        got, cache = port.decode_step(params, torch.from_numpy(nxt), cache)
        _close(got, want)
        for key in ref_cache:
            _close(cache[key], ref_cache[key], key)


def _all_logits(ref, ref_params):
    @jax.jit
    def run(tokens):
        x = ref._embed(ref_params, tokens)
        positions = jnp.arange(tokens.shape[1])[None]
        x, _ = ref._forward(ref_params, x, positions)
        return ref._head(ref_params, x)[0]
    return run


def _assert_no_near_tie(all_logits, prompt, generated):
    """The greedy comparison means something only where no near-tie can
    flip the argmax: the reference's top-2 gap at each emitted token must
    exceed 10x the f32 tolerance."""
    seq = list(prompt) + list(generated[:-1])
    steps = np.asarray(all_logits(jnp.asarray([seq], jnp.int32))
                       )[len(prompt) - 1:]
    assert list(np.argmax(steps, -1)) == list(generated)
    top2 = np.sort(steps, axis=-1)[:, -2:]
    bound = 10 * (TOL["atol"] + TOL["rtol"] * np.abs(top2[:, 1]))
    assert np.all(top2[:, 1] - top2[:, 0] > bound)


@pytest.mark.parametrize("policy", list(POLICIES))
def test_engine_tokens_match_reference(policy):
    """4 requests on 2 slots (a slot is reused after its state drifted
    while dead), max_new [4, 7, 5, 6], no EOS."""
    ref, ref_params, params, port, cfg = _models("reduced", policy)
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(2, cfg.vocab_size, n)]
               for n in (9, 20, 5, 13)]
    max_news = [4, 7, 5, 6]
    serve = dict(batch_slots=2, max_seq_len=CACHE_LEN, eos_id=-1)
    ref_eng = RefEngine(ref, ref_params, RefServe(**serve))
    eng = BatchedEngine(port, params, ServeConfig(**serve))
    want = ref_eng.run([RefRequest(rid=i, prompt=list(p), max_new_tokens=m)
                        for i, (p, m) in enumerate(zip(prompts, max_news))])
    got = eng.run([Request(rid=i, prompt=list(p), max_new_tokens=m)
                   for i, (p, m) in enumerate(zip(prompts, max_news))])
    all_logits = _all_logits(ref, ref_params)
    for r in want:
        _assert_no_near_tie(all_logits, r.prompt, r.generated)
    assert {r.rid: r.generated for r in got} == \
        {r.rid: r.generated for r in want}
    assert [len(r.generated) for r in got] == max_news
    assert eng.tick_count == ref_eng.tick_count


def test_paged_serve_config_raises_in_both():
    """Neither package has a paged cache for the hybrid family."""
    ref, ref_params, params, port, _ = _models("reduced", "fused")
    serve = dict(batch_slots=2, max_seq_len=CACHE_LEN, eos_id=-1,
                 page_size=8)
    with pytest.raises(AttributeError, match="init_paged_cache"):
        RefEngine(ref, ref_params, RefServe(**serve))
    with pytest.raises(AttributeError, match="init_paged_cache"):
        BatchedEngine(port, params, ServeConfig(**serve))


# --------------------------------------------------------------------------
# A prompt past max_seq_len: refused by both dense engines
# --------------------------------------------------------------------------

FUSED = POLICIES["fused"]


@functools.lru_cache(maxsize=None)
def _tiny():
    cfg = tse.tiny_model()[1]
    ref = ref_build(cfg, RefPar(remat="none", **FUSED))
    ref_params = ref.init_params(tse.KEY)
    port = build_model(ModelConfig(**dataclasses.asdict(cfg)),
                       ParallelConfig(**FUSED), device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), "cpu")
    return ref, ref_params, port, params, cfg


def _engines(ref, ref_params, port, params, **extra):
    serve = dict(batch_slots=2, max_seq_len=CACHE_LEN, eos_id=-1, **extra)
    return (RefEngine(ref, ref_params, RefServe(**serve)),
            BatchedEngine(port, params, ServeConfig(**serve)))


def _prompt(cfg, n, seed=3):
    rng = np.random.default_rng(seed)
    return [int(t) for t in rng.integers(2, cfg.vocab_size, n)]


def _refuses_past_max_seq_len(ref, ref_params, port, params, cfg):
    ref_eng, eng = _engines(ref, ref_params, port, params)
    # a request already in the other slot: its cache entries must survive
    assert eng.add_request(Request(rid=0, prompt=_prompt(cfg, 9, seed=4),
                                   max_new_tokens=4))
    before = {k: v.clone() for k, v in eng.cache.items()}
    long = _prompt(cfg, CACHE_LEN + 8)
    with pytest.raises(ValueError):
        ref_eng.add_request(RefRequest(rid=1, prompt=list(long),
                                       max_new_tokens=4))
    with pytest.raises(ValueError, match="does not fit"):
        eng.add_request(Request(rid=1, prompt=list(long), max_new_tokens=4))
    assert set(eng.cache) == set(before)
    for key, t in before.items():
        assert torch.equal(eng.cache[key], t), key


def test_dense_engine_refuses_a_prompt_past_max_seq_len():
    """40 prompt tokens on a 32-position strip: both engines raise
    ``ValueError``, and no leaf of the port's cache was written."""
    _refuses_past_max_seq_len(*_tiny())


def test_hybrid_engine_refuses_a_prompt_past_max_seq_len():
    """The same on the hybrid, whose state leaves fit but whose K/V strips
    do not: every leaf is checked before any is written."""
    ref, ref_params, params, port, cfg = _models("reduced", "fused")
    _refuses_past_max_seq_len(ref, ref_params, port, params, cfg)


def test_prompt_of_max_seq_len_tokens_matches_reference():
    """32 prompt tokens fill the strip: both engines serve it.  The first
    tick decodes at pos 32 == max_seq_len, where the reference's Pallas
    ``flash_attention_matmul`` also attends to one zero key of its padded
    strip (``test_decode_at_a_full_strip_ignores_padding``), so the port's
    tokens are held to the reference engine whose decode attention is its
    plain version (``fuse_epilogues`` alone: the same norm-GEMM kernels);
    the prefill's token is held to the fused engine's too."""
    ref, ref_params, port, params, cfg = _tiny()
    plain_attn = ref_build(cfg, RefPar(remat="none", fuse_epilogues=True))
    prompt = _prompt(cfg, CACHE_LEN)
    got = _engines(ref, ref_params, port, params)[1].run(
        [Request(rid=0, prompt=list(prompt), max_new_tokens=5)])
    want = {}
    for name, model in (("fused", ref), ("plain attention", plain_attn)):
        ref_eng = _engines(model, ref_params, port, params)[0]
        want[name] = ref_eng.run([RefRequest(rid=0, prompt=list(prompt),
                                             max_new_tokens=5)])[0].generated
    assert len(got[0].generated) == 5
    assert got[0].generated == want["plain attention"]
    assert got[0].generated[0] == want["fused"][0]


def test_decode_at_a_full_strip_ignores_padding():
    """At pos == Skv every key of the strip is live.  The reference's
    Pallas kernel pads the strip to its key block and its mask
    (column <= pos) lets the first zero padding key in: it equals its own
    library row over the strip with one zero key appended.  The port's
    wrapper (its plain version here) equals the library row over the strip
    itself, as the reference's unfused decode does."""
    from repro.kernels import fused as ref_fused
    from repro_torch.kernels import fused
    rng = np.random.default_rng(5)
    b, h, hkv, s, d, n = 2, 4, 2, CACHE_LEN, 16, 64
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for shape in
               ((b, h, 1, d), (b, hkv, s, d), (b, hkv, s, d)))
    w = (rng.standard_normal((h * d, n)) * 0.1).astype(np.float32)
    pos = np.array([s, s - 12], np.int32)
    zero = np.zeros((b, hkv, 1, d), np.float32)

    def ref_call(k, v, mode, **kw):
        return np.asarray(ref_fused.flash_attention_matmul(
            *map(jnp.asarray, (q, k, v, w)), pos=jnp.asarray(pos),
            mode=mode, **kw))
    library = ref_call(k, v, "library")
    kernel = ref_call(k, v, "native", interpret=True)
    padded = ref_call(np.concatenate([k, zero], 2),
                      np.concatenate([v, zero], 2), "library")
    port = fused.flash_attention_matmul(
        *map(torch.from_numpy, (q, k, v, w)),
        pos=torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(port, library, **TOL)
    np.testing.assert_allclose(kernel, padded, **TOL)
    assert np.abs(kernel[0] - library[0]).max() > 10 * TOL["atol"]
    np.testing.assert_allclose(kernel[1], library[1], **TOL)


def test_paged_engine_raises_on_a_prompt_past_max_seq_len_as_reference():
    """Paged, the 40-token prompt needs more table entries than a slot
    has: both engines raise ``ValueError`` (unchanged by the repair)."""
    ref, ref_params, port, params, cfg = _tiny()
    ref_eng, eng = _engines(ref, ref_params, port, params, page_size=8)
    long = _prompt(cfg, CACHE_LEN + 8)
    with pytest.raises(ValueError):
        ref_eng.add_request(RefRequest(rid=0, prompt=list(long),
                                       max_new_tokens=4))
    with pytest.raises(ValueError):
        eng.add_request(Request(rid=0, prompt=list(long), max_new_tokens=4))
