"""The port's architecture registry and model layer against the JAX
package's, on the CPU: all ten configs field by field with their parameter
counts; each reduced model's own parameter tree (``init_params``) key for
key and shape for shape against the reference's under the per-matrix and
the fused layout, then a prefill and a decode step on it (ROADMAP C.12:
qwen3's ``q_norm``/``k_norm`` and a layernorm block's ``bias`` were
missing); the plain pieces the new families need (``layernorm``,
``sinusoidal_positions``, ``cross_entropy``, ``chunked_attention``); and
the dense family's reduced configs (qwen3-32b, mistral-nemo-12b,
mistral-large-123b, llama4-scout-17b-16e) under the fused and the library
policy: prefill logits, every cache leaf and five decode steps, in f32 at
``TOLERANCES["f32"]``, on the reference's parameters
(``params_from_numpy``).  The JAX side runs its Pallas kernels in
interpret mode.  tests/test_torch_archs_engine.py serves the same four
through both engines."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tolerance_for
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_config
from repro.configs import get_reduced as ref_reduced
from repro.models import attention as ref_attention
from repro.models import build_model as ref_build
from repro.models import common as ref_common
from repro.models.config import LEGACY_LAYOUT as REF_LEGACY
from repro.models.config import ParallelConfig as RefPar

from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.models import attention, build_model, common
from repro_torch.models.config import ParallelConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import TransformerLM

TOL = tolerance_for("f32")
POLICIES = {"library": dict(),
            "fused": dict(fuse_epilogues=True, use_pallas_attn=True)}
#: the dense family's configs this slice adds (llama4-scout is its MoE
#: member: top-1 routing beside a shared expert)
DENSE = ("qwen3-32b", "mistral-nemo-12b", "mistral-large-123b",
         "llama4-scout-17b-16e")
PROMPT_LEN, STEPS = 11, 5


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(torch.as_tensor(got).float().numpy(),
                               np.asarray(want, np.float32), **tol)


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------


def test_archs_are_the_reference_tuple():
    assert ARCHS == REF_ARCHS


@pytest.mark.parametrize("which", ["CONFIG", "REDUCED"])
@pytest.mark.parametrize("arch", REF_ARCHS)
def test_configs_equal_reference(arch, which):
    get, ref_get = ((get_config, ref_config) if which == "CONFIG"
                    else (get_reduced, ref_reduced))
    assert dataclasses.asdict(get(arch)) == dataclasses.asdict(ref_get(arch))
    underscored = arch.replace("-", "_")
    assert dataclasses.asdict(get(underscored)) == \
        dataclasses.asdict(ref_get(arch))


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_param_counts_equal_reference(arch):
    for get, ref_get in ((get_config, ref_config),
                         (get_reduced, ref_reduced)):
        cfg, ref = get(arch), ref_get(arch)
        assert cfg.param_count() == ref.param_count()
        assert cfg.active_param_count() == ref.active_param_count()


def test_parallel_config_chunk_fields_equal_reference():
    names = ("attn_chunk_q", "attn_chunk_kv", "causal_folding")
    got = {f.name: f.default for f in dataclasses.fields(ParallelConfig)}
    want = {f.name: f.default for f in dataclasses.fields(RefPar)}
    assert {n: got[n] for n in names} == {n: want[n] for n in names}


def test_build_model_takes_every_family():
    classes = {}
    for arch in ARCHS:
        model = build_model(get_reduced(arch), device="cpu")
        classes[get_reduced(arch).family] = type(model).__name__
    assert classes == {"moe": "TransformerLM", "dense": "TransformerLM",
                       "vlm": "TransformerLM", "encdec": "EncDecLM",
                       "ssm": "MambaLM", "hybrid": "HybridLM"}
    audio = dataclasses.replace(get_reduced("whisper-base"), family="audio")
    assert isinstance(build_model(audio, device="cpu"), EncDecLM)
    with pytest.raises(ValueError, match="unknown model family"):
        build_model(dataclasses.replace(audio, family="diffusion"),
                    device="cpu")
    with pytest.raises(ValueError, match="dense, moe and vlm"):
        TransformerLM(audio, ParallelConfig(), device="cpu")


# --------------------------------------------------------------------------
# the port's own parameters (ROADMAP C.12)
# --------------------------------------------------------------------------


def _batch(cfg, rng, b=2, s=7):
    batch = {"tokens": torch.from_numpy(
        rng.integers(2, cfg.vocab_size, (b, s)).astype(np.int32))}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.vlm.num_patches, cfg.d_model)).astype(np.float32))
    if cfg.encdec is not None:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.encdec.num_frames, cfg.d_model)).astype(np.float32))
    return batch


def _with_room(cache, extra: int):
    """The prefill cache's K/V strips with ``extra`` free positions, so
    that decode writes land."""
    out = dict(cache)
    for key in ("k", "v", "attn_k", "attn_v"):
        if key in cache:
            out[key] = torch.nn.functional.pad(cache[key], (0, 0, 0, extra))
    return out


@pytest.mark.parametrize("layout", ["legacy", "fused"])
@pytest.mark.parametrize("arch", REF_ARCHS)
def test_own_params_equal_reference_tree_and_serve(arch, layout):
    """The port's ``init_params`` gives the reference's tree (keys, shapes,
    dtypes) in the layout the policy plans, and serves a prefill and a
    decode step on it.  Before the C.12 repair qwen3's tree lacked
    ``q_norm``/``k_norm`` (its prefill raised ``KeyError``) and whisper's
    layernorm blocks their ``bias``."""
    cfg = get_reduced(arch)
    par = POLICIES["fused" if layout == "fused" else "library"]
    model = build_model(cfg, ParallelConfig(**par), device="cpu")
    params = model.init_params(0)
    ref = ref_build(ref_reduced(arch), RefPar(remat="none", **par))
    if layout == "legacy":
        assert getattr(ref, "param_layout", REF_LEGACY) == REF_LEGACY
    want = jax.eval_shape(lambda: ref.init_params(jax.random.PRNGKey(0)))
    want_flat = jax.tree_util.tree_flatten_with_path(want)[0]
    got_flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [p for p, _ in got_flat] == [p for p, _ in want_flat]
    for (_, got), (path, leaf) in zip(got_flat, want_flat):
        assert tuple(got.shape) == leaf.shape, path
        assert str(got.dtype).split(".")[-1] == str(leaf.dtype), path
    if cfg.qk_norm:
        assert torch.equal(params["blocks"]["attn"]["q_norm"],
                           torch.ones(cfg.num_layers, cfg.resolved_head_dim))
    if cfg.norm == "layernorm":
        assert not params["enc_blocks"]["ln1"]["bias"].any()
    rng = np.random.default_rng(0)
    batch = _batch(cfg, rng)
    logits, cache = model.prefill(params, batch)
    assert logits.shape == (2, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    nxt = logits.argmax(-1).to(torch.int32)
    logits, cache = model.decode_step(params, nxt, _with_room(cache, 4))
    assert logits.shape == (2, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())


# --------------------------------------------------------------------------
# plain pieces
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 5, 64), (2, 40)])
def test_layernorm_matches_reference(shape):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    for eps in (1e-5, 1e-6):
        want = ref_common.layernorm(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b), eps)
        got = common.layernorm(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(b), eps)
        _close(got, want)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = ref_common.layernorm(jnp.asarray(xb.float().numpy(),
                                            jnp.bfloat16),
                                jnp.asarray(w), jnp.asarray(b))
    got = common.layernorm(xb, torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want.astype(jnp.float32)),
           dict(rtol=1e-2, atol=1e-2))
    norm = common.init_norm(shape[-1], "layernorm")
    assert set(norm) == {"scale", "bias"}
    assert set(common.init_norm(shape[-1], "rmsnorm")) == {"scale"}
    assert common.norm_specs("layernorm") == ref_common.norm_specs(
        "layernorm")
    assert common.norm_specs("rmsnorm") == ref_common.norm_specs("rmsnorm")
    _close(common.apply_norm(torch.from_numpy(x), dict(
        scale=torch.from_numpy(w), bias=torch.from_numpy(b)), "layernorm",
        1e-6), ref_common.apply_norm(jnp.asarray(x), dict(
            scale=jnp.asarray(w), bias=jnp.asarray(b)), "layernorm", 1e-6))


@pytest.mark.parametrize("n,d", [(16, 64), (1500, 512), (7, 10)])
def test_sinusoidal_positions_match_reference(n, d):
    want = ref_common.sinusoidal_positions(n, d)
    got = common.sinusoidal_positions(n, d)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=2e-5)


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((2, 9, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (2, 9)).astype(np.int32)
    want = ref_common.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = common.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels))
    _close(got, want)
    got_bf = common.cross_entropy(torch.from_numpy(logits).to(torch.bfloat16),
                                  torch.from_numpy(labels))
    assert got_bf.dtype == torch.float32


#: (Sq, Skv, chunk_q, chunk_kv, causal, kv_offset, exact_causal)
CHUNKED = {
    "causal-ragged-chunks": (37, 37, 8, 16, True, 0, False),
    "causal-folded": (37, 37, 8, 16, True, 0, True),
    "causal-kv-offset": (20, 50, 7, 9, True, 30, False),
    "causal-kv-offset-folded": (20, 50, 7, 9, True, 30, True),
    "causal-negative-offset": (9, 13, 4, 5, True, -2, False),
    "noncausal-ragged-chunks": (33, 45, 10, 12, False, 0, False),
    "one-chunk": (16, 16, 512, 1024, True, 0, False),
}


@pytest.mark.parametrize("case", list(CHUNKED))
def test_chunked_attention_matches_reference(case):
    sq, skv, cq, ck, causal, off, exact = CHUNKED[case]
    rng = np.random.default_rng(sq * skv)
    q = rng.standard_normal((2, 6, sq, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, skv, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, skv, 16)).astype(np.float32)
    kw = dict(causal=causal, kv_offset=off, chunk_q=cq, chunk_kv=ck,
              exact_causal=exact)
    want = ref_attention.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), **kw)
    got = attention.chunked_attention(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v), **kw)
    _close(got, want)


# --------------------------------------------------------------------------
# the dense family's reduced configs against the reference
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _params(arch, policy):
    """The reference's parameters (PRNGKey(0)) in the policy's layout,
    and the port's copy of them."""
    ref = ref_build(ref_reduced(arch), RefPar(remat="none",
                                              **POLICIES[policy]))
    ref_params = ref.init_params(jax.random.PRNGKey(0))
    return ref_params, params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                         "cpu")


def _models(arch, policy):
    ref = ref_build(ref_reduced(arch), RefPar(remat="none",
                                              **POLICIES[policy]))
    port = build_model(get_reduced(arch), ParallelConfig(**POLICIES[policy]),
                       device="cpu")
    return (ref, port, *_params(arch, policy))


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("arch", DENSE)
def test_dense_prefill_and_decode_match_reference(arch, policy):
    ref, port, ref_params, params = _models(arch, policy)
    cfg = get_reduced(arch)
    rng = np.random.default_rng(1)
    toks = rng.integers(2, cfg.vocab_size, (2, PROMPT_LEN)).astype(np.int32)
    want, ref_cache = jax.jit(ref.prefill)(ref_params,
                                           {"tokens": jnp.asarray(toks)})
    got, cache = port.prefill(params, {"tokens": torch.from_numpy(toks)})
    _close(got, want)
    assert set(cache) == set(ref_cache) == {"k", "v", "pos"}
    for key in ref_cache:
        assert tuple(cache[key].shape) == ref_cache[key].shape, key
        _close(cache[key], ref_cache[key])
    # both sides decode on a cache with room for the steps
    room = STEPS + 1
    ref_cache = dict(ref_cache, **{
        n: jnp.pad(ref_cache[n], ((0, 0),) * 3 + ((0, room), (0, 0)))
        for n in ("k", "v")})
    cache = _with_room(cache, room)
    decode = jax.jit(ref.decode_step)
    for _ in range(STEPS):
        nxt = np.argmax(np.asarray(want), -1).astype(np.int32)
        want, ref_cache = decode(ref_params, jnp.asarray(nxt), ref_cache)
        got, cache = port.decode_step(params, torch.from_numpy(nxt), cache)
        _close(got, want)
    for key in ref_cache:
        _close(cache[key], ref_cache[key])
    assert cache["pos"].tolist() == [PROMPT_LEN + STEPS] * 2
