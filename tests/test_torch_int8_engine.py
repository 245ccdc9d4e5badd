"""The int8 serving path of the port against the JAX package's: prefill
logits and teacher-forced decode steps on a dense and on a paged int8 KV
cache (a reaped slot writing through sentinel entries), under the fused
int8 policy and its unfused form, on the serve-equivalence tiny model and
on granite-8b-reduced; then the BatchedEngine's tokens against the JAX
engine of ``test_serve_equivalence.py::TestQuantizedEngine`` (dense, paged,
prefix-shared), and the page footprint under a ``kv_pool_bytes`` budget.

Both sides serve the JAX package's quantized tree (``quantize_params``:
int8 leaves beside f32 scales), so they read the same int8 weight bytes,
in f32, at ``TOLERANCES[None]``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tolerance_for
from repro.configs import get_reduced as ref_reduced
from repro.models import build_model as ref_build
from repro.models import common as ref_common
from repro.models.config import ParallelConfig as RefPar
from repro.serve import BatchedEngine as RefEngine
from repro.serve import Request as RefRequest
from repro.serve import ServeConfig as RefServe
from test_serve_equivalence import tiny_model

from repro_torch.kernels import fused
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig, ParallelConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import BatchedEngine, Request, ServeConfig

TOL = tolerance_for(None)
INT8 = dict(weight_precision="int8", kv_cache_int8=True)
#: the fused int8 policy (the main path) and its unfused form, which
#: dequantizes weights and caches up front
POLICIES = {"fused": dict(fuse_epilogues=True, use_pallas_attn=True, **INT8),
            "unfused": dict(fuse_epilogues=False, **INT8)}
CONFIGS = {"tiny": lambda: tiny_model()[1],
           "granite-8b-reduced": lambda: ref_reduced("granite-8b")}
PROMPT_LEN, STEPS, PAGE, NUM_PAGES = 6, 6, 4, 10
KEY = jax.random.PRNGKey(0)


def _models(cfg_name, policy):
    """Reference and port under ``policy``, serving one quantized tree
    drawn under the fused layout (so wqkv and wig are int8 too)."""
    ref_cfg = CONFIGS[cfg_name]()
    layout = ref_build(ref_cfg, RefPar(remat="none", **POLICIES["fused"]))
    ref_params = ref_common.quantize_params(layout.init_params(KEY))
    ref = ref_build(ref_cfg, RefPar(remat="none", **POLICIES[policy]))
    port = build_model(ModelConfig(**dataclasses.asdict(ref_cfg)),
                       ParallelConfig(**POLICIES[policy]), device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), "cpu")
    assert params["blocks"]["attn"]["wqkv"].dtype == torch.int8
    return ref, ref_params, port, params, ref_cfg


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _paged_int8_caches(cache, prompt_len):
    """Slot 0's prefill rows (values and scales) on pages [7, 2, 9, 4];
    slot 1 a reaped slot (sentinel row) whose pos keeps advancing.  Fresh
    pools hold int8 zeros and scales of 1e-8, as init_paged_cache makes
    them; the port's carry the trash page."""
    tables = np.array([[7, 2, 9, 4], [NUM_PAGES] * 4], np.int32)
    ref, port = {}, {}
    for name in ("k", "k_scale", "v", "v_scale"):
        strip = np.asarray(cache[name])
        nl, _, hkv, _, last = strip.shape
        pool = np.full((nl, NUM_PAGES + 1, hkv, PAGE, last),
                       1e-8 if name.endswith("scale") else 0, strip.dtype)
        for j in range(-(-prompt_len // PAGE)):
            rows = strip[:, 0, :, j * PAGE:(j + 1) * PAGE]
            pool[:, tables[0, j], :, :rows.shape[2]] = rows
        ref[name + "_pages"] = jnp.asarray(pool[:, :NUM_PAGES])
        port[name + "_pages"] = torch.from_numpy(pool)
    pos = np.full((2,), prompt_len, np.int32)
    ref.update(block_tables=jnp.asarray(tables), pos=jnp.asarray(pos))
    port.update(block_tables=torch.from_numpy(tables),
                pos=torch.from_numpy(pos))
    return ref, port


def _grow(cache, pad, lib):
    """The dense int8 cache padded by ``pad`` positions (values 0, scales
    0 past the prompt, as the engine's slot write leaves them)."""
    out = dict(cache)
    for n in ("k", "k_scale", "v", "v_scale"):
        if lib is torch:
            out[n] = torch.nn.functional.pad(cache[n], (0, 0, 0, pad))
        else:
            out[n] = jnp.pad(cache[n], ((0, 0),) * 3 + ((0, pad), (0, 0)))
    return out


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_int8_prefill_and_decode_match_reference(cfg_name, policy):
    ref, ref_params, port, params, cfg = _models(cfg_name, policy)
    rng = np.random.default_rng(0)
    toks = rng.integers(2, cfg.vocab_size, (2, PROMPT_LEN)).astype(np.int32)
    ref_prefill, ref_decode = jax.jit(ref.prefill), jax.jit(ref.decode_step)
    ref_logits, ref_cache = ref_prefill(ref_params,
                                        {"tokens": jnp.asarray(toks)})
    logits, cache = port.prefill(params, {"tokens": torch.from_numpy(toks)})
    _close(logits, ref_logits)
    for name in ("k", "v"):
        # the prompt's K/V quantized: the same int8 bytes, except where an
        # f32 value sits within rounding noise of a .5 boundary, which may
        # then round the other way (one step, and rarely)
        got, want = cache[name].numpy(), np.asarray(ref_cache[name])
        assert got.dtype == np.int8
        off = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert off.max() <= 1
        assert np.count_nonzero(off) <= max(1, 1e-3 * off.size)
        _close(cache[name + "_scale"], ref_cache[name + "_scale"])
    # decode from the reference's cache, so both sides read the same bytes
    cache = params_from_numpy(jax.tree.map(np.asarray, ref_cache), "cpu")
    ref_dense, dense = _grow(ref_cache, STEPS + 2, jnp), \
        _grow(cache, STEPS + 2, torch)
    ref_paged, paged = _paged_int8_caches(ref_cache, PROMPT_LEN)
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
    np.testing.assert_array_equal(dense["k"].numpy(),
                                  np.asarray(ref_dense["k"]))
    _close(dense["v_scale"], ref_dense["v_scale"])
    for name in ("k_pages", "v_pages"):
        np.testing.assert_array_equal(paged[name][:, :NUM_PAGES].numpy(),
                                      np.asarray(ref_paged[name]))
    _close(paged["k_scale_pages"][:, :NUM_PAGES], ref_paged["k_scale_pages"])
    assert paged["pos"].tolist() == [PROMPT_LEN + STEPS] * 2


# ---------------------------------------------------------------------------
# the engine: TestQuantizedEngine's stream
# ---------------------------------------------------------------------------

CACHE_LEN, ENGINE_PAGE = 32, 8


@pytest.fixture(scope="module")
def engines():
    """The tiny model under the fused int8 policy, both packages, one
    quantized tree (TestQuantizedEngine's)."""
    cfg = tiny_model()[1]
    ref = ref_build(cfg, RefPar(remat="none", **POLICIES["fused"]))
    ref_params = ref_common.quantize_params(ref.init_params(KEY))
    port = build_model(ModelConfig(**dataclasses.asdict(cfg)),
                       ParallelConfig(**POLICIES["fused"]), device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), "cpu")
    return ref, ref_params, port, params, cfg


def _prompts(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(2, cfg.vocab_size, 3 + i % 3)]
            for i in range(n)]


def _run_both(engines, prompts, max_news, **serve):
    ref, ref_params, port, params, _ = engines
    ref_eng = RefEngine(ref, ref_params, RefServe(**serve))
    eng = BatchedEngine(port, params, ServeConfig(**serve))
    want = ref_eng.run([RefRequest(rid=i, prompt=list(p), max_new_tokens=m)
                        for i, (p, m) in enumerate(zip(prompts, max_news))])
    got = eng.run([Request(rid=i, prompt=list(p), max_new_tokens=m)
                   for i, (p, m) in enumerate(zip(prompts, max_news))])
    return ref_eng, want, eng, got


def _tokens(reqs):
    return {r.rid: (r.generated, r.done, r.rejected) for r in reqs}


@pytest.mark.parametrize("page_size", [None, ENGINE_PAGE])
def test_int8_engine_matches_reference(engines, page_size):
    cfg = engines[4]
    ref_eng, want, eng, got = _run_both(
        engines, _prompts(cfg, 4), [4, 7, 5, 6], batch_slots=2,
        max_seq_len=CACHE_LEN, eos_id=-1, page_size=page_size)
    assert len(got) == 4 and _tokens(got) == _tokens(want)
    assert eng.tick_count == ref_eng.tick_count
    assert eng.tick_stats == ref_eng.tick_stats
    key = "k_pages" if page_size else "k"
    assert eng.cache[key].dtype == torch.int8


def test_int8_prefix_sharing_matches_reference(engines):
    cfg = engines[4]
    prompt = _prompts(cfg, 1, seed=3)[0] * 4          # one full shared page
    prompts = [prompt, prompt + [7, 9]]
    ref_eng, want, eng, got = _run_both(
        engines, prompts, [5, 5], batch_slots=2, max_seq_len=CACHE_LEN,
        eos_id=-1, page_size=ENGINE_PAGE)
    assert _tokens(got) == _tokens(want)
    assert eng.pool.shared_hits == ref_eng.pool.shared_hits == 1


def test_int8_engine_on_cpu_launches_no_kernel(engines):
    """On CPU tensors the wrappers run their plain versions: a whole run
    launches no kernel (the card's launch counts are chip_smoke.py's)."""
    cfg = engines[4]
    fused.reset_launch_counts()
    _run_both(engines, _prompts(cfg, 2), [3, 3], batch_slots=2,
              max_seq_len=CACHE_LEN, eos_id=-1, page_size=ENGINE_PAGE)
    assert not any(fused.LAUNCHES.values())


@pytest.mark.parametrize("int8", [False, True])
def test_page_footprint_and_pool_budget_match_reference(engines, int8):
    """At one ``kv_pool_bytes`` budget the int8 engine holds
    4 hd / (hd + 4) times the f32 pages (hd = 16: 3.2x), as the JAX
    engine's accounting says."""
    ref, ref_params, port, params, cfg = engines
    if not int8:
        ref = ref_build(cfg, RefPar(remat="none"))
        ref_params = ref.init_params(KEY)
        port = build_model(ModelConfig(**dataclasses.asdict(cfg)),
                           ParallelConfig(), device="cpu")
        params = params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                   "cpu")
    serve = dict(batch_slots=2, max_seq_len=CACHE_LEN, eos_id=-1,
                 page_size=ENGINE_PAGE, kv_pool_bytes=64 * 1024)
    ref_eng = RefEngine(ref, ref_params, RefServe(**serve))
    eng = BatchedEngine(port, params, ServeConfig(**serve))
    assert eng.page_footprint_bytes() == ref_eng.page_footprint_bytes()
    assert eng.num_pages == ref_eng.num_pages
    hd = cfg.resolved_head_dim
    per_layer = 2 * cfg.num_kv_heads * ENGINE_PAGE * (hd + 4 if int8
                                                      else 4 * hd)
    assert eng.page_footprint_bytes() == cfg.num_layers * per_layer
    pool = eng.cache["k_pages"]
    assert pool.shape[1] == eng.num_pages + 1       # the trash page
    assert pool.dtype == (torch.int8 if int8 else torch.float32)
