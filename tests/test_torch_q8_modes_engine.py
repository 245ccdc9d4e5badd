"""granite-8b-reduced and granite-moe-3b-a800m-reduced under the int8 policy
in the abstract and abstract+shuffle modes (``ParallelConfig(isa_mode=m,
fuse_epilogues=True, use_pallas_attn=True, weight_precision="int8",
kv_cache_int8=True)``), against the JAX package under the same policy:
prefill logits, then teacher-forced decode steps from the reference's
quantized cache (dense, and paged at 128-key int8 pages with a sentinel
entry), and the BatchedEngine's tokens at pages of 128 with two requests
sharing a full first page.

Both sides serve the JAX package's quantized tree (``quantize_params``:
int8 leaves beside f32 scales; granite-moe's tied head a float table the
q8 op quantizes per call, on both sides), so they read the same int8
bytes, in f32, at ``TOLERANCES["f32"]``; the JAX side runs its Pallas
kernels in interpret mode.  Decode starts from the reference's cache:
each side's own prefill may round a K/V value on a .5 boundary the other
way."""
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
from test_torch_moe import port_config

from repro_torch.kernels import fused
from repro_torch.models import build_model
from repro_torch.models.config import ParallelConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import BatchedEngine, Request, ServeConfig

TOL = tolerance_for("f32")
MODES = ("abstract", "abstract+shuffle")
ARCHS = ("granite-8b", "granite-moe-3b-a800m")
# 2 x 40 prompt tokens: granite-moe routes them in two 64-token groups
BATCH, PROMPT_LEN, STEPS, PAGE, NUM_PAGES = 2, 40, 2, 128, 3
KEY = jax.random.PRNGKey(0)


def _policy(mode):
    return dict(isa_mode=mode, fuse_epilogues=True, use_pallas_attn=True,
                weight_precision="int8", kv_cache_int8=True)


@pytest.fixture(scope="module", params=ARCHS)
def reference(request):
    """One quantized tree per architecture, drawn under the fused layout
    (so wqkv and wig are int8 too), carried across as numpy."""
    cfg = ref_reduced(request.param)
    layout = ref_build(cfg, RefPar(remat="none", **_policy("abstract")))
    ref_params = ref_common.quantize_params(layout.init_params(KEY))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), "cpu")
    assert params["blocks"]["attn"]["wqkv"].dtype == torch.int8
    return cfg, ref_params, params


def _models(reference, mode):
    cfg, ref_params, params = reference
    ref = ref_build(cfg, RefPar(remat="none", **_policy(mode)))
    port = build_model(port_config(cfg), ParallelConfig(**_policy(mode)),
                       device="cpu")
    return ref, ref_params, port, params, cfg


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _paged_int8_caches(cache):
    """Slot 0's prefill rows (values and scales) on page 2, slot 1's on
    page 0, a sentinel entry past each frontier.  Fresh pools hold int8
    zeros and scales of 1e-8, as init_paged_cache makes them; the port's
    carry the trash page."""
    tables = np.array([[2, NUM_PAGES], [0, NUM_PAGES]], np.int32)
    ref, port = {}, {}
    for name in ("k", "k_scale", "v", "v_scale"):
        strip = np.asarray(cache[name])
        nl, _, hkv, s, last = strip.shape
        pool = np.full((nl, NUM_PAGES + 1, hkv, PAGE, last),
                       1e-8 if name.endswith("scale") else 0, strip.dtype)
        pool[:, 2, :, :s] = strip[:, 0]
        pool[:, 0, :, :s] = strip[:, 1]
        ref[name + "_pages"] = jnp.asarray(pool[:, :NUM_PAGES])
        port[name + "_pages"] = torch.from_numpy(pool)
    pos = np.full((BATCH,), PROMPT_LEN, np.int32)
    ref.update(block_tables=jnp.asarray(tables), pos=jnp.asarray(pos))
    port.update(block_tables=torch.from_numpy(tables),
                pos=torch.from_numpy(pos))
    return ref, port


def _grow(cache, pad, lib):
    """The dense int8 cache padded by ``pad`` positions."""
    out = dict(cache)
    for n in ("k", "k_scale", "v", "v_scale"):
        if lib is torch:
            out[n] = torch.nn.functional.pad(cache[n], (0, 0, 0, pad))
        else:
            out[n] = jnp.pad(cache[n], ((0, 0),) * 3 + ((0, pad), (0, 0)))
    return out


@pytest.mark.parametrize("mode", MODES)
def test_int8_prefill_and_decode_match_reference(reference, mode):
    ref, ref_params, port, params, cfg = _models(reference, mode)
    assert port.policy.kernel().mode == mode
    assert port.policy.precision == "int8"
    rng = np.random.default_rng(0)
    toks = rng.integers(2, cfg.vocab_size, (BATCH, PROMPT_LEN)).astype(
        np.int32)
    ref_decode = jax.jit(ref.decode_step)
    ref_logits, ref_cache = jax.jit(ref.prefill)(
        ref_params, {"tokens": jnp.asarray(toks)})
    logits, cache = port.prefill(params, {"tokens": torch.from_numpy(toks)})
    _close(logits, ref_logits)
    assert cache["k"].dtype == torch.int8
    cache = params_from_numpy(jax.tree.map(np.asarray, ref_cache), "cpu")
    ref_dense, dense = _grow(ref_cache, STEPS + 2, jnp), \
        _grow(cache, STEPS + 2, torch)
    ref_paged, paged = _paged_int8_caches(ref_cache)
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
    for name in ("k_pages", "v_pages"):
        np.testing.assert_array_equal(paged[name][:, :NUM_PAGES].numpy(),
                                      np.asarray(ref_paged[name]))
    assert paged["pos"].tolist() == [PROMPT_LEN + STEPS] * BATCH


def _prompts(vocab):
    rng = np.random.default_rng(4)
    prompts = [[int(t) for t in rng.integers(2, vocab, n)]
               for n in (140, 150, 9)]
    prompts[1][:PAGE] = prompts[0][:PAGE]        # one full shared page
    return prompts


@pytest.mark.parametrize("mode", MODES)
def test_int8_engine_tokens_match_reference(reference, mode, monkeypatch):
    """Three requests on two slots at pages of 128 (one admitted between
    ticks), the first two sharing a full page: the same tokens, ticks and
    shared hits; on the port's side every q8 twin runs in the mode asked
    for, and no plain version of another mode or of the f32 ops."""
    ref, ref_params, port, params, cfg = _models(reference, mode)
    seen = set()
    for name in ("rmsnorm_matmul_q8_plain", "rmsnorm_swiglu_q8_plain",
                 "flash_attention_matmul_q8_plain", "rmsnorm_matmul_plain",
                 "rmsnorm_swiglu_plain", "flash_attention_matmul_plain"):
        real = getattr(fused, name)
        monkeypatch.setattr(fused, name, lambda *a, _n=name, _r=real, **k:
                            seen.add((_n, k.get("mode"))) or _r(*a, **k))
    serve = dict(batch_slots=2, max_seq_len=2 * PAGE, eos_id=-1,
                 page_size=PAGE)
    prompts, news = _prompts(cfg.vocab_size), [3, 2, 3]
    ref_eng = RefEngine(ref, ref_params, RefServe(**serve))
    eng = BatchedEngine(port, params, ServeConfig(**serve))
    want = ref_eng.run([RefRequest(rid=i, prompt=list(p), max_new_tokens=m)
                        for i, (p, m) in enumerate(zip(prompts, news))])
    got = eng.run([Request(rid=i, prompt=list(p), max_new_tokens=m)
                   for i, (p, m) in enumerate(zip(prompts, news))])
    assert {r.rid: r.generated for r in got} == \
        {r.rid: r.generated for r in want}
    assert all(r.done and len(r.generated) == m for r, m in zip(got, news))
    assert eng.tick_count == ref_eng.tick_count
    assert eng.pool.shared_hits == ref_eng.pool.shared_hits == 1
    assert eng.cache["k_pages"].dtype == torch.int8
    kernels = {"rmsnorm_matmul_q8_plain", "flash_attention_matmul_q8_plain"}
    if cfg.moe is None:
        kernels.add("rmsnorm_swiglu_q8_plain")
    assert seen == {(n, mode) for n in kernels}
