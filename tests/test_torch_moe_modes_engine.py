"""granite-moe-3b-a800m-reduced under the abstract and abstract+shuffle modes,
fused (P1: ``ParallelConfig(isa_mode=m, fuse_epilogues=True,
use_pallas_attn=True)``) and unfused (P2: ``ParallelConfig(isa_mode=m,
use_pallas_attn=True)``), against the JAX package under the same policy:
prefill logits over more tokens than the 64-token routing group, 4
teacher-forced decode steps (dense cache, and paged at 128-key pages with a
sentinel entry), and the BatchedEngine's tokens at pages of 128 with two
requests sharing a full first page.  Both sides get the reference's
parameters, in f32, at ``TOLERANCES["f32"]``; the JAX side runs its Pallas
kernels in interpret mode.  The engine serves three requests on two
slots, so one is admitted between ticks.  Then the path check: under each policy every
kernel of the path runs in the policy's mode."""
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
from test_torch_moe import ARCH, port_config

from repro_torch.kernels import attention, fused, rmsnorm
from repro_torch.models import build_model
from repro_torch.models.config import ParallelConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import BatchedEngine, Request, ServeConfig

TOL = tolerance_for("f32")
MODES = ("abstract", "abstract+shuffle")
BATCH, PROMPT_LEN, STEPS, PAGE, NUM_PAGES = 2, 40, 4, 128, 3


def _policy(label, mode):
    pol = dict(isa_mode=mode, use_pallas_attn=True)
    if label == "P1":
        pol["fuse_epilogues"] = True
    return pol


@pytest.fixture(scope="module")
def reference():
    """The reference's parameters, drawn once under P1's layout (P2 reads
    them through the layout accessors, in both packages)."""
    cfg = ref_reduced(ARCH)
    ref = ref_build(cfg, RefPar(remat="none", **_policy("P1", "abstract")))
    ref_params = ref.init_params(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), "cpu")
    return cfg, ref_params, params


def _models(reference, label, mode):
    cfg, ref_params, params = reference
    ref = ref_build(cfg, RefPar(remat="none", **_policy(label, mode)))
    port = build_model(port_config(cfg), ParallelConfig(**_policy(label, mode)),
                       device="cpu")
    return ref, ref_params, port, params, cfg


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _paged_caches(k, v):
    """Slot 0's prefill rows on page 2, slot 1's on page 0, a sentinel
    entry past each frontier."""
    nl, _, hkv, s, hd = k.shape
    tables = np.array([[2, NUM_PAGES], [0, NUM_PAGES]], np.int32)
    pools = []
    for strip in (k, v):
        pool = np.zeros((nl, NUM_PAGES, hkv, PAGE, hd), np.float32)
        pool[:, 2, :, :s] = strip[:, 0]
        pool[:, 0, :, :s] = strip[:, 1]
        pools.append(pool)
    pos = np.full((2,), s, np.int32)
    ref = {"k_pages": jnp.asarray(pools[0]), "v_pages": jnp.asarray(pools[1]),
           "block_tables": jnp.asarray(tables), "pos": jnp.asarray(pos)}
    trash = np.zeros((nl, 1) + pools[0].shape[2:], np.float32)
    port = {"k_pages": torch.from_numpy(np.concatenate([pools[0], trash], 1)),
            "v_pages": torch.from_numpy(np.concatenate([pools[1], trash], 1)),
            "block_tables": torch.from_numpy(tables),
            "pos": torch.from_numpy(pos)}
    return ref, port


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("label", ["P1", "P2"])
def test_prefill_and_decode_logits_match_reference(reference, label, mode):
    ref, ref_params, port, params, cfg = _models(reference, label, mode)
    assert port.policy.kernel().mode == mode
    assert port.policy.fuses() == (label == "P1")
    rng = np.random.default_rng(0)
    toks = rng.integers(2, cfg.vocab_size, (BATCH, PROMPT_LEN)).astype(
        np.int32)                              # 80 tokens: two groups
    ref_logits, ref_cache = jax.jit(ref.prefill)(
        ref_params, {"tokens": jnp.asarray(toks)})
    logits, cache = port.prefill(params, {"tokens": torch.from_numpy(toks)})
    _close(logits, ref_logits)
    _close(cache["k"], ref_cache["k"])
    pad = STEPS + 2
    ref_dense = dict(ref_cache, **{
        n: jnp.pad(ref_cache[n], ((0, 0),) * 3 + ((0, pad), (0, 0)))
        for n in ("k", "v")})
    dense = dict(cache, **{n: torch.nn.functional.pad(cache[n], (0, 0, 0, pad))
                           for n in ("k", "v")})
    ref_paged, paged = _paged_caches(np.asarray(ref_cache["k"]),
                                     np.asarray(ref_cache["v"]))
    ref_decode = jax.jit(ref.decode_step)
    nxt = np.argmax(np.asarray(ref_logits), -1).astype(np.int32)
    for _ in range(STEPS):
        ref_l, ref_dense = ref_decode(ref_params, jnp.asarray(nxt), ref_dense)
        got, dense = port.decode_step(params, torch.from_numpy(nxt), dense)
        _close(got, ref_l)
        ref_lp, ref_paged = ref_decode(ref_params, jnp.asarray(nxt),
                                       ref_paged)
        got_p, paged = port.decode_step(params, torch.from_numpy(nxt), paged)
        _close(got_p, ref_lp)
        nxt = np.argmax(np.asarray(ref_l), -1).astype(np.int32)
    _close(paged["k_pages"][:, :NUM_PAGES], ref_paged["k_pages"])
    _close(dense["v"], ref_dense["v"])


def _prompts(vocab):
    rng = np.random.default_rng(4)
    prompts = [[int(t) for t in rng.integers(2, vocab, n)]
               for n in (140, 150, 70)]
    prompts[1][:PAGE] = prompts[0][:PAGE]        # one full shared page
    return prompts


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("label", ["P1", "P2"])
def test_engine_tokens_match_reference(reference, label, mode):
    ref, ref_params, port, params, cfg = _models(reference, label, mode)
    serve = dict(batch_slots=2, max_seq_len=2 * PAGE, eos_id=-1,
                 page_size=PAGE)
    prompts = _prompts(cfg.vocab_size)
    news = [5, 4, 3]
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


@pytest.mark.parametrize("label", ["P1", "P2"])
def test_the_mode_reaches_every_kernel_of_the_path(reference, label,
                                                   monkeypatch):
    """Under ``isa_mode="abstract"`` every kernel of the path runs its
    abstract lowering: P1 ln1 -> wqkv and the tied head (rmsnorm_matmul),
    ln2 (add_rmsnorm) and attention + wo; P2 every norm (rmsnorm) and the
    prefill attention (flash_attention).  No other plain kernel version
    runs."""
    _, _, port, params, cfg = _models(reference, label, "abstract")
    seen = []
    for module, name in ((fused, "rmsnorm_matmul_plain"),
                         (fused, "add_rmsnorm_plain"),
                         (fused, "rmsnorm_swiglu_plain"),
                         (fused, "flash_attention_matmul_plain"),
                         (rmsnorm, "rmsnorm_plain"),
                         (attention, "flash_attention_plain")):
        real = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _n=name, _r=real, **k:
                            seen.append((_n, k.get("mode"))) or _r(*a, **k))
    monkeypatch.setattr(fused.REGISTRY, "_record", lambda *a: seen.append(a))
    toks = torch.from_numpy(np.array([[5, 9, 3]], np.int32))
    _, cache = port.prefill(params, {"tokens": toks})
    cache = dict(cache, **{n: torch.nn.functional.pad(cache[n], (0, 0, 0, 2))
                           for n in ("k", "v")})
    port.decode_step(params, torch.tensor([7], dtype=torch.int32), cache)
    assert {m for _, m in seen} == {"abstract"}
    assert {n for n, _ in seen} == (
        {"rmsnorm_matmul_plain", "add_rmsnorm_plain",
         "flash_attention_matmul_plain"} if label == "P1"
        else {"rmsnorm_plain", "flash_attention_plain"})
