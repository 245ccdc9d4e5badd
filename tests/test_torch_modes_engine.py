"""granite-8b-reduced under ``ParallelConfig(isa_mode=m, fuse_epilogues=True,
use_pallas_attn=True)`` for m in {abstract, abstract+shuffle}, against the
JAX package under the same policy: prefill logits and 6 teacher-forced
decode steps (dense cache, and paged at 128-key pages with a reaped slot),
and the BatchedEngine's tokens, dense and paged (two requests sharing a full
first page of 128 tokens).  Both sides get the reference's parameters, in
f32, at ``TOLERANCES["f32"]``; the JAX side runs its Pallas kernels in
interpret mode.  Then the port's three repairs against the reference:
MambaLM under the int8 policy, a precision no op declares, and
``ServeConfig.greedy``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_serve_equivalence as tse
from conftest import tolerance_for
from repro.configs import get_reduced as ref_reduced
from repro.core.registry import LoweringRegistry as RefLoweringRegistry
from repro.core.registry import ExecutionPolicy as RefPolicy
from repro.kernels import fused as ref_fused
from repro.models import build_model as ref_build
from repro.models.config import ParallelConfig as RefPar
from repro.serve import BatchedEngine as RefEngine
from repro.serve import Request as RefRequest
from repro.serve import ServeConfig as RefServe
from test_torch_mamba import port_config as mamba_port_config

from repro_torch.core import ExecutionPolicy, LoweringRegistry
from repro_torch.kernels import fused
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig, ParallelConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import BatchedEngine, Request, ServeConfig

TOL = tolerance_for("f32")
MODES = ("abstract", "abstract+shuffle")
PROMPT_LEN, STEPS, PAGE, NUM_PAGES = 6, 6, 128, 3


def _policy(mode):
    return dict(isa_mode=mode, fuse_epilogues=True, use_pallas_attn=True)


@pytest.fixture(scope="module")
def reference():
    cfg = ref_reduced("granite-8b")
    ref = ref_build(cfg, RefPar(remat="none", **_policy("abstract")))
    ref_params = ref.init_params(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), "cpu")
    return cfg, ref_params, params


def _models(reference, mode):
    cfg, ref_params, params = reference
    ref = ref_build(cfg, RefPar(remat="none", **_policy(mode)))
    port = build_model(ModelConfig(**dataclasses.asdict(cfg)),
                       ParallelConfig(**_policy(mode)), device="cpu")
    return ref, ref_params, port, params, cfg


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _paged_caches(k, v):
    """Slot 0's prefill rows on page 2; slot 1 is a reaped slot (sentinel
    entries) whose pos keeps advancing."""
    nl, _, hkv, s, hd = k.shape
    tables = np.array([[2, 0], [NUM_PAGES, NUM_PAGES]], np.int32)
    pools = []
    for strip in (k, v):
        pool = np.zeros((nl, NUM_PAGES, hkv, PAGE, hd), np.float32)
        pool[:, 2, :, :s] = strip[:, 0]
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
def test_prefill_and_decode_logits_match_reference(reference, mode):
    ref, ref_params, port, params, cfg = _models(reference, mode)
    assert port.policy.kernel().mode == mode and port.policy.fuses()
    rng = np.random.default_rng(0)
    toks = rng.integers(2, cfg.vocab_size, (2, PROMPT_LEN)).astype(np.int32)
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
    nxt = nxt_paged = np.argmax(np.asarray(ref_logits), -1).astype(np.int32)
    for _ in range(STEPS):
        ref_l, ref_dense = ref_decode(ref_params, jnp.asarray(nxt), ref_dense)
        got, dense = port.decode_step(params, torch.from_numpy(nxt), dense)
        _close(got, ref_l)
        ref_lp, ref_paged = ref_decode(ref_params, jnp.asarray(nxt_paged),
                                       ref_paged)
        got_p, paged = port.decode_step(params, torch.from_numpy(nxt_paged),
                                        paged)
        _close(got_p, ref_lp)
        nxt = np.argmax(np.asarray(ref_l), -1).astype(np.int32)
        nxt_paged = np.argmax(np.asarray(ref_lp), -1).astype(np.int32)
    _close(paged["k_pages"][:, :NUM_PAGES], ref_paged["k_pages"])


def test_the_mode_reaches_every_kernel_of_the_path(reference, monkeypatch):
    """Under the abstract policy the path's four kernel shapes run in that
    mode and no plain norm runs: ln1, ln2 and the final norm are fused."""
    _, _, port, params, cfg = _models(reference, "abstract")
    seen = []
    for name in ("rmsnorm_matmul_plain", "rmsnorm_swiglu_plain",
                 "flash_attention_matmul_plain",
                 "paged_attention_matmul_plain"):
        real = getattr(fused, name)
        monkeypatch.setattr(fused, name, lambda *a, _n=name, _r=real, **k:
                            seen.append((_n, k.get("mode"))) or _r(*a, **k))
    monkeypatch.setattr(fused.REGISTRY, "_record", lambda *a: seen.append(a))
    toks = torch.from_numpy(np.array([[5, 9, 3]], np.int32))
    _, cache = port.prefill(params, {"tokens": toks})
    cache = dict(cache, **{n: torch.nn.functional.pad(cache[n], (0, 0, 0, 2))
                           for n in ("k", "v")})
    port.decode_step(params, torch.tensor([7], dtype=torch.int32), cache)
    assert {m for _, m in seen} == {"abstract"}
    assert {n for n, _ in seen} == {"rmsnorm_matmul_plain",
                                    "rmsnorm_swiglu_plain",
                                    "flash_attention_matmul_plain"}
    with pytest.raises(ValueError, match="multiple of 128"):
        BatchedEngine(port, params, ServeConfig(
            batch_slots=1, max_seq_len=64, eos_id=-1, page_size=8)).run(
                [Request(rid=0, prompt=[5, 9, 3], max_new_tokens=2)])


def _prompts(vocab):
    rng = np.random.default_rng(4)
    prompts = [[int(t) for t in rng.integers(2, vocab, n)]
               for n in (140, 150, 9, 20)]
    prompts[1][:PAGE] = prompts[0][:PAGE]        # one full shared page
    return prompts


@pytest.mark.parametrize("page_size", [None, PAGE])
@pytest.mark.parametrize("mode", MODES)
def test_engine_tokens_match_reference(reference, mode, page_size):
    ref, ref_params, port, params, cfg = _models(reference, mode)
    serve = dict(batch_slots=2, max_seq_len=2 * PAGE, eos_id=-1,
                 page_size=page_size)
    prompts = _prompts(cfg.vocab_size)
    news = [5, 4, 6, 3]
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
    if page_size is not None:
        assert eng.pool.shared_hits == ref_eng.pool.shared_hits == 1


# ---------------------------------------------------------------------------
# the repairs: the port now does what the reference does
# ---------------------------------------------------------------------------


def test_mamba_accepts_the_int8_policy_as_the_reference_does():
    """Ops that declare no int8 variant (the SSD kernels, the norms) run
    their own rows under ``weight_precision="int8"``, in both packages:
    the same tokens and logits as the JAX engine."""
    ref_cfg = ref_reduced("mamba2-2.7b")
    pol = dict(fuse_epilogues=True, weight_precision="int8")
    ref = ref_build(ref_cfg, RefPar(remat="none", **pol))
    port = build_model(mamba_port_config(ref_cfg), ParallelConfig(**pol),
                       device="cpu")
    assert port.policy.precision == "int8"
    ref_params = ref.init_params(tse.KEY)
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), "cpu")
    toks = np.random.default_rng(1).integers(
        2, ref_cfg.vocab_size, (2, 11)).astype(np.int32)
    want, _ = jax.jit(ref.prefill)(ref_params, {"tokens": jnp.asarray(toks)})
    got, _ = port.prefill(params, {"tokens": torch.from_numpy(toks)})
    _close(got, want)
    serve = dict(batch_slots=2, max_seq_len=24, eos_id=-1)
    prompts = [list(map(int, t)) for t in toks] + [[3, 4, 5]]
    want = RefEngine(ref, ref_params, RefServe(**serve)).run(
        [RefRequest(rid=i, prompt=p, max_new_tokens=4)
         for i, p in enumerate(prompts)])
    got = BatchedEngine(port, params, ServeConfig(**serve)).run(
        [Request(rid=i, prompt=p, max_new_tokens=4)
         for i, p in enumerate(prompts)])
    assert {r.rid: r.generated for r in got} == \
        {r.rid: r.generated for r in want}


def test_a_precision_no_op_declares_keeps_the_base_row():
    """Both registries keep the base op when no op declares a variant for
    the policy's precision."""
    reg, ref_reg = LoweringRegistry(), RefLoweringRegistry()
    reg.register("rmsnorm_matmul", "library", fused.rmsnorm_matmul_plain)
    ref_reg.register("rmsnorm_matmul", "library",
                     ref_fused._rmsnorm_matmul_library)
    low = reg.select("rmsnorm_matmul",
                     ExecutionPolicy(mode="library", precision="int8"))
    want = ref_reg.select("rmsnorm_matmul",
                          RefPolicy(mode="library", precision="int8"))
    assert low.op == want.op == "rmsnorm_matmul"
    assert low.impl is fused.rmsnorm_matmul_plain


def test_serve_config_has_the_references_greedy_field():
    fields = {f.name: f.default for f in dataclasses.fields(ServeConfig)}
    want = {f.name: f.default for f in dataclasses.fields(RefServe)}
    assert fields["greedy"] is want["greedy"] is True
    assert list(fields).index("greedy") == list(want).index("greedy")
    assert ServeConfig(batch_slots=1, max_seq_len=8, greedy=False).greedy \
        is False
