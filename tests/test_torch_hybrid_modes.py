"""zamba2-1.2b-reduced under the abstract and abstract+shuffle modes
(``ParallelConfig(isa_mode=m, fuse_epilogues=True, use_pallas_attn=True)``)
against the JAX package's HybridLM under the same policy: prefill logits
and cache, 3 teacher-forced decode steps, and the BatchedEngine's tokens on
2 slots with 3 requests (one admitted into a reused slot).  Both sides get
the reference's parameters, in f32, logits at ``TOLERANCES["f32"]`` and
the leaves downstream of the SSD scan at ``TOLERANCES["f32_accum"]``; the
JAX side runs its Pallas kernels in interpret mode.  Then the path check:
every kernel of a prefill and a decode step runs in the policy's mode
(the scan or the decode recurrence once a mamba layer, rmsnorm 2 x layers
+ 1 a call, and per application of the shared block rmsnorm_matmul and
rmsnorm_swiglu, with flash_attention_matmul in the prefill)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as ref_build
from repro.models.config import ParallelConfig as RefPar
from repro.serve import BatchedEngine as RefEngine
from repro.serve import Request as RefRequest
from repro.serve import ServeConfig as RefServe
from test_torch_hybrid import (CACHE_LEN, _close, _pad_kv, _ref_cfg,
                               port_config)

from repro_torch.kernels import fused, rmsnorm, ssd
from repro_torch.models import build_model
from repro_torch.models.config import ParallelConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import BatchedEngine, Request, ServeConfig

MODES = ("abstract", "abstract+shuffle")
PROMPT_LEN, STEPS = 21, 3


def _policy(mode):
    return dict(isa_mode=mode, fuse_epilogues=True, use_pallas_attn=True)


@pytest.fixture(scope="module")
def reference():
    """The reference's parameters, drawn once (the layout does not depend
    on the mode)."""
    cfg = _ref_cfg("reduced")
    ref = ref_build(cfg, RefPar(remat="none", **_policy("abstract")))
    ref_params = ref.init_params(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), "cpu")
    return cfg, ref_params, params


def _models(reference, mode):
    cfg, ref_params, params = reference
    ref = ref_build(cfg, RefPar(remat="none", **_policy(mode)))
    port = build_model(port_config(cfg), ParallelConfig(**_policy(mode)),
                       device="cpu")
    return ref, ref_params, port, params, cfg


@pytest.mark.parametrize("mode", MODES)
def test_prefill_and_decode_match_reference(reference, mode):
    ref, ref_params, port, params, cfg = _models(reference, mode)
    assert port.policy.kernel().mode == mode and port.policy.fuses()
    rng = np.random.default_rng(1)
    tokens = rng.integers(2, cfg.vocab_size, (2, PROMPT_LEN)).astype(np.int32)
    want, ref_cache = jax.jit(ref.prefill)(
        ref_params, {"tokens": jnp.asarray(tokens)})
    got, cache = port.prefill(params, {"tokens": torch.from_numpy(tokens)})
    _close(got, want)
    for key in ref_cache:
        assert tuple(cache[key].shape) == ref_cache[key].shape, key
        _close(cache[key], ref_cache[key], key)
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


@pytest.mark.parametrize("mode", MODES)
def test_engine_tokens_match_reference(reference, mode):
    ref, ref_params, port, params, cfg = _models(reference, mode)
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(2, cfg.vocab_size, n)]
               for n in (9, 25, 14)]
    news = [5, 4, 3]
    serve = dict(batch_slots=2, max_seq_len=48, eos_id=-1)
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


@pytest.mark.parametrize("mode", MODES)
def test_the_mode_reaches_every_kernel_of_the_path(reference, mode,
                                                   monkeypatch):
    """Under ``isa_mode=mode`` the scan, the decode recurrence, every norm
    and the shared block's norm-GEMMs and prefill attention + wo run their
    ``mode`` lowering, each as often as the path prescribes, and no other
    plain kernel version or fallback runs (the shared block's decode
    attention is plain PyTorch, as in the reference)."""
    _, _, port, params, cfg = _models(reference, mode)
    seen = []
    for module, name in ((ssd, "ssd_scan_plain"), (ssd, "ssd_decode_plain"),
                         (rmsnorm, "rmsnorm_plain"),
                         (fused, "rmsnorm_matmul_plain"),
                         (fused, "add_rmsnorm_plain"),
                         (fused, "rmsnorm_swiglu_plain"),
                         (fused, "flash_attention_matmul_plain")):
        real = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _n=name, _r=real, **k:
                            seen.append((_n, k.get("mode"))) or _r(*a, **k))
    monkeypatch.setattr(fused.REGISTRY, "_record", lambda *a: seen.append(a))
    toks = torch.from_numpy(np.array([[5, 9, 3, 4]], np.int32))
    _, cache = port.prefill(params, {"tokens": toks})
    layers, apps = cfg.num_layers, port.n_apps
    want = {("ssd_scan_plain", mode): layers,
            ("rmsnorm_plain", mode): 2 * layers + 1,
            ("rmsnorm_matmul_plain", mode): apps,
            ("rmsnorm_swiglu_plain", mode): apps,
            ("flash_attention_matmul_plain", mode): apps}
    assert {k: seen.count(k) for k in set(seen)} == want
    seen.clear()
    cache = _pad_kv(cache, 8, lambda t, n: torch.nn.functional.pad(
        t, (0, 0, 0, n)))
    port.decode_step(params, torch.tensor([7], dtype=torch.int32), cache)
    want = {("ssd_decode_plain", mode): layers,
            ("rmsnorm_plain", mode): 2 * layers + 1,
            ("rmsnorm_matmul_plain", mode): apps,
            ("rmsnorm_swiglu_plain", mode): apps}
    assert {k: seen.count(k) for k in set(seen)} == want
