"""mamba2-2.7b-reduced under the abstract and abstract+shuffle modes
(``ParallelConfig(isa_mode=m, fuse_epilogues=True)``) against the JAX
package under the same policy: prefill logits and cache, 4 teacher-forced
decode steps, and the BatchedEngine's tokens on 2 slots with 3 requests (one
admitted between ticks).  Both sides get the reference's parameters, in
f32, at ``TOLERANCES["f32"]``; the JAX side runs its Pallas kernels (the
SSD scan and decode, the norms) in interpret mode.  Then the path check:
every ssd_scan, ssd_decode and rmsnorm call of a prefill and a decode step
runs in the policy's mode, and the norms count 2 x layers + 1 a call."""
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
from test_torch_mamba import port_config

from repro_torch.kernels import rmsnorm, ssd
from repro_torch.models import build_model
from repro_torch.models.config import ParallelConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import BatchedEngine, Request, ServeConfig

TOL = tolerance_for("f32")
ARCH = "mamba2-2.7b"
MODES = ("abstract", "abstract+shuffle")
PROMPT_LEN, STEPS = 21, 4


def _policy(mode):
    return dict(isa_mode=mode, fuse_epilogues=True)


@pytest.fixture(scope="module")
def reference():
    """The reference's parameters, drawn once (the layout does not depend
    on the mode)."""
    cfg = ref_reduced(ARCH)
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


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", MODES)
def test_prefill_and_decode_match_reference(reference, mode):
    ref, ref_params, port, params, cfg = _models(reference, mode)
    assert port.policy.kernel().mode == mode and port.policy.fuses()
    rng = np.random.default_rng(1)
    tokens = rng.integers(2, cfg.vocab_size, (2, PROMPT_LEN)).astype(np.int32)
    want, ref_cache = jax.jit(ref.prefill)(
        ref_params, {"tokens": jnp.asarray(tokens)})   # two chunks of 16
    got, cache = port.prefill(params, {"tokens": torch.from_numpy(tokens)})
    _close(got, want)
    for key in ("h", "conv", "pos"):
        assert tuple(cache[key].shape) == ref_cache[key].shape
        _close(cache[key], ref_cache[key])
    ref_decode = jax.jit(ref.decode_step)
    for _ in range(STEPS):
        nxt = np.argmax(np.asarray(want), -1).astype(np.int32)
        want, ref_cache = ref_decode(ref_params, jnp.asarray(nxt), ref_cache)
        got, cache = port.decode_step(params, torch.from_numpy(nxt), cache)
        _close(got, want)
        for key in ("h", "conv", "pos"):
            _close(cache[key], ref_cache[key])


@pytest.mark.parametrize("mode", MODES)
def test_engine_tokens_match_reference(reference, mode):
    ref, ref_params, port, params, cfg = _models(reference, mode)
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(2, cfg.vocab_size, n)]
               for n in (9, 40, 23)]
    news = [5, 4, 3]
    serve = dict(batch_slots=2, max_seq_len=64, eos_id=-1)
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
    """Under ``isa_mode=mode`` the scan, the decode recurrence and every
    norm (each layer's input norm, the gated norm, the final norm) run
    their ``mode`` lowering, and no fallback is taken."""
    _, _, port, params, cfg = _models(reference, mode)
    seen = []
    for module, name in ((ssd, "ssd_scan_plain"), (ssd, "ssd_decode_plain"),
                         (rmsnorm, "rmsnorm_plain")):
        real = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _n=name, _r=real, **k:
                            seen.append((_n, k.get("mode"))) or _r(*a, **k))
    monkeypatch.setattr(ssd.REGISTRY, "_record", lambda *a: seen.append(a))
    toks = torch.from_numpy(np.array([[5, 9, 3, 4]], np.int32))
    _, cache = port.prefill(params, {"tokens": toks})
    layers = cfg.num_layers
    assert seen.count(("ssd_scan_plain", mode)) == layers
    assert seen.count(("rmsnorm_plain", mode)) == 2 * layers + 1
    assert len(seen) == 3 * layers + 1
    seen.clear()
    port.decode_step(params, torch.tensor([7], dtype=torch.int32), cache)
    assert seen.count(("ssd_decode_plain", mode)) == layers
    assert seen.count(("rmsnorm_plain", mode)) == 2 * layers + 1
    assert len(seen) == 3 * layers + 1
