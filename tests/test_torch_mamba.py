"""MambaLM of the port against the JAX package's, on the CPU: prefill logits
and cache (``h``, ``conv``, ``pos``), 4 teacher-forced decode steps, and the
BatchedEngine's tokens, on the SSD serve-equivalence config and on
mamba2-2.7b-reduced, under the unfused (library) and the fused policy, in
f32 at ``TOLERANCES["f32"]``.  Both sides get the reference's parameters
(``params_from_numpy`` without ``dtype=``, so the f32 leaves stay f32) and
the same tokens."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_serve_equivalence as tse
from conftest import tolerance_for
from repro.configs import get_reduced as ref_reduced
from repro.models import build_model as ref_build
from repro.models.config import ParallelConfig as RefPar
from repro.serve import BatchedEngine as RefEngine
from repro.serve import Request as RefRequest
from repro.serve import ServeConfig as RefServe

from repro_torch.configs import get_reduced
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig, ParallelConfig, SSMConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import BatchedEngine, Request, ServeConfig

TOL = tolerance_for("f32")
POLICIES = {"library": dict(), "fused": dict(fuse_epilogues=True)}
CONFIGS = {"ssd-serve": lambda: tse.TestSSDDecodeServe()._cfg(),
           "mamba2-2.7b-reduced": lambda: ref_reduced("mamba2-2.7b")}
PROMPT_LEN, STEPS = 13, 4


def port_config(ref_cfg) -> ModelConfig:
    d = dataclasses.asdict(ref_cfg)
    d["ssm"] = SSMConfig(**d["ssm"])
    return ModelConfig(**d)


def _models(cfg_name, policy):
    ref_cfg = CONFIGS[cfg_name]()
    ref = ref_build(ref_cfg, RefPar(remat="none", **POLICIES[policy]))
    port = build_model(port_config(ref_cfg),
                       ParallelConfig(**POLICIES[policy]), device="cpu")
    ref_params = ref.init_params(tse.KEY)
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), "cpu")
    return ref, ref_params, port, params, ref_cfg


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_reduced_config_matches_the_reference():
    assert get_reduced("mamba2-2.7b") == port_config(
        ref_reduced("mamba2-2.7b"))


def test_params_keep_their_dtypes():
    _, ref_params, _, params, _ = _models("mamba2-2.7b-reduced", "fused")
    ref_leaves = jax.tree.leaves(ref_params)
    leaves = jax.tree.leaves(params)
    assert len(leaves) == len(ref_leaves)
    for got, want in zip(leaves, ref_leaves):
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        assert tuple(got.shape) == want.shape
    assert params["blocks"]["A_log"].dtype == torch.float32


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("cfg_name", list(CONFIGS))
def test_prefill_and_decode_match_reference(cfg_name, policy):
    ref, ref_params, port, params, cfg = _models(cfg_name, policy)
    assert port.policy.fuses() == (policy == "fused")
    rng = np.random.default_rng(0)
    tokens = rng.integers(2, cfg.vocab_size, (2, PROMPT_LEN)).astype(np.int32)
    want, ref_cache = ref.prefill(ref_params, {"tokens": jnp.asarray(tokens)})
    got, cache = port.prefill(params, {"tokens": torch.from_numpy(tokens)})
    _close(got, want)
    for key in ("h", "conv", "pos"):
        assert tuple(cache[key].shape) == ref_cache[key].shape
        _close(cache[key], ref_cache[key])
    assert cache["h"].dtype == torch.float32
    for _ in range(STEPS):
        nxt = np.argmax(np.asarray(want), -1).astype(np.int32)
        want, ref_cache = ref.decode_step(ref_params, jnp.asarray(nxt),
                                          ref_cache)
        got, cache = port.decode_step(params, torch.from_numpy(nxt), cache)
        _close(got, want)
        for key in ("h", "conv", "pos"):
            _close(cache[key], ref_cache[key])


def _all_logits(ref, ref_params):
    @jax.jit
    def run(tokens):
        x = ref._embed(ref_params, tokens)
        x, _ = ref._scan_blocks(ref_params, x)
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


@pytest.mark.parametrize("cfg_name,policy", [
    ("ssd-serve", "library"), ("ssd-serve", "fused"),
    ("mamba2-2.7b-reduced", "fused")])
def test_engine_tokens_match_reference(cfg_name, policy):
    """The SSD serve-equivalence run: 4 requests on 2 slots (a slot is
    reused after its state drifted while dead), max_new [4, 7, 5, 6], no
    EOS."""
    ref, ref_params, port, params, cfg = _models(cfg_name, policy)
    prompts = tse._prompts(cfg, 4)
    max_news = [4, 7, 5, 6]
    serve = dict(batch_slots=2, max_seq_len=tse.CACHE_LEN, eos_id=-1)
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


def test_new_request_overwrites_the_slots_whole_state():
    """_write_slot copies every cache leaf: a slot's ``h`` and ``conv``
    slices are replaced outright (a dead slot's state has drifted), the
    other slot is untouched, and ``pos`` takes the prompt length."""
    _, _, port, params, cfg = _models("ssd-serve", "fused")
    eng = BatchedEngine(port, params, ServeConfig(
        batch_slots=2, max_seq_len=tse.CACHE_LEN, eos_id=-1))
    for key in ("h", "conv"):
        eng.cache[key].normal_()
    other = {k: eng.cache[k][:, 0].clone() for k in ("h", "conv")}
    prompt = [3, 5, 7, 11, 13]
    _, cache1 = port.prefill(params, {"tokens": torch.tensor([prompt])})
    eng._write_slot(1, cache1)
    for key in ("h", "conv"):
        assert torch.equal(eng.cache[key][:, 1], cache1[key][:, 0])
        assert torch.equal(eng.cache[key][:, 0], other[key])
    assert int(eng.cache["pos"][1]) == len(prompt)
    assert eng.param_layout is None           # MambaLM plans no layout
