"""The port's BatchedEngine against the JAX package's, token for token, on
the serve-equivalence tiny model under the fused policy (the main path):
dense, paged, prefix-shared, pool exhaustion with the up-front reject, and
EOS; plus the PagePool refcount and prefix invariants.

A greedy token comparison is only meaningful where no near-tie can flip
the argmax: every test asserts that the reference's top-2 logit gap at
each emitted token exceeds 10x the f32 tolerance."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import tolerance_for
from repro.models import build_model as ref_build
from repro.models.config import ParallelConfig as RefPar
from repro.serve import BatchedEngine as RefEngine
from repro.serve import Request as RefRequest
from repro.serve import ServeConfig as RefServe
from test_serve_equivalence import tiny_model

from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig, ParallelConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import BatchedEngine, PagePool, Request, ServeConfig

TOL = tolerance_for("f32")
FUSED = dict(fuse_epilogues=True, use_pallas_attn=True)
CACHE_LEN, PAGE = 32, 8


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_model()[1]
    ref = ref_build(cfg, RefPar(remat="none", **FUSED))
    ref_params = ref.init_params(jax.random.PRNGKey(0))
    port = build_model(ModelConfig(**dataclasses.asdict(cfg)),
                       ParallelConfig(**FUSED), device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), "cpu")
    # teacher-forced logits of the unfused reference over a whole sequence
    plain = ref_build(cfg, RefPar(remat="none"))

    @jax.jit
    def all_logits(tokens):
        x = plain._embed(ref_params, tokens, {})
        positions = jnp.arange(tokens.shape[1])[None]
        x, _, _ = plain._scan_blocks(ref_params, x, positions)
        return plain._head(ref_params, x)[0]

    return ref, ref_params, port, params, cfg, all_logits


def _prompts(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(2, cfg.vocab_size, 3 + i % 3)]
            for i in range(n)]


def _run_both(setup, prompts, max_news, **serve):
    ref, ref_params, port, params, _, all_logits = setup
    ref_eng = RefEngine(ref, ref_params, RefServe(**serve))
    eng = BatchedEngine(port, params, ServeConfig(**serve))
    want = ref_eng.run([RefRequest(rid=i, prompt=list(p), max_new_tokens=m)
                        for i, (p, m) in enumerate(zip(prompts, max_news))])
    got = eng.run([Request(rid=i, prompt=list(p), max_new_tokens=m)
                   for i, (p, m) in enumerate(zip(prompts, max_news))])
    for r in want:
        _assert_no_near_tie(all_logits, r.prompt, r.generated)
    return ref_eng, want, eng, got


def _assert_no_near_tie(all_logits, prompt, generated):
    if not generated:
        return
    seq = list(prompt) + list(generated[:-1])
    logits = np.asarray(all_logits(jnp.asarray([seq], jnp.int32)))
    steps = logits[len(prompt) - 1:]
    top2 = np.sort(steps, axis=-1)[:, -2:]
    assert list(np.argmax(steps, -1)) == list(generated)
    gap = top2[:, 1] - top2[:, 0]
    bound = 10 * (TOL["atol"] + TOL["rtol"] * np.abs(top2[:, 1]))
    assert np.all(gap > bound), (gap.min(), prompt)


def _tokens(reqs):
    return {r.rid: (r.generated, r.done, r.rejected) for r in reqs}


@pytest.mark.parametrize("page_size", [None, PAGE])
def test_oversubscribed_matches_reference(setup, page_size):
    cfg = setup[4]
    ref_eng, want, eng, got = _run_both(
        setup, _prompts(cfg, 5), [4, 7, 5, 6, 4], batch_slots=2,
        max_seq_len=CACHE_LEN, eos_id=-1, page_size=page_size)
    assert len(got) == 5 and _tokens(got) == _tokens(want)
    assert eng.tick_count == ref_eng.tick_count
    assert eng.tick_stats == ref_eng.tick_stats


def test_prefix_sharing_matches_reference(setup):
    cfg = setup[4]
    prompt = _prompts(cfg, 1, seed=3)[0] * 4          # one full shared page
    prompts = [prompt, prompt + [7, 9]]
    ref_eng, want, eng, got = _run_both(
        setup, prompts, [5, 5], batch_slots=2, max_seq_len=CACHE_LEN,
        eos_id=-1, page_size=PAGE)
    assert _tokens(got) == _tokens(want)
    assert eng.pool.shared_hits == ref_eng.pool.shared_hits == 1
    assert eng.tick_stats == ref_eng.tick_stats


def test_pool_exhaustion_and_upfront_reject_match_reference(setup):
    cfg = setup[4]
    # reserve = ceil((3 + 20 - 1) / 8) = 3 > 2 pages: rejected up front;
    # the others wait for pages (one reservation fits at a time)
    prompts = [[3, 5, 7]] + _prompts(cfg, 3, seed=6)
    ref_eng, want, eng, got = _run_both(
        setup, prompts, [20, 4, 4, 4], batch_slots=2, max_seq_len=CACHE_LEN,
        eos_id=-1, page_size=PAGE, num_pages=2)
    assert _tokens(got) == _tokens(want)
    assert got[0].rejected and got[0].slot is None and got[0].generated == []
    assert all(r.done and len(r.generated) == 4 for r in got[1:])
    assert eng.tick_count == ref_eng.tick_count < 100


def test_admission_stops_at_the_page_budget(setup):
    _, _, port, params, cfg, _ = setup
    eng = BatchedEngine(port, params, ServeConfig(
        batch_slots=2, max_seq_len=CACHE_LEN, eos_id=-1, page_size=PAGE,
        num_pages=1))
    reqs = [Request(rid=i, prompt=p[:3], max_new_tokens=4)
            for i, p in enumerate(_prompts(cfg, 2))]
    assert eng.admit(reqs) == 1 and eng.pool.free_pages == 0
    eng.run(reqs[1:])
    assert all(r.done and len(r.generated) == 4 for r in reqs)


def test_eos_matches_reference(setup):
    cfg = setup[4]
    prompts = _prompts(cfg, 3, seed=1)
    probe = BatchedEngine(setup[2], setup[3], ServeConfig(
        batch_slots=1, max_seq_len=CACHE_LEN, eos_id=-1)).run(
            [Request(rid=0, prompt=prompts[0], max_new_tokens=8)])
    eos = probe[0].generated[2]                # appears mid-stream
    _, want, _, got = _run_both(setup, prompts, [8, 8, 8], batch_slots=2,
                                max_seq_len=CACHE_LEN, eos_id=eos,
                                page_size=PAGE)
    assert _tokens(got) == _tokens(want)
    assert len(got[0].generated) == 3 and got[0].generated[-1] == eos


def test_page_pool_refcounts_and_prefix_index():
    pool = PagePool(num_pages=4, page_size=2)
    a = pool.alloc(2)
    assert a == [0, 1] and pool.free_pages == 2
    hashes = PagePool.prefix_hashes([5, 6, 7, 8, 9], 2)
    assert len(hashes) == 2
    assert hashes != PagePool.prefix_hashes([5, 6, 0, 8, 9], 2)
    assert hashes[0] == PagePool.prefix_hashes([5, 6, 0, 8, 9], 2)[0]
    pool.publish_prefix(hashes[0], a[0])
    assert pool.lookup_prefix(hashes[0]) == a[0]
    pool.retain(a[0])
    pool.release(a[0])
    assert pool.refcount[a[0]] == 1 and pool.lookup_prefix(hashes[0]) == 0
    pool.release(a[0])                     # refcount 0: freed, unpublished
    assert a[0] not in pool.refcount and pool.lookup_prefix(hashes[0]) is None
    assert pool.free_pages == 3 and pool.occupied_pages == 1
    with pytest.raises(RuntimeError, match="exhausted"):
        pool.alloc(4)
    with pytest.raises(RuntimeError, match="free page"):
        pool.retain(a[0])


def test_reaped_slot_pages_are_released(setup):
    _, _, port, params, cfg, _ = setup
    eng = BatchedEngine(port, params, ServeConfig(
        batch_slots=2, max_seq_len=CACHE_LEN, eos_id=-1, page_size=PAGE))
    reqs = [Request(rid=i, prompt=p, max_new_tokens=3 + i)
            for i, p in enumerate(_prompts(cfg, 4))]
    eng.run(reqs)
    assert all(r.done for r in reqs)
    assert eng.pool.occupied_pages == sum(len(p) for p in eng._slot_pages)
    assert {reqs[2].slot, reqs[3].slot} == {reqs[0].slot, reqs[1].slot}
