"""The port's paged BatchedEngine against the JAX package's, token for
token, on granite-moe-3b-a800m-reduced under the fused policy (P1) and the
unfused kernel policy (P2): prompts longer than the 64-token routing group
(so prefill pads a group), two requests sharing full prompt pages, more
requests than slots (admission between ticks, dead slots routing in the
tick).  Both sides get the reference's parameters, in f32; the JAX side
runs its Pallas kernels in interpret mode.

The MoE routes a teacher-forced sequence in other groups than the engine
routes its ticks, so no whole-sequence logits can vouch for the argmax
margins; the two engines compute the same f32 function step by step (the
logits agree to ``TOLERANCES["f32"]``, tests/test_torch_moe.py)."""
import jax
import numpy as np
import pytest

from repro.configs import get_reduced as ref_reduced
from repro.models import build_model as ref_build
from repro.models.config import ParallelConfig as RefPar
from repro.serve import BatchedEngine as RefEngine
from repro.serve import Request as RefRequest
from repro.serve import ServeConfig as RefServe
from test_torch_moe import ARCH, POLICIES, port_config

from repro_torch.models import build_model
from repro_torch.models.config import ParallelConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import BatchedEngine, Request, ServeConfig

PAGE, MAX_LEN = 8, 112


def _prompts(vocab):
    rng = np.random.default_rng(4)
    prompts = [[int(t) for t in rng.integers(2, vocab, n)]
               for n in (70, 83, 66, 9)]
    prompts[1][:2 * PAGE] = prompts[0][:2 * PAGE]       # two shared pages
    return prompts


@pytest.mark.parametrize("policy", ["fused", "unfused-kernel"])
def test_paged_engine_tokens_match_reference(policy):
    ref_cfg = ref_reduced(ARCH)
    ref = ref_build(ref_cfg, RefPar(remat="none", **POLICIES[policy]))
    ref_params = ref.init_params(jax.random.PRNGKey(0))
    port = build_model(port_config(ref_cfg),
                       ParallelConfig(**POLICIES[policy]), device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), "cpu")
    serve = dict(batch_slots=2, max_seq_len=MAX_LEN, eos_id=-1,
                 page_size=PAGE)
    prompts = _prompts(ref_cfg.vocab_size)
    news = [6, 5, 7, 4]
    ref_eng = RefEngine(ref, ref_params, RefServe(**serve))
    eng = BatchedEngine(port, params, ServeConfig(**serve))
    want = ref_eng.run([RefRequest(rid=i, prompt=list(p), max_new_tokens=m)
                        for i, (p, m) in enumerate(zip(prompts, news))])
    got = eng.run([Request(rid=i, prompt=list(p), max_new_tokens=m)
                   for i, (p, m) in enumerate(zip(prompts, news))])
    assert {r.rid: r.generated for r in got} == \
        {r.rid: r.generated for r in want}
    assert all(r.done and len(r.generated) == m for r, m in zip(got, news))
    assert eng.pool.shared_hits == ref_eng.pool.shared_hits == 2
    assert eng.tick_count == ref_eng.tick_count
    assert eng.tick_stats == ref_eng.tick_stats
