"""The port's BatchedEngine against the JAX package's, token for token, on
the dense family's reduced configs that this slice adds (qwen3-32b,
mistral-nemo-12b, mistral-large-123b, llama4-scout-17b-16e) under the
fused and the library policy, with dense caches and paged at 8 keys a page
(two requests sharing a full prompt page, more requests than slots).  Both
sides get the reference's parameters, in f32; the JAX side runs its Pallas
kernels in interpret mode.  tests/test_torch_archs.py holds the same
models' logits and caches to ``TOLERANCES["f32"]``."""
import numpy as np
import pytest

from repro.serve import BatchedEngine as RefEngine
from repro.serve import Request as RefRequest
from repro.serve import ServeConfig as RefServe
from test_torch_archs import DENSE, _models

from repro_torch.serve import BatchedEngine, Request, ServeConfig

PAGE, MAX_LEN = 8, 40
NEWS = (6, 5, 7, 4)


def _prompts(vocab):
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(2, vocab, n)]
               for n in (12, 17, 5, 9)]
    prompts[1][:PAGE] = prompts[0][:PAGE]              # one shared page
    return prompts


def engine_tokens_match_reference(arch, policy, paged):
    ref, port, ref_params, params = _models(arch, policy)
    serve = dict(batch_slots=2, max_seq_len=MAX_LEN, eos_id=-1,
                 page_size=PAGE if paged else None)
    prompts = _prompts(port.cfg.vocab_size)
    ref_eng = RefEngine(ref, ref_params, RefServe(**serve))
    eng = BatchedEngine(port, params, ServeConfig(**serve))
    want = ref_eng.run([RefRequest(rid=i, prompt=list(p), max_new_tokens=m)
                        for i, (p, m) in enumerate(zip(prompts, NEWS))])
    got = eng.run([Request(rid=i, prompt=list(p), max_new_tokens=m)
                   for i, (p, m) in enumerate(zip(prompts, NEWS))])
    assert {r.rid: r.generated for r in got} == \
        {r.rid: r.generated for r in want}
    assert all(r.done and len(r.generated) == m for r, m in zip(got, NEWS))
    assert eng.tick_count == ref_eng.tick_count
    if paged:
        assert eng.pool.shared_hits == ref_eng.pool.shared_hits == 1


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("arch", DENSE)
def test_engine_tokens_match_reference(arch, paged):
    engine_tokens_match_reference(arch, "fused", paged)
