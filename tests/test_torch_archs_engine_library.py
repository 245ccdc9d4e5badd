"""tests/test_torch_archs_engine.py's engine comparison under the library
policy (``ParallelConfig()``: the plain chunked prefill attention and
norms, no kernel): the port's BatchedEngine against the JAX package's,
token for token, on qwen3-32b, mistral-nemo-12b, mistral-large-123b and
llama4-scout-17b-16e reduced, dense and paged at 8 keys a page."""
import pytest

from test_torch_archs import DENSE
from test_torch_archs_engine import engine_tokens_match_reference


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("arch", DENSE)
def test_engine_tokens_match_reference(arch, paged):
    engine_tokens_match_reference(arch, "library", paged)
