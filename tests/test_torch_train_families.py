"""tests/test_torch_train_model.py's loss, gradient and remat checks for
the reduced SSM (mamba2-2.7b), hybrid (zamba2-1.2b) and encoder-decoder
(whisper-base) architectures, in a file of their own to keep each file's
time short.  The JAX package remats these families under ``"full"``
alone; the port's ``"dots"`` is then a plain call, bitwise the same."""
import pytest

from test_torch_train_model import (TRANSFORMERS, check_grads, check_loss,
                                    check_remat)

from repro_torch.configs import ARCHS, get_reduced

OTHERS = tuple(a for a in ARCHS if a not in TRANSFORMERS)


def test_every_family_is_covered():
    assert sorted(get_reduced(a).family for a in OTHERS) == [
        "encdec", "hybrid", "ssm"]


@pytest.mark.parametrize("arch", OTHERS)
def test_loss_fn_matches_reference(arch):
    check_loss(arch)


@pytest.mark.parametrize("arch", OTHERS)
def test_grads_match_reference(arch):
    check_grads(arch)


@pytest.mark.parametrize("arch", OTHERS)
def test_remat_modes_are_bitwise_equal(arch):
    check_remat(arch)
