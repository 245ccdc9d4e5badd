"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests run on the real
single CPU device; only launch/dryrun.py forces 512 placeholder devices.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running test (deselect with -m 'not slow')")
    config.addinivalue_line("markers", "gpu: needs a CUDA card (skips without one)")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True, scope="module")
def _bound_jit_memory_per_module():
    """Drop XLA's compiled-executable caches once a module finishes.

    The full suite compiles hundreds of distinct programs in one
    process; letting every executable stay resident can segfault the
    CPU backend's JIT late in the run.  Compiled programs are never
    shared across test modules (each builds its own tiny models), so
    clearing between modules costs nothing but the crash."""
    yield
    jax.clear_caches()


#: Shared per-precision numeric tolerance policy (ISSUE 7): every suite
#: that checks a lowering against the f32 library reference draws its
#: bounds from this one table instead of ad-hoc per-test constants.
#: ``None``/"f32" is the f32-kernel-vs-f32-library bound (accumulation
#: order only).  "int8" bounds quantized rows against the *f32*
#: reference: per-output-channel symmetric int8 carries ~0.4-1.7% max
#: relative error at conformance shapes (measured across all three
#: quantized fused ops, dense/decode/paged), so 2e-2 relative — plus an
#: absolute leg for elements crossing zero, because quantization error
#: is proportional to the quantized channel's *dynamic range*, not the
#: element's magnitude.  The atol leg therefore scales with the
#: reference tensor: ``atol_scale x max|ref|`` when the reference is
#: supplied (swiglu compounds two quantized projections, so its error
#: tracks the O(100) intermediates; a flat constant would either fail
#: it or be vacuous for O(1) weight round-trips), falling back to the
#: flat ``atol`` when it is not.
TOLERANCES = {
    None: dict(rtol=2e-4, atol=2e-4),
    "f32": dict(rtol=2e-4, atol=2e-4),
    #: sequential f32-accumulator kernels (ISSUE 8: the fused SSD scan
    #: carries its [N,P] state in VMEM across every chunk step): both
    #: sides accumulate in f32, but the kernel's per-chunk dot order and
    #: exp(decay) association differ from the jnp chunk path, and the
    #: drift compounds with sequence length rather than staying at the
    #: single-reduction bound above.
    "f32_accum": dict(rtol=1e-3, atol=1e-3),
    "int8": dict(rtol=2e-2, atol=2e-2, atol_scale=2e-1),
}


def tolerance_for(precision=None, ref=None) -> dict:
    """The atol/rtol kwargs the given ExecutionPolicy precision earns.

    ``ref`` (the comparison's reference tensor, or any leaf sequence of
    them) widens range-relative precisions' atol to
    ``atol_scale x max|ref|``."""
    tol = dict(TOLERANCES[precision])
    scale = tol.pop("atol_scale", None)
    if scale is not None and ref is not None:
        leaves = jax.tree.leaves(ref)
        ref_max = max((float(np.max(np.abs(np.asarray(l, np.float32))))
                       for l in leaves if np.asarray(l).size), default=0.0)
        tol["atol"] = max(tol["atol"], scale * ref_max)
    return tol


def assert_allclose(a, b, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32),
                               rtol=rtol, atol=atol)


def assert_close_for(a, b, precision=None):
    """assert_allclose at the shared tolerance policy's bounds (``b`` is
    the reference and anchors any range-relative atol)."""
    tol = tolerance_for(precision, ref=b)
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **tol)
