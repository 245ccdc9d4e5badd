"""The port's SSD kernels module against the JAX package's, on the CPU.

The same numpy inputs go through the port's plain versions and through the
JAX package's native Pallas kernels (interpret mode, as its own tests run
them) and its jnp references.  The scan compares at
``TOLERANCES["f32_accum"]`` (a sequential f32 carry whose per-chunk order
differs between the two), the one-token decode at ``TOLERANCES["f32"]``.
On CPU tensors the port's native wrappers run the plain versions."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tolerance_for
from repro.kernels import ops as ref_ops
from repro.kernels.ssd import ssd_decode_reference, ssd_scan_reference

from repro_torch.core import ExecutionPolicy
from repro_torch.core.registry import LoweringFallbackWarning
from repro_torch.kernels import ops, ssd
from repro_torch.kernels._launch import LAUNCHES

ACCUM = tolerance_for("f32_accum")
F32 = tolerance_for("f32")
B, H, P, N, CHUNK = 2, 4, 16, 16, 16


def _scan_inputs(seed, b, l, h, p, g, n, init):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)) - 2.0)
                  ).astype(np.float32)
    A = -np.exp(rng.uniform(0.0, np.log(16.0), h)).astype(np.float32)
    Bm = (rng.standard_normal((b, l, g, n)) * n ** -0.25).astype(np.float32)
    Cm = (rng.standard_normal((b, l, g, n)) * n ** -0.25).astype(np.float32)
    h0 = (rng.standard_normal((b, g, h // g, n, p)).astype(np.float32)
          if init else None)
    return x, dt, A, Bm, Cm, h0


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("init", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("l", [16, 37, 64])
@pytest.mark.parametrize("g", [1, 2])
def test_scan_plain_matches_jax_kernel_and_reference(g, l, init):
    x, dt, A, Bm, Cm, h0 = _scan_inputs(l + g, B, l, H, P, g, N, init)
    y, state = ssd.ssd_scan_plain(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm),
                                  _t(h0), chunk=CHUNK)
    y_k, state_k = ref_ops.fused_ssd_scan(
        _j(x), _j(dt), _j(A), _j(Bm), _j(Cm), chunk=CHUNK,
        initial_state=_j(h0), mode="native")
    y_r, state_r = ssd_scan_reference(_j(x), _j(dt), _j(A), _j(Bm), _j(Cm),
                                      CHUNK, initial_state=_j(h0))
    assert y.shape == (B, l, H, P) and state.shape == (B, g, H // g, N, P)
    assert state.dtype == torch.float32
    for want_y, want_state in ((y_k, state_k), (y_r, state_r)):
        _close(y, want_y, ACCUM)
        _close(state, want_state, ACCUM)


def test_scan_chunk_clamps_to_the_sequence():
    """An explicit chunk longer than L clamps to L (one chunk), as the JAX
    package's resolve_chunk does."""
    x, dt, A, Bm, Cm, _ = _scan_inputs(5, 1, 12, H, P, 1, N, False)
    args = [_t(a) for a in (x, dt, A, Bm, Cm)]
    y_long, s_long = ssd.ssd_scan_plain(*args, chunk=256)
    y_one, s_one = ssd.ssd_scan_plain(*args, chunk=12)
    assert torch.equal(y_long, y_one) and torch.equal(s_long, s_one)
    assert ssd.resolve_chunk(12, 256) == 12 and ssd.resolve_chunk(300, 256) \
        == 256


@pytest.mark.parametrize("g", [1, 2])
def test_decode_plain_matches_jax_kernel_and_reference(g):
    rng = np.random.default_rng(g)
    b = 3
    state = rng.standard_normal((b, g, H // g, N, P)).astype(np.float32)
    x = rng.standard_normal((b, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, H)) - 2.0)
                  ).astype(np.float32)
    A = -np.exp(rng.uniform(0.0, np.log(16.0), H)).astype(np.float32)
    Bt = rng.standard_normal((b, g, N)).astype(np.float32)
    Ct = rng.standard_normal((b, g, N)).astype(np.float32)
    args = (state, x, dt, A, Bt, Ct)
    new, y = ssd.ssd_decode_plain(*[_t(a) for a in args])
    new_k, y_k = ref_ops.fused_ssd_decode(*[_j(a) for a in args],
                                          mode="native")
    new_r, y_r = ssd_decode_reference(*[_j(a) for a in args])
    for want_state, want_y in ((new_k, y_k), (new_r, y_r)):
        _close(new, want_state, F32)
        _close(y, want_y, F32)
    # into ``out``, here the state itself: an update in place
    st = _t(state.copy())
    same, y2 = ssd.ssd_decode_plain(st, *[_t(a) for a in args[1:]], out=st)
    assert same is st and torch.equal(st, new) and torch.equal(y2, y)


def test_scan_then_decode_continues_the_sequence():
    """Scanning L tokens and then decoding token L+1 gives the scan's own
    output at L+1 and its final state (the prefill -> decode handoff)."""
    x, dt, A, Bm, Cm, _ = _scan_inputs(11, B, 21, H, P, 2, N, False)
    full = [_t(a) for a in (x, dt, A, Bm, Cm)]
    y_all, state_all = ssd.ssd_scan_plain(*full, chunk=8)
    head = [_t(a[:, :20]) if a.ndim > 1 else _t(a)
            for a in (x, dt, A, Bm, Cm)]
    _, state = ssd.ssd_scan_plain(*head, chunk=8)
    new, y = ssd.ssd_decode_plain(state, _t(x[:, 20]), _t(dt[:, 20]),
                                  _t(A), _t(Bm[:, 20]), _t(Cm[:, 20]))
    _close(y, y_all[:, 20].numpy(), ACCUM)
    _close(new, state_all.numpy(), ACCUM)


def test_native_wrappers_run_the_plain_versions_on_cpu():
    x, dt, A, Bm, Cm, h0 = _scan_inputs(2, B, 37, H, P, 2, N, True)
    args = [_t(a) for a in (x, dt, A, Bm, Cm)]
    before = dict(LAUNCHES)
    y, state = ops.fused_ssd_scan(*args, chunk=CHUNK, initial_state=_t(h0),
                                  mode="native")
    y_p, state_p = ssd.ssd_scan_plain(*args, _t(h0), chunk=CHUNK)
    assert torch.equal(y, y_p) and torch.equal(state, state_p)
    st = state.clone()
    new, yd = ops.fused_ssd_decode(st, args[0][:, 0], args[1][:, 0], args[2],
                                   args[3][:, 0], args[4][:, 0], out=st,
                                   mode="native")
    new_p, yd_p = ssd.ssd_decode_plain(state, args[0][:, 0], args[1][:, 0],
                                       args[2], args[3][:, 0], args[4][:, 0])
    assert new is st and torch.equal(new, new_p) and torch.equal(yd, yd_p)
    assert LAUNCHES == before                 # no kernel ran
    # chunk=None resolves the tuned chunk (the table, else the first
    # candidate) instead of raising; both paths agree on it
    q = ssd.resolve_chunk(37, None, mode="native", p=P, n=N)
    y_t, s_t = ops.fused_ssd_scan(*args, mode="native")
    y_q, s_q = ssd.ssd_scan_plain(*args, chunk=q)
    assert torch.equal(y_t, y_q) and torch.equal(s_t, s_q)
    y_n, s_n = ssd.ssd_scan(*args, chunk=None)
    assert torch.equal(y_n, y_q) and torch.equal(s_n, s_q)
    assert LAUNCHES == before                 # still no kernel ran


def test_registry_rows_and_foreign_dialect_on_cpu():
    """Every lowering of the JAX package is registered (the abstract pair
    since the SSD modes were ported, tests/test_torch_ssd_modes.py); a
    foreign-dialect native request takes the declared fallback (warned)
    for CPU operands (on the card it raises, see test_torch_gpu.py)."""
    from repro_torch.core import REGISTRY, IsaMode
    for op in ("ssd_scan", "ssd_decode"):
        assert REGISTRY.modes(op) == ("abstract", "abstract+shuffle",
                                      "native", "library")
        low = REGISTRY.select(op, ExecutionPolicy(mode="abstract"))
        assert low.mode is IsaMode.ABSTRACT
    x, dt, A, Bm, Cm, _ = _scan_inputs(4, 1, 8, H, P, 1, N, False)
    args = [_t(a) for a in (x, dt, A, Bm, Cm)]
    pol = ExecutionPolicy(mode="native", dialect="nvidia-ada-sm89")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        y, _ = ops.fused_ssd_scan(*args, chunk=4, policy=pol)
    assert any(issubclass(w.category, LoweringFallbackWarning)
               for w in caught)
    assert torch.equal(y, ssd.ssd_scan_plain(*args, chunk=4)[0])
