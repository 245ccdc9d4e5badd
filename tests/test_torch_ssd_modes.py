"""The abstract and abstract+shuffle lowerings of the SSD kernels (ssd_scan,
ssd_decode) against the JAX package's Pallas lowerings of the same mode in
interpret mode, and the two ops' registry rows, contracts and declared
fallbacks.

The same numpy inputs go to both sides, in f32.  The scan compares at
``TOLERANCES["f32_accum"]`` (a sequential f32 carry whose per-chunk order
differs: the port's abstract+shuffle prefix sum runs one warp over the
chunk, 8 positions a lane, where the JAX kernel runs Hillis-Steele stages
over the whole lane row), the one-token decode at ``TOLERANCES["f32"]``
(the port's N-in-lanes readout folds N to 32 lanes before its tree, the
JAX kernel's tree spans all N lanes).  On CPU tensors each mode's wrapper
runs the plain version of that mode."""
import functools

import numpy as np
import pytest
import torch

from conftest import tolerance_for
from repro.core.registry import REGISTRY as REF_REGISTRY
from repro.core.registry import ExecutionPolicy as RefPolicy
from repro.kernels import ops as ref_ops
from test_torch_ssd import _close, _j, _scan_inputs, _t

from repro_torch.core import REGISTRY, ExecutionPolicy, IsaMode
from repro_torch.core.registry import LoweringFallbackWarning, \
    UnsupportedLowering
from repro_torch.kernels import ops, ssd
from repro_torch.kernels._launch import LAUNCHES

ACCUM = tolerance_for("f32_accum")
F32 = tolerance_for("f32")
MODES = ("abstract", "abstract+shuffle")
B, H, P, N, CHUNK = 2, 4, 16, 16, 16


def _decode_inputs(seed, b, g, h, n, p):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, g, h // g, n, p)).astype(np.float32),
            rng.standard_normal((b, h, p)).astype(np.float32),
            np.log1p(np.exp(rng.standard_normal((b, h)) - 2.0)
                     ).astype(np.float32),
            -np.exp(rng.uniform(0.0, np.log(16.0), h)).astype(np.float32),
            rng.standard_normal((b, g, n)).astype(np.float32),
            rng.standard_normal((b, g, n)).astype(np.float32))


# ---------------------------------------------------------------------------
# the kernels' plain versions against the JAX lowerings of the same mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("init", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("l", [16, 37, 64])
@pytest.mark.parametrize("g", [1, 2])
def test_scan_matches_jax_mode(g, l, init, mode):
    x, dt, A, Bm, Cm, h0 = _scan_inputs(3 * l + g, B, l, H, P, g, N, init)
    args = [_t(a) for a in (x, dt, A, Bm, Cm)]
    want_y, want_state = ref_ops.fused_ssd_scan(
        _j(x), _j(dt), _j(A), _j(Bm), _j(Cm), chunk=CHUNK,
        initial_state=_j(h0), mode=mode)
    got = ssd.ssd_scan_plain(*args, _t(h0), chunk=CHUNK, mode=mode)
    assert got[0].shape == (B, l, H, P) and got[1].dtype == torch.float32
    for y, state in (got,
                     ssd.ssd_scan(*args, _t(h0), chunk=CHUNK, mode=mode),
                     ops.fused_ssd_scan(*args, chunk=CHUNK,
                                        initial_state=_t(h0), mode=mode)):
        _close(y, want_y, ACCUM)
        _close(state, want_state, ACCUM)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("g,n,p", [(1, 16, 16), (2, 16, 16), (1, 64, 8),
                                   (1, 128, 64), (1, 4, 12)])
def test_decode_matches_jax_mode(g, n, p, mode):
    """An odd batch of 3; N = 16 (the reduced config's, narrower than a
    warp: 16-lane groups), 64 (two rows a lane), 128 (mamba2-2.7b's) and 4
    (4-lane groups; P = 12, three column quads)."""
    args = _decode_inputs(n + g, 3, g, H, n, p)
    want_state, want_y = ref_ops.fused_ssd_decode(*[_j(a) for a in args],
                                                  mode=mode)
    new, y = ssd.ssd_decode_plain(*[_t(a) for a in args], mode=mode)
    assert new.shape == (3, g, H // g, n, p) and y.shape == (3, H, p)
    _close(new, want_state, F32)
    _close(y, want_y, F32)
    # the wrapper and the registry's row, into ``out``: an update in place
    st = _t(args[0].copy())
    same, y2 = ops.fused_ssd_decode(st, *[_t(a) for a in args[1:]], out=st,
                                    mode=mode)
    assert same is st and torch.equal(st, new) and torch.equal(y2, y)


@pytest.mark.parametrize("n,p", [(128, 64), (4, 12)])
def test_native_decode_matches_jax_at_the_edge_widths(n, p):
    """native's plain decode against JAX ``fused_ssd_decode`` (native) at
    mamba2-2.7b's state width (2 slots x 4 heads) and the narrowest the
    kernel's staged tile takes (N = 4, P = 12), at ``TOLERANCES["f32"]``
    (the einsum's sum over N against the Pallas kernel's)."""
    args = _decode_inputs(n + p, 2, 1, H, n, p)
    want_state, want_y = ref_ops.fused_ssd_decode(*[_j(a) for a in args],
                                                  mode="native")
    new, y = ssd.ssd_decode_plain(*[_t(a) for a in args], mode="native")
    _close(new, want_state, F32)
    _close(y, want_y, F32)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("q", [1, 7, 32, 100, 256])
def test_prefix_sum_of_each_mode_is_the_cumsum(mode, q):
    """Each mode's prefix sum over chunks of 1 to 256 positions (the
    abstract+shuffle warp holds 8 a lane, so 1 and 7 stay in lane 0 and 100
    ends inside lane 12) against torch.cumsum, and the readout of each mode
    against the einsum."""
    rng = np.random.default_rng(q)
    dA = torch.from_numpy(-np.abs(rng.standard_normal((2, 3, q, 2, 2)))
                          .astype(np.float32) * 0.1)
    torch.testing.assert_close(ssd.prefix_sum(dA, mode),
                               torch.cumsum(dA, dim=2), **ACCUM)
    C = torch.from_numpy(rng.standard_normal((2, 1, 32)).astype(np.float32))
    state = torch.from_numpy(rng.standard_normal((2, 1, 3, 32, 8))
                             .astype(np.float32))
    torch.testing.assert_close(ssd.readout(C, state, mode),
                               torch.einsum("bgn,bghnp->bghp", C, state),
                               **F32)


def test_modes_change_only_the_cross_lane_stage():
    """The three modes agree to f32 rounding and differ only in the order
    of the prefix sum's and the readout's adds."""
    x, dt, A, Bm, Cm, h0 = _scan_inputs(9, B, 70, H, P, 2, N, True)
    args = [_t(a) for a in (x, dt, A, Bm, Cm, h0)]
    native = ssd.ssd_scan_plain(*args, chunk=32)
    for mode in MODES:
        for got, want in zip(ssd.ssd_scan_plain(*args, chunk=32, mode=mode),
                             native):
            torch.testing.assert_close(got, want, **ACCUM)


def test_wrappers_run_the_plain_versions_on_cpu():
    x, dt, A, Bm, Cm, h0 = _scan_inputs(2, B, 37, H, P, 2, N, True)
    args = [_t(a) for a in (x, dt, A, Bm, Cm)]
    dec = [_t(a) for a in _decode_inputs(4, 3, 2, H, N, P)]
    before = dict(LAUNCHES)
    for mode in MODES:
        y, state = ssd.ssd_scan(*args, _t(h0), chunk=CHUNK, mode=mode)
        y_p, state_p = ssd.ssd_scan_plain(*args, _t(h0), chunk=CHUNK,
                                          mode=mode)
        assert torch.equal(y, y_p) and torch.equal(state, state_p)
        new, yd = ssd.ssd_decode(*dec, mode=mode)
        new_p, yd_p = ssd.ssd_decode_plain(*dec, mode=mode)
        assert torch.equal(new, new_p) and torch.equal(yd, yd_p)
    assert LAUNCHES == before                 # no kernel ran
    for mode in MODES:
        assert LAUNCHES[f"ssd_scan_{mode}"] == 0
        assert LAUNCHES[f"ssd_decode_{mode}"] == 0


@pytest.mark.parametrize("mode", MODES)
def test_a_state_width_off_the_power_of_two_raises_outside_native(mode):
    """The readout's trees need N a power of two, as the JAX package's
    fused_ssd_decode says; native sums any N."""
    dec = [_t(a) for a in _decode_inputs(5, 2, 1, H, 12, 8)]
    with pytest.raises(ValueError, match="power-of-two"):
        ssd.ssd_decode_plain(*dec, mode=mode)
    with pytest.raises(ValueError, match="power-of-two"):
        ops.fused_ssd_decode(*dec, mode=mode)
    new, y = ssd.ssd_decode(*dec)
    assert y.shape == (2, H, 8)
    with pytest.raises(ValueError, match="mode must be one of"):
        ssd.ssd_decode_plain(*dec, mode="library")


# ---------------------------------------------------------------------------
# registry rows, contracts, fallbacks
# ---------------------------------------------------------------------------

_WRAPPERS = {"ssd_scan": ssd.ssd_scan, "ssd_decode": ssd.ssd_decode}


@pytest.mark.parametrize("op", ssd.OPS)
def test_mode_rows_and_contracts_match_jax(op):
    assert REGISTRY.modes(op) == REF_REGISTRY.modes(op) == (
        "abstract", "abstract+shuffle", "native", "library")
    for mode in MODES + ("native",):
        low = REGISTRY.select(op, ExecutionPolicy(mode=mode))
        want = REF_REGISTRY.select(op, RefPolicy(mode=mode))
        assert low.mode is IsaMode(mode)
        if mode == "native":
            assert low.impl is _WRAPPERS[op]
            assert low.target == "nvidia-hopper-sm90"   # pinned to Hopper
        else:
            assert low.target is None
            assert isinstance(low.impl, functools.partial)
            assert low.impl.func is _WRAPPERS[op]
            assert low.impl.keywords == {"mode": mode}
        assert low.contract.kernel == want.contract.kernel == op
        assert low.contract.mode.value == want.contract.mode.value == mode
        assert {p.name for p in low.contract.primitives} == \
            {p.name for p in want.contract.primitives}
        assert low.contract.native_features == want.contract.native_features
    assert REGISTRY.select(op, ExecutionPolicy(mode="library")).impl is \
        {"ssd_scan": ssd.ssd_scan_plain,
         "ssd_decode": ssd.ssd_decode_plain}[op]


@pytest.mark.parametrize("op", ssd.OPS)
def test_shuffle_fallback_is_declared_as_in_jax(op):
    """Without lane shuffles abstract+shuffle degrades to abstract, on
    both sides, for CPU operands; on the card no fallback is taken."""
    pol = ExecutionPolicy(mode="abstract+shuffle", dialect="uisa-universal10")
    ref_pol = RefPolicy(mode="abstract+shuffle", dialect="uisa-universal10")
    with pytest.warns(LoweringFallbackWarning):
        low = REGISTRY.select(op, pol, device="cpu")
    with pytest.warns(Warning):
        want = REF_REGISTRY.select(op, ref_pol)
    assert low.mode is IsaMode.ABSTRACT and want.mode.value == "abstract"
    assert low.impl.keywords == {"mode": "abstract"}
    with pytest.raises(UnsupportedLowering, match="on the card"):
        REGISTRY.select(op, pol, device=torch.device("cuda", 0))


def test_shuffle_fallback_runs_the_abstract_plain_version():
    """Through ops under the no-shuffle dialect the scan takes the abstract
    row: the abstract plain version's result, bit for bit."""
    x, dt, A, Bm, Cm, _ = _scan_inputs(6, 1, 40, H, P, 1, N, False)
    args = [_t(a) for a in (x, dt, A, Bm, Cm)]
    pol = ExecutionPolicy(mode="abstract+shuffle", dialect="uisa-universal10")
    with pytest.warns(LoweringFallbackWarning):
        y, state = ops.fused_ssd_scan(*args, chunk=16, policy=pol)
    y_a, state_a = ssd.ssd_scan_plain(*args, chunk=16, mode="abstract")
    assert torch.equal(y, y_a) and torch.equal(state, state_a)
