"""Every structural cost model of the port against the JAX package's: each
function in every mode the JAX package registers, at each ``PROBE_SHAPES``
and ``CANONICAL_SHAPES`` row, on the six reference dialects, at the JAX
package's compile target (``target=TPU_V5E``), key for key: ints exact,
floats within 1e-12 relative.  At the port's own target (Hopper) the same
formulas give Hopper's numbers, some of which are pinned here, and Table
V's structural half equals the JAX module's at the JAX target."""
import contextlib
import io
import itertools

import pytest
import torch

from benchmarks import tablev as ref_tablev
from repro.core import REGISTRY as REF_REGISTRY
from repro.core import dialect as ref_dialect
from repro.core import tuning as ref_tuning
from repro.kernels import ops as ref_ops

from repro_torch.benchmarks import tablev
from repro_torch.core import DIALECTS, REGISTRY, TARGET, TPU_V5E
from repro_torch.kernels import gemm, ops

SHARED = sorted(ref_dialect.DIALECTS)
#: the fields a canonical row (a tuning bucket's shape) leaves to the op
CANONICAL_EXTRA = {
    "flash_attention": dict(b=1, h=4, causal=True),
    "flash_attention_matmul": dict(b=1, h=4, causal=True),
    "flash_attention_matmul_q8": dict(b=1, h=4, causal=True),
    "ssd_scan": dict(b=1, h=8, g=1),
    "ssd_decode": dict(h=8, g=1),
}
#: shapes beyond the two tables: dtypes, odd sizes, pinned blocks, pages
EXTRA_SHAPES = {
    "gemm": [dict(m=300, n=700, k=65, dtype=torch.bfloat16)],
    "rmsnorm": [dict(rows=7, d=1539, dtype=torch.bfloat16)],
    "rmsnorm_matmul": [dict(rows=8, d=4096, n=6144, dtype=torch.bfloat16)],
    "rmsnorm_matmul_q8": [dict(rows=8, d=4096, n=49152)],
    "rmsnorm_swiglu": [dict(rows=512, d=4096, f=14336)],
    "add_rmsnorm": [dict(rows=3, d=100)],
    "flash_attention": [dict(b=2, h=8, sq=300, skv=700, d=128, causal=True,
                             block_q=128, block_kv=None)],
    "flash_attention_matmul": [
        dict(b=8, h=32, sq=1, skv=640, d=128, n=4096, causal=False,
             block_q=None, block_kv=128, page_size=128, pages_occupied=40),
        dict(b=1, h=32, sq=512, skv=512, d=128, n=4096, causal=True,
             dtype=torch.bfloat16)],
    "flash_attention_matmul_q8": [
        dict(b=4, h=8, sq=1, skv=1024, d=64, n=512, causal=False,
             page_size=128, pages_occupied=11)],
    "ssd_scan": [dict(b=2, seq=300, h=80, p=64, g=1, n=128, chunk=256,
                      dtype=torch.bfloat16)],
    "ssd_decode": [dict(b=3, h=6, p=32, g=2, n=16, block_b=2)],
}


def _rows(op):
    out = [dict(ops.PROBE_SHAPES[op])]
    out += [{**CANONICAL_EXTRA.get(op, {}), **r}
            for r in ref_tuning.CANONICAL_SHAPES.get(op, [])]
    return out + EXTRA_SHAPES.get(op, [])


def _jax_shape(shape):
    """The same shape with the dtype the JAX model reads."""
    import jax.numpy as jnp
    if "dtype" not in shape:
        return shape
    return dict(shape, dtype={torch.bfloat16: jnp.bfloat16,
                              torch.float32: jnp.float32}[shape["dtype"]])


def _assert_equal(got, want, what):
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for key, w in want.items():
        g = got[key]
        if isinstance(w, float):
            assert abs(g - w) <= 1e-12 * max(1.0, abs(w)), (what, key, g, w)
        else:
            assert g == w and type(g) is type(w), (what, key, g, w)


CASES = [(op, mode) for op in sorted(ops.STRUCTURAL_COSTS)
         for mode in REF_REGISTRY.modes(op)]


def test_cost_tables_name_the_reference_ops():
    assert set(ops.STRUCTURAL_COSTS) == {
        op for op in ref_ops.STRUCTURAL_COSTS if not op.endswith("_tp")}
    assert ops.PROBE_SHAPES == {k: v for k, v in ref_ops.PROBE_SHAPES.items()
                                if not k.endswith("_tp")}
    for op in ops.STRUCTURAL_COSTS:
        assert REGISTRY.modes(op) == REF_REGISTRY.modes(op), op


@pytest.mark.parametrize("op,mode", CASES)
def test_cost_equals_reference_at_its_target(op, mode):
    """The registered cost of (op, mode) and the module function behind
    it both equal the JAX package's, on every reference dialect's tuning
    slice."""
    fn = ops.STRUCTURAL_COSTS[op]
    ref_fn = ref_ops.STRUCTURAL_COSTS[op]
    for name, shape in itertools.product(SHARED, _rows(op)):
        want = ref_fn(mode=mode, plan_dialect=name, **_jax_shape(shape))
        got = fn(mode=mode, plan_dialect=name, target=TPU_V5E, **shape)
        _assert_equal(got, want, (op, mode, name, shape))
        low = REGISTRY.variant(op, mode)
        _assert_equal(low.structural_cost(plan_dialect=name, target=TPU_V5E,
                                          **shape), want, (op, mode, name))


@pytest.mark.parametrize("op,mode", CASES)
def test_fused_identity_on_hopper(op, mode):
    """At the port's own target the models keep the JAX identities: the
    fused bytes are the unfused pair less the saving, which only the
    library row forgoes; scratch is spent by the abstract tree alone."""
    for name, shape in itertools.product(sorted(DIALECTS), _rows(op)):
        c = REGISTRY.variant(op, mode).structural_cost(plan_dialect=name,
                                                       **shape)
        if "hbm_bytes_unfused_pair" in c:
            assert c["hbm_bytes"] == c["hbm_bytes_unfused_pair"] \
                - c["hbm_bytes_saved"]
            assert (c["hbm_bytes_saved"] == 0) == (mode == "library")
        assert (c.get("scratch_bytes_total", 0) > 0) == (
            mode == "abstract" and op != "gemm"), (op, mode, name)
        if mode == "abstract+shuffle":
            assert c["lane_shuffles_per_block"] > 0


def test_hopper_numbers_from_the_same_formulas():
    # the GEMM rules on Hopper's matrix unit and 227 KB
    assert gemm.modeled_abstract_block_shape() == (128, 128, 128)
    assert gemm.modeled_native_block_shape() == (256, 1024, 32)
    assert gemm.modeled_native_block_shape(target=TPU_V5E) == (512, 512, 256)
    big = gemm.structural_cost(4096, 4096, 4096, "native",
                               plan_dialect="amd-rdna3")
    assert big["block"] == (256, 1024, 32) and not big["mxu_aligned"]
    # log2(32) = 5 round trips a block at Hopper's warp, 7 at 128 lanes
    red = ops.STRUCTURAL_COSTS["reduction"]
    assert red(1 << 24, "abstract")["scratch_round_trips_per_block"] == 5
    assert red(1 << 24, "abstract", plan_dialect="tpu-v5e",
               target=TPU_V5E)["scratch_round_trips_per_block"] == 7
    # the canonical Hopper bucket's table entry drives the plan
    assert red(1 << 21, "abstract")["block_rows"] == 256
    ssd = ops.STRUCTURAL_COSTS["ssd_scan"]
    assert ssd(1, 1024, 8, 64, 1, 128, "abstract+shuffle")["chunk"] == 64


def test_tablev_structural_equals_reference():
    with contextlib.redirect_stdout(io.StringIO()):
        want = ref_tablev.structural_tables()
    got = tablev.structural_tables(TPU_V5E, log=lambda *a: None)
    assert set(got) == set(want)
    for key in want:
        _assert_equal(got[key], want[key], key)


def test_tablev_structural_on_hopper():
    lines = []
    got = tablev.structural_tables(log=lines.append)
    assert got["gemm_native"]["block"] == (256, 1024, 32)
    assert got["reduction_abstract"]["scratch_round_trips_per_block"] == 5
    assert got["reduction_abstract+shuffle"]["lane_shuffles_per_block"] == 5
    assert got["histogram_abstract"]["scratch_round_trips_per_block"] > 0
    assert got["attention_native"]["skip_fraction"] > 0.45
    assert any(TARGET.name in line for line in lines)
    assert tablev.model_round_trips("reduction", "abstract") == 5
    assert tablev.model_round_trips("histogram", "native") == 0
    assert tablev.model_round_trips("gemm", "native") is None


def test_run_op_dispatches_by_name():
    x = torch.arange(100, dtype=torch.float32)
    got = ops.run_op("reduction", x, mode="auto")
    assert float(got) == float(x.sum())
    a = torch.ones(4, 8)
    b = torch.ones(8, 3)
    assert torch.equal(ops.run_op("gemm", a, b, mode="native"),
                       torch.full((4, 3), 8.0))
