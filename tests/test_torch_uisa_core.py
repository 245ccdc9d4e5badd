"""The port's UISA core remainder against the JAX package's: the dialect
queries and the collective cost model, the primitive table, the execution
and memory models, the mapping reports and the pipeline plans.

Each result is compared with the JAX function's on the same inputs on all
seven dialects: the JAX functions read a dialect only through its fields
and methods, so the port's Hopper dialect is handed to them as well."""
import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dialect as ref_dialect
from repro.core import execution_model as ref_exec
from repro.core import mapping as ref_mapping
from repro.core import memory_model as ref_memory
from repro.core import pipeline as ref_pipeline
from repro.core import primitives as ref_primitives

from repro_torch.core import dialect, execution_model, mapping, memory_model
from repro_torch.core import pipeline, primitives
from repro_torch.core.dialect import DIALECTS, TARGET, TPU_V5E

NAMES = sorted(DIALECTS)                 # the six shared + Hopper
SHARED = sorted(ref_dialect.DIALECTS)


def _ref_dialect(name):
    """The JAX package's dialect of ``name``, or the port's Hopper (which
    the JAX functions read through the same fields)."""
    return ref_dialect.DIALECTS.get(name, DIALECTS[name])


# ---------------------------------------------------------------------------
# Dialects: queries, helpers, the collective cost model
# ---------------------------------------------------------------------------


QUERY_KEYS = ("W", "wave_widths", "R", "S", "F", "max_workgroup",
              "named_barriers", "native_fp64", "matrix_tile",
              "matrix_dtypes", "has_hw_atomics", "has_lane_shuffle",
              "memory_levels")


@pytest.mark.parametrize("name", SHARED)
def test_queries_equal_reference(name):
    got, ref = dialect.get_dialect(name), ref_dialect.get_dialect(name)
    for key in QUERY_KEYS:
        assert got.query(key) == ref.query(key), key
    with pytest.raises(KeyError):
        got.query("nonexistent")
    for size in (0, 1, 256, 257, 1024, 1025):
        assert got.validate_workgroup(size) == ref.validate_workgroup(size)
    for block, bufs in itertools.product((1, 4096, 1 << 20), (1, 2, 3, 4)):
        assert got.buffer_occupancy(block, bufs) == \
            ref.buffer_occupancy(block, bufs)
    with pytest.raises(ValueError):
        got.buffer_occupancy(0)


def test_hopper_queries():
    assert TARGET.query("W") == 32
    assert TARGET.query("matrix_tile") == (64, 256, 16)
    assert TARGET.query("S") == 232_448
    # Eq. 1 for buffers: two 58 KB stages double-buffered fill the 227 KB
    assert TARGET.buffer_occupancy(58_112, 2) == 2
    assert TARGET.buffer_occupancy(58_113, 2) == 1


def test_helpers_equal_reference():
    assert [d.name for d in dialect.gpu_dialects()] == \
        [d.name for d in ref_dialect.gpu_dialects()]
    for x, m in itertools.product((0, 1, 127, 128, 129, 1000), (1, 8, 128)):
        assert dialect.align_up(x, m) == ref_dialect.align_up(x, m)
    for name in SHARED:
        for dim in (1, 64, 100, 128, 300):
            assert dialect.mxu_align(dim, DIALECTS[name]) == \
                ref_dialect.mxu_align(dim, ref_dialect.DIALECTS[name])
    assert dialect.mxu_align(100) == 128          # Hopper's 64-row tile
    assert dialect.dtype_bytes(torch.bfloat16) == 2
    assert dialect.dtype_bytes("float32") == 4
    with pytest.raises(TypeError):
        dialect.dtype_bytes(np.float32)


KINDS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
         "permute")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", SHARED)
def test_collective_cost_equals_reference(kind, name):
    for group, payload in itertools.product(range(0, 9),
                                            (0, 1, 4096, 12_345_678)):
        got = dialect.collective_cost(kind, payload, group, DIALECTS[name])
        ref = ref_dialect.collective_cost(kind, payload, group,
                                          ref_dialect.DIALECTS[name])
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
        assert got.cost_keys() == ref.cost_keys()


def test_collective_cost_on_hopper_and_errors():
    one = dialect.collective_cost("all_reduce", 1 << 20, 1, TARGET)
    assert (one.wire_bytes, one.hops, one.hbm_equiv_bytes) == (0, 0, 0)
    eight = dialect.collective_cost("all_reduce", 1 << 20, 8, TARGET)
    assert eight.wire_bytes == 2 * (1 << 20) * 7 // 8 and eight.hops == 14
    # NVLink at 450 GB/s against 3.35 TB/s of HBM, plus 14 hops of 1 us
    want = eight.wire_bytes * 3.35e12 / 450e9 + 14 * 1e-6 * 3.35e12
    assert eight.hbm_equiv_bytes == int(np.ceil(want))
    apple = dialect.collective_cost("permute", 64, 2,
                                    DIALECTS["apple-g13"])
    assert apple.hbm_equiv_bytes == dialect.NO_INTERCONNECT_BYTES
    with pytest.raises(KeyError):
        dialect.collective_cost("broadcast", 1, 2, TARGET)


# ---------------------------------------------------------------------------
# Primitives: the Table II specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prim", list(primitives.Primitive),
                         ids=lambda p: p.name)
def test_specs_equal_reference(prim):
    got = primitives.SPECS[prim]
    ref = ref_primitives.SPECS[ref_primitives.Primitive(prim.value)]
    assert got.primitive is prim
    assert got.classification.value == ref.classification.value
    assert (got.rationale, got.vendor_realization, got.tpu_realization,
            got.tpu_direct) == (ref.rationale, ref.vendor_realization,
                                ref.tpu_realization, ref.tpu_direct)
    # Hopper's realization stands beside the JAX spec's NVIDIA entry
    assert "NVIDIA" in ref.vendor_realization and got.hopper_realization


def test_classifications_equal_reference():
    assert [c.value for c in primitives.Classification] == \
        [c.value for c in ref_primitives.Classification]
    assert [p.name for p in primitives.invariants()] == \
        [p.name for p in ref_primitives.invariants()]
    assert [p.name for p in primitives.divergences()] == \
        [p.name for p in ref_primitives.divergences()]
    assert not primitives.SPECS[primitives.Primitive.ZERO_COST_SWITCH] \
        .tpu_direct


# ---------------------------------------------------------------------------
# Execution model: launch validation, Eq. 1 occupancy
# ---------------------------------------------------------------------------


GEOMETRIES = [
    dict(grid=(8, 8), workgroup=256),
    dict(grid=(1,), workgroup=2048),
    dict(grid=(0,), workgroup=32),
    dict(grid=(4,), workgroup=64, regs_per_thread=200),
    dict(grid=(4,), workgroup=128, regs_per_thread=64,
         scratchpad_bytes=48 * 1024),
    dict(grid=(2, 3), workgroup=1024, regs_per_thread=32,
         scratchpad_bytes=200 * 1024, cluster=2),
    dict(grid=(1,), workgroup=96, regs_per_thread=255,
         scratchpad_bytes=1 << 30),
]


def _launch_result(mod, geom, d):
    try:
        mod.validate_launch(geom, d)
        valid = True
    except mod.LaunchError:
        valid = False
    return valid, mod.occupancy(geom, d)


@pytest.mark.parametrize("name", NAMES)
def test_launch_validation_and_occupancy_equal_reference(name):
    for g in GEOMETRIES:
        got = execution_model.LaunchGeometry(**g)
        ref = ref_exec.LaunchGeometry(**g)
        assert (got.total_workgroups, got.total_threads) == \
            (ref.total_workgroups, ref.total_threads)
        assert _launch_result(execution_model, got, DIALECTS[name]) == \
            _launch_result(ref_exec, ref, _ref_dialect(name)), g


@pytest.mark.parametrize("name", NAMES)
def test_eq1_equals_reference(name):
    got, ref = DIALECTS[name], _ref_dialect(name)
    for regs, width in itertools.product((1, 16, 32, 64, 128, 255, 256),
                                         (None, 8, 32, 64)):
        assert got.occupancy(regs, wave_width=width) == \
            ref_dialect.Dialect.occupancy(ref, regs, wave_width=width)
    for ws, bufs, occ in itertools.product((1, 4096, 1 << 20, 1 << 27),
                                           (1, 2, 3), (1, 2, 4)):
        assert execution_model.choose_block_bytes(ws, got, bufs, occ) == \
            ref_exec.choose_block_bytes(ws, ref, bufs, occ)
        assert execution_model.tpu_pipeline_occupancy(ws, bufs, got) == \
            ref_exec.tpu_pipeline_occupancy(ws, bufs, ref)


def test_grid_for_and_lane_ids():
    for total, per in itertools.product((1, 7, 128, 1000), (1, 8, 128)):
        assert execution_model.grid_for(total, per) == \
            ref_exec.grid_for(total, per)
    with pytest.raises(ValueError):
        execution_model.grid_for(4, 0)
    ids = execution_model.WaveView(TARGET.W).lane_ids("cpu")
    assert ids.dtype == torch.int32 and ids.device.type == "cpu"
    np.testing.assert_array_equal(
        ids.numpy(), np.asarray(ref_exec.WaveView(32).lane_ids()))


def test_eq1_nvidia_example_and_monotone():
    nv = DIALECTS["nvidia-ada-sm89"]
    assert nv.occupancy(32) == 64 and nv.occupancy(256) == 0
    assert TARGET.occupancy(32) == 64                 # 64K regs per SM
    for d in dialect.gpu_dialects() + (TARGET,):
        occ = [d.occupancy(r) for r in range(1, d.R + 1)]
        assert occ == sorted(occ, reverse=True)


# ---------------------------------------------------------------------------
# Memory model
# ---------------------------------------------------------------------------


def test_memory_model_equals_reference():
    assert [s.value for s in memory_model.Scope] == \
        [s.value for s in ref_memory.Scope]
    assert [o.value for o in memory_model.Ordering] == \
        [o.value for o in ref_memory.Ordering]
    for a, b in itertools.product(memory_model.Scope, repeat=2):
        assert a.rank == ref_memory.Scope(a.value).rank
        assert memory_model.requires_fence(a, b) == ref_memory.requires_fence(
            ref_memory.Scope(a.value), ref_memory.Scope(b.value))
        for o in memory_model.Ordering:
            memory_model.fence(a, o)                 # auditable no-op
    got = [(m.name, m.scope.value, m.explicit)
           for m in memory_model.MANDATORY_HIERARCHY]
    assert got == [(m.name, m.scope.value, m.explicit)
                   for m in ref_memory.MANDATORY_HIERARCHY]
    assert len(got) == 3


# ---------------------------------------------------------------------------
# Mapping (Fig. 3)
# ---------------------------------------------------------------------------


def test_full_report_equals_reference_line_for_line():
    got = mapping.full_report().splitlines()
    ref = ref_mapping.full_report().splitlines()
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a == b, i
    assert "Google" in mapping.dialect_table()


@pytest.mark.parametrize("vendor", ["NVIDIA", "AMD", "Intel", "Apple",
                                    "Google"])
def test_mapping_rows_equal_reference(vendor):
    assert mapping.mapping_rows(vendor) == ref_mapping.mapping_rows(vendor)


@pytest.mark.parametrize("report", ["vendor_mapping_report",
                                    "tpu_adaptation_report", "dialect_table"])
def test_reports_equal_reference(report):
    assert getattr(mapping, report)() == getattr(ref_mapping, report)()


# ---------------------------------------------------------------------------
# Pipeline plans (tests/test_pipeline_plan.py's cases through the port)
# ---------------------------------------------------------------------------


PLAN_FIELDS = ("block_rows", "row_bytes", "n_buffers", "occupancy", "grid",
               "padded_rows", "mode", "semantics", "block_bytes")


def _plans_equal(kw, name):
    got = pipeline.plan_row_pipeline(dialect=DIALECTS[name], **kw)
    ref = ref_pipeline.plan_row_pipeline(dialect=_ref_dialect(name), **kw)
    for f in PLAN_FIELDS:
        assert getattr(got, f) == getattr(ref, f), (f, kw, name)
    return got


PLAN_CASES = (
    [dict(total_rows=t, row_bytes=512, mode="native", max_block_rows=64)
     for t in (1, 7, 9, 63, 65, 1000, 1025)]
    + [dict(total_rows=t, row_bytes=512, mode="abstract", pow2_blocks=True)
       for t in range(1, pipeline.SUBLANES + 1)]
    + [dict(total_rows=t, row_bytes=512, mode="abstract", max_block_rows=48,
            pow2_blocks=True) for t in (12, 100, 1000, 4096)]
    + [dict(total_rows=777, row_bytes=2048, mode="native", max_block_rows=64,
            tuned=tuned) for tuned in ({"block_rows": 100000},
                                       {"block_rows": 16, "n_buffers": 3},
                                       {"n_buffers": 4}, {})]
    + [dict(total_rows=t, row_bytes=rb, mode="native", max_block_rows=cap,
            n_buffers=nb)
       for t, rb, cap, nb in itertools.product(
           (1, 100, 4096, 1 << 16), (4, 512, 4096, 1 << 20),
           (None, 8, 512), (2, 3))]
)


@pytest.mark.parametrize("name", NAMES)
def test_plans_equal_reference(name):
    for kw in PLAN_CASES:
        plan = _plans_equal(kw, name)
        assert plan.padded_rows >= kw["total_rows"]
        assert plan.padded_rows % plan.block_rows == 0
        assert plan.grid == (plan.padded_rows // plan.block_rows,)


def test_plan_invariants_under_tiny_budgets():
    row_bytes = 4096
    for scratch in (2 * 2 * pipeline.SUBLANES * row_bytes,
                    2 * 2 * pipeline.SUBLANES * row_bytes - 1, 1024,
                    48 * 1024):
        tiny = dataclasses.replace(TPU_V5E, scratchpad_bytes=scratch,
                                   regfile_bytes_per_core=scratch)
        ref_tiny = dataclasses.replace(ref_dialect.TPU_V5E,
                                       scratchpad_bytes=scratch,
                                       regfile_bytes_per_core=scratch)
        got = pipeline.plan_row_pipeline(1024, row_bytes, mode="native",
                                         dialect=tiny)
        ref = ref_pipeline.plan_row_pipeline(1024, row_bytes, mode="native",
                                             dialect=ref_tiny)
        assert (got.block_rows, got.occupancy) == (ref.block_rows,
                                                   ref.occupancy)
        assert got.occupancy >= 2 or got.block_rows == pipeline.SUBLANES
    with pytest.raises(ValueError):
        pipeline.plan_row_pipeline(0, 512, mode="native")
    with pytest.raises(ValueError):
        pipeline.plan_row_pipeline(8, 0, mode="native")


def test_hopper_plan_is_eq1_on_shared_memory():
    """227 KB of shared memory at two buffers and an occupancy of two:
    58112 bytes a block, so a 4 KB row plans 8-row blocks (the granule)
    and a 512-byte row 112."""
    assert pipeline.plan_row_pipeline(4096, 4096, mode="native",
                                      max_block_rows=64).block_rows == 8
    plan = pipeline.plan_row_pipeline(4096, 512, mode="native")
    assert plan.block_rows == 112 and plan.occupancy == 2
    assert not hasattr(plan, "compiler_params")


@pytest.mark.parametrize("rows", [1, 5, 8, 13, 64])
def test_pad_rows_equals_reference(rows):
    x = np.arange(rows * 3, dtype=np.float32).reshape(rows, 3)
    for value in (0, -1):
        got = pipeline.pad_rows(torch.from_numpy(x), pipeline.plan_row_pipeline(
            rows, 12, mode="native", max_block_rows=8), value)
        ref = ref_pipeline.pad_rows(jnp.asarray(x),
                                    ref_pipeline.plan_row_pipeline(
                                        rows, 12, mode="native",
                                        max_block_rows=8), value)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
