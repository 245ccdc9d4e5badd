"""The mesh-aware registry and the tensor-parallel twins of the port against
the JAX package's: each twin's cost in every mode on the six reference
dialects at the JAX package's compile target (``target=TPU_V5E``), auto's
pick under a model axis, the (op, mode) pairs, the selection memo across
mesh sizes, pinned modes and the int8 precision (neither retargets to a
twin), and the ambient axes read from an entered ``DeviceMesh`` on a
one-rank gloo group."""
import itertools
import warnings

import pytest
import torch
import torch.distributed as dist

from repro.core import ExecutionPolicy as RefPolicy
from repro.core import REGISTRY as REF_REGISTRY
from repro.core import dialect as ref_dialect
from repro.core.registry import use_mesh_axes as ref_use_mesh_axes
from repro.kernels import collective as ref_collective
from repro.kernels import ops as ref_ops  # noqa: F401 (registers ref ops)
from test_torch_structural_cost import _assert_equal, _jax_shape

from repro_torch.core import (DIALECTS, REGISTRY, TARGET, TP_AXIS, TPU_V5E,
                              ExecutionPolicy, IsaMode, LoweringRegistry,
                              ambient_mesh_axes, tp_axis_size, use_mesh_axes)
from repro_torch.kernels import collective, ops

SHARED = sorted(ref_dialect.DIALECTS)
TPS = (1, 2, 4, 64)
#: granite-8b's served shapes of the three fused bases (8 slots, prompts
#: of 512, pages of 128), and the decode GEMM of the JAX policy test
DECODE = {
    "gemm_tp": [dict(m=128, n=4096, k=4096),
                dict(m=8, n=4096, k=4096, dtype=torch.bfloat16)],
    "rmsnorm_matmul_tp": [dict(rows=8, d=4096, n=6144),
                          dict(rows=512, d=4096, n=6144),
                          dict(rows=8, d=4096, n=49152,
                               dtype=torch.bfloat16)],
    "rmsnorm_swiglu_tp": [dict(rows=8, d=4096, f=14336),
                          dict(rows=512, d=4096, f=14336)],
    "flash_attention_matmul_tp": [
        dict(b=8, h=32, sq=1, skv=640, d=128, n=4096, causal=False,
             block_q=None, block_kv=128, page_size=128, pages_occupied=40),
        dict(b=1, h=32, sq=512, skv=512, d=128, n=4096, causal=True,
             block_q=None, block_kv=None)],
}
CASES = [(twin, mode) for twin in collective.TP_OPS
         for mode in REF_REGISTRY.modes(twin)]
#: (op, shape) probed for auto's pick under a model axis
PICKS = [("rmsnorm_matmul", dict(rows=8, d=4096, n=6144)),
         ("rmsnorm_matmul", dict(rows=8, d=4096, n=6144,
                                 dtype=torch.bfloat16)),
         ("rmsnorm_matmul", dict(rows=512, d=4096, n=6144)),
         ("rmsnorm_matmul", dict(rows=8, d=4096, n=49152)),
         ("rmsnorm_swiglu", dict(rows=8, d=4096, f=14336)),
         ("rmsnorm_swiglu", dict(rows=512, d=4096, f=14336)),
         ("gemm", dict(m=128, n=4096, k=4096)),
         ("flash_attention_matmul", DECODE["flash_attention_matmul_tp"][0]),
         ("rmsnorm_matmul_q8", dict(rows=8, d=4096, n=6144))]
#: the dialects whose auto picks the JAX package makes as the port does
#: at its target: every reference dialect
PICK_DIALECTS = SHARED


def _ref_pick(op, name, shape, tp):
    with ref_use_mesh_axes({"data": 1, "model": tp}), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        low = REF_REGISTRY.select(op, RefPolicy(mode="auto", dialect=name),
                                  shape=_jax_shape(shape))
    return low.op, low.mode.value


# ---------------------------------------------------------------------------
# The registry's rows
# ---------------------------------------------------------------------------


def test_pairs_and_twins_equal_reference():
    pairs = {(op, m) for op in REGISTRY.ops() for m in REGISTRY.modes(op)}
    ref = {(op, m) for op in REF_REGISTRY.ops()
           for m in REF_REGISTRY.modes(op)}
    assert pairs == ref and len(pairs) == 70
    assert REGISTRY.collective_variants() == \
        REF_REGISTRY.collective_variants()
    assert len(REGISTRY.collective_variants()) == 4
    assert set(collective.TP_OPS) == set(ref_collective.TP_OPS)
    assert set(ops.STRUCTURAL_COSTS) == set(ref_ops.STRUCTURAL_COSTS)


@pytest.mark.parametrize("twin", collective.TP_OPS)
def test_twin_rows_reuse_the_base(twin):
    """A twin runs its base op's impl in every mode, under the base's
    contract re-keyed to the twin, with the base's fallbacks."""
    base = twin[:-3]
    assert REGISTRY.collective_variant(base) == twin
    assert REGISTRY.modes(twin) == REGISTRY.modes(base)
    for mode in REGISTRY.modes(twin):
        low, blow = REGISTRY.variant(twin, mode), REGISTRY.variant(base, mode)
        assert low.impl is blow.impl and low.target == blow.target
        assert low.contract.kernel == twin
        assert low.contract.primitives == blow.contract.primitives
    for c, ref in zip(REGISTRY.contracts(twin),
                      REF_REGISTRY.contracts(twin)):
        assert (c.kernel, c.mode.value) == (ref.kernel, ref.mode.value)
    for mode in IsaMode:
        fb, ref = REGISTRY.fallback_for(twin, mode), \
            REF_REGISTRY.fallback_for(twin, mode.value)
        assert (fb is None) == (ref is None), (twin, mode)
        if fb is not None:
            assert (fb.missing.value, fb.to.value) == \
                (ref.missing.value, ref.to.value)


def test_unregister_drops_the_pair():
    reg = LoweringRegistry()
    for op in ("base", "base_tp"):
        reg.register(op, IsaMode.LIBRARY, lambda x: x)
    reg.register_collective_variant("base", "base_tp")
    assert reg.collective_variant("base") == "base_tp"
    reg.unregister("base_tp")
    assert reg.collective_variants() == {}
    with pytest.raises(Exception, match="unknown op"):
        reg.register_collective_variant("base", "missing_tp")


# ---------------------------------------------------------------------------
# The cost models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("twin,mode", CASES)
def test_twin_cost_equals_reference(twin, mode):
    """The module function, the registered row and the ambient axis (tp
    None) each equal the JAX twin's cost, key for key, on every reference
    dialect's interconnect and tuning slice.  With no slice named the
    collective is priced on the target's interconnect (the base cost then
    reads the port's own slice, which the JAX package has not)."""
    fn, ref_fn = collective.TP_COSTS[twin], ref_collective.TP_COSTS[twin]
    shapes = [ops.PROBE_SHAPES[twin]] + DECODE[twin]
    for shape, tp in itertools.product(shapes, TPS):
        for name in SHARED:
            want = ref_fn(mode=mode, plan_dialect=name, tp=tp,
                          **_jax_shape(shape))
            got = fn(mode=mode, plan_dialect=name, tp=tp, target=TPU_V5E,
                     **shape)
            _assert_equal(got, want, (twin, mode, name, shape, tp))
        want = ref_fn(mode=mode, tp=tp, **_jax_shape(shape))
        got = fn(mode=mode, tp=tp, target=TPU_V5E, **shape)
        _assert_equal({k: v for k, v in got.items()
                       if k.startswith(("collective", "tp_axis"))},
                      {k: v for k, v in want.items()
                       if k.startswith(("collective", "tp_axis"))},
                      (twin, mode, shape, tp, "target"))
        with use_mesh_axes({TP_AXIS: tp}), ref_use_mesh_axes({"model": tp}):
            want = ref_fn(mode=mode, plan_dialect="tpu-v5e",
                          **_jax_shape(shape))
            low = REGISTRY.variant(twin, mode)
            got = low.structural_cost(plan_dialect="tpu-v5e",
                                      target=TPU_V5E, **shape)
            _assert_equal(got, want, (twin, mode, shape, tp, "ambient"))


def test_twin_cost_on_hopper():
    """At the port's own target the collective rides NVLink's 450 GB/s
    and 1 us a hop at 3.35 TB/s; tp 1 is the base's cost with a zero
    collective."""
    shape = dict(rows=8, d=4096, n=6144)
    base = REGISTRY.variant("rmsnorm_matmul", "native").structural_cost(
        **shape)
    one = collective.structural_cost_rmsnorm_matmul_tp(mode="native", tp=1,
                                                       **shape)
    assert one["hbm_bytes"] == base["hbm_bytes"]
    assert one["collective_hbm_equiv_bytes"] == 0
    four = collective.structural_cost_rmsnorm_matmul_tp(mode="native", tp=4,
                                                        **shape)
    link = TARGET.interconnect
    wire = 8 * 6144 * 4 * 3 // 4
    assert four["collective_bytes"] == wire and four["collective_hops"] == 3
    assert four["collective_hbm_equiv_bytes"] == int(
        wire * TARGET.hbm_bandwidth / link.link_bandwidth
        + 3 * link.hop_latency_s * TARGET.hbm_bandwidth)
    assert four["weight_stream_bytes"] == base["weight_stream_bytes"] // 4


# ---------------------------------------------------------------------------
# auto under a model axis
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op,shape", PICKS,
                         ids=[f"{op}-{i}" for i, (op, _) in
                              enumerate(PICKS)])
def test_auto_pick_under_mesh_equals_reference(op, shape):
    for name, tp in itertools.product(PICK_DIALECTS, (1, 2, 4, 16, 64)):
        want = _ref_pick(op, name, shape, tp)
        with use_mesh_axes({"data": 1, "model": tp}):
            ranked = REGISTRY.ranked(op, DIALECTS[name], shape,
                                     target=TPU_V5E)
        assert (ranked[0].op, ranked[0].mode.value) == want, \
            (op, name, tp, shape)


def test_twin_flips_with_the_mesh_on_tpu():
    """The JAX package's flips, at its target: the bf16 decode qkv takes
    the twin at 2-16 and the replicated op at 1 and 64; on
    nvidia-ada-sm89 the replicated op at 16 again."""
    shape = dict(rows=8, d=4096, n=6144, dtype=torch.bfloat16)
    picks = {tp: _ref_pick("rmsnorm_matmul", "tpu-v5e", shape, tp)[0]
             for tp in (1, 2, 4, 16, 64)}
    assert picks == {1: "rmsnorm_matmul", 2: "rmsnorm_matmul_tp",
                     4: "rmsnorm_matmul_tp", 16: "rmsnorm_matmul_tp",
                     64: "rmsnorm_matmul"}
    assert _ref_pick("rmsnorm_matmul", "nvidia-ada-sm89", shape,
                     16)[0] == "rmsnorm_matmul"


def _hopper_pick(op, shape, tp, policy=None, device="cpu"):
    policy = policy or ExecutionPolicy(mode="auto")
    with use_mesh_axes({"model": tp}):
        return REGISTRY.select(op, policy, shape=shape,
                               device=torch.device(device))


def test_memo_follows_the_mesh():
    """One shape at model 4, then 64, then 4: twin, replicated, twin (the
    memo keys on the model axis's size)."""
    shape = dict(rows=8, d=4096, n=6144)
    ops_seen = [_hopper_pick("rmsnorm_matmul", shape, tp, device=dev).op
                for tp in (4, 64, 4) for dev in ("cpu", "cuda")]
    assert ops_seen == ["rmsnorm_matmul_tp"] * 2 + ["rmsnorm_matmul"] * 2 \
        + ["rmsnorm_matmul_tp"] * 2
    assert _hopper_pick("rmsnorm_matmul", shape, 1).op == "rmsnorm_matmul"


def test_pinned_modes_and_int8_never_retarget():
    shape = dict(rows=8, d=4096, n=6144)
    for mode in ("native", "abstract", "abstract+shuffle", "library"):
        low = _hopper_pick("rmsnorm_matmul", shape, 4,
                           ExecutionPolicy(mode=mode))
        assert (low.op, low.mode.value) == ("rmsnorm_matmul", mode)
    low = _hopper_pick("rmsnorm_matmul", shape, 4,
                       ExecutionPolicy(mode="auto", precision="int8"))
    assert low.op == "rmsnorm_matmul_q8"
    assert REGISTRY.collective_variant("rmsnorm_matmul_q8") is None


def test_no_interconnect_never_picks_a_twin():
    for (op, shape), tp in itertools.product(PICKS, TPS):
        low = _hopper_pick(op, shape, tp,
                           ExecutionPolicy(mode="auto", dialect="apple-g13"))
        assert not low.op.endswith("_tp"), (op, tp)


# ---------------------------------------------------------------------------
# The ambient axes
# ---------------------------------------------------------------------------


def test_use_mesh_axes_scopes_the_axis():
    assert ambient_mesh_axes() == {} and tp_axis_size() == 1
    with use_mesh_axes({"data": 2, "model": 8}):
        assert tp_axis_size() == 8
        with use_mesh_axes({"model": 4}):
            assert tp_axis_size() == 4
        assert tp_axis_size() == 8
    assert tp_axis_size() == 1


def test_ambient_axes_from_an_entered_device_mesh(tmp_path):
    """A world-size-1 gloo group over a FileStore: inside ``with mesh:``
    the axes are the mesh's dim names and sizes, ``use_mesh_axes``
    shadows them, and a mesh without dim names gives none."""
    from torch.distributed.device_mesh import init_device_mesh
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        with mesh:
            assert ambient_mesh_axes() == {"data": 1, "model": 1}
            with use_mesh_axes({"model": 4}):
                assert tp_axis_size() == 4
                assert _hopper_pick("rmsnorm_swiglu",
                                    dict(rows=8, d=4096, f=14336),
                                    4).op == "rmsnorm_swiglu_tp"
            assert tp_axis_size() == 1
        with init_device_mesh("cpu", (1,)):
            assert ambient_mesh_axes() == {}
        assert ambient_mesh_axes() == {}
    finally:
        dist.destroy_process_group()
