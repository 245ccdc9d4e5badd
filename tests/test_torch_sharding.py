"""The port's sharding layer against the JAX package's: ``ShardCtx.spec``
for every logical name and flag combination with no mesh and on
``(data, model)`` and ``(pod, data, model)`` meshes, the DTensor
placements a spec means, ``sanitize_sharding`` on hand-made cases, the
four model classes' ``param_specs`` / ``cache_specs`` key for key on the
ten reduced configs (both parameter layouts, the int8 cache), the
``qkv_heads`` rule of ``make_ctx``, and the full-size specs, which
allocate nothing.

The port's meshes are ``DeviceMesh``es over a one-rank gloo group: a
``(1, 1)`` mesh is a real one; the larger ones are descriptions
(``_init_backend=False``), which is all the spec code reads."""
import dataclasses
import itertools

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard
from torch.overrides import TorchFunctionMode

from repro.configs import get_reduced as ref_reduced
from repro.launch.mesh import make_ctx as ref_make_ctx
from repro.models import build_model as ref_build
from repro.models.config import ParallelConfig as RefPar
from repro.parallel import sharding as ref_sharding

from repro_torch import tree
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.launch import hostdev, mesh as mesh_mod
from repro_torch.models import build_model
from repro_torch.models.config import ParallelConfig
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import (NamedSharding, ShardCtx,
                                           sanitize_sharding, sanitize_tree,
                                           tree_shardings)

AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
NAMES = sorted(sharding._rules(True, True, "batch_heads"))
#: logical tuples where an axis would repeat (the later use replicates)
#: or a tuple entry meets a mesh without one of its axes
MULTI = [("act_batch", "act_group"), ("act_cache_batch", "act_kv_seq"),
         ("act_kv_seq", "act_cache_batch"), ("embed", "vocab"),
         ("vocab", "act_vocab"), ("act_heads", "act_kv_heads", "act_seq"),
         (None, "act_cache_batch", "act_kv_heads", "act_kv_seq",
          "act_head_dim"), ("experts", "embed", "expert_mlp")]
FLAGS = list(itertools.product((True, False), (True, False),
                               ("batch_heads", "batch_seq", "seq_all"),
                               (True, False)))


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    store = dist.FileStore(str(tmp_path_factory.mktemp("pg") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def described(shape, axes):
    """A DeviceMesh of ``shape`` named ``axes`` without process groups."""
    n = int(np.prod(shape))
    return DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=axes, _init_backend=False)


def ref_mesh(axes):
    return Mesh(np.array(jax.devices()[:1]).reshape((1,) * len(axes)), axes)


# ---------------------------------------------------------------------------
# Specs and placements
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ndim", [None, 2, 3])
def test_spec_equals_reference(group, ndim):
    mesh = None if ndim is None else init_device_mesh(
        "cpu", (1,) * ndim, mesh_dim_names=AXES[ndim])
    rmesh = None if ndim is None else ref_mesh(AXES[ndim])
    for fsdp, seq, layout, qkv in FLAGS:
        kw = dict(fsdp=fsdp, seq_shard_acts=seq, cache_layout=layout,
                  qkv_heads_shardable=qkv)
        ctx, ref = ShardCtx(mesh=mesh, **kw), \
            ref_sharding.ShardCtx(mesh=rmesh, **kw)
        for logical in [(n,) for n in NAMES] + MULTI:
            assert ctx.spec(logical) == tuple(ref.spec(logical)), \
                (logical, kw, ndim)


def test_placements(group):
    mesh = described((2, 4, 8), AXES[3])
    ctx = ShardCtx(mesh=mesh)
    assert ctx.placements(("act_batch", "act_heads", None, None)) == (
        Shard(0), Shard(0), Shard(1))
    assert ctx.placements(("embed", "vocab")) == (
        Replicate(), Shard(0), Shard(1))
    assert ctx.placements(("norm",)) == (Replicate(),) * 3
    two = ShardCtx(mesh=described((2, 2), AXES[2]), cache_layout="seq_all")
    assert two.spec((None, "act_cache_batch", "act_kv_heads", "act_kv_seq",
                     "act_head_dim")) == (None, None, None,
                                          ("data", "model"), None)
    assert two.placements((None, "act_cache_batch", "act_kv_heads",
                           "act_kv_seq", "act_head_dim")) == (Shard(3),
                                                              Shard(3))


def test_shard_is_the_identity_off_a_mesh(group):
    x = torch.ones(2, 3)
    assert sharding.shard(x, ("act_batch", "act_embed"), None) is x
    assert sharding.shard(x, ("act_batch", "act_embed"), ShardCtx()) is x
    ctx = ShardCtx(mesh=init_device_mesh("cpu", (1, 1),
                                         mesh_dim_names=AXES[2]))
    assert sharding.shard(x, ("act_batch", "act_embed"), ctx) is x


# ---------------------------------------------------------------------------
# sanitize_sharding
# ---------------------------------------------------------------------------

SANITIZE = [
    # (mesh shape, spec, tensor shape, the sanitized spec)
    ((2, 2), ("model", "data"), (40, 64), ("model", "data")),
    ((1, 16), ("model", None), (40, 4096), (None, None)),
    ((2, 4), ("model", None), (40, 4096), ("model", None)),
    ((1, 16), ("data", "model"), (4096, 49155), ("data", None)),
    ((2, 2), ("model", "data"), (49155, 4096), (None, "data")),
    ((1, 16), ("data", "model"), (4096, 8 * 128), ("data", "model")),
    ((1, 16), (None, ("data", "model"), "model"), (8, 8, 8),
     (None, "data", None)),
    ((4, 4), (("data", "model"), None), (8, 3), ("data", None)),
    ((4, 4), (("data", "model"), None), (32, 3), (("data", "model"), None)),
    ((2, 2), (None, None, "model"), (3, 5), (None, None, None)),
]


@pytest.mark.parametrize("shape,spec,dims,want", SANITIZE)
def test_sanitize_sharding(group, shape, spec, dims, want):
    mesh = described(shape, AXES[2])
    got = sanitize_sharding(NamedSharding(mesh, spec), dims)
    assert got.spec == want and got.mesh is mesh
    assert sanitize_sharding(None, dims) is None


def test_sanitize_tree_and_kv_heads_on_16(group):
    """8 kv heads of 128 on a 16-way model axis: wk divides (1024), the
    cache's kv-head dim does not and replicates."""
    cfg = dataclasses.replace(get_reduced("granite-8b"), num_heads=32,
                              num_kv_heads=8, head_dim=128, d_model=256)
    ctx = ShardCtx(mesh=described((1, 16), AXES[2]))
    model = build_model(cfg, device="cpu")
    specs = model.cache_specs()
    shapes = {"k": (2, 4, 8, 64, 128), "v": (2, 4, 8, 64, 128),
              "pos": (4,)}
    got = sanitize_tree(tree_shardings(ctx, specs), shapes)
    assert got["k"].spec == (None, "data", None, None, None)
    assert got["pos"].spec == (None,)
    wk = sanitize_sharding(ctx.sharding(("embed", "kv_heads")), (256, 1024))
    assert wk.spec == ("data", "model")
    assert sanitize_tree(None, shapes) is None
    assert tree_shardings(ShardCtx(), specs) == {"k": None, "v": None,
                                                 "pos": None}


# ---------------------------------------------------------------------------
# param_specs / cache_specs
# ---------------------------------------------------------------------------

POLICIES = {"default": {}, "fused": dict(fuse_epilogues=True),
            "int8_cache": dict(kv_cache_int8=True)}


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_reference(arch):
    for name, kw in POLICIES.items():
        if name == "int8_cache" and get_reduced(arch).family not in (
                "dense", "moe", "vlm"):
            continue
        model = build_model(get_reduced(arch), ParallelConfig(**kw),
                            device="cpu")
        ref = ref_build(ref_reduced(arch), RefPar(**kw))
        assert model.param_specs() == ref.param_specs(), (arch, name)
        assert model.cache_specs() == ref.cache_specs(), (arch, name)
        # every parameter and cache leaf has a spec of its rank
        params = tree.flatten(model.init_params(0))
        assert set(_leaf_paths(model.param_specs())) == set(params), \
            (arch, name)
        for path, spec in _leaf_paths(model.param_specs()).items():
            assert len(spec) == params[path].ndim, (arch, path)
        cache = tree.flatten(model.init_cache(2, 8))
        for path, spec in _leaf_paths(model.cache_specs()).items():
            assert len(spec) == cache[path].ndim, (arch, path)


def _leaf_paths(specs, prefix=""):
    """Slash-joined paths of a spec tree (its tuples are leaves)."""
    if isinstance(specs, dict):
        out = {}
        for k, v in specs.items():
            out.update(_leaf_paths(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: specs}


class _NoTensors(TorchFunctionMode):
    """Fails on any torch function call: a tensor made, or one read."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        raise AssertionError(f"param_specs called {func}")


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_specs_allocate_nothing(arch):
    """At full size the specs equal the reduced config's, and building
    them calls no torch function."""
    for kw in POLICIES.values():
        par = ParallelConfig(**kw)
        model = build_model(get_config(arch), par, device="cpu")
        with _NoTensors():
            specs, cache = model.param_specs(), model.cache_specs()
        small = build_model(get_reduced(arch), par, device="cpu")
        assert specs == small.param_specs() and cache == small.cache_specs()


# ---------------------------------------------------------------------------
# make_ctx, the production mesh, hostdev
# ---------------------------------------------------------------------------


def test_make_ctx_qkv_rule(group):
    par = ParallelConfig(fsdp=False, cache_layout="batch_seq")
    cfg = get_reduced("granite-8b")                 # 4 heads, 2 kv heads
    for t, ok in ((1, True), (2, True), (4, False)):
        ctx = mesh_mod.make_ctx(described((1, t), AXES[2]), par, cfg)
        assert ctx.qkv_heads_shardable is ok, t
        assert (ctx.fsdp, ctx.cache_layout) == (False, "batch_seq")
        assert ctx.spec(("embed", "qkv_heads")) == (
            None, "model" if ok else None)
    assert mesh_mod.make_ctx(None, par, cfg).qkv_heads_shardable
    ref = ref_make_ctx(ref_mesh(AXES[2]), RefPar(), ref_reduced("granite-8b"))
    got = mesh_mod.make_ctx(described((1, 1), AXES[2]), ParallelConfig(),
                            cfg)
    assert dataclasses.asdict(dataclasses.replace(got, mesh=None)) == \
        dataclasses.asdict(dataclasses.replace(ref, mesh=None))


def test_kernel_rows_take_whole_dtensors(group):
    # a kernel lowering reads DTensor operands whole and returns replicated
    # DTensors (a pallas_call under GSPMD); a library row shards itself
    from repro_torch.kernels import ops
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=AXES[2])
    gen = torch.Generator().manual_seed(0)
    x, w = torch.randn(6, 32, generator=gen), torch.rand(32, generator=gen)
    wp = torch.randn(32, 24, generator=gen)
    placed = [sharding.place_tree(t, NamedSharding(mesh, spec)) for t, spec
              in ((x, ("data", None)), (w, (None,)), (wp, (None, "model")))]
    assert sharding.has_dtensor(placed, {})
    assert not sharding.has_dtensor((x, w), dict(w_proj=wp))
    for mode in ("native", "abstract", "library"):
        want = ops.fused_rmsnorm_matmul(x, w, wp, mode=mode)
        got = ops.fused_rmsnorm_matmul(*placed, mode=mode)
        if mode != "library":
            assert all(p == Replicate() for p in got.placements), mode
        torch.testing.assert_close(got.full_tensor(), want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="must be replicated"):
        sharding.replicated_call(torch.add, placed[0], placed[0],
                                 out=placed[0])


def test_make_mesh_checks_the_world(group):
    with pytest.raises(ValueError, match="needs a world of 256"):
        mesh_mod.make_production_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="needs a world of 512"):
        mesh_mod.make_production_mesh(multi_pod=True, device_type="cpu")
    mesh = mesh_mod.make_mesh((1, 1), AXES[2], device_type="cpu")
    assert mesh.mesh_dim_names == AXES[2]


def test_roofline_constants_are_the_cards():
    # the JAX module's TPU v5e constants are not copied; the card's own
    # are the Hopper dialect's, stated once
    from repro_torch.core.dialect import NVIDIA_HOPPER_SM90 as hopper
    for name in ("PEAK_FLOPS_BF16", "HBM_BW", "ICI_BW", "NVLINK_BW"):
        assert not hasattr(mesh_mod, name), name
    assert hopper.peak_flops_bf16 == 989e12
    assert hopper.hbm_bandwidth == 3.35e12
    assert hopper.interconnect.link_bandwidth == 450e9


def test_sim_device_count(monkeypatch):
    monkeypatch.delenv(hostdev.ENV_VAR, raising=False)
    assert hostdev.sim_device_count() == hostdev.DEFAULT_DEVICES
    assert hostdev.sim_device_count(4) == 4
    monkeypatch.setenv(hostdev.ENV_VAR, "2")
    assert hostdev.sim_device_count(4) == 2
    monkeypatch.setenv(hostdev.ENV_VAR, "x")
    assert hostdev.sim_device_count(4) == 4
    # the knob names a launcher's default; the ranks started are the count
    monkeypatch.setenv(hostdev.ENV_VAR, "0")
    assert hostdev.run_host_ranks(dist.get_world_size, count=2) == 2
    with pytest.raises(ValueError, match="count of 1 or more"):
        hostdev.run_host_ranks(dist.get_world_size, count=0)
