"""Device meshes over ``torch.distributed``.

The JAX package's ``launch/mesh.py``.  Its production meshes keep their
shapes and axis names: one pod ``(data=16, model=16)``, two pods ``(pod=2,
data=16, model=16)`` with a leading ``pod`` axis that carries plain data
parallelism, so that only the gradient all-reduce crosses pods.  A mesh
spans the ranks of the default process group, which the caller initializes
(``torch.distributed.init_process_group`` with its address, world size and
rank); a mesh whose size is not the world's is refused.

Functions, not module constants: importing this module touches no process
group.  The JAX module's roofline constants are a TPU v5e's; the card's own
(an H100 80GB HBM3 at 700 W) are ``core.dialect.NVIDIA_HOPPER_SM90``'s
fields, read there.
"""
from __future__ import annotations

import math
from typing import Tuple

from repro_torch.models.config import ParallelConfig
from repro_torch.parallel.sharding import ShardCtx, mesh_axis_sizes


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The ``(16, 16)`` mesh, or ``(2, 16, 16)`` with ``multi_pod``: it
    needs a world of 256 (512) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with dim names ``axes`` over the whole
    world (``init_device_mesh``); raises unless the world has
    ``prod(shape)`` ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs an initialized default "
                           f"process group (init_process_group)")
    need, world = math.prod(shape), dist.get_world_size()
    if need != world:
        raise ValueError(f"a {shape} mesh needs a world of {need} ranks; "
                         f"this one has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_ctx(mesh, par: ParallelConfig, cfg=None) -> ShardCtx:
    """The model's :class:`ShardCtx` on ``mesh``.  ``cfg`` (a ModelConfig)
    gates the ``qkv_heads`` rule: the persisted [wq|wk|wv] concat shards
    over the model axis only when every segment's head count divides it;
    otherwise a shard boundary would cut across the q/k/v seams (8 kv
    heads on a 16-way axis), so it replicates."""
    qkv_ok = True
    if cfg is not None and mesh is not None:
        t = mesh_axis_sizes(mesh).get("model", 1)
        hkv = cfg.num_kv_heads or cfg.num_heads
        qkv_ok = cfg.num_heads % t == 0 and hkv % t == 0
    return ShardCtx(mesh=mesh, fsdp=par.fsdp,
                    seq_shard_acts=par.seq_shard_acts,
                    cache_layout=par.cache_layout,
                    qkv_heads_shardable=qkv_ok)

