"""Logical-axis sharding rules (DP / FSDP / TP / EP / SP on one table), on
``torch.distributed`` device meshes.

The JAX package's ``parallel/sharding.py``.  Mesh axes (launch/mesh.py):

- ``pod``: data parallelism across pods (only the gradient all-reduce
  crosses it);
- ``data``: the DP / FSDP axis within a pod;
- ``model``: the TP / EP axis.

Layers and parameters name their dims by logical axes, which
:class:`ShardCtx` resolves through :func:`_rules` into a spec: a tuple with
one entry a tensor dim, each a mesh axis name, a tuple of them, or None
(JAX's ``PartitionSpec`` entries).  :class:`NamedSharding` pairs a spec
with its ``DeviceMesh`` and gives the DTensor ``placements`` it means.

``torch.distributed.tensor`` is imported inside the functions that place
or move a tensor: importing it costs about a second, and a model run with
no mesh never needs it.
"""
from __future__ import annotations

import dataclasses
import math
import sys
from typing import Optional, Sequence, Tuple, Union

Axis = Union[str, Tuple[str, ...], None]


def _rules(fsdp: bool, seq_shard_acts: bool, cache_layout: str,
           qkv_heads_shardable: bool = True):
    # cache_layout: how the decode KV cache maps onto the mesh:
    #   batch_heads  batch -> (pod, data), kv heads -> model
    #                (needs num_kv_heads divisible by the model axis)
    #   batch_seq    batch -> (pod, data), cache seq -> model
    #   seq_all      cache seq -> (data, model)  (long context, batch 1)
    if cache_layout not in ("batch_heads", "batch_seq", "seq_all"):
        raise ValueError(f"unknown cache_layout {cache_layout!r}")
    return {
        # ---- activations ----
        "act_batch": ("pod", "data"),
        "act_seq": "model" if seq_shard_acts else None,
        "act_seq_unsharded": None,
        "act_embed": None,
        "act_mlp": "model",
        "act_heads": "model",
        "act_kv_heads": "model" if cache_layout == "batch_heads" else None,
        "act_head_dim": None,
        "act_vocab": "model",
        "act_experts": "model",
        "act_capacity": None,
        "act_group": ("pod", "data"),
        "act_kv_seq": {"batch_heads": None, "batch_seq": "model",
                       "seq_all": ("data", "model")}[cache_layout],
        "act_cache_batch": None if cache_layout == "seq_all"
        else ("pod", "data"),
        "act_ssm_heads": "model",
        "act_ssm_state": None,
        "act_frames": None,
        # ---- parameters ----
        "embed": "data" if fsdp else None,     # the FSDP axis
        "vocab": "model",
        "q_heads": "model",
        "kv_heads": "model",
        # the persisted [wq|wk|wv] concat shards over the model axis only
        # when every segment's head count divides it; otherwise a shard
        # boundary would cut across the q/k/v seams, so it replicates
        "qkv_heads": "model" if qkv_heads_shardable else None,
        "heads_merged": "model",
        "head_dim": None,
        "mlp": "model",
        "experts": "model",
        "expert_mlp": None,
        "ssm_inner": "model",
        "ssm_heads": "model",
        "ssm_state": None,
        "conv_width": None,
        "norm": None,
        "frames": None,
    }


def mesh_axis_sizes(mesh) -> dict:
    """A ``DeviceMesh``'s axis name -> size."""
    return dict(zip(mesh.mesh_dim_names or (), mesh.mesh.shape))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (JAX's ``NamedSharding``)."""

    mesh: object                     # torch.distributed DeviceMesh
    spec: Tuple[Axis, ...]

    @property
    def placements(self):
        """The DTensor placements: for each mesh dim, ``Shard(i)`` on the
        tensor dim ``i`` whose entry names it, else ``Replicate()``.  A
        tuple entry shards one tensor dim over several mesh dims, major to
        minor in the mesh's own order (``make_mesh`` lists ``pod`` before
        ``data``, as the JAX spec reads them)."""
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for name in self.mesh.mesh_dim_names:
            dim = next((i for i, entry in enumerate(self.spec)
                        if entry == name or (isinstance(entry, tuple)
                                             and name in entry)), None)
            out.append(Replicate() if dim is None else Shard(dim))
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Resolves logical axis names to a spec for the active mesh.

    ``mesh=None`` (one device) makes every operation the identity, so the
    model code is mesh-agnostic."""

    mesh: object = None              # torch.distributed DeviceMesh or None
    fsdp: bool = True
    seq_shard_acts: bool = True
    cache_layout: str = "batch_heads"
    #: whether the persisted [wq|wk|wv] concat may shard over the model
    #: axis (launch/mesh.py::make_ctx: num_heads and num_kv_heads both
    #: divisible by the axis's size)
    qkv_heads_shardable: bool = True

    def spec(self, logical: Sequence[Optional[str]]) -> Tuple[Axis, ...]:
        """The spec of ``logical``, entries as JAX's ``PartitionSpec``
        holds them: a mesh axis appears at most once (a later duplicate is
        replicated), and an axis the mesh lacks is dropped."""
        rules = _rules(self.fsdp, self.seq_shard_acts, self.cache_layout,
                       self.qkv_heads_shardable)
        names = None if self.mesh is None else self.mesh.mesh_dim_names
        axes = []
        used = set()
        for name in logical:
            if name is None:
                axes.append(None)
                continue
            ax = rules[name]
            if isinstance(ax, tuple):
                ax = tuple(a for a in ax if a not in used
                           and (names is None or a in names))
                used.update(ax)
                # a one-axis tuple is that axis, as PartitionSpec reads it
                axes.append(ax[0] if len(ax) == 1 else (ax or None))
            elif ax in used or (names is not None and ax is not None
                                and ax not in names):
                axes.append(None)
            else:
                if ax is not None:
                    used.add(ax)
                axes.append(ax)
        return tuple(axes)

    def sharding(self, logical: Sequence[Optional[str]]
                 ) -> Optional[NamedSharding]:
        if self.mesh is None:
            return None
        return NamedSharding(self.mesh, self.spec(logical))

    def placements(self, logical: Sequence[Optional[str]]):
        """The DTensor placements of ``logical`` on the mesh."""
        return self.sharding(logical).placements


def shard(x, logical: Sequence[Optional[str]], ctx: Optional[ShardCtx]):
    """Move a DTensor to the layout its logical axes name (JAX's
    ``with_sharding_constraint``); the identity without a mesh or on a
    plain tensor.  A dim that its axes do not divide stays replicated over
    them (:func:`sanitize_sharding`): GSPMD pads such a dim, a DTensor
    would split it unevenly."""
    if ctx is None or ctx.mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    if len(logical) != x.ndim:
        raise ValueError(f"{len(logical)} logical axes for a tensor of "
                         f"shape {tuple(x.shape)}")
    placements = sanitize_sharding(ctx.sharding(logical), x.shape).placements
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(ctx.mesh, placements)


def unflatten(x, dim: int, sizes: Sequence[int]):
    """``x.unflatten(dim, sizes)``, for plain tensors and DTensors alike.

    A DTensor sharded on ``dim`` can be split only when its shards fall on
    whole elements of the leading size (3 kv heads of 16 over 2 devices
    cannot): there it is gathered on ``dim`` first, where GSPMD would pad."""
    placements = getattr(x, "placements", None)
    if placements is not None:
        dim = dim % x.ndim
        over = [i for i, p in enumerate(placements) if p.is_shard(dim)]
        extent = math.prod(x.device_mesh.mesh.shape[i] for i in over)
        if sizes[0] % extent:
            from torch.distributed.tensor import Replicate
            x = x.redistribute(x.device_mesh, [
                Replicate() if i in over else p
                for i, p in enumerate(placements)])
    return x.unflatten(dim, sizes)


def _map(fn, spec_tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure (a spec
    tree's leaves are its tuples), into that structure."""
    if isinstance(spec_tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in spec_tree.items()}
    return fn(spec_tree, *rest)


def tree_shardings(ctx: ShardCtx, spec_tree):
    """Map a tree of logical-axis tuples to :class:`NamedSharding`s (or
    None without a mesh)."""
    return _map(ctx.sharding, spec_tree)


def batch_sharding(ctx: ShardCtx) -> Optional[NamedSharding]:
    """The sharding of host-side [B, S] token batches."""
    if ctx.mesh is None:
        return None
    return ctx.sharding(("act_batch", "act_seq_unsharded"))


def sanitize_sharding(sh: Optional[NamedSharding], shape
                      ) -> Optional[NamedSharding]:
    """Drop spec axes that do not divide the argument's dims.

    The configs are full of dims that no power of two divides (40 experts,
    vocab 49155, 8 kv heads on a 16-way axis), so a placement is sanitized
    per leaf: each dim keeps the longest prefix of its axis tuple whose
    size product divides it; the dims that lose an axis are replicated.
    ``shape`` is a tensor or its shape."""
    if sh is None:
        return None
    sizes = mesh_axis_sizes(sh.mesh)
    dims = tuple(getattr(shape, "shape", shape))
    new_axes = []
    for i, entry in enumerate(sh.spec):
        if entry is None or i >= len(dims):
            new_axes.append(None)
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        kept = []
        prod = 1
        for n in names:
            if dims[i] % (prod * sizes[n]) == 0:
                kept.append(n)
                prod *= sizes[n]
            else:
                break
        new_axes.append(tuple(kept) if len(kept) > 1
                        else (kept[0] if kept else None))
    return NamedSharding(sh.mesh, tuple(new_axes))


def sanitize_tree(shardings, shapes):
    """Map :func:`sanitize_sharding` over matching trees (``shapes``: the
    tensors or their shapes)."""
    if shardings is None:
        return None
    return _map(sanitize_sharding, shardings, shapes)


def place_tree(params, shardings):
    """The parameter tree as DTensors placed by ``shardings`` (JAX's
    ``device_put``): each rank keeps its shards of every leaf, which every
    rank must hold whole and equal; a None sharding leaves its leaf a
    plain tensor."""
    from torch.distributed.tensor import distribute_tensor

    def place(x, sh):
        if sh is None:
            return x
        return distribute_tensor(x, sh.mesh, sh.placements)
    return _map(place, params, shardings)


def has_dtensor(args, kwargs) -> bool:
    """Whether an argument is a DTensor (False at once when
    ``torch.distributed.tensor`` was never imported: no DTensor exists)."""
    mod = sys.modules.get("torch.distributed.tensor")
    if mod is None:
        return False
    dt = mod.DTensor
    return any(isinstance(a, dt) for a in args) \
        or any(isinstance(a, dt) for a in kwargs.values())


def replicated_call(fn, *args, **kwargs):
    """``fn`` on the whole tensors of its DTensor arguments; its tensor
    results come back as DTensors replicated on their mesh.  A hand-written
    kernel reads every operand whole, as a ``pallas_call`` under GSPMD does
    (XLA gathers a custom call's sharded operands).  An ``out=`` DTensor
    that the kernel writes into must be replicated, so that its whole
    tensor is its own storage."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate
    meshes = []

    def whole(a):
        if not isinstance(a, DTensor):
            return a
        meshes.append(a.device_mesh)
        return a.full_tensor()
    out = kwargs.get("out")
    if isinstance(out, DTensor) and not all(p.is_replicate()
                                            for p in out.placements):
        raise ValueError(f"an out= DTensor must be replicated, got "
                         f"{out.placements}")
    result = fn(*map(whole, args), **{k: whole(v) for k, v in kwargs.items()})
    mesh = meshes[0]
    if any(m != mesh for m in meshes):
        raise ValueError("DTensor arguments on different meshes")
    rep = [Replicate()] * mesh.ndim

    def wrap(o):
        if isinstance(o, torch.Tensor):
            return DTensor.from_local(o, mesh, rep, run_check=False)
        if isinstance(o, (tuple, list)):
            return type(o)(wrap(x) for x in o)
        return o
    return wrap(result)
